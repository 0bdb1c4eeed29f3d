"""The ``transfuser`` configuration with ``"reference": "convnext"``.
``use_convnext`` puts it, as a file of the test's own, in the place of
``transfuser``'s, so that the ``transfuser.*`` cells run the ConvNeXt
reference under their own mixes and limits. BENCHMARK.json has no such
configuration."""

from __future__ import annotations

import json

from bench_port import harness


def convnext_config(trunk=None) -> dict:
    """The configuration file's contents, both trunks ``trunk`` where
    given (else ``transfuser``'s, for ``tiny_config`` to replace)."""
    config = harness.load_json(f"{harness.HERE}/configs/transfuser.json")
    config["reference"] = "convnext"
    if trunk is not None:
        config["config"]["model"].update(image_architecture=trunk,
                                         lidar_architecture=trunk)
    return config


def use_convnext(monkeypatch, path, trunk=None) -> None:
    """Write the configuration to ``path`` and point the ``transfuser``
    configuration at it."""
    with open(path, "w") as f:
        json.dump(convnext_config(trunk), f)
    spec = harness.spec()
    for c in spec["configs"]:
        if c["name"] == "transfuser":
            c["file"] = str(path)
    monkeypatch.setattr(harness, "spec", lambda: spec)
