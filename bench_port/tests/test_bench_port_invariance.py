"""The accepted configurations' seeded weights, held to hashes computed
before the reference model could be chosen by a configuration: every
float leaf's seeding rule at full size (on the meta device), the bits at
the test size on the CPU at two seeds and, on a card, the bits at full
size. A change to a rule, to the order of the draw or to a leaf's shape
changes them."""

import hashlib
import json

import pytest
import torch

from bench_port import harness, weights
from tiny import tiny_config

SEEDS = (3, 2147483713)
CONFIGS = ("transfuser", "transfuser-pillars")
# resolved rules: full size, test size
PLAN = {
    "transfuser": (
        "34a7e50b46c2be3780f470d44f61207ccde20555415b5d8a231bce4ebe515a2f",
        "044002b3bf2e015e5e49393cadddead3426e6fbd68812ecaa8cd11657156af1e"),
    "transfuser-pillars": (
        "5089bc57c9c7f19e43d9ecd0a63a10d751a1bde81fe31c9559682da1debfb3cd",
        "e21e018a9c2ff7b6e384aff5e209bfadd3e787092ebaf03e03d7e86e0d94cefb"),
}
# the state dict at the test size on the CPU, at each seed
TINY = {
    ("transfuser", 3):
        "42fa653710f6a469cba4ba8c0b426c179ec017faad12eb22a40580870cde2a61",
    ("transfuser", 2147483713):
        "4eabbe7aee7e43f650a4c22b476a69c3d13fab28314bab06afe426b66e9f734b",
    ("transfuser-pillars", 3):
        "b08966155c7093fa2e89bb6bab66793503dc42838ba4625fd11451d98390f3a3",
    ("transfuser-pillars", 2147483713):
        "d0e0a3c87ea58215e0f2aca4cc5b3f65f5c956f33b3cfd98d019845476f41325",
}
# the state dict at full size on the card (torch 2.11.0+cu128's CUDA
# generator, H100 80GB HBM3)
CARD = {
    ("transfuser", 3):
        "dcdccd580803ac24bc10b0c8c3bd9480124573c32af3792d70ed83647e8bbd78",
    ("transfuser", 2147483713):
        "1d5dabb7ad32da71a02d4d8e7447b1d79bf78d05d377b37e8243417578c52aec",
    ("transfuser-pillars", 3):
        "779c69f23c6fee016bc57824545d928741de83a8f3a682e726381a13773a5935",
    ("transfuser-pillars", 2147483713):
        "f2dbcef71a0d1195a0dbdfa1026b25e2023cb6f02ab1f1a5c969ea972463d4b7",
}


def state_hash(sd) -> str:
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(f"{k}|{v.dtype}|{tuple(v.shape)}|".encode())
        h.update(v.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def plan_hash(ref, cfg) -> str:
    """Every float leaf with its shape and its rule, in the draw's order
    (the standard deviation of a normal leaf, the value of a constant)."""
    model = ref.build(cfg, "meta")
    plan = weights._plan(ref, model)
    rows = []
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            kind, value = plan[k]
            value = 0.0 if kind in ("zero", "one") else value
            rows.append([k, list(v.shape), kind, repr(float(value))])
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def _config(name, tiny):
    config = harness.load_json(f"{harness.HERE}/configs/{name}.json")
    if tiny:
        config = tiny_config(config)
    ref = harness.reference(config)
    return ref, ref.namespace(config["config"])


@pytest.mark.parametrize("name", CONFIGS)
def test_seeding_rules_are_unchanged(name):
    for tiny, want in zip((False, True), PLAN[name]):
        assert plan_hash(*_config(name, tiny)) == want, tiny


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_seeded_weights_are_unchanged(name, seed):
    ref, cfg = _config(name, tiny=True)
    sd = weights.seeded_state_dict(ref, cfg, seed, "cpu")
    assert state_hash(sd) == TINY[(name, seed)]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_seeded_weights_on_the_card_are_unchanged(card, name, seed):
    ref, cfg = _config(name, tiny=False)
    sd = weights.seeded_state_dict(ref, cfg, seed, card)
    assert state_hash(sd) == CARD[(name, seed)]
