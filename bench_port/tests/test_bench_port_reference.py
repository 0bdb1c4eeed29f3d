"""A configuration brings its own reference model: a module that
``reference/model.py`` does not know, named by the configuration's file,
reaches every caller of the reference, and a leaf that no seeding rule
names is refused."""

import json
import sys
import types

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_port import harness
from bench_port.reference import model as ref
from bench_port.weights import seeded_state_dict
from tiny import tiny_config, tiny_run

STUB = "bench_port.reference.stub_resnet"


class BasicBlock(nn.Module):
    """The port's ResNet BasicBlock in plain fp32, under its names."""

    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = ref.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = ref.BatchNorm(cout, eps=1e-5)
        self.conv2 = ref.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = ref.BatchNorm(cout, eps=1e-5)
        self.downsample = (nn.Sequential(
            ref.Conv2d(cin, cout, 1, stride, bias=False),
            ref.BatchNorm(cout, eps=1e-5))
            if stride != 1 or cin != cout else None)

    def forward(self, x):
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetMicro(nn.Module):
    """The port's ``resnet_micro``: a trunk ``model.py`` lacks."""

    def __init__(self, in_channels, widths=(16, 32, 64, 128)):
        super().__init__()
        self.widths = widths
        self.conv1 = ref.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = ref.BatchNorm(64, eps=1e-5)
        cin = 64
        for i, w in enumerate(widths):
            self.add_module(f"layer{i + 1}", nn.Sequential(
                BasicBlock(cin, w, 2 if i else 1)))
            cin = w

    def stem(self, x):
        return F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)

    def stage(self, i, x):
        return getattr(self, f"layer{i + 1}")(x)


def _module(name, build, seed_rules=ref.seed_rules):
    mod = types.ModuleType(name)
    mod.__dict__.update(
        namespace=ref.namespace, plain_fp32=ref.plain_fp32, lowp=ref.lowp,
        _resizing=ref._resizing, seed_rules=seed_rules, build=build,
        TINY_TRUNK="resnet_micro", callers=set())
    return mod


@pytest.fixture
def stub(monkeypatch, tmp_path):
    """The stub registered as ``reference/stub_resnet.py`` would be, and
    the ``transfuser`` configuration's file naming it."""
    trunks = dict(ref.TRUNK_FACTORIES, resnet_micro=ResNetMicro)

    def build(cfg, device="cpu"):
        mod.callers.add(sys._getframe(1).f_globals["__name__"])
        return ref.build(cfg, device, trunks=trunks)

    mod = _module(STUB, build)
    monkeypatch.setitem(sys.modules, STUB, mod)
    spec = harness.spec()
    path = tmp_path / "transfuser-resnet.json"
    config = harness.load_json(f"{harness.HERE}/configs/transfuser.json")
    json.dump(dict(config, reference="stub_resnet"), open(path, "w"))
    for c in spec["configs"]:
        if c["name"] == "transfuser":
            c["file"] = str(path)
    monkeypatch.setattr(harness, "spec", lambda: spec)
    return mod


def test_a_configuration_runs_its_own_reference(stub):
    frame = tiny_run("transfuser.frame", seconds=0.5,
                     sample_compute_frames=2, warmup_frames=2)
    train = tiny_run("transfuser.train", seconds=0.3)
    train.config["config"]["train"]["compute_dtype"] = "float32"
    for run in (frame, train):
        assert run.ref is stub
        assert run.config["config"]["model"]["image_architecture"] == \
            "resnet_micro"
        harness.drive(run)
        assert run.units > 0
    assert stub.callers >= {"bench_port.drivers.frame",
                            "bench_port.drivers.train", "bench_port.flops",
                            "bench_port.weights"}
    assert frame.flops_per_unit > 0 and train.flops_per_unit > 0
    # in fp32 the stub's trunk is the port's resnet_micro
    assert train.readings["loss_gap"] < 1e-5
    assert train.readings["grad_gap_p90"] < 1e-4


@pytest.mark.parametrize("key, name", [
    ("image_architecture", "resnet_micro"), ("backbone", "late_fusion")])
def test_model_names_the_route_for_what_it_lacks(key, name):
    """A trunk or a backbone family ``model.py`` lacks: the error says
    how a reference module adds it, and passed to ``build`` it is
    built."""
    config = tiny_config(harness.load_json(
        f"{harness.HERE}/configs/transfuser.json"))["config"]
    config["model"][key] = name
    cfg = ref.namespace(config)
    with pytest.raises(ValueError, match="reference/<name>.py"):
        ref.build(cfg, "meta")
    trunks = dict(ref.TRUNK_FACTORIES, resnet_micro=ResNetMicro)
    backbones = dict(ref.BACKBONES, late_fusion=ref.TransfuserBackbone)
    model = ref.build(cfg, "meta", trunks=trunks, backbones=backbones)
    if key == "backbone":
        assert type(model._model) is ref.TransfuserBackbone
    else:
        assert isinstance(model._model.image_encoder.features, ResNetMicro)


def test_every_float_leaf_needs_a_seeding_rule():
    """A leaf the reference module adds (here a layer scale) is refused
    until its ``seed_rules`` names it; named, it takes its rule and every
    other leaf keeps the bits ``model`` gives it."""
    def build(cfg, device="cpu"):
        model = ref.build(cfg, device)
        with torch.device(device):
            model.layer_scale = nn.Parameter(torch.empty(8))
        return model

    cfg = ref.namespace(tiny_config(harness.load_json(
        f"{harness.HERE}/configs/transfuser.json"))["config"])
    bare = _module(STUB, build)
    with pytest.raises(ValueError, match="layer_scale"):
        seeded_state_dict(bare, cfg, 5, "cpu")

    def rules(model):
        return dict(ref.seed_rules(model), layer_scale=("const", 1e-6))

    named = _module(STUB, build, rules)
    sd = seeded_state_dict(named, cfg, 5, "cpu")
    assert torch.equal(sd.pop("layer_scale"), torch.full((8,), 1e-6))
    want = seeded_state_dict(ref, cfg, 5, "cpu")
    assert list(sd) == list(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)
