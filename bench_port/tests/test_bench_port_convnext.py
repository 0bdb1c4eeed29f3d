"""The ConvNeXt reference (``reference/convnext.py``): its trunks are the
port's, every leaf has a seeding rule, the FLOP count holds the depthwise
convolutions, and a training run of a ConvNeXt TransFuser, which has no
BatchNorm, is compared end to end on the CPU."""

import math

import torch

from bench_port import flops, harness, weights
from bench_port.drivers import train
from bench_port.reference import convnext
from convnext_config import convnext_config, use_convnext
from tiny import tiny_config, tiny_run

# what ``numbers`` reads of a model with no BatchNorm
NUMBERS = ("loss1_gap", "loss_gap", "grad_gap", "grad_gap_p90",
           "grad_gap_median", "update_gap", "update_gap_p90",
           "update_gap_median")


def _trunks(arch, device):
    from transfuser_torch.models.encoders import make_encoder

    with torch.device(device):
        return (make_encoder(arch, 3),
                convnext.TRUNK_FACTORIES[arch](in_channels=3))


def test_the_tiny_trunk_is_the_ports():
    """One seeded state dict in both; the stem and every stage agree."""
    port, ref = _trunks("convnext_tiny", "cpu")
    g = torch.Generator().manual_seed(11)
    sd = {}
    for k, v in ref.state_dict().items():
        if k.endswith("gamma") or v.dim() == 1:
            sd[k] = 1.0 + 0.1 * torch.randn(v.shape, generator=g)
        else:
            fan_in = v[0].numel()
            sd[k] = torch.randn(v.shape, generator=g) / math.sqrt(fan_in)
    port.load_state_dict(sd)
    ref.load_state_dict(sd)
    x = torch.randn(2, 3, 64, 128, generator=g)
    with torch.no_grad():
        a, b = port.stem(x), ref.stem(x)
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
        for i in range(4):
            a, b = port.stage(i, a), ref.stage(i, a)
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
            a = b


def test_the_base_trunk_has_the_ports_names_and_shapes():
    port, ref = _trunks("convnext_base", "meta")
    assert port.widths == ref.widths == (128, 256, 512, 1024)
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}


def _cfg(trunk=None):
    """At the test size with ``convnext_tiny`` trunks, or at full size."""
    config = convnext_config(trunk)
    if trunk is None:
        config = tiny_config(config)
    return convnext.namespace(config["config"])


def test_every_float_leaf_is_seeded_and_the_layer_scale_is_one():
    model = convnext.build(_cfg("convnext_base"), "meta")
    plan = weights._plan(convnext, model)
    floats = [k for k, v in model.state_dict().items()
              if v.is_floating_point()]
    assert set(floats) <= set(plan)
    gammas = [k for k in floats if k.endswith(".gamma")]
    assert len(gammas) == 2 * (3 + 3 + 27 + 3)
    assert {plan[k] for k in gammas} == {("const", convnext.GAMMA)}
    assert not any(k.endswith(train.ref_train.RUNNING) for k in floats)
    sd = weights.seeded_state_dict(convnext, _cfg(), 5, "cpu")
    assert all(torch.equal(v, torch.ones_like(v))
               for k, v in sd.items() if k.endswith(".gamma"))


def test_the_flop_count_holds_the_depthwise_convolutions(monkeypatch):
    """A stage's forward and backward count each depthwise 7x7 once
    forward and twice backward, as its linears; a training step of the
    tiny model counts every block's."""
    _, trunk = _trunks("convnext_tiny", "meta")
    b, c, h, w = 2, 96, 16, 32
    x = torch.empty(b, c, h, w, device="meta", requires_grad=True)
    with flops.FlopCounter(convnext) as count:
        trunk.stage(0, x).sum().backward()
    dw = 2 * b * h * w * c * 49
    mlp = 2 * 2 * b * h * w * c * 4 * c
    assert count.counts["convolution"] == 3 * dw
    assert count.counts["convolution_backward"] == 3 * 2 * dw
    assert count.total == 3 * 3 * (dw + mlp)

    seen = []

    def conv_flops(x_shape, w_shape, out_shape, transposed=False):
        seen.append(tuple(w_shape))
        return real(x_shape, w_shape, out_shape, transposed)

    real = flops.conv_flops
    monkeypatch.setattr(flops, "conv_flops", conv_flops)
    assert flops.train_step_flops(convnext, _cfg(), 2) > 0
    depthwise = [s for s in seen if s[1:] == (1, 7, 7)]
    # both trunks' 18 blocks, forward and backward
    assert len(depthwise) == 2 * 2 * (3 + 3 + 9 + 3)


def test_a_training_run_without_batchnorm_is_compared(monkeypatch,
                                                      tmp_path):
    """The tiny ConvNeXt TransFuser through the train driver and its
    comparison in fp32: every number but the BatchNorm ones, as tight as
    the RegNetY model's; the cell's limit on ``bn_stats_gap`` fails."""
    use_convnext(monkeypatch, tmp_path / "transfuser-convnext.json")
    run = tiny_run("transfuser.train", seconds=0.2, check_steps=2)
    assert run.ref is convnext
    assert run.config["config"]["model"]["image_architecture"] == \
        "convnext_tiny"
    run.config["config"]["train"]["compute_dtype"] = "float32"
    harness.drive(run)
    r = run.readings
    assert run.units > 0
    assert set(r) == {p + k for p in ("", "after_") for k in NUMBERS} | {
        "after_step_loss_gap"}
    assert all(math.isfinite(v) for v in r.values())
    for pre in ("", "after_"):
        assert r[pre + "loss_gap"] < 1e-5
        assert r[pre + "grad_gap_p90"] < 1e-4
        assert r[pre + "update_gap_p90"] < 1e-3
    assert r["after_step_loss_gap"] < 1e-5
    assert run.checks["bn_stats_gap"][0] == math.inf
    assert not run.correct()

