"""The port's bench and entry check on the CPU:
``transfuser_torch.tools.bench`` (FLOP count, JSON line, refusals, flags)
and ``transfuser_torch.tools.graft_entry`` (entry, multi-rank dry run).

FLOP parity with the JAX package, at the tiny config of
tests/test_torch_forward_ego.py (``_parity_config``), batch 1, fp32, the
same weights on both sides (made from a seed with numpy in the JAX tree's
shapes, carried into the port by ``state_dict_from_jax``):
  * the port's convolution count equals the FLOPs of every
    ``conv_general_dilated`` in ``jax.make_jaxpr`` of the JAX
    ``forward_ego``: 2 per multiply-add, over the output elements, the
    kernel window and the input channels of a group;
  * its matrix-product and attention count equals that jaxpr's
    ``dot_general`` FLOPs less those of ``jax.image.resize``, which
    resizes through weight matrices (transfuser_tpu/ops/image_ops.py
    :77-90) where the port's ``F.interpolate`` counts nothing. Those are
    counted from the jaxpr of each resize alone, at the shapes the
    forward calls it with (recorded by wrapping ``resize_bilinear`` where
    the JAX models import it, for the trace only).
"""

import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_full_import import _parity_config
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.config import GlobalConfig as JaxConfig
from transfuser_tpu.models import decoders as jax_decoders
from transfuser_tpu.models import transfuser as jax_transfuser
from transfuser_tpu.models.lidar_centernet import LidarCenterNet as JaxModel
from transfuser_tpu.ops import image_ops as jax_image_ops
from transfuser_torch.config import GlobalConfig
from transfuser_torch.data.synthetic import synthetic_batch, write_route
from transfuser_torch.models import LidarCenterNet, gpt
from transfuser_torch.ops import flops
from transfuser_torch.ops.attention import reference_attention
from transfuser_torch.tools import bench, graft_entry
from transfuser_torch.train.jax_import import state_dict_from_jax
from transfuser_torch.train.losses import compute_losses, total_loss
from transfuser_torch.train.trainer import Trainer, _model_inputs

CPU = torch.device("cpu")
INPUTS = ("rgb", "lidar", "target_point", "target_point_image", "speed")
# bench.py's JSON keys (bench.py:421-437, :567-591) less vs_baseline with
# its baseline_note (an assumed A100 figure), mfu_useful (equal to mfu in
# the port) and real_remat (remat='early' for real data is not carried
# over); plus the port's own
BENCH_PY_KEYS = {
    "metric", "value", "unit", "value_runs", "mfu", "train_step_tflop",
    "p50_inference_ms", "p50_inference_e2e_host_ms",
    "p50_inference_pipelined_ms", "p50_inference_frame_ms",
    "p50_dispatch_floor_ms", "loss_first", "loss_last", "batch_size",
    "remat", "group_lowering", "split_step", "backbone", "device",
    "real_bytes_per_sample", "real_h2d_mbps", "real_transfer_ms_per_step",
    "real_chip_step_ms", "real_sps_aug", "real_wait_frac_aug",
    "real_sps_cached", "real_wait_frac_cached", "real_n_samples",
    "real_sps_hbm"}
PORT_KEYS = {"nvidia_smi", "peak_tflops", "fetch_rtt_ms",
             "attention_launches_per_forward", "train_step_flops_by_op",
             "real_wait_frac_hbm", "image_architecture",
             "lidar_architecture", "point_pillars"}
# a train step (forward, backward, AdamW) against the train-mode forward:
# each product's backward is two products of its size (input and weight
# gradients), less the input gradient of the first layers, which take no
# gradient; AdamW and the losses count nothing
TRAIN_TO_FORWARD = (2.8, 3.0)


def port_config(jax_cfg) -> GlobalConfig:
    return GlobalConfig.from_json(jax_cfg.to_json())


def bench_tiny_config() -> GlobalConfig:
    """The forward_ego test's tiny config (anchors the port pools to
    exactly), without the reference's view-unpack quirk."""
    cfg = _parity_config()
    model = dataclasses.replace(
        cfg.model, gpt=dataclasses.replace(cfg.model.gpt,
                                           reference_view_unpack=False))
    return port_config(cfg.replace(model=model))


# ---------------------------------------------------------------- FLOPs

def jaxpr_flops(jaxpr, acc=None):
    """{"conv", "dot"}: FLOPs of every conv_general_dilated and dot_general
    in ``jaxpr`` and the jaxprs it calls (no loops: the GRU is unrolled)."""
    acc = acc if acc is not None else {"conv": 0, "dot": 0}
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        assert name not in ("scan", "while"), name
        out = eqn.outvars[0].aval.shape if eqn.outvars else ()
        if name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            out_features = rhs[eqn.params["dimension_numbers"].rhs_spec[0]]
            acc["conv"] += 2 * int(np.prod(out)) * \
                int(np.prod(rhs)) // out_features
        elif name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            acc["dot"] += 2 * int(np.prod(out)) * \
                int(np.prod([lhs[i] for i in contract]))
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else [value]:
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    jaxpr_flops(sub.jaxpr, acc)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    jaxpr_flops(sub, acc)
    return acc


def seeded_variables(shapes, seed=0):
    """numpy leaves in the JAX tree's shapes: BatchNorm variances in
    [0.5, 1.5], everything else normal with scale 0.1."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = (0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
        return out

    return {k: walk(dict(v)) for k, v in shapes.items()}


def ego_inputs(seed=11):
    rng = np.random.default_rng(seed)
    return dict(
        rgb=rng.uniform(0, 255, (1, 64, 128, 3)).astype(np.float32),
        lidar=rng.uniform(0, 1, (1, 64, 64, 2)).astype(np.float32),
        target_point=rng.uniform(-20, 20, (1, 2)).astype(np.float32),
        target_point_image=(rng.uniform(0, 1, (1, 64, 64, 1)) > 0.99
                            ).astype(np.float32),
        speed=rng.uniform(0, 10, (1,)).astype(np.float32))


@pytest.fixture(scope="module")
def flop_models():
    cfg = _parity_config()
    x = ego_inputs()
    jm = JaxModel(cfg, dtype=jnp.float32)
    args = [jnp.asarray(x[k]) for k in INPUTS]
    shapes = jax.eval_shape(lambda key: jm.init(key, *args, train=False),
                            jax.random.PRNGKey(0))
    variables = seeded_variables(shapes)
    tm = LidarCenterNet(port_config(cfg), dtype=torch.float32, device="cpu")
    tm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return cfg, jm, variables, tm, x


def port_ego_counts(tm, x):
    with flops.FlopCounter() as counter:
        tm.forward_ego(*[torch.from_numpy(x[k]) for k in INPUTS])
    return dict(counter.counts)


def test_forward_ego_flops_equal_jax(flop_models):
    cfg, jm, variables, tm, x = flop_models
    calls = []
    resize = jax_image_ops.resize_bilinear

    def recorded(t, out_hw, align_corners=False):
        calls.append((t.shape, t.dtype, tuple(out_hw), align_corners))
        return resize(t, out_hw, align_corners)

    with mock.patch.object(jax_transfuser, "resize_bilinear", recorded), \
            mock.patch.object(jax_decoders, "resize_bilinear", recorded):
        jaxpr = jax.make_jaxpr(
            lambda v, *a: jm.apply(v, *a, method="forward_ego"))(
            variables, *[jnp.asarray(x[k]) for k in INPUTS])
    want = jaxpr_flops(jaxpr.jaxpr)
    assert calls, "the forward made no resize"
    resize_dots = 0
    for shape, dtype, out_hw, align_corners in calls:
        alone = jax.make_jaxpr(lambda t: resize(t, out_hw, align_corners))(
            jax.ShapeDtypeStruct(shape, dtype))
        resize_dots += jaxpr_flops(alone.jaxpr)["dot"]
    assert resize_dots > 0

    got = port_ego_counts(tm, x)
    assert got["convolution"] == want["conv"]
    matmuls = sum(got.get(k, 0) for k in ("mm", "addmm", "bmm", "baddbmm"))
    assert matmuls + got["attention"] == want["dot"] - resize_dots


def test_attention_formula_equals_plain_einsum(flop_models, monkeypatch):
    """The count with attention's formula equals the count through its
    plain einsum (two bmm), and nothing is counted twice."""
    _, _, _, tm, x = flop_models
    formula = port_ego_counts(tm, x)
    monkeypatch.setattr(gpt, "attention", reference_attention)
    einsum = port_ego_counts(tm, x)
    assert formula["attention"] > 0 and "attention" not in einsum
    assert einsum.get("bmm", 0) - formula.get("bmm", 0) == \
        formula["attention"]
    assert sum(einsum.values()) == sum(formula.values())


def test_train_step_counts_about_three_forwards():
    cfg = bench_tiny_config()
    host = synthetic_batch(cfg, 2)
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu", seed=0)
    batch = trainer.put_batch(host)
    model = trainer.model
    model.train()
    gen = torch.Generator().manual_seed(0)
    with flops.FlopCounter() as fwd:
        args, extra = _model_inputs(batch)
        out = model(*args, **extra, compute_aux=True, gen=gen)
        total_loss(compute_losses(out, batch, cfg), cfg)
    step, _, loss = bench.count_step_flops(trainer, batch)
    assert np.isfinite(loss)
    ratio = step / fwd.total
    assert TRAIN_TO_FORWARD[0] <= ratio <= TRAIN_TO_FORWARD[1], ratio


@pytest.mark.parametrize("groups", [1, 4])
def test_conv_backward_counts_two_forwards(groups):
    """Each gradient of a convolution counts what its forward counts, with
    groups too; with one group the counter equals FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 12, 12, generator=gen, requires_grad=True)
    conv = torch.nn.Conv2d(8, 16, 3, stride=2, padding=1, groups=groups)
    with flops.FlopCounter() as fwd:
        y = conv(x)
    with flops.FlopCounter() as both:
        conv(x).sum().backward()
    forward = 2 * 2 * 6 * 6 * 16 * (8 // groups) * 9
    assert fwd.total == forward and both.total == 3 * forward
    if groups == 1:
        with FlopCounterMode(display=False) as torch_count:
            conv(x).sum().backward()
        assert torch_count.get_total_flops() == both.total
    del y


# ---------------------------------------------------------------- the bench

def test_bench_json_line_on_cpu(tmp_path):
    """The bench's functions at tiny size: bench.py's keys, finite losses,
    loss_first = the Trainer's first-step loss on the same seed and batch."""
    cfg = bench_tiny_config()
    data = tmp_path / "data"
    write_route(str(data / "route0"), 14, seed=0)
    opts = bench.parse_args(["2", "--device=cpu", f"--real-data={data}"])
    res = bench.run(cfg, opts, CPU, n_steps=2, n_reps=2, iters=3, chain=2)
    assert set(res) == BENCH_PY_KEYS | PORT_KEYS
    json.dumps(res)
    assert res["mfu"] is None and res["peak_tflops"] is None
    assert res["device"] == "cpu" and res["nvidia_smi"] is None
    assert res["train_step_tflop"] > 0
    assert res["batch_size"] == 2 and len(res["value_runs"]) == 2
    assert res["attention_launches_per_forward"] == 0  # the plain path
    assert res["real_n_samples"] >= 2
    for k, v in res.items():
        if k.startswith(("value", "loss_", "p50_", "real_sps")):
            assert np.isfinite(v).all(), k
    # the bench wrote nothing into the dataset it was given
    assert sorted(os.listdir(data)) == ["route0"]

    trainer = Trainer(cfg, dtype=torch.bfloat16, device="cpu", seed=0)
    first = trainer.train_step(trainer.put_batch(synthetic_batch(cfg, 2)))
    assert res["loss_first"] == float(first["loss_total"])


def test_mfu_above_one_raises():
    assert bench.checked_mfu(1e9, 10, 1.0, 1e12) == pytest.approx(1e-2)
    assert bench.checked_mfu(1e9, 10, 1.0, None) is None
    with pytest.raises(RuntimeError, match="exceeds the card's peak"):
        bench.checked_mfu(1e9, 10, 1.0, 1e9)


@pytest.mark.parametrize("card, peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12),
    ("NVIDIA H100 PCIe", 756.5e12),
    ("NVIDIA H100 NVL", 835.5e12),
])
def test_h100_peaks(card, peak):
    assert bench.peak_flops_of(card) == peak


def test_unknown_card_raises():
    with pytest.raises(ValueError, match="no peak FLOP rate"):
        bench.peak_flops_of("NVIDIA A100-SXM4-80GB")
    assert bench.peak_flops(CPU) is None


def test_no_card_without_device_cpu_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--no-real-data"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    assert graft_entry.main([]) != 0
    with pytest.raises(SystemExit, match="unknown flag"):
        bench.parse_args(["--steps=3"])


def jax_bench_config(flags):
    """bench.py:233-263's config, less its TPU knobs (remat,
    group_lowering), which the port does not read."""
    cfg = JaxConfig()
    model_cfg = cfg.model
    for f in flags:
        if f.startswith("--image-arch="):
            model_cfg = dataclasses.replace(
                model_cfg, image_architecture=f.split("=", 1)[1])
        if f.startswith("--lidar-arch="):
            model_cfg = dataclasses.replace(
                model_cfg, lidar_architecture=f.split("=", 1)[1])
        if f.startswith("--backbone="):
            model_cfg = dataclasses.replace(
                model_cfg, backbone=f.split("=", 1)[1])
    if "--pillars" in flags:
        model_cfg = dataclasses.replace(
            model_cfg, point_pillars=dataclasses.replace(
                model_cfg.point_pillars, use_point_pillars=True))
    return cfg.replace(model=model_cfg)


def jax_tpu_knobs(flags):
    """(remat, group_lowering, split_step) as bench.py:236-243, 264 set
    them."""
    remat = "all" if "--remat" in flags else \
        ("early" if "--remat-early" in flags else False)
    lowering = "auto"
    if "--native-groups" in flags:
        lowering = "native"
    elif "--dense-groups" in flags:
        lowering = "dense"
    return remat, lowering, "--monolithic" not in flags


@pytest.mark.parametrize("argv", [
    [],
    ["16"],
    ["--pillars"],
    ["--backbone=late_fusion"],
    ["--backbone=latentTF", "--image-arch=convnext_base"],
    ["--image-arch=resnet34", "--lidar-arch=resnet18", "--train-only"],
    ["--remat", "--native-groups", "--monolithic", "--no-real-data"],
    ["--remat-early", "--dense-groups", "--pillars", "--real-data=/x"],
])
def test_flags_give_bench_py_config(argv):
    opts = bench.parse_args(argv)
    flags = {a for a in argv if a.startswith("--")}
    got = bench.bench_config(opts)
    want = jax_bench_config(flags)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (opts.remat, opts.group_lowering, opts.split_step) == \
        jax_tpu_knobs(flags)
    # the TPU knobs change nothing but the record
    assert got.model.remat is False and got.model.group_lowering == "native"
    assert opts.batch_size == (int(argv[0]) if argv[:1] == ["16"] else 12)
    assert opts.train_only == ("--train-only" in flags)
    assert opts.no_real_data == ("--no-real-data" in flags)
    assert opts.real_data == ("/x" if "--real-data=/x" in flags else None)


# ---------------------------------------------------------------- graft_entry

def test_entry_runs_forward_ego_through_functional_call(monkeypatch):
    """entry() at a tiny config (the flagship is full size): forward with
    the state dict as an argument equals the model's own forward_ego, and
    other weights give other waypoints."""
    cfg = bench_tiny_config()
    monkeypatch.setattr(graft_entry, "GlobalConfig", lambda: cfg)
    forward, args = graft_entry.entry("cpu")
    state, inputs = args[0], args[1:]
    assert all(t.device == CPU for t in inputs)
    with torch.no_grad():
        wp, boxes, labels = forward(*args)
    model = LidarCenterNet(cfg, dtype=torch.bfloat16, device="cpu", seed=0)
    want = model.forward_ego(*inputs)
    for g, w in zip((wp, boxes, labels), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    other = {k: v + 0.01 if v.is_floating_point() else v
             for k, v in state.items()}
    with torch.no_grad():
        assert not torch.equal(forward(other, *inputs)[0], wp)


def test_dryrun_4_ranks_matches_one_process(capsys):
    """dryrun 4 (2 x 2 gloo ranks on the CPU) prints the ok line; its loss
    is within 1e-5 of one process on the same config, seed and global
    batch. Dropout is off: the data ranks draw their own masks. The ranks
    get 180 s (about 10 s alone), not the command's 900."""
    cfg = graft_entry.dryrun_config()
    g = dataclasses.replace(cfg.model.gpt, embd_pdrop=0.0, attn_pdrop=0.0,
                            resid_pdrop=0.0)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, gpt=g))
    loss = graft_entry.dryrun(4, config=cfg, timeout_s=180.0)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh=(2x2), step=1, "
                           "loss_total=")
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu", seed=0)
    one = trainer.train_step(trainer.put_batch(
        graft_entry.dryrun_batch(cfg, 2)))
    assert np.isfinite(loss)
    assert abs(loss - float(one["loss_total"])) <= 1e-5
