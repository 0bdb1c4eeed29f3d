"""Per-module parity, PyTorch port vs the JAX package, fp32 on the CPU.

Each case builds the JAX module, initialises it, hands its variables to
the port's module through the weight bridge's converters, and compares
the outputs on the same seeded numpy inputs. Tolerance rtol 1e-4 /
atol 1e-5 for single modules (fp32, only the summation order differs),
rtol 1e-3 / atol 1e-4 for the RegNetY stages (deeper conv stacks, as
tests/test_regnet_import.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.models import decoders as jdec
from transfuser_tpu.models import encoders as jenc
from transfuser_tpu.models import gpt as jgpt
from transfuser_tpu.models import heads as jheads
from transfuser_tpu.models import waypoint_gru as jgru
from transfuser_tpu.ops import centernet as jcn
from transfuser_tpu.ops import image_ops as jops
from transfuser_torch.models.decoders import TopDown
from transfuser_torch.models.encoders import make_encoder
from transfuser_torch.models.gpt import GPTFusion
from transfuser_torch.models.heads import LidarCenterNetHead
from transfuser_torch.models.waypoint_gru import WaypointGRU
from transfuser_torch.ops import centernet as tcn
from transfuser_torch.ops import image_ops as tops
from transfuser_torch.train.jax_import import (_gpt, _put_conv, _put_dense,
                                               _regnety)

RTOL, ATOL = 1e-4, 1e-5


def _np(seed, *shape, low=None, high=None):
    rng = np.random.default_rng(seed)
    if low is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(low, high, shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


def _init(module, *args, **kw):
    v = jax.jit(lambda key: module.init(key, *args, **kw))(
        jax.random.PRNGKey(0))
    return {k: dict(val) for k, val in jax.device_get(v).items()}


# ------------------------------------------------------------- image_ops

IMAGE_CASES = {
    "normalize_imagenet": lambda x: (jops.normalize_imagenet,
                                     tops.normalize_imagenet, (x * 255,)),
    "adaptive_avg_pool": lambda x: (jops.adaptive_avg_pool,
                                    tops.adaptive_avg_pool, (x, (4, 3))),
    "global_avg_pool": lambda x: (jops.global_avg_pool,
                                  tops.global_avg_pool, (x,)),
    "max_pool": lambda x: (jops.max_pool, tops.max_pool, (x, 3, 2, 1)),
    "resize_up_half_pixel": lambda x: (jops.resize_bilinear,
                                       tops.resize_bilinear,
                                       (x, (16, 24))),
    "resize_identity": lambda x: (jops.resize_bilinear, tops.resize_bilinear,
                                  (x, (8, 12))),
    "resize_up_align_corners": lambda x: (
        lambda *a: jops.resize_bilinear(*a, align_corners=True),
        lambda *a: tops.resize_bilinear(*a, align_corners=True),
        (x, (20, 30))),
    "resize_down_align_corners": lambda x: (
        lambda *a: jops.resize_bilinear(*a, align_corners=True),
        lambda *a: tops.resize_bilinear(*a, align_corners=True),
        (x, (5, 7))),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_image_ops(case):
    x = _np(1, 2, 8, 12, 3)
    jfn, tfn, args = IMAGE_CASES[case](x)
    want = jfn(jnp.asarray(args[0]), *args[1:])
    got = tfn(torch.from_numpy(args[0]), *args[1:])
    _close(got, want, rtol=1e-5, atol=1e-4 if case.startswith("norm")
           else 1e-6)


def test_resize_half_pixel_downsample_raises():
    """A half-pixel downsample no longer raises: it antialiases as
    jax.image.resize does (tests/test_torch_image_ops.py holds more
    cases)."""
    x = _np(7, 1, 8, 8, 2)
    got = tops.resize_bilinear(torch.from_numpy(x), (4, 4)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jops.resize_bilinear(jnp.asarray(x), (4, 4))),
        rtol=0, atol=1e-5)


# ------------------------------------------------------------- RegNetY


@pytest.fixture(scope="module")
def regnet():
    jm = jenc.make_encoder("regnety_micro", 3, jnp.float32)
    x = _np(2, 1, 32, 64, 3)
    v = _init(jm, jnp.asarray(x))
    rng = np.random.default_rng(4)
    stats = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    v["batch_stats"] = stats
    state = {}
    _regnety(state, "", v["params"], stats)
    tm = make_encoder("regnety_micro", 3).eval()
    tm.load_state_dict(state, strict=True)
    return jm, v, tm, x


@pytest.mark.parametrize("stage", ["stem", 0, 1, 2, 3])
def test_regnety_micro_stage(regnet, stage):
    jm, v, tm, x = regnet
    xj = jnp.asarray(x)
    # the input of the stage under test: the JAX trunk up to it
    xj = jm.apply(v, xj, method=lambda m, a: m.stem(a))
    for i in range(stage if stage != "stem" else 0):
        xj = jm.apply(v, xj, method=lambda m, a, i=i: m.stage(i, a))
    if stage == "stem":
        want, got = xj, tm.stem_nhwc(torch.from_numpy(x))
    else:
        want = jm.apply(v, xj, method=lambda m, a: m.stage(stage, a))
        got = tm.stage_nhwc(stage, torch.from_numpy(np.array(xj)))
    with torch.no_grad():
        _close(got, want, rtol=1e-3, atol=1e-4)


# ------------------------------------------------------------- GPTFusion


@pytest.mark.parametrize("reference_view_unpack", [False, True])
def test_gpt_fusion(reference_view_unpack):
    kw = dict(n_embd=48, n_head=4, n_layer=2, block_exp=4,
              img_anchors=(2, 4), lidar_anchors=(2, 2), use_velocity=True,
              reference_view_unpack=reference_view_unpack)
    jm = jgpt.GPTFusion(**kw, dtype=jnp.float32)
    img, lid = _np(3, 2, 2, 4, 48), _np(4, 2, 2, 2, 48)
    vel = _np(5, 2, low=0, high=10)
    v = _init(jm, jnp.asarray(img), jnp.asarray(lid), jnp.asarray(vel))
    v["params"]["pos_emb"] = _np(6, 1, 12, 48) * 0.1
    state = {}
    _gpt(state, "", v["params"])
    tm = GPTFusion(**kw).eval()
    tm.load_state_dict(state, strict=True)
    want = jm.apply(v, jnp.asarray(img), jnp.asarray(lid), jnp.asarray(vel))
    with torch.no_grad():
        got = tm(torch.from_numpy(img), torch.from_numpy(lid),
                 torch.from_numpy(vel))
    for g, w, name in zip(got, want, ("image", "lidar")):
        assert g.shape == w.shape
        _close(g, w, msg=name)


# ------------------------------------------------------------- TopDown


def test_top_down():
    jm = jdec.TopDown(channel=16, upsample_factor=2, dtype=jnp.float32)
    x = _np(7, 2, 4, 4, 32)
    v = _init(jm, jnp.asarray(x))
    state = {}
    for name, p in v["params"].items():
        _put_conv(state, name, p)
    tm = TopDown(32, 16, 2)
    tm.load_state_dict(state, strict=True)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(tops.to_nchw(torch.from_numpy(x)))
    for g, w in zip(got, want):
        _close(tops.to_nhwc(g), w)


# ------------------------------------------------------------- head


def test_centernet_head():
    jm = jheads.LidarCenterNetHead(in_channel=16, feat_channel=16,
                                   num_classes=1, num_dir_bins=12,
                                   dtype=jnp.float32)
    x = _np(8, 2, 8, 8, 16)
    v = _init(jm, jnp.asarray(x))
    state = {}
    for branch, p in v["params"].items():
        _put_conv(state, f"{branch}_head.0", p["conv0"])
        _put_conv(state, f"{branch}_head.2", p["conv1"])
    tm = LidarCenterNetHead(16, 16, 1, 12)
    tm.load_state_dict(state, strict=True)
    want = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(tops.to_nchw(torch.from_numpy(x)))
    assert set(got) == set(want)
    for k in want:
        _close(tops.to_nhwc(got[k]), want[k], msg=k)


# ------------------------------------------------------------- GRU


def test_waypoint_gru():
    jm = jgru.WaypointGRU(pred_len=4, hidden_size=64,
                          concat_target_point=True, lidar_pos_x=1.3)
    fused = _np(9, 2, 128)
    tp = _np(10, 2, 2, low=-20, high=20)
    v = _init(jm, jnp.asarray(fused), jnp.asarray(tp))
    p = v["params"]
    state = {}
    for i, j in enumerate((0, 2, 4)):
        _put_dense(state, f"join.{j}", p[f"join_{i}"])
    for w in ("ih", "hh"):
        state[f"decoder.weight_{w}"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["cell"][f"weight_{w}"]["kernel"]).T))
        state[f"decoder.bias_{w}"] = torch.from_numpy(
            np.array(p["cell"][f"weight_{w}"]["bias"]))
    _put_dense(state, "output", p["output"])
    tm = WaypointGRU(128, 4, 64, True, 1.3)
    tm.load_state_dict(state, strict=True)
    want = jm.apply(v, jnp.asarray(fused), jnp.asarray(tp))
    with torch.no_grad():
        got = tm(torch.from_numpy(fused), torch.from_numpy(tp))
    _close(got, want)


# ------------------------------------------------------------- decode


@pytest.mark.parametrize("k", [20, 100])
def test_decode_heatmap(k):
    b, h, w = 2, 16, 16
    maps = dict(
        heatmap=1 / (1 + np.exp(-_np(11, b, h, w, 1))),
        wh=_np(12, b, h, w, 2), offset=_np(13, b, h, w, 2),
        yaw_class=_np(14, b, h, w, 12), yaw_res=_np(15, b, h, w, 1),
        velocity=_np(16, b, h, w, 1), brake=_np(17, b, h, w, 2))
    maps["heatmap"] = maps["heatmap"].astype(np.float32)
    order = ("heatmap", "wh", "offset", "yaw_class", "yaw_res", "velocity",
             "brake")
    want = jcn.decode_heatmap(*[jnp.asarray(maps[n]) for n in order], k=k)
    got = tcn.decode_heatmap(*[torch.from_numpy(maps[n]) for n in order],
                             k=k)
    _close(got.boxes, want.boxes, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
