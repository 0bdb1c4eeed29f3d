"""The port's PointPillars ops and encoder vs the JAX package, on the CPU,
and the scatter-max kernel's key encoding and design emulated in plain
torch. The CUDA kernel itself is held to its plain version on a card in
tests/test_torch_kernels_cuda.py.

Inputs come from numpy with a seed. The ops are exact where the JAX ones
are (cell ids, max); sums (segment_mean, decoration) differ only in the
order of float additions, rtol 1e-6. The encoder is compared in fp32 at
rtol 1e-4 / atol 1e-5, the per-module bound of tests/test_torch_modules.py.

experiments/pallas_scatter_max.py is never imported: it runs its TPU
benchmark at import. Its function's semantics are the JAX package's
segment_max, which is what these tests hold the port to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transfuser_tpu.config import PointPillarConfig
from transfuser_tpu.models.point_pillar import PointPillarNet as JaxPPN
from transfuser_tpu.ops import pillars as jp
from transfuser_torch.models.point_pillar import PointPillarNet
from transfuser_torch.ops import kernels
from transfuser_torch.ops import pillars as tp
from transfuser_torch.train.jax_import import _point_net

RTOL, ATOL = 1e-4, 1e-5
# 8 m x 8 m at 8 px/m: 64 x 64 cells
PP = PointPillarConfig(use_point_pillars=True, max_lidar_points=400,
                       min_x=-4.0, max_x=4.0, min_y=-8.0, max_y=0.0)
GRID = dict(min_x=PP.min_x, max_x=PP.max_x, min_y=PP.min_y, max_y=PP.max_y,
            pixels_per_meter=8)
NX = NY = 64
CELLS = NX * NY


def _cloud(seed, b=2, n=PP.max_lidar_points):
    """Points partly outside the grid, ragged counts, and a cluster of
    points in few cells so that pillars hold several points."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-5, 5, (b, n, 1)),
                          rng.uniform(-9, 1, (b, n, 1)),
                          rng.uniform(-3, 1, (b, n, 1)),
                          rng.uniform(0, 1, (b, n, 1))], -1)
    pts[:, : n // 4, :2] = rng.uniform(-0.3, 0.3, (b, n // 4, 2)) + \
        np.array([0.0, -4.0])
    num = np.array([n - 37 * i for i in range(b)], np.int32)
    return pts.astype(np.float32), num


@jax.jit
def _jax_cells(pts, num):
    return jax.vmap(lambda p, n: jp.pillar_cells(p, n, **GRID))(pts, num)


def test_pillar_cells_decoration_and_mean():
    pts, num = _cloud(0)
    ids, valid = tp.pillar_cells(torch.from_numpy(pts), torch.from_numpy(num),
                                 **GRID)
    jids, jvalid = _jax_cells(pts, num)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert 0 < valid.sum() < valid.numel()

    feats = tp.decorate_points(torch.from_numpy(pts), ids, valid, CELLS,
                               PP.min_x, PP.min_y, NX, 8)
    jfeats = jax.jit(jax.vmap(lambda p, c, v: jp.decorate_points(
        p, c, v, CELLS, PP.min_x, PP.min_y, NX, 8)))(
        jnp.asarray(pts), jids, jvalid)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), rtol=1e-6,
                               atol=1e-6)

    vals = np.where(np.asarray(jvalid)[..., None], pts, 0.0)[0]
    mean = tp.segment_mean(torch.from_numpy(vals), ids[0], CELLS + 1)
    np.testing.assert_allclose(
        mean.numpy(), np.asarray(jp.segment_mean(jnp.asarray(vals), jids[0],
                                                 CELLS)),
        rtol=1e-6, atol=0)


def _tied_values(seed, n=300, c=5, segments=40):
    """Values on a coarse grid (many ties), ids that leave segments empty,
    some NEG_INF rows for padded points."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-3, 4, (n, c)).astype(np.float32) / 2
    ids = rng.integers(0, segments - 8, n).astype(np.int32)
    vals[rng.uniform(size=n) < 0.2] = jp.NEG_INF
    return vals, ids, segments


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_max_is_exact(seed):
    vals, ids, segments = _tied_values(seed)
    kernels.reset_launches()
    got = tp.segment_max(torch.from_numpy(vals), torch.from_numpy(ids),
                         segments)
    assert kernels.launches["scatter_max"] == 0  # CPU: the plain version
    want = np.asarray(jp.segment_max(jnp.asarray(vals), jnp.asarray(ids),
                                     segments - 1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[-8:] == 0).all()  # empty segments


def test_segment_max_grad_splits_ties_like_jax():
    vals, ids, segments = _tied_values(2)
    rng = np.random.default_rng(3)
    cot = rng.standard_normal((segments, vals.shape[1])).astype(np.float32)
    x = torch.from_numpy(vals).requires_grad_(True)
    (tp.segment_max(x, torch.from_numpy(ids), segments) *
     torch.from_numpy(cot)).sum().backward()
    want = jax.grad(lambda v: (jp.segment_max(v, jnp.asarray(ids),
                                              segments - 1) * cot).sum())(
        jnp.asarray(vals))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    # ties really were split: some point got a fraction of its cotangent
    assert np.any((np.abs(np.asarray(want)) > 0) &
                  (np.abs(np.asarray(want)) < np.abs(cot).max() / 1.5))


def _encode_key(bits):
    """csrc/scatter_max.cu's order-preserving key of float32 bits (an
    int32 view), as int64 in [0, 2^32): ~bits when the sign bit is set,
    bits | 0x80000000 otherwise."""
    u = bits.to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, ~u & 0xFFFFFFFF, u | 2 ** 31)


def _decode_key(key):
    """The kernel's decode back to float32 bits (int32); key 0, an entry no
    value reached, decodes to +0.0."""
    raw = torch.where(key >= 2 ** 31, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    raw = torch.where(key == 0, 0, raw)
    return torch.where(raw >= 2 ** 31, raw - 2 ** 32, raw).to(torch.int32)


def _special_floats(seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.finfo(np.float32)
    special = [0.0, -0.0, 1e30, -1e30, f32.tiny / 4, -f32.tiny / 4,
               f32.smallest_subnormal, -f32.smallest_subnormal, f32.tiny,
               -f32.tiny, f32.max, -f32.max, np.inf, -np.inf, 1.0, -1.0]
    return torch.from_numpy(np.concatenate([
        np.array(special, np.float32),
        (rng.standard_normal(300) *
         10.0 ** rng.integers(-40, 38, 300)).astype(np.float32)]))


def test_key_order_matches_float_order():
    x = _special_floats()
    key = _encode_key(x.view(torch.int32))
    less = x[:, None] < x[None, :]
    assert less.any()
    assert bool((key[:, None] < key[None, :])[less].all())
    # -0.0 orders just below +0.0, equal floats of equal bits share a key
    assert int(_encode_key(torch.tensor([-0.0]).view(torch.int32))) + 1 == \
        int(_encode_key(torch.tensor([0.0]).view(torch.int32)))


def test_key_decode_inverts_encode_bit_for_bit():
    bits = _special_floats(1).view(torch.int32)
    assert torch.equal(_decode_key(_encode_key(bits)), bits)


def test_empty_key_is_below_every_value_and_decodes_to_plus_zero():
    key = _encode_key(_special_floats(2).view(torch.int32))
    assert bool((key > 0).all())
    assert int(_decode_key(torch.zeros(1, dtype=torch.int64))) == 0


def _one_write_scatter_max(values, ids, segments):
    """The kernel's design in plain torch: points whose values are all
    <= NEG_INF / 2 skipped, a cell cleared to key 0 by the first point
    that reaches it with a live value, a max over keys, then every cell
    written once: decoded where such a point came, +0.0 elsewhere."""
    c = values.shape[1]
    live = values > tp.NEG_INF / 2
    keys = torch.where(live, _encode_key(values.view(torch.int32)), 0)
    canvas = torch.zeros(segments, c, dtype=torch.int64).scatter_reduce(
        0, ids.long()[:, None].expand(-1, c), keys, "amax")
    ready = torch.zeros(segments, dtype=torch.bool)
    ready[ids.long()[live.any(dim=1)]] = True
    out = torch.where(ready[:, None], _decode_key(canvas), 0)
    return out.to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("kind", ["ties", "uniform"])
def test_one_write_design_equals_the_plain_version(kind):
    """The NEG_INF / 2 skip, the keys and the final write give the plain
    version's canvas bit for bit: negatives, ties, NEG_INF padding rows
    and empty cells included."""
    rng = np.random.default_rng(7)
    if kind == "ties":
        n, c, segments = 2000, 32, 12
        vals = rng.integers(-3, 4, (n, c)).astype(np.float32) / 2
        ids = rng.integers(0, segments - 4, n)
        vals[:40] = -np.abs(vals[:40]) - 0.5   # a cell of negatives only
        ids[:40] = segments - 4
        vals[n // 2:] = jp.NEG_INF   # padding, in the sentinel cell
        ids[n // 2:] = segments - 1
    else:
        n, c, segments = 1000, 9, 1025
        vals = rng.standard_normal((n, c)).astype(np.float32)
        ids = rng.integers(0, segments, n)
    vals, ids = torch.from_numpy(vals), torch.from_numpy(ids.astype(np.int32))
    want = tp.reference_segment_max(vals, ids, segments)
    got = _one_write_scatter_max(vals, ids, segments)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (want == 0).any() and (want < 0).any()


@pytest.mark.parametrize("bad", ["shape", "dtype", "ids", "stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    vals, ids = torch.zeros(6, 4), torch.zeros(6, dtype=torch.int32)
    if bad == "shape":
        ids = ids[:5]
    elif bad == "dtype":
        vals = vals.double()
    elif bad == "ids":
        ids = ids.long()
    else:
        vals = torch.zeros(4, 6).t()
    with pytest.raises((ValueError, TypeError)):
        tp._check(vals, ids, 3)


@pytest.fixture(scope="module")
def encoders():
    pts, num = _cloud(4)
    jm = JaxPPN(config=PP, dtype=jnp.float32)
    variables = jax.device_get(jax.jit(lambda k: jm.init(
        k, jnp.asarray(pts), jnp.asarray(num)))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    variables = jax.tree_util.tree_map(
        lambda a: a + rng.uniform(-0.2, 0.2, a.shape).astype(np.float32),
        {k: dict(v) for k, v in variables.items()})
    state = {}
    _point_net(state, variables["params"], variables["batch_stats"])
    tm = PointPillarNet(PP)
    tm.load_state_dict({k[len("point_pillar_net."):]: v
                        for k, v in state.items()}, strict=True)
    return jm, variables, tm, pts, num


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_point_pillar_net(encoders, train):
    jm, variables, tm, pts, num = encoders
    if train:
        want, mutated = jax.jit(lambda v: jm.apply(
            v, jnp.asarray(pts), jnp.asarray(num), True,
            mutable=["batch_stats"]))(variables)
    else:
        want = jax.jit(lambda v: jm.apply(v, jnp.asarray(pts),
                                          jnp.asarray(num)))(variables)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), torch.from_numpy(num), torch.float32)
    assert got.shape == (2, NY, NX, PP.num_features[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if train:
        stats = jax.device_get(mutated["batch_stats"]["DynamicPointNet_0"])
        for i in range(len(PP.num_features)):
            bn = tm.point_net.net[3 * i + 1]
            np.testing.assert_allclose(bn.running_mean.numpy(),
                                       stats[f"bn{i}"]["mean"], rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(bn.running_var.numpy(),
                                       stats[f"bn{i}"]["var"], rtol=RTOL,
                                       atol=ATOL)
