"""The port's attention vs the Pallas TPU kernel (interpret mode on the CPU)
and the JAX einsum reference, in fp32; and the kernels' tensor-core
arithmetic, emulated in plain torch, vs the plain version: bf16 operands
with a split P, fp32 as split TF32, and the key-tiled kernel's one-pass
softmax over its key groups. The CUDA kernel itself is held to
its plain version on a card in tests/test_torch_kernels_cuda.py and in
chip_smoke.py's kernels phase."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.ops.attention import (pallas_attention,
                                          reference_attention as jax_ref)
from transfuser_torch.ops import kernels
from transfuser_torch.ops.attention import (_bf16_rows, _check, _layout,
                                            attention, copies,
                                            reference_attention)

# as tests/test_attention.py holds the Pallas kernel to the einsum path
RTOL, ATOL = 2e-4, 2e-5
SHAPES = [(2, 174, 4, 18), (1, 64, 4, 128), (1, 174, 4, 54),
          (1, 174, 4, 144), (1, 174, 4, 378)]
MAIN_SHAPES = [(1, 174, 4, d) for d in (18, 54, 144, 378)]


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_attention_matches_pallas_and_reference(shape):
    q, k, v = _qkv(shape, seed=sum(shape))
    kernels.reset_launches()
    got = attention(*[torch.from_numpy(a) for a in (q, k, v)]).numpy()
    assert kernels.launches["attention"] == 0  # CPU: the plain version
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        got, np.asarray(pallas_attention(jq, jk, jv, interpret=True)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref(jq, jk, jv)),
                               rtol=RTOL, atol=ATOL)


def test_bf16_keeps_probabilities_fp32():
    """bf16 in, bf16 out, but P.V in fp32 as in the Pallas kernel: equal to
    the fp32 computation on the bf16-rounded inputs, rounded once."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv((1, 40, 2, 24), seed=3))
    got = reference_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = reference_attention(q.float(), k.float(), v.float())
    assert torch.equal(got, want.to(torch.bfloat16))


def _bf16(shape, seed):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(shape, seed)]


def _tensor_core_emulation(q, k, v, split=True):
    """The bf16 kernel's arithmetic (csrc/attention.cu) in plain torch, in
    fp32 before the final cast: bf16 operands, D zero-padded to a multiple
    of 16, keys padded to a multiple of 16 and masked, fp32 accumulation,
    an exact softmax, and P split into bf16 hi + lo for P.V (or, with
    split=False, rounded once to bf16)."""
    b, t, h, d = q.shape
    dp, tp = -(-d // 16) * 16, -(-t // 16) * 16

    def padded(x, rows):  # (B, T, H, D) -> (B, H, rows, dp) fp32
        return F.pad(x.permute(0, 2, 1, 3).float(),
                     (0, dp - d, 0, rows - t))

    qp, kp, vp = padded(q, t), padded(k, tp), padded(v, tp)
    logits = (qp @ kp.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    logits[..., t:] = float("-inf")
    p = torch.softmax(logits, dim=-1)
    hi = p.to(torch.bfloat16).float()
    out = hi @ vp
    if split:
        out = out + (p - hi).to(torch.bfloat16).float() @ vp
    return out[..., :d].permute(0, 2, 1, 3)


@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=str)
def test_tensor_core_arithmetic_within_one_bf16_ulp(shape):
    """The split-P design meets the kernel's bf16 tolerance (one bf16 ulp
    at the output's largest magnitude, as chip_smoke.py holds the card
    to), and before the cast it is within 2^-14 of that scale of fp32."""
    q, k, v = _bf16(shape, seed=sum(shape))
    want = reference_attention(q, k, v).float()
    emulated = _tensor_core_emulation(q, k, v)
    scale = float(want.abs().max())
    err = float((emulated.to(torch.bfloat16).float() - want).abs().max())
    assert err <= scale * 2.0 ** -7
    exact = reference_attention(q.float(), k.float(), v.float())
    assert float((emulated - exact).abs().max()) <= scale * 2.0 ** -14


@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=str)
def test_single_bf16_probabilities_lose_what_the_split_keeps(shape):
    """Why the kernel splits P: one bf16 P in the P.V product errs many
    times more, against fp32 P.V, than the hi + lo split."""
    q, k, v = _bf16(shape, seed=sum(shape) + 1)
    exact = reference_attention(q.float(), k.float(), v.float())
    split = float((_tensor_core_emulation(q, k, v) - exact).abs().max())
    single = float((_tensor_core_emulation(q, k, v, split=False) -
                    exact).abs().max())
    assert single > 16 * split


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: 10 mantissa bits, to
    nearest, ties away from zero (on the fp32 bits: add half of the 13
    dropped bits' range to the magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32_emulation(q, k, v, split=True):
    """The fp32 kernel's arithmetic (csrc/attention.cu, attention_tc_f32)
    in plain torch: D zero-padded and keys padded to multiples of 8, the
    padded keys masked, each operand of q.k and P.V split into big =
    tf32(x) and small = tf32(x - big), three products (big.big, big.small,
    small.big) with fp32 sums, an exact softmax; with split=False one TF32
    product."""
    b, t, h, d = q.shape
    dp, tp = -(-d // 8) * 8, -(-t // 8) * 8

    def padded(x, rows):  # (B, T, H, D) -> (B, H, rows, dp) fp32
        return F.pad(x.permute(0, 2, 1, 3).float(),
                     (0, dp - d, 0, rows - t))

    def product(x, y):
        xb, yb = _tf32(x), _tf32(y)
        out = xb @ yb
        if split:
            out = out + (xb @ _tf32(y - yb) + _tf32(x - xb) @ yb)
        return out

    qp, kp, vp = padded(q, t), padded(k, tp), padded(v, tp)
    logits = product(qp, kp.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    logits[..., t:] = float("-inf")
    out = product(torch.softmax(logits, dim=-1), vp)
    return out[..., :d].permute(0, 2, 1, 3)


def _fp32(shape, seed):
    return [torch.from_numpy(a) for a in _qkv(shape, seed)]


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The emulation's rounding keeps 10 mantissa bits, rounds to the
    nearer TF32 value and a tie away from zero, as cvt.rna does."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                      one + 3 * ulp / 4, 3.0, 0.0])
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0])
    assert torch.equal(_tf32(x), want)


SPLIT_SHAPES = MAIN_SHAPES + [(1, 174, 4, 512), (2, 1024, 1, 64)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=str)
def test_split_tf32_arithmetic_within_fp32_tolerance(shape):
    """The split-TF32 design meets the kernel's fp32 tolerance against
    the plain version (1e-5, as chip_smoke.py holds the card to), and is
    within 4e-6 of the fp64 result."""
    q, k, v = _fp32(shape, seed=sum(shape) + 2)
    emulated = _split_tf32_emulation(q, k, v)
    want = reference_attention(q, k, v)
    assert float((emulated - want).abs().max()) <= 1e-5
    exact = reference_attention(q.double(), k.double(), v.double())
    assert float((emulated.double() - exact).abs().max()) <= 4e-6


@pytest.mark.parametrize("shape", MAIN_SHAPES, ids=str)
def test_single_tf32_loses_what_the_split_keeps(shape):
    """Why the kernel splits: one TF32 product errs more than 16 times as
    much as the split, against fp64."""
    q, k, v = _fp32(shape, seed=sum(shape) + 3)
    exact = reference_attention(q.double(), k.double(), v.double())
    split = float((_split_tf32_emulation(q, k, v).double() -
                   exact).abs().max())
    single = float((_split_tf32_emulation(q, k, v, split=False).double() -
                    exact).abs().max())
    assert single > 16 * split


# csrc/attention.cu: keys per tile of the key-tiled kernel (kKtKeys), by
# dtype, and a Q / K column chunk width it may take (the host picks a
# multiple of the MMA's k step; the width changes only the order of the
# fp32 sums of the chunks' logits)
KEY_TILE = {torch.float32: 32, torch.bfloat16: 64}
KEY_TILED_CHUNK = 64


def _key_groups(shape, dtype, sms=132):
    """The key groups csrc/attention.cu's launch_kt gives a shape on a card
    of `sms` SMs (where their stages fit in shared memory, as at every
    shape here): column chunks of at most 24 8-column tiles, more while
    the grid leaves a tenth of the SMs idle; then as many groups as a
    warp's registers allow for its tiles (kt_max_groups) and the key tiles
    fill."""
    b, t, h, d = shape
    tiles, base = -(-d // 8), b * h * -(-t // 64)
    n_chunks = max(-(-tiles // 24), min(-(-(sms * 9 // 10) // base), tiles))
    per_chunk = -(-tiles // n_chunks)
    n_tiles = next(n for n in (2, 4, 8, 16, 24) if n >= per_chunk)
    small = 2 if dtype == torch.float32 else 4
    groups = 4 if n_tiles <= small else 3 if n_tiles <= 8 else 2
    return min(groups, -(-t // KEY_TILE[dtype]))


def _tf32_truncated(x):
    """x as the tensor core reads an fp32 operand of a TF32 product: its
    top 19 bits, the 13 low mantissa bits dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _key_tiled_emulation(q, k, v, chunk=KEY_TILED_CHUNK, groups=1):
    """The key-tiled kernel's arithmetic (csrc/attention.cu,
    attention_kt) in plain torch, in fp32 before the final cast: D
    zero-padded to the MMA's k step (8 fp32, 16 bf16); key tiles of
    KEY_TILE keys dealt to `groups` key groups (tile j to group j mod
    groups), each group one pass over its tiles with a running row max m
    and sum l in log2 units. Per tile: the logits over the Q / K column
    chunks (split-TF32 products for fp32, each operand x as big =
    tf32(x), rounded, and small = x - big, which the tensor core
    truncates; added over the chunks in fp32; bf16 operands, whose
    products fp32 holds exactly), times scale *
    log2(e); m' = max(m, the tile's row max), alpha = 2^(m - m'), p = 2^(s
    - m'), l = l alpha + sum p, and out = out alpha + p.V (fp32:
    split-TF32 products, the tile's sum added into fp32 out; bf16: p as
    bf16 hi + lo, lo.V then hi.V). Then the groups merge in order (m =
    max, each side scaled by 2^(m_side - m)) and out / l. Keys past T are
    in no tile (the kernel masks them: 2^-inf = 0). A group's first tile
    has a key, so m' is finite from it on and alpha never meets -inf -
    (-inf); a group with no tile weighs 2^-inf = 0 in the merge."""
    bf16 = q.dtype == torch.bfloat16
    b, t, h, d = q.shape
    step = 16 if bf16 else 8
    dp = -(-d // step) * step

    def heads(x):  # (B, T, H, D) -> (B, H, T, dp) fp32
        return F.pad(x.permute(0, 2, 1, 3).float(), (0, dp - d))

    def product(x, y):
        if bf16:
            return x @ y
        xb, yb = _tf32(x), _tf32(y)
        return xb @ yb + (xb @ _tf32_truncated(y - yb) +
                          _tf32_truncated(x - xb) @ yb)

    qp, kp, vp = heads(q), heads(k), heads(v)
    sl2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * \
        torch.tensor(math.log2(math.e), dtype=torch.float32)
    tile = KEY_TILE[q.dtype]
    sides = []
    for grp in range(groups):
        m = torch.full(qp.shape[:-1] + (1,), float("-inf"))
        l = torch.zeros_like(m)
        out = torch.zeros_like(qp)
        for j in range(grp * tile, t, groups * tile):
            keys = slice(j, j + tile)
            s = None
            for c in range(0, dp, chunk):
                part = product(qp[..., c:c + chunk],
                               kp[..., keys, c:c + chunk].transpose(-1, -2))
                s = part if s is None else s + part
            s = s * sl2
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            if bf16:
                hi = p.to(torch.bfloat16).float()
                lo = (p - hi).to(torch.bfloat16).float()
                out = (out * alpha + lo @ vp[..., keys, :] +
                       hi @ vp[..., keys, :])
            else:
                out = out * alpha + product(p, vp[..., keys, :])
            m = m_new
        sides.append((m, l, out))
    m, l, out = sides[0]
    for mo, lo_, oo in sides[1:]:
        m_new = torch.maximum(m, mo)
        a, w = torch.exp2(m - m_new), torch.exp2(mo - m_new)
        l, out, m = l * a + lo_ * w, out * a + oo * w, m_new
    return (out / l)[..., :d].permute(0, 2, 1, 3)


def _rising_qkv(shape, seed, dtype=torch.float32):
    """Seeded q, k, v whose logits rise with the key index: q is scaled
    x30 along one direction u, and k_j leans towards u in proportion to j
    (the seeded parts scaled by 1e-3), so every row's maximum lies in the
    last key tile and each tile raises the running max: every rescale
    step is taken. The logits stay within 30 / sqrt(D) of 0, where fp32
    itself keeps them to about 1e-6."""
    b, t, h, d = shape
    q, k, v = (torch.from_numpy(a) for a in _qkv(shape, seed))
    u = F.normalize(torch.ones(d), dim=0)
    ramp = torch.arange(t, dtype=torch.float32).view(1, t, 1, 1) / t
    q = 30 * (1e-3 * q + u)
    k = 1e-3 * k + ramp * u
    return [x.to(dtype) for x in (q, k, v)]


def _within_tolerance(got, q, k, v):
    """chip_smoke.py's tolerance: fp32 1e-5 against the plain version and
    against fp64; bf16 one bf16 ulp at the output's largest magnitude
    against the plain version."""
    want = reference_attention(q, k, v).float()
    assert torch.isfinite(got).all()
    if q.dtype == torch.bfloat16:
        err = float((got.to(torch.bfloat16).float() - want).abs().max())
        assert err <= float(want.abs().max()) * 2.0 ** -7
        return
    assert float((got - want).abs().max()) <= 1e-5
    exact = reference_attention(q.double(), k.double(), v.double())
    assert float((got.double() - exact).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 2016, 4, 378), (1, 174, 1, 1512)],
                         ids=str)
def test_key_tiled_arithmetic_within_fp32_tolerance(shape):
    """The key-tiled kernel's one-pass algorithm (running max and sum,
    rescaled per key tile) meets the fp32 tolerance (1e-5) against the
    plain version and against fp64 at the longest token grid (anchors
    20x88 + 16x16) and the widest head (one head of RegNetY-032's 1512
    channels)."""
    q, k, v = _fp32(shape, seed=sum(shape) + 4)
    groups = _key_groups(shape, q.dtype)
    _within_tolerance(_key_tiled_emulation(q, k, v, groups=groups), q, k, v)


@pytest.mark.parametrize("shape", [(1, 2016, 4, 378), (1, 174, 8, 189)],
                         ids=str)
def test_key_tiled_arithmetic_within_one_bf16_ulp(shape):
    """bf16: P as bf16 hi + lo through P.V keeps the one-pass kernel
    within one bf16 ulp of the plain version, at the longest token grid
    and at an odd D (8 heads)."""
    q, k, v = _bf16(shape, seed=sum(shape) + 5)
    groups = _key_groups(shape, q.dtype)
    _within_tolerance(_key_tiled_emulation(q, k, v, groups=groups), q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_key_tiled_rescaling_with_maxima_in_the_last_tile(dtype):
    """q x30 and logits that rise with the key index: every row's maximum
    lies in the last key tile, so each tile rescales the sums before it;
    still within the tolerance."""
    shape = (1, 2016, 2, 54)
    q, k, v = _rising_qkv(shape, seed=6, dtype=dtype)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    assert bool((s.argmax(-1) >= 2016 - KEY_TILE[dtype]).all())
    groups = _key_groups(shape, dtype)
    _within_tolerance(_key_tiled_emulation(q, k, v, groups=groups), q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("t", [1, 17])
def test_key_tiled_short_rows_stay_finite(t, dtype):
    """T = 1 and 17: one key tile, mostly masked keys; the running
    statistics start from m = -inf and l = 0 without a NaN."""
    q, k, v = (x.to(dtype) for x in _fp32((1, t, 4, 64), seed=t))
    assert _key_groups(q.shape, dtype) == 1
    _within_tolerance(_key_tiled_emulation(q, k, v, groups=1), q, k, v)


def test_ablation_variants_still_match_the_kernel_source():
    """tools/attention_ablation.py cuts parts out of csrc/attention.cu by
    text substitution: each must still match the source exactly once,
    and each variant differs from the kernel."""
    from transfuser_torch.tools import attention_ablation

    sources = attention_ablation.variant_sources()
    assert set(sources) == set(attention_ablation.VARIANTS)
    assert len(set(sources.values())) == len(sources)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    """What JAX's attention() would reject as malformed too: q/k/v of
    different shapes, a dtype other than fp32 or bf16."""
    q = torch.zeros(1, 8, 2, 4)
    k, v = q.clone(), q.clone()
    if bad == "shape":
        k = k[:, :4]
    else:
        q, k, v = (x.half() for x in (q, k, v))
    with pytest.raises((ValueError, TypeError)):
        _check(q, k, v)


def _readable_by_a_kernel(x):
    """A layout some kernel reads in place: a unit D stride; for bf16 with
    an even D in the resident kernel's domain, also its rows (16-byte
    aligned, batch and row strides multiples of 8, an even head stride)."""
    b, t, h, d = x.shape
    sb, st, sh, sd = x.stride()
    if d > 1 and sd != 1:
        return False
    if x.dtype != torch.bfloat16 or d % 2 or t > 1024 or d > 512:
        return True
    return (x.data_ptr() % 16 == 0 and sh % 2 == 0 and
            (b == 1 or sb % 8 == 0) and (t == 1 or st % 8 == 0))


@pytest.mark.parametrize("case", ["T", "D", "stride", "bf16_odd_D",
                                  "bf16_odd_stride"])
def test_wrapper_takes_what_jax_takes(case, monkeypatch):
    """Shapes and layouts the JAX package's attention() takes, which the
    port refused before the key-tiled kernel: _check accepts them, and the
    wrapper's layout step hands the kernel a layout it reads, with the
    same values, copying only where it must (counted in ``copies``). The
    dispatch rule lives in the CUDA library (asked on a card in
    tests/test_torch_kernels_cuda.py); here it stands in with its answer
    for padded rows at T = 8, the resident kernel, and is asked only
    about rows that kernel cannot read."""
    asked = []
    monkeypatch.setattr("transfuser_torch.ops.attention._route_code",
                        lambda args: asked.append(args) or 1)
    bf16 = dict(dtype=torch.bfloat16)
    if case == "T":
        x, copied = torch.randn(1, 1025, 1, 4), None
    elif case == "D":
        x, copied = torch.randn(1, 4, 1, 513), None
    elif case == "stride":  # a D stride of 4
        x, copied = torch.randn(1, 8, 4, 2).transpose(2, 3), "d_stride"
    elif case == "bf16_odd_D":  # the key-tiled kernel reads odd D in place
        x, copied = torch.randn(1, 8, 2, 5, **bf16), None
    else:  # even D, odd head stride: padded rows for the resident kernel
        x, copied = torch.randn(1, 8, 3, 5, **bf16)[..., :4], "bf16_rows"
    _check(x, x, x)
    before = dict(copies)
    q, k, v, out = _layout(x, x, x)
    assert all(_readable_by_a_kernel(y) for y in (q, k, v))
    assert torch.equal(q, x) and out.shape == x.shape
    assert (q is x) == (copied is None)
    for kind in copies:
        assert copies[kind] - before[kind] == 3 * (kind == copied)
    assert bool(asked) == (copied == "bf16_rows")


@pytest.mark.parametrize("rule", [1, 2], ids=["resident", "key_tiled"])
def test_rows_are_padded_only_for_the_resident_kernel(rule, monkeypatch):
    """Rows the resident bf16 kernel cannot read (a 2-head shard, row
    stride 2D) are copied into padded rows only where the dispatch rule
    picks that kernel for the padded layout; the key-tiled kernel reads
    them in place. Asking which kernel runs copies nothing."""
    from transfuser_torch.ops.attention import _ARGS, kernel_route

    asked = []
    monkeypatch.setattr("transfuser_torch.ops.attention._route_code",
                        lambda args: asked.append(_ARGS.unpack(args)) or rule)
    qkv = torch.randn(1, 174, 3, 2, 54).bfloat16()
    q, k, v = qkv.unbind(2)
    before = dict(copies)
    assert kernel_route(q, k, v) == ("resident" if rule == 1
                                     else "key_tiled")
    assert copies == before
    # the rule saw the padded rows: pointer 0 (a new buffer), strides of
    # a row of 2 x 56
    assert asked[0][:4] == (0, 0, 0, 0)
    assert asked[0][4:7] == (174 * 112, 112, 56)
    staged = _layout(q, k, v)[:3]
    assert copies["bf16_rows"] - before["bf16_rows"] == 3 * (rule == 1)
    assert all((y is x) == (rule == 2) and torch.equal(y, x)
               for x, y in zip((q, k, v), staged))


@pytest.mark.parametrize("d", [18, 54, 144, 378])
def test_bf16_rows_of_two_head_shards_are_readable(d):
    """The tensor-parallel GPT's 2-head shards (row stride 2D): the
    wrapper's copy into padded rows passes the kernel's layout check and
    holds the same values; readable inputs are passed through as they
    are."""
    q = torch.randn(4, 174, 2, d).bfloat16()
    staged = _bf16_rows(q)
    _check(staged, staged, staged)
    assert torch.equal(staged, q)
    assert (staged is q) == (2 * d % 8 == 0)
    four = torch.randn(1, 174, 4, d).bfloat16()
    assert _bf16_rows(four) is four


if __name__ == "__main__":
    # the emulated errors quoted in csrc/attention.cu's header
    for shape in [(1, 2016, 4, 378), (1, 174, 1, 1512)]:
        q, k, v = _fp32(shape, seed=sum(shape) + 4)
        tiled = _key_tiled_emulation(q, k, v,
                                     groups=_key_groups(shape, q.dtype))
        exact = reference_attention(q.double(), k.double(), v.double())
        plain = float((tiled - reference_attention(q, k, v)).abs().max())
        print(f"key-tiled {shape}: vs plain {plain:.2e}, vs fp64 "
              f"{float((tiled.double() - exact).abs().max()):.2e}")
    for d in (16, 18, 54, 144, 256, 378, 512):
        shape = (1, 174, 4, d)
        q, k, v = _fp32(shape, seed=sum(shape) + 2)
        want = reference_attention(q, k, v)
        exact = reference_attention(q.double(), k.double(), v.double())
        split = _split_tf32_emulation(q, k, v)
        single = _split_tf32_emulation(q, k, v, split=False)
        print(f"D={d}: split vs plain {float((split - want).abs().max()):.2e}"
              f", vs fp64 {float((split.double() - exact).abs().max()):.2e}"
              f"; plain vs fp64 {float((want.double() - exact).abs().max()):.2e}"
              f"; one TF32 vs plain {float((single - want).abs().max()):.2e}")
