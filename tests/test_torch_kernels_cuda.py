"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a card. Every test is marked ``cuda`` and skips without one
(a CUDA kernel has no CPU mode). The file imports neither JAX nor the JAX
package, so it runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerances are chip_smoke.py's: attention fp32 1e-5 (summation order
and the split-TF32 products), bf16 one bf16 ulp at the output's largest
magnitude; the scatter-max equal bit for bit. Each call launches its
kernel exactly once. The fp32 edge cases and the head counts and token
grids of the key-tiled kernel are chip_smoke.py's own.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (ATTN_CONFIG_SHAPES, ATTN_F32_EDGE_CASES,
                        attention_inputs, attention_tol)
from transfuser_torch.ops import kernels
from transfuser_torch.ops import pillars as tp
from transfuser_torch.ops.attention import (_attention_key_tiled,
                                            _attention_resident,
                                            _resident_takes, attention,
                                            copies, kernel_route,
                                            reference_attention)

ATTN_MAIN_SHAPES = [(1, 174, 4, d) for d in (18, 54, 144, 378)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_attention_kernel_matches_plain_version_on_card(dtype):
    """The main-path shapes, shapes the kernel must mask (T=200, D=40;
    D=18 at batch 2), and q/k/v as slices of wider rows (head stride 2D,
    row stride 2HD, as a fused projection would give them), read in
    place."""
    _needs_card()
    cases = [[torch.from_numpy(a).to("cuda", dtype) for a in _qkv(shape, 1)]
             for shape in ATTN_MAIN_SHAPES + [(2, 174, 4, 18),
                                              (1, 200, 4, 40)]]
    cases.append([torch.from_numpy(a).to("cuda", dtype)[..., :54]
                  for a in _qkv((1, 174, 4, 108), seed=5)])
    assert cases[-1][0].stride() == (174 * 4 * 108, 4 * 108, 108, 1)
    for q, k, v in cases:
        before = kernels.launches["attention"]
        got = attention(q, k, v)
        torch.cuda.synchronize()
        assert kernels.launches["attention"] == before + 1
        want = reference_attention(q, k, v).float()
        if dtype == torch.float32:
            rtol, atol = 1e-5, 1e-5
        else:
            rtol, atol = 0.0, float(want.abs().max()) * 2.0 ** -7
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_attention_kernel_at_the_other_trunks_head_dims_on_card(d, dtype):
    """The head dims of the ResNet-18/34 (16/32/64/128) and ConvNeXt-base
    (32/64/128/256) GPT stages, at one forward's shape (1, 174, 4, D)."""
    _needs_card()
    q, k, v = [torch.from_numpy(a).to("cuda", dtype)
               for a in _qkv((1, 174, 4, d), seed=d)]
    before = kernels.launches["attention"]
    got = attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches["attention"] == before + 1
    want = reference_attention(q, k, v).float()
    if dtype == torch.float32:
        rtol, atol = 1e-5, 1e-5
    else:
        rtol, atol = 0.0, float(want.abs().max()) * 2.0 ** -7
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_F32_EDGE_CASES, ids=lambda c: c[0])
def test_attention_fp32_kernel_masks_edge_shapes_on_card(case):
    """chip_smoke.py's fp32 edge cases: head dims that are not multiples
    of 8, one key, a ragged query tile, the longest T (narrower K chunks,
    V streamed), batch 3, inputs one float into a buffer (only 4-byte
    aligned) and a permuted view: within 1e-5 of the plain version, one
    launch each."""
    _needs_card()
    _, shape, layout = case
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = attention_inputs(shape, layout, gen, torch.float32)
    if layout == "offset":
        assert q.data_ptr() % 8 == 4
    before = kernels.launches["attention"]
    got = attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches["attention"] == before + 1
    torch.testing.assert_close(got, reference_attention(q, k, v),
                               rtol=1e-5, atol=1e-5)


def _check_launch(q, k, v, fn=attention):
    """One launch of the wrapper (or of the key-tiled kernel forced),
    within chip_smoke.py's tolerance of the plain version."""
    before = kernels.launches["attention"]
    got = fn(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches["attention"] == before + 1
    want = reference_attention(q, k, v)
    assert bool(torch.isfinite(got).all()), (q.shape, q.dtype, fn)
    err = float((got.float() - want.float()).abs().max())
    assert err <= attention_tol(q.dtype, want), (q.shape, q.dtype, fn)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", list(ATTN_CONFIG_SHAPES), ids=str)
def test_attention_key_tiled_kernel_at_other_heads_and_grids_on_card(
        shape, dtype):
    """RegNetY-032 at 8, 2 and 1 heads (odd bf16 D, D up to 1512) and the
    token grids of anchors 10x44 and 20x88 (T = 696, 2016): the dispatch
    rule picks the key-tiled kernel wherever the resident one cannot take
    the shape, and either kernel meets the tolerance."""
    _needs_card()
    b, t, h, d = shape
    q, k, v = [torch.from_numpy(a).to("cuda", dtype)
               for a in _qkv(shape, seed=t + h + d)]
    route = kernel_route(q, k, v)
    if t > 1024 or d > 512 or (dtype == torch.bfloat16 and d % 2):
        assert route == "key_tiled"
    _check_launch(q, k, v)
    _check_launch(q, k, v, _attention_key_tiled)


# the key-tiled kernel forced at the ragged edges of its tiles (64 query
# rows a block, 32 or 64 keys a tile, D in k steps of 8 or 16, column
# chunks), the layouts it reads in place or after the wrapper's copy, and
# inputs whose row maxima lie in the last key tile (every rescale step of
# its one-pass softmax taken): (what, shape, layout)
KT_EDGE_CASES = [
    ("T=1", (1, 1, 4, 64), "dense"),
    ("T=17", (1, 17, 4, 64), "dense"),
    ("T=63", (1, 63, 4, 64), "dense"),
    ("T=65", (1, 65, 4, 64), "dense"),
    ("T=1025", (1, 1025, 2, 64), "dense"),
    ("T=2016", (1, 2016, 4, 54), "dense"),
    ("D=1", (1, 174, 4, 1), "dense"),
    ("D=9", (1, 174, 8, 9), "dense"),
    ("D=17", (1, 174, 4, 17), "dense"),
    ("D=513", (1, 174, 1, 513), "dense"),
    ("D=1512", (1, 174, 1, 1512), "dense"),
    ("batch 3", (3, 174, 4, 54), "dense"),
    ("one element into a buffer", (1, 174, 4, 54), "offset"),
    ("one element into a buffer, odd D", (2, 17, 3, 17), "offset"),
    ("odd D at odd head offsets, shifted", (1, 174, 8, 27), "offset"),
    ("(B, H, T, D) permuted to (B, T, H, D)", (1, 174, 4, 54), "permuted"),
    ("D stride 2", (1, 174, 4, 54), "d_stride"),
    ("maxima in the last key tile", (1, 2016, 4, 54), "rising"),
    ("maxima in the last key tile, D=378", (1, 696, 4, 378), "rising"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", KT_EDGE_CASES, ids=lambda c: c[0])
def test_attention_key_tiled_kernel_edges_on_card(case, dtype):
    """The key-tiled kernel, forced, at its tiles' ragged edges, in every
    layout and with every rescale step taken: one launch, within
    chip_smoke.py's tolerance of the plain version, no NaN."""
    _needs_card()
    _, shape, layout = case
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    q, k, v = attention_inputs(shape, layout, gen, dtype)
    _check_launch(q, k, v, _attention_key_tiled)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_attention_routes_on_card(dtype):
    """The main path keeps the resident kernels, the key-tiled kernel
    takes the same shapes within the tolerance when forced, and asking
    the rule copies nothing. Above T = 384 the rule picks the key-tiled
    kernel where the resident ones take the shape too, which then
    still meet the tolerance when forced. 2-head shards (row stride 2D,
    rows the resident bf16 kernel cannot read) are padded where the
    resident kernel runs (T = 174, and forced at T = 696) and read in
    place by the key-tiled one (T = 696)."""
    _needs_card()
    for shape in ATTN_MAIN_SHAPES:
        q, k, v = [torch.from_numpy(a).to("cuda", dtype)
                   for a in _qkv(shape, seed=sum(shape))]
        before = dict(copies)
        assert kernel_route(q, k, v) == "resident"
        assert _resident_takes(q, k, v)
        assert copies == before
        _check_launch(q, k, v)
        _check_launch(q, k, v, _attention_key_tiled)
    bf16 = dtype == torch.bfloat16
    for t in (174, 696):
        qkv = torch.randn(1, t, 3, 2, 378, device="cuda").to(dtype)
        q, k, v = qkv.unbind(2)
        route = "key_tiled" if t == 696 else "resident"
        before = dict(copies)
        assert kernel_route(q, k, v) == route
        assert _resident_takes(q, k, v) == (not bf16 or t == 174)
        assert copies == before
        _check_launch(q, k, v)
        padded = bf16 and route == "resident"
        assert copies["bf16_rows"] - before["bf16_rows"] == 3 * padded
    q, k, v = [torch.from_numpy(a).to("cuda", dtype)
               for a in _qkv((1, 696, 4, 54), seed=7)]
    assert kernel_route(q, k, v) == "key_tiled" and _resident_takes(q, k, v)
    _check_launch(q, k, v)
    _check_launch(q, k, v, _attention_resident)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("layout", ["d_stride", "offset", "permuted"])
def test_attention_layouts_on_card(layout, dtype):
    """A D stride of 2 (the wrapper's counted contiguous copy), inputs
    one element into a buffer (bf16 rows only 2-byte aligned: the
    key-tiled kernel's 2-byte copies) and a permuted view, at odd and
    even D."""
    _needs_card()
    for shape in [(1, 174, 4, 54), (2, 17, 3, 17)]:
        gen = torch.Generator(device="cuda").manual_seed(sum(shape))
        q, k, v = attention_inputs(shape, layout, gen, dtype)
        before = copies["d_stride"]
        _check_launch(q, k, v)
        assert copies["d_stride"] - before == 3 * (layout == "d_stride")


@pytest.mark.cuda
def test_attention_kernel_refuses_inputs_that_need_a_gradient_on_card():
    """The kernel has no backward (nor had the Pallas kernel): on the card
    the wrapper raises rather than return an output with no grad_fn; under
    no_grad it launches as before. On the CPU the plain version stays
    differentiable."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv((1, 16, 2, 8), seed=4))
    attention(q, k, v).sum().backward()
    assert q.grad is not None
    _needs_card()
    qc = q.detach().cuda().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        attention(qc, qc.detach(), qc.detach())
    with torch.no_grad():
        attention(qc, qc, qc)


@pytest.mark.cuda
def test_scatter_max_kernel_matches_plain_version_on_card():
    """Uniform cells, a pillar canvas, few cells with many collisions,
    tied negative values, and 480,000 points over 12 pillar canvases with
    half of them NEG_INF padding in one cell."""
    _needs_card()
    rng = np.random.default_rng(0)
    for n, c, segments, kind in [(1000, 9, 1025, "normal"),
                                 (40000, 32, 65537, "normal"),
                                 (5000, 32, 8, "normal"),
                                 (40000, 32, 8, "ties"),
                                 (480000, 32, 12 * 65537, "padded")]:
        if kind == "ties":
            vals = rng.integers(-3, 4, (n, c)).astype(np.float32) / 2
        else:
            vals = rng.standard_normal((n, c)).astype(np.float32)
        ids = rng.integers(0, segments, n).astype(np.int32)
        if kind == "padded":
            vals[n // 2:] = tp.NEG_INF
            ids[n // 2:] = segments - 1
        vals, ids = torch.from_numpy(vals).cuda(), torch.from_numpy(ids).cuda()
        before = kernels.launches["scatter_max"]
        got = tp.segment_max(vals, ids, segments)
        torch.cuda.synchronize()
        assert kernels.launches["scatter_max"] == before + 1
        want = tp.reference_segment_max(vals, ids, segments)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
