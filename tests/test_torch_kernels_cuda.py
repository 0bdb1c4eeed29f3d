"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a card. Every test is marked ``cuda`` and skips without one
(a CUDA kernel has no CPU mode). The file imports neither JAX nor the JAX
package, so it runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerances are chip_smoke.py's: attention fp32 1e-5 (summation order
only), bf16 one bf16 ulp at the output's largest magnitude; the
scatter-max equal bit for bit. Each call launches its kernel exactly once.
"""

import numpy as np
import pytest
import torch

from transfuser_torch.ops import kernels
from transfuser_torch.ops import pillars as tp
from transfuser_torch.ops.attention import attention, reference_attention

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
