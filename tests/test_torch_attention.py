"""The port's attention vs the Pallas TPU kernel (interpret mode on the CPU)
and the JAX einsum reference, in fp32; and the bf16 kernel's tensor-core
arithmetic, emulated in plain torch, vs the plain version. The CUDA kernel
itself is held to its plain version on a card in
tests/test_torch_kernels_cuda.py."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from transfuser_tpu.ops.attention import (pallas_attention,
                                          reference_attention as jax_ref)
from transfuser_torch.ops import kernels
from transfuser_torch.ops.attention import (_check, attention,
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


@pytest.mark.parametrize("bad", ["shape", "dtype", "T", "D", "stride",
                                 "bf16_odd_D", "bf16_odd_stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 8, 2, 4)
    k, v = q.clone(), q.clone()
    if bad == "bf16_odd_D":
        q, k, v = (torch.zeros(1, 8, 2, 5, dtype=torch.bfloat16)
                   for _ in range(3))
    elif bad == "bf16_odd_stride":
        q, k, v = (torch.zeros(1, 8, 3, 5, dtype=torch.bfloat16)
                   [..., :4] for _ in range(3))
    elif bad == "shape":
        k = k[:, :4]
    elif bad == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "T":
        q = k = v = torch.zeros(1, 1025, 1, 4)
    elif bad == "D":
        q = k = v = torch.zeros(1, 4, 1, 513)
    else:
        q = torch.zeros(1, 8, 4, 2).transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        _check(q, k, v)
