"""Fused multi-head attention for the token-fusion GPT.

``attention(q, k, v)`` computes softmax(q k^T / sqrt(D)) v over
(B, T, H, D) tensors. On a CUDA tensor it launches the hand-written kernel
``csrc/attention.cu`` (the port of the Pallas TPU kernel
transfuser_tpu/ops/attention.py:_attn_kernel; the kernel source says what
bounds it on Hopper and how its design answers that) or raises. On a CPU
tensor it computes the same function with ``reference_attention``, which
is the plain PyTorch version the tests and ``chip_smoke.py`` hold the
kernel against. The kernel dispatches on dtype, both on the tensor cores:
bf16 (the main path) with bf16 operands, fp32 as split TF32 (each operand
x = big + small, both TF32, and three products big.big + big.small +
small.big with fp32 sums). One TF32 product keeps 10 mantissa bits and
would miss the fp32 tolerance of 1e-5 by 40-54x; the split keeps about
22, within it (tests/test_torch_attention.py emulates both). fp32 takes
any strides with a unit D stride and 4-byte alignment.

Both follow the Pallas kernel, not the JAX package's einsum fallback: the
probabilities P stay fp32 through P.V (the fallback casts P to the input
dtype first). Forward only: the Pallas kernel has no VJP either. On the
CPU the plain version is differentiable; on the card the wrapper raises
when autograd would need a gradient through it (grad mode on and an
input that requires grad), rather than hand back an output with no
``grad_fn``. bf16 inputs whose row strides the kernel cannot read (the
tensor-parallel GPT's 2-head shards) are first copied into padded rows
(``_bf16_rows``). Training with attention dropout takes the GPT's explicit
probabilities instead (models/gpt.py).

Under an active ``ops.flops.FlopCounter`` a call adds its 4 B H T^2 D
operations by formula (the counter cannot see the kernel), and the plain
version runs uncounted.
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from . import flops, kernels
from .dtypes import acc_dtype

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_T = 1024  # a block's 16 logit rows live in registers (attention.cu)
_MAX_D = 512
# csrc/attention.cu's AttentionArgs: q, k, v, out pointers; (b, t, h)
# strides of each; B, T, H, D, dtype code (one packed argument costs the
# host less than 22 ctypes conversions)
_ARGS = struct.Struct("<4Q12q5i4x")
_ARGTYPES = (ctypes.c_char_p, ctypes.c_void_p)


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 logits, softmax and P.V, cast at the end."""
    d = q.shape[-1]
    acc = acc_dtype(q.dtype)
    logits = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc))
    p = torch.softmax(logits * (1.0 / math.sqrt(d)), dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.to(acc)).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"attention takes three (B, T, H, D) tensors of one shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"attention kernel takes float32 or bfloat16 q/k/v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    b, t, _, d = q.shape
    if not (1 <= t <= _MAX_T and 1 <= d <= _MAX_D):
        raise ValueError(f"attention kernel takes 1 <= T <= {_MAX_T} and "
                         f"1 <= D <= {_MAX_D}; got T={t}, D={d}")
    bf16 = q.dtype == torch.bfloat16
    for name, x in (("q", q), ("k", k), ("v", v)):
        sb, st, sh, sd = x.stride()
        if sd != 1:
            raise ValueError(f"attention kernel needs a unit D stride; "
                             f"{name} has strides {x.stride()}")
        # the bf16 kernel copies 16-byte-aligned spans of rows and reads
        # bf16 pairs
        if bf16 and (d % 2 or x.data_ptr() % 16 or sh % 2 or
                     (b > 1 and sb % 8) or (t > 1 and st % 8)):
            raise ValueError(f"the bf16 attention kernel needs an even D, "
                             f"16-byte aligned data, batch and row strides "
                             f"that are multiples of 8 and an even head "
                             f"stride; {name} has D={d}, strides "
                             f"{x.stride()}")


def _bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """``x``, or for a bf16 tensor with even D whose strides the bf16
    kernel cannot read, a copy into a buffer whose D is padded so that
    the head stride is even and the row and batch strides are multiples
    of 8 (the kernel reads the unpadded D). The 4-head GPT never needs
    it; its tensor-parallel shards of 2 heads at D = 18, 54 and 378 do
    (row stride 2D)."""
    b, t, h, d = x.shape
    sb, st, sh, sd = x.stride()
    if x.dtype != torch.bfloat16 or d % 2 or (
            sd == 1 and x.data_ptr() % 16 == 0 and sh % 2 == 0 and
            (b == 1 or sb % 8 == 0) and (t == 1 or st % 8 == 0)):
        return x  # readable as it is, or refused by _check
    padded = d
    while (h * padded) % 8:
        padded += 2
    rows = x.new_empty((b, t, h, padded))[..., :d]
    return rows.copy_(x)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) fused attention; the output has q's dtype."""
    dev = q.device
    if q.dim() == 4:
        flops.count("attention", flops.attention_flops(*q.shape))
    if dev.type == "cpu":
        with flops.uncounted():
            return reference_attention(q, k, v)
    if dev.type != "cuda":
        raise ValueError(f"attention runs on CUDA or CPU, not {dev}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        raise RuntimeError(
            "the attention kernel is forward only (the Pallas kernel has no "
            "VJP either): call it under torch.no_grad(), or train with "
            "attn_pdrop > 0, which takes the explicit-probabilities branch")
    if q.dim() == 4 and q.shape == k.shape == v.shape:
        q, k, v = (_bf16_rows(x) for x in (q, k, v))
    _check(q, k, v)
    out = torch.empty_like(q)  # q's layout where dense, else contiguous
    b, t, h, d = q.shape
    args = _ARGS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                      *v.stride()[:3], *out.stride()[:3], b, t, h, d,
                      _DTYPE_CODE[q.dtype])
    err = kernels.call(
        kernels.function("attention", "tf_attention_forward", _ARGTYPES),
        dev, args)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error "
                           f"{err} at shape {tuple(q.shape)} {q.dtype}")
    kernels.count_launch("attention")
    return out
