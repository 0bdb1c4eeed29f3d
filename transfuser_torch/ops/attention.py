"""Fused multi-head attention for the token-fusion GPT.

``attention(q, k, v)`` computes softmax(q k^T / sqrt(D)) v over
(B, T, H, D) tensors. On a CUDA tensor it launches the hand-written kernel
``csrc/attention.cu`` (the port of the Pallas TPU kernel
transfuser_tpu/ops/attention.py:_attn_kernel; the kernel source says what
bounds it on Hopper and how its design answers that) or raises. On a CPU
tensor it computes the same function with ``reference_attention``, which
is the plain PyTorch version the tests and ``chip_smoke.py`` hold the
kernel against.

Both follow the Pallas kernel, not the JAX package's einsum fallback: the
probabilities P stay fp32 through P.V (the fallback casts P to the input
dtype first). Forward only: the Pallas kernel has no VJP either. On the
CPU the plain version is differentiable; on the card the wrapper raises
when autograd would need a gradient through it (grad mode on and an
input that requires grad), rather than hand back an output with no
``grad_fn``. Training with attention dropout takes the GPT's explicit
probabilities instead (models/gpt.py).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import kernels
from .dtypes import acc_dtype

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_T = 1024  # logit rows live in shared memory (csrc/attention.cu)
_MAX_D = 512


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 logits, softmax and P.V, cast at the end."""
    d = q.shape[-1]
    acc = acc_dtype(q.dtype)
    logits = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc))
    p = torch.softmax(logits * (1.0 / math.sqrt(d)), dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.to(acc)).to(q.dtype)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.tf_attention_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 +
                       [ctypes.c_longlong] * 12 +
                       [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


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
    _, t, _, d = q.shape
    if not (1 <= t <= _MAX_T and 1 <= d <= _MAX_D):
        raise ValueError(f"attention kernel takes 1 <= T <= {_MAX_T} and "
                         f"1 <= D <= {_MAX_D}; got T={t}, D={d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"attention kernel needs a unit D stride; "
                             f"{name} has strides {x.stride()}")


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) fused attention; the output has q's dtype."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on CUDA or CPU, not {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "the attention kernel is forward only (the Pallas kernel has no "
            "VJP either): call it under torch.no_grad(), or train with "
            "attn_pdrop > 0, which takes the explicit-probabilities branch")
    _check(q, k, v)
    lib = _bind(kernels.load("attention"))
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tf_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, h, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error "
                           f"{err} at shape {tuple(q.shape)} {q.dtype}")
    kernels.count_launch("attention")
    return out
