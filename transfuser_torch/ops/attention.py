"""Fused multi-head attention for the token-fusion GPT.

``attention(q, k, v)`` computes softmax(q k^T / sqrt(D)) v over
(B, T, H, D) tensors of any size. On a CUDA tensor it launches the
hand-written kernel ``csrc/attention.cu`` (the port of the Pallas TPU
kernel transfuser_tpu/ops/attention.py:_attn_kernel; the kernel source
says what bounds it on Hopper and how its design answers that) or raises.
On a CPU tensor it computes the same function with ``reference_attention``,
which is the plain PyTorch version the tests and ``chip_smoke.py`` hold
the kernel against. The kernel computes on the tensor cores in either
dtype: bf16 (the main path) with bf16 operands, fp32 as split TF32 (each
operand x = big + small, both TF32, and three products big.big +
big.small + small.big with fp32 sums). One TF32 product keeps 10 mantissa
bits and would miss the fp32 tolerance of 1e-5 by 40-54x; the split keeps
about 22, within it (tests/test_torch_attention.py emulates both). Which
of its kernels runs is a rule on the shape, in the kernel's header: the
resident kernels where they take the shape (T <= 1024 and D <= 512; bf16
also an even D, rows they can read and K within shared memory) and ran
faster on the card (T up to 384, but for fp32 at D >= 144 over 8 or more
(batch, head) pairs; fp32 at D above 384), the key-tiled kernel for every
other shape.
``_attention_key_tiled`` and ``_attention_resident`` force one kernel, for
the comparison the rule rests on (chip_smoke.py, the card tests).

Both follow the Pallas kernel, not the JAX package's einsum fallback: the
probabilities P stay fp32 through P.V (the fallback casts P to the input
dtype first). Forward only: the Pallas kernel has no VJP either. On the
CPU the plain version is differentiable; on the card the wrapper raises
when autograd would need a gradient through it (grad mode on and an
input that requires grad), rather than hand back an output with no
``grad_fn``. Training with attention dropout takes the GPT's explicit
probabilities instead (models/gpt.py).

Layout steps before a launch, each a copy counted in ``copies``: a tensor
whose D stride is not 1 (and D > 1) is made contiguous ("d_stride"); a
bf16 tensor with an even D whose rows the resident kernel cannot read
(the tensor-parallel GPT's 2-head shards) is copied into padded rows
("bf16_rows", ``_bf16_rows``), but only where the resident kernel then
runs (it asks the rule first, or the resident kernel is forced). The
key-tiled kernel reads any other layout in place, odd bf16 D included.

Under an active ``ops.flops.FlopCounter`` a call adds its 4 B H T^2 D
operations by formula (the counter cannot see the kernel), and the plain
version runs uncounted.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import Dict

import torch

from ..tracing import span
from . import flops, kernels
from .dtypes import acc_dtype

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/attention.cu's AttentionArgs: q, k, v, out pointers; (b, t, h)
# strides of each; B, T, H, D, dtype code, force (0 the rule, 1 the
# key-tiled kernel, 2 the resident ones; one packed argument costs the
# host less than 23 ctypes conversions)
_ARGS = struct.Struct("<4Q12q6i")
_ARGTYPES = (ctypes.c_char_p, ctypes.c_void_p)

# the layout copies the wrapper made on the card, by kind (a running
# count, as kernels.launches)
copies: Dict[str, int] = {"d_stride": 0, "bf16_rows": 0}


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 logits, softmax and P.V, cast at the end."""
    d = q.shape[-1]
    acc = acc_dtype(q.dtype)
    logits = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc))
    p = torch.softmax(logits * (1.0 / math.sqrt(d)), dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.to(acc)).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Refuse what JAX's attention() would refuse too: not three (B, T, H,
    D) tensors of one shape, a dtype other than fp32 or bf16 (or mixed),
    tensors on more than one device."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"attention takes three (B, T, H, D) tensors of one shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"attention kernel takes float32 or bfloat16 q/k/v "
                        f"of one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _padded_width(h: int, d: int) -> int:
    """The smallest even D' >= d with h * D' a multiple of 8: the row
    pitch of ``_bf16_rows``' buffer."""
    padded = d
    while (h * padded) % 8:
        padded += 2
    return padded


def _view(x: torch.Tensor, pad: bool = False):
    """(pointer, (b, t, h) strides) of ``x`` as the layout steps hand it to
    the kernel: as it lies, or described, not made, the copy it takes
    (contiguous for a D stride other than 1, padded rows for ``pad``;
    pointer 0: a new buffer is aligned)."""
    b, t, h, d = x.shape
    if pad:
        w = _padded_width(h, d)
        return 0, (t * h * w, h * w, w)
    if d > 1 and x.stride(-1) != 1:
        return 0, (t * h * d, h * d, d)
    return x.data_ptr(), x.stride()[:3]


def _unreadable_rows(x: torch.Tensor) -> bool:
    """Whether ``x`` is bf16 with an even D and rows, after the D-stride
    step, that the resident kernel cannot read in place (it needs 16-byte
    aligned rows, batch and row strides multiples of 8 and an even head
    stride: csrc/attention.cu bf16_rows_readable)."""
    b, t, h, d = x.shape
    if x.dtype != torch.bfloat16 or d % 2:
        return False
    ptr, (sb, st, sh) = _view(x)
    return not (ptr % 16 == 0 and sh % 2 == 0 and (b == 1 or sb % 8 == 0)
                and (t == 1 or st % 8 == 0))


def _unit_d_stride(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a contiguous copy where its D stride is not 1 (the
    kernels read rows of D)."""
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        copies["d_stride"] += 1
        return x.contiguous()
    return x


def _bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """``x``, or where ``_unreadable_rows(x)``, a copy into a buffer whose
    D is padded so that the head stride is even and the row and batch
    strides are multiples of 8 (the kernel reads the unpadded D). The
    4-head GPT never needs it; its tensor-parallel shards of 2 heads at
    D = 18, 54 and 378 do (row stride 2D)."""
    if not _unreadable_rows(x):
        return x
    b, t, h, d = x.shape
    rows = x.new_empty((b, t, h, _padded_width(h, d)))[..., :d]
    copies["bf16_rows"] += 1
    return rows.copy_(x)


def _pack(views, shape, dtype: torch.dtype, force: int = 0) -> bytes:
    """AttentionArgs for q, k, v and out, each as (pointer, strides)."""
    return _ARGS.pack(*(ptr for ptr, _ in views),
                      *(s for _, strides in views for s in strides),
                      *shape, _DTYPE_CODE[dtype], force)


def _route_code(args: bytes) -> int:
    """csrc/attention.cu's dispatch rule on packed arguments: 1 the
    resident kernels, 2 the key-tiled kernel (alone in taking the shape),
    3 the key-tiled kernel where the resident ones take the shape too, -1
    none (copies and launches nothing)."""
    fn = kernels.function("attention", "tf_attention_route",
                          (ctypes.c_char_p,))
    return fn(args)


def _plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          force: int = 0):
    """The layout steps for q, k, v, decided but not taken: whether rows
    the resident kernel cannot read get padded (only where it then runs:
    by the rule, or forced), and the (pointer, strides) of q, k, v and
    out that the kernel would read."""
    unreadable = [_unreadable_rows(x) for x in (q, k, v)]

    def views(pad):
        ins = [_view(x, pad and u) for x, u in zip((q, k, v), unreadable)]
        b, t, h, d = q.shape
        out = ((t * h * d, h * d, d) if ins[0][0] == 0 else
               torch.empty_like(q, device="meta").stride()[:3])
        return ins + [(0, out)]

    pad = any(unreadable) and force != 1 and (force == 2 or _route_code(
        _pack(views(True), q.shape, q.dtype)) == 1)
    return pad, views(pad)


def _layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            force: int = 0):
    """The wrapper's layout steps (module docstring): q, k, v as the
    kernel reads them, and the output buffer (q's layout where dense,
    else contiguous)."""
    pad, _ = _plan(q, k, v, force)
    q, k, v = (_bf16_rows(_unit_d_stride(x)) if pad else _unit_d_stride(x)
               for x in (q, k, v))
    return q, k, v, torch.empty_like(q)


def kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """"resident" or "key_tiled": the kernel ``attention`` launches for
    these CUDA inputs, by the dispatch rule (csrc/attention.cu) on the
    layout its steps would give; copies and launches nothing."""
    _check(q, k, v)
    _, views = _plan(q, k, v)
    code = _route_code(_pack(views, q.shape, q.dtype))
    if code not in (1, 2, 3):
        raise ValueError(f"no attention kernel takes {tuple(q.shape)} "
                         f"{q.dtype}")
    return "resident" if code == 1 else "key_tiled"


def _resident_takes(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> bool:
    """Whether the resident kernels take these CUDA inputs (after the
    layout steps ``_attention_resident`` would take), whichever kernel the
    rule picks; copies and launches nothing."""
    _check(q, k, v)
    _, views = _plan(q, k, v, force=2)
    return _route_code(_pack(views, q.shape, q.dtype)) in (1, 3)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) fused attention; the output has q's dtype."""
    return _forward(q, k, v, force=0)


def _attention_key_tiled(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """``attention`` on the key-tiled kernel at any shape on a card,
    whatever the rule picks: for measuring the kernels against each other
    (chip_smoke.py, tests/test_torch_kernels_cuda.py)."""
    return _forward(q, k, v, force=1)


def _attention_resident(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """``attention`` on the resident kernels wherever they take the shape
    (``_resident_takes``), whatever the rule picks; raises elsewhere. For
    the same measurements as ``_attention_key_tiled``."""
    return _forward(q, k, v, force=2)


def _forward(q, k, v, force: int) -> torch.Tensor:
    dev = q.device
    if q.dim() == 4:
        flops.count("attention", flops.attention_flops(*q.shape))
    if dev.type == "cpu":
        with flops.uncounted():
            return reference_attention(q, k, v)
    if dev.type != "cuda":
        raise ValueError(f"attention runs on CUDA or CPU, not {dev}")
    with span("kernels.attention"):
        _check(q, k, v)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise RuntimeError(
                "the attention kernel is forward only (the Pallas kernel has "
                "no VJP either): call it under torch.no_grad(), or train "
                "with attn_pdrop > 0, which takes the explicit-probabilities "
                "branch")
        if q.numel() == 0:
            return torch.empty_like(q)
        q, k, v, out = _layout(q, k, v, force)
        err = kernels.call(
            kernels.function("attention", "tf_attention_forward", _ARGTYPES),
            dev, _pack([_view(x) for x in (q, k, v, out)], q.shape, q.dtype,
                       force))
    if err != 0:
        forced = ("", ", key-tiled", ", resident")[force]
        raise RuntimeError(f"attention kernel launch failed: CUDA error "
                           f"{err} at shape {tuple(q.shape)} {q.dtype}"
                           f"{forced}")
    kernels.count_launch("attention")
    return out
