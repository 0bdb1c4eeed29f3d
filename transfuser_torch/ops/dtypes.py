"""Accumulation-dtype helpers (counterpart of transfuser_tpu/ops/dtypes.py).

The compute path runs bf16 with fp32 islands (softmax, LayerNorm,
BatchNorm, the GRU and waypoint math). Those islands UPcast, never
downcast: fp64 inputs stay fp64.
"""

import functools
from typing import Tuple

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """At-least-fp32 accumulation dtype for a given compute dtype."""
    return torch.promote_types(dtype, torch.float32)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast to fp32 (bf16 inputs) but keep fp64 untouched."""
    return x.to(acc_dtype(x.dtype))


@functools.lru_cache(maxsize=None)
def constant(values: Tuple[float, ...], dtype: torch.dtype,
             device: torch.device, scale: float = 1.0) -> torch.Tensor:
    """``torch.tensor(values, dtype, device) * scale`` (rounded to ``dtype``
    first, then scaled in it), made once per arguments and kept: made per
    call it is a host-to-device copy each time, which a CUDA graph cannot
    capture. Never an inference tensor, so training may use it too."""
    with torch.inference_mode(False), torch.no_grad():
        t = torch.tensor(values, dtype=dtype, device=device)
        return t * scale if scale != 1.0 else t
