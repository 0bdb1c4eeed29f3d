"""Image-space primitives (counterpart of transfuser_tpu/ops/image_ops.py).

Public functions take and return the JAX package's NHWC layout; each has
an ``_nchw`` twin that the port's modules call.

  * ``adaptive_avg_pool``: nn.AdaptiveAvgPool2d. Exact divisors (the
    shipped anchors: 40x176 -> 5x22 is 8x8 windows) take a reshape and a
    mean, as the JAX op does; any other size takes torch's general windows
    [floor(i*H/oh), ceil((i+1)*H/oh)), upsampling included.
  * ``resize_bilinear``: F.interpolate(mode='bilinear') with either
    align_corners semantics. With align_corners=False the JAX package
    calls jax.image.resize(method="linear"), which antialiases along an
    axis that shrinks: a call that shrinks either axis applies that
    function's triangle weights (``_linear_weights``) by two matrix
    products; an upsample stays F.interpolate, which equals it there.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import flops
from .dtypes import constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def adaptive_avg_pool_nchw(x: torch.Tensor,
                           out_hw: Tuple[int, int]) -> torch.Tensor:
    n, c, h, w = x.shape
    oh, ow = out_hw
    if h % oh or w % ow:
        return F.adaptive_avg_pool2d(x, (oh, ow))
    return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC adaptive average pool to ``out_hw``."""
    return to_nhwc(adaptive_avg_pool_nchw(to_nchw(x), out_hw))


def global_avg_pool_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NC global average pool."""
    return x.mean(dim=(1, 2))


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: int) -> torch.Tensor:
    """NHWC max pool with symmetric -inf padding (torch MaxPool2d)."""
    return to_nhwc(F.max_pool2d(to_nchw(x), window, stride, padding))


def _linear_weights(in_size: int, out_size: int,
                    x: torch.Tensor) -> torch.Tensor:
    """(in_size, out_size) weights of jax.image.resize(method="linear")
    along one axis, in x's dtype and on its device: the triangle kernel,
    widened by in/out where the axis shrinks (antialiasing), each column
    normalised to sum 1 (jax/_src/image/scale.py:compute_weight_mat with
    scale out/in and no translation; computed in fp32 as there)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=x.device)
    sample = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(in_size, **f32)[:, None]).abs()
    weights = (1.0 - dist / kernel_scale).clamp(min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > 1000.0 * eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0).to(x.dtype)


def resize_bilinear_nchw(x: torch.Tensor, out_hw: Tuple[int, int],
                         align_corners: bool = False) -> torch.Tensor:
    h, w = x.shape[2:]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    if align_corners or (oh >= h and ow >= w):
        return F.interpolate(x, size=(oh, ow), mode="bilinear",
                             align_corners=align_corners)
    # a shrinking axis: jax.image.resize's antialiased weights along each
    # axis that changes (as it contracts only those); uncounted by
    # ops.flops, as F.interpolate is
    with flops.uncounted():
        if ow != w:
            x = torch.matmul(x, _linear_weights(w, ow, x))
        if oh != h:
            x = torch.matmul(_linear_weights(h, oh, x).t(), x)
    return x


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """NHWC bilinear resize matching torch F.interpolate semantics."""
    return to_nhwc(resize_bilinear_nchw(to_nchw(x), out_hw, align_corners))


def _imagenet_consts(x: torch.Tensor, shape) -> Tuple[torch.Tensor, ...]:
    # constants rounded to x.dtype first, then scaled in it, as the JAX
    # package does
    mean = constant(tuple(IMAGENET_MEAN), x.dtype, x.device, 255.0)
    std = constant(tuple(IMAGENET_STD), x.dtype, x.device, 255.0)
    return mean.reshape(shape), std.reshape(shape)


def normalize_imagenet_nchw(x: torch.Tensor) -> torch.Tensor:
    mean, std = _imagenet_consts(x, (1, 3, 1, 1))
    return (x - mean) / std


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """uint8-range NHWC RGB -> ImageNet-normalized (transfuser.py:419-428)."""
    mean, std = _imagenet_consts(x, (3,))
    return (x - mean) / std
