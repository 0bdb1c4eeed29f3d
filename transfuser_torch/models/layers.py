"""Layers that keep fp32 parameters and compute in the input's dtype.

Flax's ``dtype=bf16, param_dtype=fp32`` casts parameters to the compute
dtype at each call; these layers do the same explicitly instead of
relying on autocast's op lists. Normalisations are the fp32 islands of
the JAX package: they compute in at-least-fp32 and cast back.

BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``. In
training mode it normalises with the batch's mean and biased variance
(fp32) and updates the running statistics as ``0.9 * running + 0.1 *
batch``, with the biased variance. ``F.batch_norm`` would update
``running_var`` with the unbiased one, so the port computes the
statistics itself. In eval mode it uses the running statistics.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dtypes import at_least_f32

FLAX_BN_MOMENTUM = 0.9


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(at_least_f32(x), self.normalized_shape,
                            self.weight, self.bias, self.eps).to(x.dtype)


class LayerNorm2d(LayerNorm):
    """LayerNorm over the channels of an NCHW tensor (timm's ConvNeXt
    ``LayerNorm2d``), the same fp32 island."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def flax_batch_norm(bn: nn.modules.batchnorm._BatchNorm,
                    x: torch.Tensor) -> torch.Tensor:
    """x (N, C, ...) in any float dtype -> normalised, in x's dtype."""
    x32 = at_least_f32(x)
    if not bn.training:
        return F.batch_norm(x32, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps).to(x.dtype)
    with torch.no_grad():
        dims = [0] + list(range(2, x32.dim()))
        var, mean = torch.var_mean(x32, dim=dims, correction=0)
        m = FLAX_BN_MOMENTUM
        bn.running_mean.mul_(m).add_(mean.to(bn.running_mean.dtype),
                                     alpha=1 - m)
        bn.running_var.mul_(m).add_(var.to(bn.running_var.dtype),
                                    alpha=1 - m)
    # training-mode F.batch_norm normalises with the biased batch variance
    return F.batch_norm(x32, None, None, bn.weight, bn.bias, True, 0.0,
                        bn.eps).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_batch_norm(self, x)


class BatchNorm1d(nn.BatchNorm1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_batch_norm(self, x)
