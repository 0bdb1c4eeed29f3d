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

Under data parallelism (a BatchNorm module's ``process_group`` set by the
trainer to the mesh's data group) the training statistics are the global
batch's, as under the JAX package's GSPMD mesh: the sum and count, then
the sum of squared deviations from the global mean, are all-reduced
through a differentiable all-reduce (``parallel/comm.py``), and every
rank normalises with them and folds the same values into its running
statistics. The two-pass form keeps fp32 as close to one device's
``var_mean`` as the summation order allows.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dtypes import at_least_f32
from ..parallel import comm

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
    group = getattr(bn, "process_group", None)
    if comm.group_size(group) > 1:
        return _global_batch_norm(bn, x32, group).to(x.dtype)
    with torch.no_grad():
        dims = [0] + list(range(2, x32.dim()))
        var, mean = torch.var_mean(x32, dim=dims, correction=0)
        _update_running(bn, mean, var)
    # training-mode F.batch_norm normalises with the biased batch variance
    return F.batch_norm(x32, None, None, bn.weight, bn.bias, True, 0.0,
                        bn.eps).to(x.dtype)


@torch.no_grad()
def _update_running(bn, mean: torch.Tensor, var: torch.Tensor) -> None:
    m = FLAX_BN_MOMENTUM
    bn.running_mean.mul_(m).add_(mean.to(bn.running_mean.dtype),
                                 alpha=1 - m)
    bn.running_var.mul_(m).add_(var.to(bn.running_var.dtype),
                                alpha=1 - m)


def _global_batch_norm(bn, x32: torch.Tensor, group) -> torch.Tensor:
    """Training-mode BatchNorm with the data group's statistics (biased
    variance, fp32)."""
    c = x32.shape[1]
    dims = [0] + list(range(2, x32.dim()))
    shape = [1, c] + [1] * (x32.dim() - 2)
    count = torch.full((1,), x32.numel() // c, dtype=x32.dtype,
                       device=x32.device)
    sums = comm.all_reduce_sum(torch.cat([x32.sum(dims), count]), group)
    mean = sums[:c] / sums[c]
    xc = x32 - mean.reshape(shape)
    var = comm.all_reduce_sum((xc * xc).sum(dims), group) / sums[c]
    _update_running(bn, mean.detach(), var.detach())
    y = xc * torch.rsqrt(var + bn.eps).reshape(shape)
    if bn.weight is not None:
        y = y * bn.weight.reshape(shape) + bn.bias.reshape(shape)
    return y


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_batch_norm(self, x)


class BatchNorm1d(nn.BatchNorm1d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_batch_norm(self, x)
