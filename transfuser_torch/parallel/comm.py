"""Collectives that carry a gradient, as ``torch.autograd.Function``s.

* ``all_reduce_sum``: the sum over a group, whose backward is again a sum
  over the group. BatchNorm's global statistics go through it: every
  rank's output depends on every rank's input, so the gradient of the
  statistics is the sum of the ranks' gradients.
* ``copy_to_group`` / ``reduce_from_group``: Megatron's conjugate pair
  around a column- then row-parallel linear. ``copy_to_group`` is the
  identity forward and sums the input gradients backward;
  ``reduce_from_group`` sums the partial outputs forward and passes the
  gradient through backward.

Each takes ``group=None`` or a group of size 1 as the identity. They use
``torch.distributed.all_reduce`` only, which gloo runs on CPU and CUDA
tensors and NCCL on CUDA ones.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum over ``group``; differentiable (backward: sum over ``group``).
    Without grad it is a plain all-reduce of a copy."""
    if group_size(group) == 1:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _sum(x, group)
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The group's mean of a tensor no gradient flows through."""
    n = group_size(group)
    if n == 1:
        return x
    return _sum(x.detach(), group) / n


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)
