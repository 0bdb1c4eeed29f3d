"""Plain fp32 ConvNeXt trunks for the reference TransFuser: the trunk of
both branches in the 2022 branch's team_code_transfuser/transfuser.py
(``convnext_base``: Liu et al., "A ConvNet for the 2020s", CVPR 2022,
arXiv:2201.03545; timm's ``convnext_base``), and ``convnext_tiny``, the
smallest ConvNeXt the port has, for the CPU-size runs of the tests.

A reference module of the harness's contract (``harness.py``; how, in
``reference/model.py``'s docstring): the GPT fusion, heads, decoders and
GRU are ``model.py``'s, and this module adds the trunks under the port's
parameter names: ``stem.{0,1}``, ``stages.S.downsample.{0,1}`` (none in
stage 0) and ``stages.S.blocks.B.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}``.

* the stem: a 4x4 stride-4 convolution, then a LayerNorm over channels;
* each downsample (stages 1-3): a LayerNorm over channels, then a 2x2
  stride-2 convolution;
* each block: a depthwise 7x7 convolution (padding 3, bias), a LayerNorm
  over channels (eps 1e-6, as every LayerNorm here), Linear C -> 4C,
  exact GELU, Linear 4C -> C, times the layer scale ``gamma``, plus the
  block's input.

Built from ``model.Conv2d``, ``model.Linear`` and ``model.LayerNorm``:
under ``lowp("fp8")`` the convolutions and linears round and the norms
stay fp32 islands, as the port's LayerNorms are and as RegNetY's
BatchNorms stay. The model has no BatchNorm and so no running statistics.

Departures from timm: no classifier ``head`` (TransFuser reads the four
stages' features) and no drop-path (TransFuser's rate is 0); and the
seeded layer scale, ``gamma`` at 1.0 where timm initialises 1e-6
(``seed_rules``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import model
from .model import _resizing, lowp, namespace, plain_fp32  # noqa: F401

EPS = 1e-6
GAMMA = 1.0


class LayerNorm2d(model.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = model.Linear(dim, hidden)
        self.fc2 = model.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv_dw = model.Conv2d(dim, dim, 7, 1, 3, groups=dim)
        self.norm = model.LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim, 4 * dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        y = self.mlp(self.norm(model.to_nhwc(self.conv_dw(x))))
        return x + model.to_nchw(y * self.gamma)


class ConvNeXtStage(nn.Module):
    def __init__(self, depth, cin, cout, downsample):
        super().__init__()
        self.downsample = (nn.Sequential(LayerNorm2d(cin, eps=EPS),
                                         model.Conv2d(cin, cout, 2, 2))
                           if downsample else None)
        self.blocks = nn.Sequential(*[ConvNeXtBlock(cout)
                                      for _ in range(depth)])

    def forward(self, x):
        if self.downsample is not None:
            x = self.downsample(x)
        return self.blocks(x)


class ConvNeXt(nn.Module):
    def __init__(self, depths, widths, in_channels):
        super().__init__()
        self.widths = tuple(widths)
        self.stem = nn.Sequential(model.Conv2d(in_channels, widths[0], 4, 4),
                                  LayerNorm2d(widths[0], eps=EPS))
        ins = (widths[0],) + self.widths[:-1]
        self.stages = nn.ModuleList(
            ConvNeXtStage(d, i, o, si > 0)
            for si, (d, i, o) in enumerate(zip(depths, ins, self.widths)))

    def stage(self, i, x):
        return self.stages[i](x)


TRUNKS = {
    "convnext_base": dict(depths=(3, 3, 27, 3), widths=(128, 256, 512, 1024)),
    "convnext_tiny": dict(depths=(3, 3, 9, 3), widths=(96, 192, 384, 768)),
}
TRUNK_FACTORIES = dict(model.TRUNK_FACTORIES, **{
    name: functools.partial(ConvNeXt, **kw) for name, kw in TRUNKS.items()})
TINY_TRUNK = "convnext_tiny"


def build(cfg, device="cpu"):
    return model.build(cfg, device, trunks=TRUNK_FACTORIES)


def seed_rules(net: nn.Module):
    """``model``'s rules, and every block's layer scale at ``GAMMA``.
    timm's 1e-6 is the value a network starts training from: each block
    is then its identity but for a millionth, and the comparison that
    decides ``correct`` could not see a fault inside one; at 1.0 every
    block's branch counts in the output as it does in a trained
    network."""
    rules = model.seed_rules(net)
    rules.update({f"{name}.gamma": ("const", GAMMA)
                  for name, m in net.named_modules()
                  if isinstance(m, ConvNeXtBlock)})
    return rules
