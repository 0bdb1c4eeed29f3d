"""Staged CNN trunks: RegNetY, ResNet (BasicBlock) and ConvNeXt
(counterpart of transfuser_tpu/models/encoders.py).

Parameter names are timm's, the names a reference checkpoint carries:
RegNetY ``stem.conv``, ``s{K}.b{J}.conv1.conv``, ...; ResNet ``conv1``,
``bn1``, ``layer{L}.{B}.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}``;
ConvNeXt ``stem.{0,1}``, ``stages.S.downsample.{0,1}``,
``stages.S.blocks.B.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}``. Modules run
NCHW: the fusion backbones drive ``stem(x)`` and ``stage(i, x)`` as the
JAX backbones do, and ``stem_nhwc`` / ``stage_nhwc`` are the NHWC entry
points that match the JAX encoder's ``stem`` / ``stage`` layout.

Only the native grouped convolution exists here: the JAX package's
``group_lowering`` variants were TPU workarounds with identical
parameters.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image_ops import to_nchw, to_nhwc
from .layers import BatchNorm2d, Conv2d, LayerNorm, LayerNorm2d, Linear


class ConvBN(nn.Module):
    """Conv + BatchNorm (eps 1e-5, running stats) + optional ReLU."""

    def __init__(self, in_chs: int, out_chs: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv2d(in_chs, out_chs, kernel, stride, (kernel - 1) // 2,
                           groups=groups, bias=False)
        self.bn = BatchNorm2d(out_chs, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class SEModule(nn.Module):
    """Squeeze-excitation with explicit reduction channels (timm RegNetY)."""

    def __init__(self, channels: int, rd_channels: int):
        super().__init__()
        self.fc1 = Conv2d(channels, rd_channels, 1)
        self.fc2 = Conv2d(rd_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class RegNetYBlock(nn.Module):
    """RegNetY bottleneck block (bottleneck ratio 1, SE)."""

    def __init__(self, in_chs: int, out_chs: int, stride: int,
                 group_width: int, se_ratio: float = 0.25):
        super().__init__()
        groups = out_chs // group_width
        self.conv1 = ConvBN(in_chs, out_chs, 1)
        self.conv2 = ConvBN(out_chs, out_chs, 3, stride, groups)
        self.se = SEModule(out_chs, int(round(in_chs * se_ratio)))
        self.conv3 = ConvBN(out_chs, out_chs, 1, act=False)
        self.downsample = (ConvBN(in_chs, out_chs, 1, stride, act=False)
                           if stride != 1 or in_chs != out_chs else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3(self.se(self.conv2(self.conv1(x))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class RegNetStage(nn.Module):
    """Blocks ``b1..bN``; the first one downsamples by 2."""

    def __init__(self, depth: int, in_chs: int, out_chs: int,
                 group_width: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"b{i + 1}", RegNetYBlock(
                in_chs if i == 0 else out_chs, out_chs, 2 if i == 0 else 1,
                group_width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"b{i + 1}")(x)
        return x


class _Trunk(nn.Module):
    """Shared by the trunks: ``stem(x)`` and ``stage(i, x)`` (NCHW) come
    from each trunk, ``widths`` are the four stage widths."""

    widths: Tuple[int, ...]

    @property
    def feature_dims(self) -> Tuple[int, ...]:
        return self.widths

    def stem_nhwc(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in and out, like the JAX encoder's ``stem``."""
        return to_nhwc(self.stem(to_nchw(x)))

    def stage_nhwc(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """NHWC in and out, like the JAX encoder's ``stage(i, x)``."""
        return to_nhwc(self.stage(i, to_nchw(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for i in range(4):
            x = self.stage(i, x)
        return x


class RegNetY(_Trunk):
    """RegNetY trunk; regnety_032: depths (2,5,13,1), widths
    (72,216,576,1512), group width 24, stem 32."""

    def __init__(self, depths: Tuple[int, ...] = (2, 5, 13, 1),
                 widths: Tuple[int, ...] = (72, 216, 576, 1512),
                 group_width: int = 24, stem_width: int = 32,
                 in_channels: int = 3):
        super().__init__()
        self.widths = tuple(widths)
        self.stem = ConvBN(in_channels, stem_width, 3, 2)
        ins = (stem_width,) + self.widths[:-1]
        for si, (d, i, o) in enumerate(zip(depths, ins, self.widths)):
            self.add_module(f"s{si + 1}", RegNetStage(d, i, o, group_width))

    def stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"s{i + 1}")(x)


class BasicBlock(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, stride: int):
        super().__init__()
        self.conv1 = Conv2d(in_chs, out_chs, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(out_chs, eps=1e-5)
        self.conv2 = Conv2d(out_chs, out_chs, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(out_chs, eps=1e-5)
        self.downsample = (nn.Sequential(
            Conv2d(in_chs, out_chs, 1, stride, bias=False),
            BatchNorm2d(out_chs, eps=1e-5))
            if stride != 1 or in_chs != out_chs else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(_Trunk):
    """ResNet-18/34 (BasicBlock) trunk; a 64-wide stem whatever the
    stage widths."""

    def __init__(self, depths: Tuple[int, ...] = (3, 4, 6, 3),
                 widths: Tuple[int, ...] = (64, 128, 256, 512),
                 in_channels: int = 3):
        super().__init__()
        self.widths = tuple(widths)
        self.conv1 = Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        in_chs = 64
        for si, (d, w) in enumerate(zip(depths, self.widths)):
            blocks = []
            for bi in range(d):
                blocks.append(BasicBlock(in_chs, w,
                                         2 if bi == 0 and si > 0 else 1))
                in_chs = w
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """conv 7x7/2, BN, ReLU, max pool 3/2 with -inf padding."""
        return F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)

    def stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"layer{i + 1}")(x)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)


class ConvNeXtBlock(nn.Module):
    """Depthwise 7x7, LayerNorm (fp32 island), MLP with exact GELU, layer
    scale ``gamma`` (multiplied in the compute dtype), residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_dw = Conv2d(dim, dim, 7, 1, 3, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, 4 * dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.conv_dw(x).permute(0, 2, 3, 1))
        y = self.mlp.fc2(F.gelu(self.mlp.fc1(y)))
        return x + (y * self.gamma.to(y.dtype)).permute(0, 3, 1, 2)


class ConvNeXtStage(nn.Module):
    def __init__(self, depth: int, in_dim: int, dim: int, downsample: bool):
        super().__init__()
        # stage 0 keeps its resolution: no downsample (timm's Identity)
        self.downsample = (nn.Sequential(LayerNorm2d(in_dim, eps=1e-6),
                                         Conv2d(in_dim, dim, 2, 2))
                           if downsample else None)
        self.blocks = nn.Sequential(*[ConvNeXtBlock(dim)
                                      for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        return self.blocks(x)


class ConvNeXt(_Trunk):
    """ConvNeXt trunk; base = dims (128,256,512,1024), depths (3,3,27,3).
    The stem and downsample LayerNorms are fp32 islands too."""

    def __init__(self, depths: Tuple[int, ...] = (3, 3, 27, 3),
                 dims: Tuple[int, ...] = (128, 256, 512, 1024),
                 in_channels: int = 3):
        super().__init__()
        self.widths = tuple(dims)
        self.stem = nn.Sequential(Conv2d(in_channels, dims[0], 4, 4),
                                  LayerNorm2d(dims[0], eps=1e-6))
        ins = (dims[0],) + self.widths[:-1]
        self.stages = nn.ModuleList(
            ConvNeXtStage(d, i, o, si > 0)
            for si, (d, i, o) in enumerate(zip(depths, ins, dims)))

    def stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return self.stages[i](x)


_ENCODERS = {
    "regnety_032": lambda c: RegNetY(in_channels=c),
    "resnet34": lambda c: ResNet(depths=(3, 4, 6, 3), in_channels=c),
    "resnet18": lambda c: ResNet(depths=(2, 2, 2, 2), in_channels=c),
    # micro trunks for fast CPU tests (not reference architectures)
    "resnet_micro": lambda c: ResNet(
        depths=(1, 1, 1, 1), widths=(16, 32, 64, 128), in_channels=c),
    "regnety_micro": lambda c: RegNetY(
        depths=(1, 2, 1, 1), widths=(24, 48, 96, 192), group_width=24,
        in_channels=c),
    "convnext_base": lambda c: ConvNeXt(in_channels=c),
    "convnext_tiny": lambda c: ConvNeXt(
        depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), in_channels=c),
}


def trunk_family(arch: str) -> str:
    """'regnety', 'resnet' or 'convnext': what names a trunk's
    parameters carry."""
    for family in ("regnety", "resnet", "convnext"):
        if arch.startswith(family):
            return family
    raise ValueError(f"unknown encoder '{arch}'; available: "
                     f"{sorted(_ENCODERS)}")


def make_encoder(arch: str, in_channels: int = 3) -> _Trunk:
    if arch not in _ENCODERS:
        raise ValueError(
            f"unknown encoder '{arch}'; available: {sorted(_ENCODERS)}")
    return _ENCODERS[arch](in_channels)
