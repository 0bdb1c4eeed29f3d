"""BEV FPN top-down decoder and the image-space seg/depth decoders
(counterpart of transfuser_tpu/models/decoders.py; reference
transfuser.py:99-118 and 214-281).

The reference registers the four 1x1 convs on the backbone itself
(``c5_conv``, ``up_conv5``, ...), so ``top_down`` is a function of those
convs that both ``TopDown`` and the backbone call. The seg/depth
decoders keep the reference's ``deconv{1,2,3}`` Sequential names. NCHW;
bilinear upsampling with align_corners=False, as the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.image_ops import resize_bilinear_nchw
from .layers import Conv2d


def top_down(c5_conv: nn.Module, up_conv5: nn.Module, up_conv4: nn.Module,
             up_conv3: nn.Module, x: torch.Tensor,
             upsample_factor: int = 2) -> Tuple[torch.Tensor, ...]:
    """c5 (B,C,H,W) -> (p2, p3, p4, p5) feature pyramid at x8, x4, x2, x1."""

    def up(t):
        h, w = t.shape[2:]
        return resize_bilinear_nchw(
            t, (h * upsample_factor, w * upsample_factor))

    p5 = F.relu(c5_conv(x))
    p4 = F.relu(up_conv5(up(p5)))
    p3 = F.relu(up_conv4(up(p4)))
    p2 = F.relu(up_conv3(up(p3)))
    return p2, p3, p4, p5


def make_top_down_convs(in_channels: int, channel: int):
    return (Conv2d(in_channels, channel, 1), Conv2d(channel, channel, 1),
            Conv2d(channel, channel, 1), Conv2d(channel, channel, 1))


class TopDown(nn.Module):
    def __init__(self, in_channels: int, channel: int = 64,
                 upsample_factor: int = 2):
        super().__init__()
        (self.c5_conv, self.up_conv5, self.up_conv4,
         self.up_conv3) = make_top_down_convs(in_channels, channel)
        self.upsample_factor = upsample_factor

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return top_down(self.c5_conv, self.up_conv5, self.up_conv4,
                        self.up_conv3, x, self.upsample_factor)


class DeconvStack(nn.Module):
    """Shared 3-stage conv + upsample trunk of the seg/depth decoders."""

    def __init__(self, cin: int, c1: int, c2: int, c3: int, cout: int,
                 scale_1: int = 8, scale_2: int = 4):
        super().__init__()
        self.deconv1 = nn.Sequential(Conv2d(cin, c1, 3, 1, 1), nn.ReLU(),
                                     Conv2d(c1, c2, 3, 1, 1), nn.ReLU())
        self.deconv2 = nn.Sequential(Conv2d(c2, c3, 3, 1, 1), nn.ReLU(),
                                     Conv2d(c3, c3, 3, 1, 1), nn.ReLU())
        self.deconv3 = nn.Sequential(Conv2d(c3, c3, 3, 1, 1), nn.ReLU(),
                                     Conv2d(c3, cout, 3, 1, 1))
        self.scales = (scale_1, scale_2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.deconv1(x)
        h, w = x.shape[2:]
        x = self.deconv2(resize_bilinear_nchw(
            x, (h * self.scales[0], w * self.scales[0])))
        h, w = x.shape[2:]
        return self.deconv3(resize_bilinear_nchw(
            x, (h * self.scales[1], w * self.scales[1])))


class SegDecoder(DeconvStack):
    """(B, C, h, w) image features -> (B, num_class, H, W) logits."""


class DepthDecoder(DeconvStack):
    """(B, C, h, w) image features -> (B, H, W) depth in (0, 1)."""

    def __init__(self, cin: int, c1: int, c2: int, c3: int,
                 scale_1: int = 8, scale_2: int = 4):
        super().__init__(cin, c1, c2, c3, 1, scale_1, scale_2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(super().forward(x)[:, 0])
