"""TransFuser backbone: two CNN branches fused by GPT attention at 4 scales
(counterpart of transfuser_tpu/models/transfuser.py; reference
team_code_transfuser/transfuser.py:7-211, whose module names it keeps).

NCHW inside; computes in the dtype of the ``image`` it is given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import GlobalConfig
from ..ops.image_ops import (adaptive_avg_pool_nchw, global_avg_pool_nchw,
                             normalize_imagenet_nchw, resize_bilinear_nchw,
                             to_nchw, to_nhwc)
from .decoders import make_top_down_convs, top_down
from .encoders import make_encoder
from .gpt import GPTFusion
from ..tracing import span
from .layers import Conv2d


class ImageEncoder(nn.Module):
    """Any trunk of ``encoders.make_encoder``, as the reference's
    ``image_encoder.features``."""

    def __init__(self, arch: str):
        super().__init__()
        self.features = make_encoder(arch, 3)


class LidarEncoder(nn.Module):
    """Any trunk with the LiDAR's input channels, as the reference's
    ``lidar_encoder._model``. The reference swaps in that first conv by
    module surgery (re-registered as a top-level ``conv1`` on RegNetY and
    ConvNeXt); the port builds it in place under the trunk's own name, and
    ``train.jax_import.load_reference_checkpoint`` renames the alias."""

    def __init__(self, arch: str, in_channels: int):
        super().__init__()
        self._model = make_encoder(arch, in_channels)


class TransfuserBackbone(nn.Module):
    """Returns (bev_pyramid (p2..p5), image_feature_grid, fused_features)."""

    def __init__(self, config: GlobalConfig, lidar_in_channels: int = 3):
        super().__init__()
        self.config = config
        mcfg = config.model
        g = mcfg.gpt
        self.image_encoder = ImageEncoder(mcfg.image_architecture)
        self.lidar_encoder = LidarEncoder(mcfg.lidar_architecture,
                                          lidar_in_channels)
        dims = self.image_encoder.features.feature_dims
        for i in range(4):
            self.add_module(f"transformer{i + 1}", GPTFusion(
                n_embd=dims[i], n_head=g.n_head, n_layer=g.n_layer,
                block_exp=g.block_exp, embd_pdrop=g.embd_pdrop,
                attn_pdrop=g.attn_pdrop, resid_pdrop=g.resid_pdrop,
                img_anchors=(g.img_vert_anchors, g.img_horz_anchors),
                lidar_anchors=(g.lidar_vert_anchors, g.lidar_horz_anchors),
                use_velocity=mcfg.use_velocity,
                reference_view_unpack=g.reference_view_unpack))
        feats = mcfg.perception_output_features
        if dims[-1] != feats:
            self.change_channel_conv_image = Conv2d(dims[-1], feats, 1)
            self.change_channel_conv_lidar = Conv2d(dims[-1], feats, 1)
        else:
            self.change_channel_conv_image = None
            self.change_channel_conv_lidar = None
        (self.c5_conv, self.up_conv5, self.up_conv4,
         self.up_conv3) = make_top_down_convs(
            feats, config.bev.bev_features_channels)

    def forward(self, image: torch.Tensor, lidar_bev: torch.Tensor,
                velocity: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None):
        """image (B,3,H,W) in [0,255], lidar_bev (B,C,H,W), both in the
        compute dtype; ``gen`` draws the GPT's dropout masks in training."""
        g = self.config.model.gpt
        img_anchors = (g.img_vert_anchors, g.img_horz_anchors)
        lidar_anchors = (g.lidar_vert_anchors, g.lidar_horz_anchors)
        img_enc = self.image_encoder.features
        lid_enc = self.lidar_encoder._model

        with span("model.encoders"):
            x_img = img_enc.stem(normalize_imagenet_nchw(image))
            x_lid = lid_enc.stem(lidar_bev)
        for i in range(4):
            with span("model.encoders"):
                x_img = img_enc.stage(i, x_img)
                x_lid = lid_enc.stage(i, x_lid)
            with span("model.fusion"):
                img_out, lid_out = getattr(self, f"transformer{i + 1}")(
                    to_nhwc(adaptive_avg_pool_nchw(x_img, img_anchors)),
                    to_nhwc(adaptive_avg_pool_nchw(x_lid, lidar_anchors)),
                    velocity, gen)
                x_img = x_img + resize_bilinear_nchw(to_nchw(img_out),
                                                     x_img.shape[2:])
                x_lid = x_lid + resize_bilinear_nchw(to_nchw(lid_out),
                                                     x_lid.shape[2:])

        with span("model.outputs"):
            if self.change_channel_conv_image is not None:
                x_img = self.change_channel_conv_image(x_img)
                x_lid = self.change_channel_conv_lidar(x_lid)

            fused = global_avg_pool_nchw(x_img) + global_avg_pool_nchw(x_lid)
            pyramid = top_down(self.c5_conv, self.up_conv5, self.up_conv4,
                               self.up_conv3, x_lid,
                               self.config.bev.bev_upsample_factor)
        return pyramid, x_img, fused
