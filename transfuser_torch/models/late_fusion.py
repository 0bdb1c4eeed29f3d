"""Late-fusion baseline: independent branches, global-pool + add fusion
(counterpart of transfuser_tpu/models/late_fusion.py; reference
team_code_transfuser/late_fusion.py:5-111, whose module names it keeps).

NCHW inside; computes in the dtype of the ``image`` it is given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import GlobalConfig
from ..ops.image_ops import global_avg_pool_nchw, normalize_imagenet_nchw
from ..tracing import span
from .decoders import make_top_down_convs, top_down
from .layers import Conv2d, LayerNorm, Linear
from .transfuser import ImageEncoder, LidarEncoder


class LateFusionBackbone(nn.Module):
    """Returns (bev_pyramid (p2..p5), image_feature_grid, fused_features)."""

    def __init__(self, config: GlobalConfig, lidar_in_channels: int = 3):
        super().__init__()
        self.config = config
        mcfg = config.model
        self.image_encoder = ImageEncoder(mcfg.image_architecture)
        self.lidar_encoder = LidarEncoder(mcfg.lidar_architecture,
                                          lidar_in_channels)
        dim = self.image_encoder.features.feature_dims[-1]
        feats = mcfg.perception_output_features
        if dim != feats:
            self.reduce_channels_conv_image = Conv2d(dim, feats, 1)
            self.reduce_channels_conv_lidar = Conv2d(
                self.lidar_encoder._model.feature_dims[-1], feats, 1)
        else:
            self.reduce_channels_conv_image = None
            self.reduce_channels_conv_lidar = None
        # ConvNeXt trunks end without a norm: the reference adds one after
        # the pool (late_fusion.py), an fp32 island
        self.norm_after_pool_img = (
            LayerNorm(feats, eps=1e-6)
            if mcfg.image_architecture.startswith("convnext") else None)
        self.norm_after_pool_lidar = (
            LayerNorm(feats, eps=1e-6)
            if mcfg.lidar_architecture.startswith("convnext") else None)
        self.vel_emb = Linear(1, feats) if mcfg.use_velocity else None
        (self.c5_conv, self.up_conv5, self.up_conv4,
         self.up_conv3) = make_top_down_convs(
            feats, config.bev.bev_features_channels)

    def forward(self, image: torch.Tensor, lidar_bev: torch.Tensor,
                velocity: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None):
        """image (B,3,H,W) in [0,255], lidar_bev (B,C,H,W), both in the
        compute dtype; ``gen`` is unused (no dropout here)."""
        with span("model.encoders"):
            x_img = self.image_encoder.features(
                normalize_imagenet_nchw(image))
            x_lid = self.lidar_encoder._model(lidar_bev)

        with span("model.outputs"):
            if self.reduce_channels_conv_image is not None:
                x_img = self.reduce_channels_conv_image(x_img)
            img_vec = global_avg_pool_nchw(x_img)
            if self.norm_after_pool_img is not None:
                img_vec = self.norm_after_pool_img(img_vec)

            if self.reduce_channels_conv_lidar is not None:
                x_lid = self.reduce_channels_conv_lidar(x_lid)
            pyramid = top_down(self.c5_conv, self.up_conv5, self.up_conv4,
                               self.up_conv3, x_lid,
                               self.config.bev.bev_upsample_factor)
            lid_vec = global_avg_pool_nchw(x_lid)
            if self.norm_after_pool_lidar is not None:
                lid_vec = self.norm_after_pool_lidar(lid_vec)

        with span("model.fusion"):
            fused = img_vec + lid_vec
            if self.vel_emb is not None:
                if velocity is None:
                    raise ValueError("use_velocity needs velocity")
                fused = fused + self.vel_emb(
                    velocity.reshape(-1, 1).to(fused.dtype))
        return pyramid, x_img, fused
