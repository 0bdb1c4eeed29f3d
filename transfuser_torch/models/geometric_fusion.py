"""Geometric fusion: multi-scale bidirectional LiDAR<->camera point
projection fusion (counterpart of transfuser_tpu/models/geometric_fusion.py;
reference team_code_transfuser/geometric_fusion.py:6-300, whose module
names it keeps).

At each scale the branch features are 1x1-projected to ``gpt.n_embd``,
pooled onto the anchor grids, and exchanged through precomputed cell
correspondences (5 samples per cell, built on the host from the raw point
cloud by ``data.correspondences``):

  bev_points (B, 8, 8, 5, 2)  int (x, y) indices into the (5, 22) image grid
  cam_points (B, 5, 22, 5, 2) int (x, y) indices into the (8, 8) lidar grid

NCHW inside; computes in the dtype of the ``image`` it is given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import GlobalConfig
from ..ops.image_ops import (adaptive_avg_pool_nchw, global_avg_pool_nchw,
                             normalize_imagenet_nchw, resize_bilinear_nchw)
from ..tracing import span
from .decoders import make_top_down_convs, top_down
from .layers import Conv2d, Linear
from .transfuser import ImageEncoder, LidarEncoder


def reference_grid_view(points: torch.Tensor) -> torch.Tensor:
    """The reference model's reading of its x-major correspondence grids:
    the data writes G[x_cell, y_cell] and the model views the buffer as
    (h, w), a fixed spatial scramble its training absorbs. Clean (h, w)
    grids -> x-major memory order, viewed again as (h, w)."""
    b, h, w, k, two = points.shape
    return points.transpose(1, 2).reshape(b, h, w, k, two)


def gather_correspondences(grid: torch.Tensor,
                           points: torch.Tensor) -> torch.Tensor:
    """grid (B,C,H,W); points (B,h,w,5,2) int (x, y) into grid, clipped
    to it -> (B,C,h,w), the sum over the 5 sampled correspondences."""
    b, c, h, w = grid.shape
    _, oh, ow, k, _ = points.shape
    x = points[..., 0].long().clamp(0, w - 1)
    y = points[..., 1].long().clamp(0, h - 1)
    idx = (y * w + x).reshape(b, 1, oh * ow * k).expand(b, c, -1)
    gathered = torch.gather(grid.reshape(b, c, h * w), 2, idx)
    return gathered.reshape(b, c, oh, ow, k).sum(dim=4)


def _projection(n_embd: int) -> nn.Sequential:
    """The reference's Sequential(Linear, ReLU) x 3, on channels-last."""
    return nn.Sequential(Linear(n_embd, n_embd), nn.ReLU(),
                         Linear(n_embd, n_embd), nn.ReLU(),
                         Linear(n_embd, n_embd), nn.ReLU())


class GeometricFusionBackbone(nn.Module):
    """Returns (bev_pyramid (p2..p5), image_feature_grid, fused_features).
    Scale i (0..3) fuses when ``gpt.n_scale >= 4 - i``; only those scales
    have parameters."""

    def __init__(self, config: GlobalConfig, lidar_in_channels: int = 3):
        super().__init__()
        self.config = config
        mcfg = config.model
        self.image_encoder = ImageEncoder(mcfg.image_architecture)
        self.lidar_encoder = LidarEncoder(mcfg.lidar_architecture,
                                          lidar_in_channels)
        dims = self.image_encoder.features.feature_dims
        lid_dims = self.lidar_encoder._model.feature_dims
        n_embd = mcfg.gpt.n_embd
        self.scales = [i for i in range(4) if mcfg.gpt.n_scale >= 4 - i]
        for i in self.scales:
            s = i + 1
            self.add_module(f"image_conv{s}", Conv2d(dims[i], n_embd, 1))
            self.add_module(f"image_deconv{s}", Conv2d(n_embd, dims[i], 1))
            self.add_module(f"lidar_conv{s}", Conv2d(lid_dims[i], n_embd, 1))
            self.add_module(f"lidar_deconv{s}",
                            Conv2d(n_embd, lid_dims[i], 1))
            self.add_module(f"image_projection{s}", _projection(n_embd))
            self.add_module(f"lidar_projection{s}", _projection(n_embd))
            if mcfg.use_velocity:
                self.add_module(f"vel_emb{s}", Linear(1, dims[i]))
        feats = mcfg.perception_output_features
        if dims[-1] != feats:
            self.change_channel_conv_image = Conv2d(dims[-1], feats, 1)
            self.change_channel_conv_lidar = Conv2d(lid_dims[-1], feats, 1)
        else:
            self.change_channel_conv_image = None
            self.change_channel_conv_lidar = None
        (self.c5_conv, self.up_conv5, self.up_conv4,
         self.up_conv3) = make_top_down_convs(
            feats, config.bev.bev_features_channels)

    def forward(self, image: torch.Tensor, lidar_bev: torch.Tensor,
                velocity: Optional[torch.Tensor] = None,
                bev_points: Optional[torch.Tensor] = None,
                cam_points: Optional[torch.Tensor] = None):
        """image (B,3,H,W) in [0,255], lidar_bev (B,C,H,W), both in the
        compute dtype; bev_points / cam_points as the module docstring."""
        mcfg = self.config.model
        g = mcfg.gpt
        img_anchors = (g.img_vert_anchors, g.img_horz_anchors)
        lidar_anchors = (g.lidar_vert_anchors, g.lidar_horz_anchors)
        if bev_points is None or cam_points is None:
            raise ValueError("geometric_fusion needs bev_points and "
                             "cam_points")
        if mcfg.geometric_reference_view:
            bev_points = reference_grid_view(bev_points)
            cam_points = reference_grid_view(cam_points)
        if mcfg.use_velocity and velocity is None:
            raise ValueError("use_velocity needs velocity")
        img_enc = self.image_encoder.features
        lid_enc = self.lidar_encoder._model

        def project(mlp, x):  # channels-last MLP on an NCHW map
            return mlp(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

        with span("model.encoders"):
            x_img = img_enc.stem(normalize_imagenet_nchw(image))
            x_lid = lid_enc.stem(lidar_bev)
        for i in range(4):
            with span("model.encoders"):
                x_img = img_enc.stage(i, x_img)
                x_lid = lid_enc.stage(i, x_lid)
            if i not in self.scales:
                continue
            s = i + 1
            with span("model.fusion"):
                img_embd = adaptive_avg_pool_nchw(
                    getattr(self, f"image_conv{s}")(x_img), img_anchors)
                lid_embd = adaptive_avg_pool_nchw(
                    getattr(self, f"lidar_conv{s}")(x_lid), lidar_anchors)

                # image -> BEV
                bev = project(getattr(self, f"image_projection{s}"),
                              gather_correspondences(img_embd, bev_points))
                bev = resize_bilinear_nchw(bev, x_lid.shape[2:])
                x_lid = x_lid + getattr(self, f"lidar_deconv{s}")(bev)

                # BEV -> image
                cam = project(getattr(self, f"lidar_projection{s}"),
                              gather_correspondences(lid_embd, cam_points))
                cam = resize_bilinear_nchw(cam, x_img.shape[2:])
                x_img = x_img + getattr(self, f"image_deconv{s}")(cam)

                if mcfg.use_velocity:
                    vel = getattr(self, f"vel_emb{s}")(
                        velocity.reshape(-1, 1).to(x_img.dtype)
                    )[:, :, None, None]
                    x_lid = x_lid + vel
                    x_img = x_img + vel

        with span("model.outputs"):
            if self.change_channel_conv_image is not None:
                x_img = self.change_channel_conv_image(x_img)
                x_lid = self.change_channel_conv_lidar(x_lid)

            fused = global_avg_pool_nchw(x_img) + global_avg_pool_nchw(x_lid)
            pyramid = top_down(self.c5_conv, self.up_conv5, self.up_conv4,
                               self.up_conv3, x_lid,
                               self.config.bev.bev_upsample_factor)
        return pyramid, x_img, fused
