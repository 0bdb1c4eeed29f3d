"""PointPillars LiDAR encoder (counterpart of
transfuser_tpu/models/point_pillar.py; reference
team_code_transfuser/point_pillar.py:11-122, from LAV).

A PointNet (Linear + BatchNorm + ReLU per width) runs on the decorated
points; per-pillar max pooling (``ops.pillars.segment_max``, the
hand-written CUDA scatter-max on the card) scatters the features onto a
dense (ny, nx, C) canvas. Padded (B, max_lidar_points, 4) clouds with a
per-sample count, as the JAX package takes them.

Module names are LAV's (``point_net.net.{0,1,3,4}``: Linear, BatchNorm1d,
ReLU per width), so a reference ``point_pillar_net.*`` state dict would
load; no such checkpoint is at hand, so the names are assumed from LAV's
source.

BatchNorm statistics in training mode cover every one of the B*N points,
the padding included: the JAX package's comment says "masked batch norm
over valid points only" but passes no mask, and the port reproduces what
it computes.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..config import PointPillarConfig
from ..ops import pillars
from .layers import BatchNorm1d, Linear

PIXELS_PER_METER = 8  # model.py:558 casts the config's 8.0 to int


class DynamicPointNet(nn.Module):
    def __init__(self, num_input: int = 9,
                 num_features: Sequence[int] = (32, 32)):
        super().__init__()
        layers = []
        for width in num_features:
            layers += [Linear(num_input, width), BatchNorm1d(width, eps=1e-5),
                       nn.ReLU()]
            num_input = width
        self.net = nn.Sequential(*layers)

    def forward(self, feats: torch.Tensor, valid: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """feats (B, N, F), valid (B, N) -> (B, N, C) in ``dtype``; Linear
        in ``dtype``, BatchNorm in fp32 over all B*N points, zero where
        not valid."""
        b, n, _ = feats.shape
        x = feats.to(dtype).reshape(b * n, -1)
        keep = valid.reshape(b * n, 1)
        for i in range(0, len(self.net), 3):
            x = torch.relu(self.net[i + 1](self.net[i](x)))
            x = torch.where(keep, x, torch.zeros_like(x))
        return x.reshape(b, n, -1)


class PointPillarNet(nn.Module):
    def __init__(self, config: PointPillarConfig):
        super().__init__()
        self.config = config
        self.point_net = DynamicPointNet(config.num_input,
                                         config.num_features)

    def forward(self, points: torch.Tensor, num_points: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """points (B, N, 4), num_points (B,) -> canvas (B, ny, nx, C) in
        ``dtype``."""
        cfg = self.config
        ppm = PIXELS_PER_METER
        nx = int((cfg.max_x - cfg.min_x) * ppm)
        ny = int((cfg.max_y - cfg.min_y) * ppm)
        num_cells = ny * nx
        b = points.shape[0]
        cell_ids, valid = pillars.pillar_cells(
            points, num_points, cfg.min_x, cfg.max_x, cfg.min_y, cfg.max_y,
            ppm)
        feats = pillars.decorate_points(points, cell_ids, valid, num_cells,
                                        cfg.min_x, cfg.min_y, nx, ppm)
        point_feats = self.point_net(feats, valid, dtype)
        point_feats = point_feats.float().masked_fill(~valid[..., None],
                                                      pillars.NEG_INF)
        pooled = pillars.segment_max(
            point_feats.reshape(b * points.shape[1], -1),
            pillars.flat_ids(cell_ids, num_cells), b * (num_cells + 1))
        canvas = pillars.scatter_to_canvas(
            pooled.reshape(b, num_cells + 1, -1), ny, nx)
        return canvas.to(dtype)
