"""Autoregressive waypoint GRU decoder (counterpart of
transfuser_tpu/models/waypoint_gru.py; reference model.py:592-646).

A join MLP compresses the fused feature to the GRU state; an
``nn.GRUCell`` (gates [r; z; n], separate ``bias_ih`` / ``bias_hh``)
consuming [x, y, (target point)] rolls out ``pred_len`` deltas. Runs in
at-least-fp32 whatever the backbone's dtype.

The reference registers ``join``, ``decoder`` and ``output`` on the model
itself, so ``waypoint_rollout`` is a function of those modules that both
``WaypointGRU`` and ``LidarCenterNet`` call.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.dtypes import at_least_f32, constant
from .layers import Linear


def make_join(in_features: int, hidden_size: int) -> nn.Sequential:
    return nn.Sequential(Linear(in_features, 256), nn.ReLU(),
                         Linear(256, 128), nn.ReLU(),
                         Linear(128, hidden_size), nn.ReLU())


def waypoint_rollout(join: nn.Module, decoder: nn.GRUCell, output: nn.Module,
                     fused: torch.Tensor, target_point: torch.Tensor,
                     pred_len: int = 4, concat_target_point: bool = True,
                     lidar_pos_x: float = 1.3) -> torch.Tensor:
    """fused (B, C), target_point (B, 2) -> waypoints (B, pred_len, 2) in
    the lidar frame (x shifted by -lidar_pos_x)."""
    z = join(at_least_f32(fused))
    dt = z.dtype
    tp = target_point.to(dt) * constant((1.0, -1.0), dt, z.device)
    x = torch.zeros((z.shape[0], 2), dtype=dt, device=z.device)
    wps = []
    for _ in range(pred_len):
        x_in = torch.cat([x, tp], dim=-1) if concat_target_point else x
        z = decoder(x_in, z)
        x = output(z)[:, :2] + x
        wps.append(x)
    pred_wp = torch.stack(wps, dim=1)
    # vehicle frame -> lidar frame (model.py:639)
    return pred_wp - constant((float(lidar_pos_x), 0.0), dt, z.device)


class WaypointGRU(nn.Module):
    def __init__(self, in_features: int, pred_len: int = 4,
                 hidden_size: int = 64, concat_target_point: bool = True,
                 lidar_pos_x: float = 1.3):
        super().__init__()
        self.join = make_join(in_features, hidden_size)
        self.decoder = nn.GRUCell(4 if concat_target_point else 2,
                                  hidden_size)
        self.output = Linear(hidden_size, 3)
        self.pred_len = pred_len
        self.concat_target_point = concat_target_point
        self.lidar_pos_x = lidar_pos_x

    def forward(self, fused: torch.Tensor,
                target_point: torch.Tensor) -> torch.Tensor:
        return waypoint_rollout(self.join, self.decoder, self.output, fused,
                                target_point, self.pred_len,
                                self.concat_target_point, self.lidar_pos_x)
