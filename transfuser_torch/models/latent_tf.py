"""Latent TransFuser (camera-only): the TransFuser fusion graph with the
LiDAR histogram replaced by a fixed 2-channel linspace positional grid
(counterpart of transfuser_tpu/models/latent_tf.py; reference
team_code_transfuser/latentTF.py:8-218).

The reference's module names are TransfuserBackbone's, flat (its GPT and
encoder stack are verbatim copies), so the port subclasses the port's
TransfuserBackbone and changes only its input. The JAX package nests the
same backbone as ``inner``; the weight bridge adds and strips that level.
"""

from __future__ import annotations

from typing import Optional

import torch

from .transfuser import TransfuserBackbone


def positional_grid(h: int, w: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """(2, H, W): ch0 = top-down linspace, ch1 = left-right linspace."""
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    return torch.stack([ys[:, None].expand(h, w),
                        xs[None, :].expand(h, w)]).to(dtype)


class LatentTFBackbone(TransfuserBackbone):
    def forward(self, image: torch.Tensor, lidar_bev: torch.Tensor,
                velocity: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None):
        """As TransfuserBackbone.forward. Channels 0/1 of ``lidar_bev``
        (B,C,H,W) become the positional grid; any extra channel (the
        target-point raster) passes through untouched."""
        b, _, h, w = lidar_bev.shape
        grid = positional_grid(h, w, lidar_bev.dtype, lidar_bev.device)
        lidar_bev = torch.cat([grid[None].expand(b, 2, h, w),
                               lidar_bev[:, 2:]], dim=1)
        return super().forward(image, lidar_bev, velocity, gen)
