"""The batch wire format's device side (counterpart of
transfuser_tpu/data/pack.py: ``LIDAR_HIST_MAX``, ``DEPTH_SCALE`` and
``unpack_batch``).

Host batches may arrive packed: uint8 rgb / LiDAR hit counts k in 0..5 /
class ids / target-point raster, uint16 depth. ``unpack_batch`` widens
them on the device to the fp32 / integer tensors the model and the losses
take; keys already widened pass through. The agent ships the LiDAR
histogram as uint8 counts and widens it by ``LIDAR_HIST_MAX`` the same way.
"""

from __future__ import annotations

from typing import Dict

import torch

DEPTH_SCALE = 65535.0
LIDAR_HIST_MAX = 5.0  # lidar_np.HIST_MAX_PER_PIXEL


def unpack_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = dict(batch)
    v = out.get("rgb")
    if v is not None and v.dtype == torch.uint8:
        out["rgb"] = v.float()
    v = out.get("lidar")
    if v is not None and v.dtype == torch.uint8:
        out["lidar"] = v.float() / LIDAR_HIST_MAX
    v = out.get("depth")
    if v is not None and v.dtype == torch.uint16:
        out["depth"] = v.float() / DEPTH_SCALE
    for key, dt in (("semantic", torch.int32), ("bev", torch.int32),
                    ("target_point_image", torch.float32)):
        v = out.get(key)
        if v is not None and v.dtype == torch.uint8:
            out[key] = v.to(dt)
    return out
