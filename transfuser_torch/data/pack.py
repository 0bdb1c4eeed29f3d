"""The batch wire format (counterpart of transfuser_tpu/data/pack.py).

``pack_sample`` (host, numpy) narrows a decoded sample: uint8 rgb / LiDAR
hit counts k in 0..5 / class ids / target-point raster, uint16 depth
(quantized by 1/65535); every other key stays as it is. Packing is exact
for every key except depth. ``unpack_batch`` (device, torch) widens a
batch back to the fp32 / integer tensors the model and the losses take;
keys already widened pass through. The agent ships the LiDAR histogram as
uint8 counts and widens it by ``LIDAR_HIST_MAX`` the same way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

DEPTH_SCALE = 65535.0
LIDAR_HIST_MAX = 5.0  # lidar_np.HIST_MAX_PER_PIXEL


def pack_sample(sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Host-side: compact dtypes for the host->device copy. Idempotent."""
    out = dict(sample)
    v = out.get("rgb")
    if v is not None and v.dtype != np.uint8:
        out["rgb"] = v.astype(np.uint8)
    v = out.get("lidar")
    if v is not None and v.dtype != np.uint8:
        out["lidar"] = np.round(v * LIDAR_HIST_MAX).astype(np.uint8)
    v = out.get("depth")
    if v is not None and v.dtype != np.uint16:
        out["depth"] = np.round(
            np.clip(v, 0.0, 1.0) * DEPTH_SCALE).astype(np.uint16)
    for key in ("semantic", "bev", "target_point_image"):
        v = out.get(key)
        if v is not None and v.dtype != np.uint8:
            out[key] = v.astype(np.uint8)
    return out


def packed_nbytes(sample: Dict[str, np.ndarray]) -> int:
    return sum(v.nbytes for v in pack_sample(sample).values())


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
