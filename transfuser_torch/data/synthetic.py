"""Synthetic data for tests and benchmarks (numpy only).

``synthetic_batch`` (a copy of transfuser_tpu/data/synthetic.py) produces
batches with the exact shapes/dtypes/padding contracts of the real CARLA
dataset pipeline (see train/losses.py docstring) without needing the
210 GB dataset on disk. Under PointPillars it adds the padded raw cloud
``lidar_raw`` (B, max_lidar_points, 4) and ``num_points`` (B,).

``write_route`` writes one route directory in the layout the DataAgent
writes and ``CarlaDataset`` reads, from a seed, with the port's PNG writer.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import GlobalConfig
from . import png


def synthetic_batch(config: GlobalConfig, batch_size: int,
                    seed: int = 0,
                    img_hw: Optional[Tuple[int, int]] = None,
                    lidar_hw: Optional[Tuple[int, int]] = None,
                    bev_hw: Optional[Tuple[int, int]] = None,
                    num_boxes: int = 5) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    ih, iw = img_hw or config.sensors.img_resolution
    lh, lw = lidar_hw or (config.sensors.lidar_resolution_height,
                          config.sensors.lidar_resolution_width)
    bh, bw = bev_hw or (config.bev.bev_resolution_height,
                        config.bev.bev_resolution_width)
    kmax = config.model.centernet.max_label_boxes

    label = np.zeros((batch_size, kmax, 7), np.float32)
    n = min(num_boxes, kmax)
    label[:, :n, 0] = rng.uniform(16, lw - 16, (batch_size, n))   # cx
    label[:, :n, 1] = rng.uniform(16, lh - 16, (batch_size, n))   # cy
    label[:, :n, 2] = rng.uniform(8, 40, (batch_size, n))         # w px
    label[:, :n, 3] = rng.uniform(16, 60, (batch_size, n))        # h px
    label[:, :n, 4] = rng.uniform(-np.pi, np.pi, (batch_size, n))  # yaw
    label[:, :n, 5] = rng.uniform(0, 10, (batch_size, n))         # speed
    label[:, :n, 6] = rng.integers(0, 2, (batch_size, n))         # brake

    batch = {
        "rgb": rng.uniform(0, 255, (batch_size, ih, iw, 3)).astype(np.float32),
        "lidar": rng.uniform(0, 1, (batch_size, lh, lw, 2)).astype(np.float32),
        "target_point": rng.uniform(-20, 20, (batch_size, 2)).astype(np.float32),
        "target_point_image": (rng.uniform(0, 1, (batch_size, lh, lw, 1)) > 0.99
                               ).astype(np.float32),
        "ego_waypoint": rng.uniform(-2, 8, (batch_size, config.model.pred_len, 2)
                                    ).astype(np.float32),
        "label": label,
        "bev": rng.integers(0, config.bev.bev_num_classes,
                            (batch_size, bh, bw)).astype(np.int32),
        "depth": rng.uniform(0, 1, (batch_size, ih, iw)).astype(np.float32),
        "semantic": rng.integers(0, config.model.num_class,
                                 (batch_size, ih, iw)).astype(np.int32),
        "speed": rng.uniform(0, 10, (batch_size,)).astype(np.float32),
    }

    if config.model.backbone == "geometric_fusion":
        g = config.model.gpt
        batch["bev_points"] = rng.integers(
            0, min(g.img_vert_anchors, g.img_horz_anchors),
            (batch_size, g.lidar_vert_anchors, g.lidar_horz_anchors, 5, 2),
        ).astype(np.int32)
        batch["cam_points"] = rng.integers(
            0, min(g.lidar_vert_anchors, g.lidar_horz_anchors),
            (batch_size, g.img_vert_anchors, g.img_horz_anchors, 5, 2),
        ).astype(np.int32)

    if config.model.point_pillars.use_point_pillars:
        pp = config.model.point_pillars
        pts = rng.uniform(-20, 20, (batch_size, pp.max_lidar_points, 4))
        batch["lidar_raw"] = pts.astype(np.float32)
        batch["num_points"] = np.full((batch_size,), pp.max_lidar_points // 2,
                                      np.int32)
    return batch


def write_route(route: str, n_frames: int, seed: int = 0,
                n_points: int = 30000) -> None:
    """A CARLA-layout route at the DataAgent's sizes: 160x960 3-camera
    rgb / depth / semantics strips, a 500x500 bit-packed topdown, a LiDAR
    sweep of ``n_points`` points (two thirds inside the BEV histogram's
    32 m x 32 m window) stored as ``[None, points]``, measurements, and
    label records (the ego first, then 3 cars). The ego drives straight
    at 5 m/s, 0.5 m per frame. PNGs at zlib level 1, filter None."""
    rng = np.random.default_rng(seed)
    for sub in ("rgb", "depth", "semantics", "lidar", "topdown",
                "label_raw", "measurements"):
        os.makedirs(os.path.join(route, sub), exist_ok=True)
    h, w, level = 160, 960, 1
    n_in = 2 * n_points // 3
    for i in range(n_frames):
        png.write(f"{route}/rgb/{i:04d}.png",
                  rng.integers(0, 256, (h, w, 3), np.uint8), level)
        png.write(f"{route}/depth/{i:04d}.png",
                  rng.integers(0, 256, (h, w, 3), np.uint8), level)
        png.write(f"{route}/semantics/{i:04d}.png",
                  rng.integers(0, 28, (h, w), np.uint8), level)
        png.write(f"{route}/topdown/encoded_{i:04d}.png",
                  rng.integers(0, 256, (500, 500, 3), np.uint8), level)
        # stored y is negated: the histogram window is x in [-16, 16],
        # stored y in [0, 32]
        inside = np.stack([rng.uniform(-16, 16, n_in),
                           rng.uniform(0, 32, n_in),
                           rng.uniform(-3, 0.5, n_in),
                           rng.uniform(0, 1, n_in)], -1)
        outside = rng.uniform(-50, 50, (n_points - n_in, 4))
        pts = np.concatenate([inside, outside]).astype(np.float32)
        np.save(f"{route}/lidar/{i:04d}.npy",
                np.array([None, pts], dtype=object), allow_pickle=True)
        ego = np.eye(4)
        ego[0, 3] = 0.5 * i
        meas = {"x": 0.5 * i, "y": 0.0, "theta": 0.0, "speed": 5.0,
                "x_command": 0.5 * i + 30.0, "y_command": 2.0,
                "steer": 0.0, "throttle": 0.5, "brake": False,
                "light_hazard": False, "ego_matrix": ego.tolist()}
        with open(f"{route}/measurements/{i:04d}.json", "w") as f:
            json.dump(meas, f)
        labels = [{"id": 0, "class": "Car", "extent": [1.5, 2.4, 1.0],
                   "position": [0.0, 0.0, 0.0], "yaw": 0.0, "speed": 5.0,
                   "brake": 0.0, "num_points": -1, "distance": -1,
                   "ego_matrix": ego.tolist()}]
        for k in range(3):
            # ahead of the ego, inside the 256 px BEV label grid
            pos = [float(rng.uniform(2, 28)), float(rng.uniform(-12, 12)),
                   0.0]
            labels.append({"id": 10 + k, "class": "Car",
                           "extent": [1.5, 2.2, 1.0], "position": pos,
                           "yaw": float(rng.uniform(-np.pi, np.pi)),
                           "speed": float(rng.uniform(0, 8)),
                           "brake": float(rng.integers(0, 2)),
                           "num_points": int(rng.integers(2, 100)),
                           "distance": float(np.hypot(*pos[:2])),
                           "ego_matrix": ego.tolist()})
        with open(f"{route}/label_raw/{i:04d}.json", "w") as f:
            json.dump(labels, f)
