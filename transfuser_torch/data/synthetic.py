"""Synthetic batch generation for tests and benchmarks (a copy of
transfuser_tpu/data/synthetic.py; numpy only).

Produces batches with the exact shapes/dtypes/padding contracts of the real
CARLA dataset pipeline (see train/losses.py docstring) without needing the
210 GB dataset on disk. Under PointPillars it adds the padded raw cloud
``lidar_raw`` (B, max_lidar_points, 4) and ``num_points`` (B,).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..config import GlobalConfig


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
