"""The general traffic generator: every mix under ``traffic/`` is a data
file of parameters that these functions read. The same seed gives the
same inputs, and every seed the same sizes.

Sensor frames follow ``chip_smoke.py``'s ``synthetic_sensor_frames``
(three uint8 cameras with an alpha channel, a uniform LiDAR cloud, GPS
along a straight route, a constant speed); training batches follow
``transfuser_torch/data/synthetic.py``'s ``synthetic_batch``, drawn on
the device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

LAT_METERS = 111324.60662786  # CARLA's metres per degree of latitude


def route_plan(mix: Dict) -> List[Tuple[Dict, int]]:
    """A straight route north, one waypoint every ``route_spacing_m``."""
    n = int(mix["route_length_m"] // mix["route_spacing_m"]) + 1
    return [({"lat": i * mix["route_spacing_m"] / LAT_METERS, "lon": 0.0}, 4)
            for i in range(n)]


class SensorFrames:
    """Frame i of the drive: the sensor payload ``i % distinct`` of a pool
    drawn from the seed, at the pose reached after i sim ticks."""

    def __init__(self, cfg, mix: Dict, seed: int):
        rng = np.random.default_rng(seed)
        s = cfg.sensors
        h, w = s.img_resolution[0], s.img_width
        n = int(mix["distinct_frames"])
        pts = int(mix["lidar_points"])
        xy, (z0, z1) = mix["lidar_xy_m"], mix["lidar_z_m"]
        self.cams = rng.integers(0, 256, (n, 3, h, w, 4), np.uint8)
        self.clouds = np.concatenate([
            rng.uniform(-xy, xy, (n, pts, 2)), rng.uniform(z0, z1, (n, pts, 1)),
            rng.uniform(0, 1, (n, pts, 1))], axis=2).astype(np.float32)
        self.speed = float(mix["speed_mps"])
        self.step_m = self.speed / cfg.controller.carla_fps
        self.n = n

    def __call__(self, i: int) -> Dict:
        k = i % self.n
        cams = self.cams[k]
        return {
            "rgb_front": (i, cams[0]), "rgb_left": (i, cams[1]),
            "rgb_right": (i, cams[2]),
            "gps": (i, np.array([i * self.step_m / LAT_METERS, 0.0, 0.0])),
            "speed": (i, {"speed": self.speed}),
            "imu": (i, np.array([0, 0, 9.8, 0, 0, 0, 0.0])),
            "lidar": (i, self.clouds[k]),
        }


def train_batches(cfg, mix: Dict, seed: int, device) -> List[Dict]:
    """``distinct_batches`` training batches of ``batch`` rows, resident on
    the device; every row of every batch drawn apart."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    b = int(mix["batch"])
    s, m = cfg.sensors, cfg.model
    ih, iw = s.img_resolution
    lh, lw = s.lidar_resolution_height, s.lidar_resolution_width
    bh, bw = cfg.bev.bev_resolution_height, cfg.bev.bev_resolution_width
    kmax = m.centernet.max_label_boxes
    nbox = min(int(mix["boxes_per_sample"]), kmax)
    kw = dict(generator=gen, device=device)

    def uniform(lo, hi, *shape):
        return torch.rand(*shape, **kw) * (hi - lo) + lo

    out = []
    for _ in range(int(mix["distinct_batches"])):
        label = torch.zeros(b, kmax, 7, device=device)
        for j, (lo, hi) in enumerate(((16, lw - 16), (16, lh - 16), (8, 40),
                                      (16, 60), (-np.pi, np.pi), (0, 10))):
            label[:, :nbox, j] = uniform(lo, hi, b, nbox)
        label[:, :nbox, 6] = torch.randint(0, 2, (b, nbox), **kw).float()
        batch = {
            "rgb": uniform(0, 255, b, ih, iw, 3),
            "target_point": uniform(-20, 20, b, 2),
            "target_point_image": (torch.rand(b, lh, lw, 1, **kw) > 0.99
                                   ).float(),
            "ego_waypoint": uniform(-2, 8, b, m.pred_len, 2),
            "label": label,
            "bev": torch.randint(0, cfg.bev.bev_num_classes, (b, bh, bw),
                                 **kw).to(torch.int32),
            "depth": torch.rand(b, ih, iw, **kw),
            "semantic": torch.randint(0, m.num_class, (b, ih, iw),
                                      **kw).to(torch.int32),
            "speed": uniform(0, 10, b),
        }
        pp = m.point_pillars
        if pp.use_point_pillars:
            batch["lidar_raw"] = uniform(-mix["lidar_xy_m"],
                                         mix["lidar_xy_m"], b,
                                         pp.max_lidar_points, 4)
            batch["num_points"] = torch.full(
                (b,), int(mix["valid_points"]), dtype=torch.int32,
                device=device)
        else:
            batch["lidar"] = torch.rand(b, lh, lw, 2, **kw)
        out.append(batch)
    return out


def half_rows(batch: Dict) -> Dict:
    """The first half of every tensor's rows (a planted fault)."""
    return {k: v[: v.shape[0] // 2] for k, v in batch.items()}
