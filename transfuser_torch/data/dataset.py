"""CARLA on-disk dataset reader (counterpart of
transfuser_tpu/data/dataset.py; numpy only).

Directory layout per route (reference data.py:46-97; produced by the
DataAgent): rgb/ depth/ semantics/ lidar/ topdown/ label_raw/ measurements/
with 4-digit frame ids. Frames 0-1 and the trailing pred_len+2 frames are
skipped. Output sample layout is documented in train/losses.py (NHWC).

Images decode through ``data/png.py`` (zlib + numpy), the augmentation's
BEV rotation and the small-config BEV resize through the numpy versions in
``data/decoders.py``: the samples equal the JAX reader's, key for key.
"""

from __future__ import annotations

import json
import os
import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import GlobalConfig
from . import decoders, lidar_np, png
from .correspondences import lidar_cam_correspondences
from .pack import pack_sample


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _imread_rgb(path: str) -> np.ndarray:
    """3-channel RGB decode: a gray file is repeated, alpha is dropped."""
    img = png.read(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: expected an 8-bit image, got {img.dtype}")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return img[..., :3]


class CarlaDataset:
    """Index + sample loader. Map-style; thread-safe __getitem__.

    cache: None (off), "memory" (in-process dict of decoded samples — only
    sound with augment=False since augmentation is sampled at decode time),
    or a directory path for an uncompressed npz disk cache of the sample
    in its wire form (the reference's diskcache role, data.py:133-197 /
    train.py:77-91).

    packed=True returns samples in the compact wire format (data/pack.py:
    uint8 rgb/lidar/semantic/bev, uint16 depth); the train/eval steps
    widen them on the device via unpack_batch.
    """

    def __init__(self, roots: Sequence[str], config: GlobalConfig,
                 augment: Optional[bool] = None,
                 cache: Optional[str] = None,
                 packed: bool = False):
        self.packed = packed
        self.config = config
        self.seq_len = config.model.seq_len
        self.pred_len = config.model.pred_len
        self.augment = config.train.augment if augment is None else augment
        self.cache = cache
        self._mem_cache: Dict[int, Dict[str, np.ndarray]] = {}
        if cache not in (None, "memory") and cache:
            os.makedirs(cache, exist_ok=True)
        if cache is not None and self.augment:
            raise ValueError(
                "sample cache requires augment=False (augmentation is "
                "sampled per read)")
        self.frames: List[tuple] = []  # (route_dir, frame_idx)
        for root in roots:
            root = Path(root)
            if not root.is_dir():
                continue
            routes = sorted(p for p in root.iterdir() if p.is_dir()) \
                if not (root / "lidar").is_dir() else [root]
            for route in routes:
                lidar_dir = route / "lidar"
                if not lidar_dir.is_dir():
                    continue
                num_seq = len(os.listdir(lidar_dir))
                # the reference's index range exactly (data.py:57
                # `range(2, num_seq - pred_len - seq_len - 2)`), whose
                # exclusive end drops one more trailing frame than its
                # "skip last two" comment says
                last = num_seq - self.pred_len - self.seq_len - 2
                for seq in range(2, last):
                    self.frames.append((str(route), seq))

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.cache == "memory" and index in self._mem_cache:
            return self._mem_cache[index]
        if self.cache not in (None, "memory") and self.cache:
            path = os.path.join(self.cache, f"{index}.npz")
            if os.path.exists(path):
                with np.load(path) as z:
                    return {k: z[k] for k in z.files}
        sample = self._load(index)
        if self.packed:
            sample = pack_sample(sample)
        if self.cache == "memory":
            self._mem_cache[index] = sample
        elif self.cache:
            np.savez(os.path.join(self.cache, f"{index}.npz"), **sample)
        return sample

    def _load(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.config
        route, seq = self.frames[index]
        # a fresh, unseeded generator per read, as the JAX reader draws
        # (dataset.py:149 there)
        rng = random.Random()

        degree = 0.0
        do_augment = self.augment and rng.random() > cfg.train.inv_augment_prob
        if do_augment:
            degree = (rng.random() * 2.0 - 1.0) * cfg.train.aug_max_rotation
        rad = np.deg2rad(degree)
        crop_shift = degree / 60.0 * cfg.sensors.img_width / cfg.sensors.scale

        measurements = _load_json(f"{route}/measurements/{seq:04d}.json")
        label_seq = [
            _load_json(f"{route}/label_raw/{seq + i:04d}.json")
            for i in range(self.seq_len + self.pred_len)
        ]

        rgb = _imread_rgb(f"{route}/rgb/{seq:04d}.png")
        rgb = decoders.crop_image(rgb, cfg.sensors.img_resolution, crop_shift)

        # LiDAR -> histogram. Stored .npy is [meta, points]; points xyzi with
        # negated y (data.py:158-163).
        raw = np.load(f"{route}/lidar/{seq:04d}.npy", allow_pickle=True)[1]
        lidar_pts = raw.astype(np.float32)
        lidar_pts[:, 1] *= -1.0
        aligned = lidar_np.align_lidar(
            lidar_pts, measurements["ego_matrix"], measurements["ego_matrix"],
            degree=degree)
        lidar_hist = lidar_np.lidar_to_histogram(
            aligned, grid=cfg.sensors.lidar_resolution_width)

        # Bit-packed topdown BEV
        packed = _imread_rgb(f"{route}/topdown/encoded_{seq:04d}.png")
        road_lane = decoders.decode_bev_channels(packed)
        bev = decoders.crop_and_encode_bev(road_lane, degree)
        bev_hw = (cfg.bev.bev_resolution_height,
                  cfg.bev.bev_resolution_width)
        if bev.shape[:2] != bev_hw:
            # small-shape configs train at reduced BEV label resolution
            bev = decoders.resize_nearest(bev, bev_hw)

        sample: Dict[str, np.ndarray] = {
            "rgb": rgb.astype(np.float32),
            "lidar": lidar_hist,
            "bev": bev,
        }

        if cfg.model.multitask:
            depth_rgb = _imread_rgb(f"{route}/depth/{seq:04d}.png")
            depth_rgb = decoders.crop_image(
                depth_rgb, cfg.sensors.img_resolution, crop_shift)
            sample["depth"] = decoders.decode_depth(depth_rgb)

            seg = png.read(f"{route}/semantics/{seq:04d}.png")
            seg = decoders.crop_image(
                seg[..., None] if seg.ndim == 2 else seg,
                cfg.sensors.img_resolution, crop_shift)
            seg = seg[..., 0] if seg.ndim == 3 else seg
            sample["semantic"] = decoders.convert_semantics(seg).astype(
                np.int32)

        # Labels + waypoints
        label, _ = decoders.parse_box_labels(
            label_seq[0][1:],  # skip ego record 0
            rad=-rad, max_boxes=cfg.model.centernet.max_label_boxes)
        sample["label"] = label
        sample["ego_waypoint"] = decoders.ego_waypoints_from_labels(
            label_seq, self.pred_len, aug_rad=rad)

        # Target point (+ raster)
        tp = decoders.local_command_point(
            measurements["x"], measurements["y"], measurements["theta"] + rad,
            measurements["x_command"], measurements["y_command"])
        sample["target_point"] = tp
        sample["target_point_image"] = decoders.rasterize_target_point(
            tp, size=cfg.sensors.lidar_resolution_width)
        sample["speed"] = np.float32(measurements["speed"])

        if cfg.model.backbone == "geometric_fusion":
            # int32 cell indices; packing and the caches pass them through
            bev_pts, cam_pts = lidar_cam_correspondences(
                raw.astype(np.float64)[:, :3])
            sample["bev_points"] = bev_pts
            sample["cam_points"] = cam_pts

        if cfg.model.point_pillars.use_point_pillars:
            mx = cfg.model.point_pillars.max_lidar_points
            fixed = np.zeros((mx, 4), np.float32)
            n = min(mx, aligned.shape[0])
            fixed[:n] = aligned[:n, :4]
            sample["lidar_raw"] = fixed
            sample["num_points"] = np.int32(n)

        return sample


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key in samples[0]:
        out[key] = np.stack([s[key] for s in samples], axis=0)
    return out
