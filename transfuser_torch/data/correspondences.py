"""(Copy of transfuser_tpu/data/correspondences.py, kept so the port never
imports the JAX package.)

LiDAR<->camera correspondence sampling for geometric fusion.

Behavioral spec (reference data.py:632-842): pinhole-project the raw point
cloud into the three 60-degree cameras folded into one 160x704 strip, bin
the surviving (bev_pixel, cam_pixel) pairs at 1/32 scale, and keep up to 5
samples per cell in each direction.

Output layout (consumed by models/geometric_fusion.py; every entry is a
/32-scale cell index below 22, so the agent ships them as uint8):
  bev_points (8, 8, 5, 2)  int32 (x, y) into the (5, 22) image anchor grid
  cam_points (5, 22, 5, 2) int32 (x, y) into the (8, 8) lidar anchor grid

Vectorized numpy (the reference uses per-point Python loops + object
arrays); sampling uses a seeded RNG for reproducibility.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PIXELS_PER_METER = 8
LIDAR_WH = 256
IMG_W = 352           # single-camera strip width at network scale
IMG_H = 160
FOV_W_DEG = 60.0
DOWNSCALE = 32
SAMPLES_PER_CELL = 5
CAM_Z, LIDAR_Z = 2.3, 2.5


def _pinhole(points: np.ndarray, focal_x: float, focal_y: float
             ) -> np.ndarray:
    z = points[:, 1]
    x = (focal_x * points[:, 0]) / z + IMG_W / 2.0
    y = (focal_y * points[:, 2]) / z + IMG_H / 2.0
    return np.stack([x, y], axis=1)


def _rot_z(deg: float) -> np.ndarray:
    t = np.radians(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def project_correspondence_pairs(world: np.ndarray
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Full-resolution (bev_px, cam_px) pairs of the surviving points.

    world: (N, 3) raw CARLA-frame points (x left, y forward, z up).
    Returns (bev_xy (M, 2) int64 into the 256px BEV, cam_xy (M, 2) int64
    into the 160x704 image strip) — the `valid_bev_points` /
    `valid_cam_points` of the reference (data.py:806-822), golden-tested
    against it in tests/test_correspondences_golden.py (the JAX package's
    copy).
    """
    half_x = (LIDAR_WH / PIXELS_PER_METER) / 2.0   # 16 m to each side
    max_y = LIDAR_WH / PIXELS_PER_METER            # 32 m ahead
    # range-filter BEFORE the float64 copy: real clouds are mostly outside
    # the 32 m box.
    keep = (np.abs(world[:, 0]) < half_x) & (world[:, 1] < max_y) \
        & (world[:, 1] > 0)
    pts = world[keep, :3].astype(np.float64)
    pts[:, 0] *= -1.0  # x now points right
    pts[:, 2] += LIDAR_Z - CAM_Z

    fov_h = 2.0 * np.arctan((IMG_H / IMG_W)
                            * np.tan(0.5 * np.radians(FOV_W_DEG)))
    focal_x = IMG_W / (2.0 * np.tan(np.radians(FOV_W_DEG) / 2.0))
    focal_y = IMG_H / (2.0 * np.tan(fov_h / 2.0))

    idx = np.arange(pts.shape[0])
    strips = []
    for rot, half in ((0.0, "center"), (-60.0, "left"), (60.0, "right")):
        p = pts if rot == 0.0 else (_rot_z(rot) @ pts.T).T
        uv = _pinhole(p, focal_x, focal_y)
        ok = (uv[:, 0] > 0) & (uv[:, 0] < IMG_W) & \
             (uv[:, 1] > 0) & (uv[:, 1] < IMG_H)
        u, v, ids = uv[ok, 0], uv[ok, 1], idx[ok]
        if half == "center":
            u = u + IMG_W / 2.0
        elif half == "left":
            m = u >= IMG_W / 2.0
            u, v, ids = u[m] - IMG_W / 2.0, v[m], ids[m]
        else:
            m = u < IMG_W / 2.0
            u, v, ids = u[m] + IMG_W / 2.0 + IMG_W, v[m], ids[m]
        strips.append(np.stack([u, v, ids], axis=1))
    total = np.concatenate(strips, axis=0)

    # BEV pixel of each surviving point; strip y flipped to top-left origin.
    pid = total[:, 2].astype(np.int64)
    bev_x = ((pts[pid, 0] + half_x) * PIXELS_PER_METER).astype(np.int64)
    bev_y = -(((pts[pid, 1] * PIXELS_PER_METER).astype(np.int64))
              - (LIDAR_WH - 1))
    img_x = total[:, 0].astype(np.int64)
    img_y = -(total[:, 1].astype(np.int64) - (IMG_H - 1))
    return (np.stack([bev_x, bev_y], axis=1),
            np.stack([img_x, img_y], axis=1))


def lidar_cam_correspondences(world: np.ndarray, seed: int = 0
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """world: (N, 3) raw CARLA-frame points (x left, y forward, z up)."""
    rng = np.random.default_rng(seed)
    bev_xy, cam_xy = project_correspondence_pairs(world)
    bev_x, bev_y = bev_xy[:, 0], bev_xy[:, 1]
    img_x, img_y = cam_xy[:, 0], cam_xy[:, 1]

    # Bin at 1/32 scale.
    lidar_cells = LIDAR_WH // DOWNSCALE                    # 8
    cam_cells_x = (IMG_W // DOWNSCALE) * 2                 # 22
    cam_cells_y = IMG_H // DOWNSCALE                       # 5
    b_cx = np.clip(bev_x // DOWNSCALE, 0, lidar_cells - 1)
    b_cy = np.clip(bev_y // DOWNSCALE, 0, lidar_cells - 1)
    c_cx = np.clip(img_x // DOWNSCALE, 0, cam_cells_x - 1)
    c_cy = np.clip(img_y // DOWNSCALE, 0, cam_cells_y - 1)

    bev_points = np.zeros((lidar_cells, lidar_cells, SAMPLES_PER_CELL, 2),
                          np.int32)
    cam_points = np.zeros((cam_cells_y, cam_cells_x, SAMPLES_PER_CELL, 2),
                          np.int32)

    def fill(points_out, cell_y, cell_x, val_x, val_y, ny, nx):
        # One global shuffle, then the first SAMPLES_PER_CELL entries of
        # each cell's run = a uniform without-replacement sample per cell
        # (vectorized, instead of a per-cell rng.choice loop).
        cell_id = cell_y * nx + cell_x
        perm = rng.permutation(cell_id.shape[0])
        order = np.argsort(cell_id[perm], kind="stable")
        src = perm[order]
        cid = cell_id[src]
        vx, vy = val_x[src], val_y[src]
        starts = np.searchsorted(cid, np.arange(ny * nx), side="left")
        counts = np.searchsorted(cid, np.arange(ny * nx),
                                 side="right") - starts
        for k in range(SAMPLES_PER_CELL):
            cells = np.nonzero(counts > k)[0]
            if cells.size == 0:
                break
            at = starts[cells] + k
            cy, cx = np.divmod(cells, nx)
            points_out[cy, cx, k, 0] = vx[at]
            points_out[cy, cx, k, 1] = vy[at]

    # image-cell coords stored per bev cell (and vice versa), at /32 scale.
    fill(bev_points, b_cy, b_cx, c_cx, c_cy, lidar_cells, lidar_cells)
    fill(cam_points, c_cy, c_cx, b_cx, b_cy, cam_cells_y, cam_cells_x)
    return bev_points, cam_points
