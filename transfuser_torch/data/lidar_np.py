"""(Copy of transfuser_tpu/data/lidar_np.py; its native path is the port's
own library, transfuser_torch/native/.)

Host-side LiDAR preprocessing: ego-motion alignment + BEV histogram.

Behavioral spec (reference data.py:411-470): grid 256x256 at 8 px/m over
x in [-16, 16], y in [-32, 0]; two height slices split at z = -2.3; counts
clipped at 5 hits/cell and normalized; final rot90(k=-1).
"""

from __future__ import annotations

import numpy as np

from .. import geometry

PIXELS_PER_METER = 8
HIST_MAX_PER_PIXEL = 5
X_METERS_MAX = 16.0
Y_METERS_MAX = 32.0
Z_SPLIT = -2.3
GRID = 32 * PIXELS_PER_METER  # 256


def align_lidar(lidar: np.ndarray, ego_matrix_from: np.ndarray,
                ego_matrix_to: np.ndarray, degree: float = 0.0) -> np.ndarray:
    """Transform points from frame of `ego_matrix_from` into the lidar frame
    at `ego_matrix_to`, with optional rotation augmentation (data.py:411-443).

    lidar: (N, 4) xyzi with the dataset's negated-y convention.
    """
    t_l2v = geometry.lidar_to_vehicle()
    t_v2l = geometry.vehicle_to_lidar()
    m0 = np.asarray(ego_matrix_from, dtype=np.float64)
    m1 = np.asarray(ego_matrix_to, dtype=np.float64)
    transform = t_v2l @ np.linalg.inv(m1) @ m0 @ t_l2v

    rad = np.deg2rad(degree)
    c, s = np.cos(rad), np.sin(rad)
    aug = np.array([[c, s, 0, 0], [-s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    transform = aug @ transform

    pts = lidar.astype(np.float64).copy()
    pts[:, 3] = 1.0
    pts[:, 1] *= -1.0  # dataset convention -> carla frame
    out = (transform @ pts.T).T
    out[:, 3] = lidar[:, 3]
    out[:, 1] *= -1.0  # back to dataset convention
    return out.astype(lidar.dtype) if lidar.dtype != np.float64 else out


def lidar_to_histogram(lidar: np.ndarray, use_native: bool = True,
                       grid: int = GRID) -> np.ndarray:
    """(N, 3+) points -> (grid, grid, 2) normalized two-slice histogram,
    NHWC channel order [above, below] matching the reference's channel
    stack. The metric window is fixed (32 m x 32 m); grid != 256 scales
    pixels-per-meter accordingly (used by small-shape test configs).

    At grid 256 it runs in the native library (native/fastloader.cpp),
    which returns the numpy result exactly. The JAX package's rule also
    asks for a fourth column, as its C reads rows of four floats; this
    one reads rows of any width, so the agent's (N, 3) cloud takes it too.
    ``use_native=False`` keeps the numpy path."""
    if use_native and grid == GRID:
        from .. import native
        return native.lidar_histogram(lidar)

    def splat(points: np.ndarray) -> np.ndarray:
        xbins = np.linspace(-X_METERS_MAX, X_METERS_MAX, grid + 1)
        ybins = np.linspace(-Y_METERS_MAX, 0.0, grid + 1)
        hist, _, _ = np.histogram2d(points[:, 0], points[:, 1],
                                    bins=(xbins, ybins))
        hist = np.minimum(hist, HIST_MAX_PER_PIXEL)
        return hist / HIST_MAX_PER_PIXEL

    below = lidar[lidar[:, 2] <= Z_SPLIT]
    above = lidar[lidar[:, 2] > Z_SPLIT]
    feat = np.stack([splat(above), splat(below)], axis=0)  # (2, X, Y)
    feat = np.rot90(feat, k=-1, axes=(1, 2))
    return np.ascontiguousarray(
        np.transpose(feat, (1, 2, 0)).astype(np.float32))
