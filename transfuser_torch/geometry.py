"""(Copy of transfuser_tpu/geometry.py: the parts the agents and the data
reader use.)

Shared geometry: rig transforms, angles, OBBs, convex IoU, bicycle model.

Pure numpy (host-side). Formulas match the reference exactly:
  * lidar<->vehicle<->BEV-image transforms: team_code_transfuser/utils.py:3-37
  * angle normalization: team_code_transfuser/utils.py:39-48
  * OBB/SAT intersection: submission_agent.py:506-537
  * convex polygon IoU for ensemble NMS: submission_agent.py:491-497
  * kinematic bicycle model (World-on-Rails constants):
    submission_agent.py:663-701 / autopilot.py:1152-1190
"""

from __future__ import annotations

import math

import numpy as np

# --------------------------------------------------------------------------
# Static rig transforms


def virtual_lidar_to_vehicle() -> np.ndarray:
    """Translation-only 'virtual lidar' frame (utils.py:3-9)."""
    t = np.eye(4)
    t[0, 3] = 1.3
    t[2, 3] = 2.5
    return t


def vehicle_to_virtual_lidar() -> np.ndarray:
    return np.linalg.inv(virtual_lidar_to_vehicle())


def lidar_to_vehicle() -> np.ndarray:
    """Rotated + translated physical lidar frame (utils.py:14-24)."""
    t = np.eye(4)
    t[:3, :3] = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], dtype=np.float64)
    t[0, 3] = 1.3
    t[2, 3] = 2.5
    return t


def vehicle_to_lidar() -> np.ndarray:
    return np.linalg.inv(lidar_to_vehicle())


def lidar_to_bevimage() -> np.ndarray:
    """Metric lidar xy -> 256x256 BEV pixel coords (utils.py:29-37)."""
    t = np.array([[0, -1, 16], [-1, 0, 32], [0, 0, 1]], dtype=np.float32)
    t[:2, :] *= 8.0
    return t


# --------------------------------------------------------------------------
# Angles


def normalize_angle(x: float) -> float:
    """Wrap into [-pi, pi) (utils.py:39-43)."""
    x = x % (2 * np.pi)
    if x > np.pi:
        x -= 2 * np.pi
    return x


def normalize_angle_degree(x: float) -> float:
    x = x % 360.0
    if x > 180.0:
        x -= 360.0
    return x


# --------------------------------------------------------------------------
# Oriented bounding boxes (2D, for safety checks / expert forecasting)


def rotation2d(rad: float) -> np.ndarray:
    c, s = np.cos(rad), np.sin(rad)
    return np.array([[c, -s], [s, c]])


def obb_corners(center: np.ndarray, extent: np.ndarray, yaw: float) -> np.ndarray:
    """4 corner points of an oriented box. center (2,), extent (2,) half-sizes."""
    r = rotation2d(yaw)
    signs = np.array([[1, 1], [1, -1], [-1, -1], [-1, 1]], dtype=np.float64)
    return center[None, :] + (signs * extent[None, :]) @ r.T


def _project_polygon(axis: np.ndarray, poly: np.ndarray) -> tuple:
    d = poly @ axis
    return d.min(), d.max()


def obb_intersect(corners_a: np.ndarray, corners_b: np.ndarray) -> bool:
    """Separating-axis test for two convex quads (submission_agent.py:506-537)."""
    for poly in (corners_a, corners_b):
        for i in range(4):
            edge = poly[(i + 1) % 4] - poly[i]
            axis = np.array([-edge[1], edge[0]])
            n = np.linalg.norm(axis)
            if n < 1e-12:
                continue
            axis = axis / n
            min_a, max_a = _project_polygon(axis, corners_a)
            min_b, max_b = _project_polygon(axis, corners_b)
            if max_a < min_b or max_b < min_a:
                return False
    return True


# --------------------------------------------------------------------------
# Convex polygons (ensemble NMS)


def polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman convex clipping; both ccw convex polygons."""
    output = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        edge = b - a
        input_list, output = output, []
        if not input_list:
            break
        s = input_list[-1]
        for e in input_list:
            e_side = np.cross(edge, e - a)
            s_side = np.cross(edge, s - a)
            if e_side >= 0:
                if s_side < 0:
                    t = s_side / (s_side - e_side)
                    output.append(s + t * (e - s))
                output.append(e)
            elif s_side >= 0:
                t = s_side / (s_side - e_side)
                output.append(s + t * (e - s))
            s = e
    return np.array(output) if output else np.zeros((0, 2))


def _ccw(poly: np.ndarray) -> np.ndarray:
    x, y = poly[:, 0], poly[:, 1]
    signed = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))
    return poly if signed > 0 else poly[::-1]


def convex_iou(poly_a: np.ndarray, poly_b: np.ndarray) -> float:
    """Exact IoU of two convex polygons (replaces shapely in ensemble NMS,
    reference submission_agent.py:491-497)."""
    pa, pb = _ccw(poly_a), _ccw(poly_b)
    inter = _clip_polygon(pa, pb)
    if inter.shape[0] < 3:
        return 0.0
    ai = polygon_area(inter)
    union = polygon_area(pa) + polygon_area(pb) - ai
    if union <= 0:
        return 0.0
    return float(ai / union)


# --------------------------------------------------------------------------
# Kinematic bicycle model


class EgoModel:
    """World-on-Rails tuned kinematic bicycle model
    (reference submission_agent.py:663-701)."""

    def __init__(self, dt: float = 1.0 / 4.0):
        self.dt = dt
        # Tuned parameters from World-on-Rails.
        self.front_wb = -0.090769015
        self.rear_wb = 1.4178275
        self.steer_gain = 0.36848336
        self.brake_accel = -4.952399
        self.throt_accel = 0.5633837
        self._beta_gain = self.rear_wb / (self.front_wb + self.rear_wb)

    def forward(self, locs: np.ndarray, yaws: np.ndarray, spds: np.ndarray,
                acts: np.ndarray):
        """One step. locs (...,2), yaws (...,1), spds (...,1),
        acts (...,3) = [steer, throttle, brake(0/1)]."""
        steer = acts[..., 0:1]
        throt = acts[..., 1:2]
        brake = acts[..., 2:3].astype(np.uint8)

        wheel = self.steer_gain * steer
        beta = np.arctan(self._beta_gain * np.tan(wheel))
        yaws = np.asarray(yaws, dtype=np.float64)
        next_locs = locs + spds * np.concatenate(
            [np.cos(yaws + beta), np.sin(yaws + beta)], -1) * self.dt
        next_yaws = yaws + spds / self.rear_wb * np.sin(beta) * self.dt
        accel = np.where(brake != 0, self.brake_accel,
                         self.throt_accel * throt)
        next_spds = spds + accel * self.dt
        next_spds = next_spds * (next_spds > 0.0)
        return next_locs, next_yaws, next_spds

    def forward_scalar(self, x: float, y: float, yaw: float, spd: float,
                       steer: float, throt: float, brake: float):
        """Scalar twin of forward() (same float64 math, ~10x less
        overhead) for the sequential single-vehicle forecast loops —
        forward() ran 1.5M times per benchmark route, mostly on
        (1,)-shaped arrays. Returns (x, y, yaw, spd)."""
        wheel = self.steer_gain * steer
        beta = math.atan(self._beta_gain * math.tan(wheel))
        nx = x + spd * math.cos(yaw + beta) * self.dt
        ny = y + spd * math.sin(yaw + beta) * self.dt
        nyaw = yaw + spd / self.rear_wb * math.sin(beta) * self.dt
        accel = self.brake_accel if int(brake) else self.throt_accel * throt
        nspd = spd + accel * self.dt
        return nx, ny, nyaw, (nspd if nspd > 0.0 else 0.0)
