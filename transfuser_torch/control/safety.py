"""(Copy of transfuser_tpu/control/safety.py: the LiDAR safety box and the
predicted-box check.)

Reference: submission_agent.py:341-390 (lidar safety box emergency stop)
and submission_agent.py:396-430 (latentTF bb_detected_in_front_of_vehicle
with the SAT OBB test, in pure numpy via geometry.obb_intersect).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..config import ControllerConfig
from ..geometry import obb_corners, obb_intersect


def num_points_in_safety_box(lidar_points: np.ndarray,
                             config: ControllerConfig) -> int:
    """Count raw LiDAR returns inside the emergency-stop box
    (submission_agent.py:347-360; box bounds config.py:160-168).

    lidar_points: (N, 3+) in the ego lidar frame (x right, y forward after
    the agent's preprocessing — bounds follow the reference convention).
    """
    p = lidar_points
    m = (p[:, 0] > config.safety_box_x_min) & (p[:, 0] < config.safety_box_x_max) \
        & (p[:, 1] > config.safety_box_y_min) & (p[:, 1] < config.safety_box_y_max) \
        & (p[:, 2] > config.safety_box_z_min) & (p[:, 2] < config.safety_box_z_max)
    return int(m.sum())


def bb_yaw(box_corners: np.ndarray) -> float:
    """Yaw of a detected box from its corner layout
    (submission_agent.py:478-486): corners rows 0..3, center row 4."""
    center_top = 0.5 * (box_corners[3] - box_corners[2]) + box_corners[2]
    vector_top = center_top - box_corners[4]
    return float(np.arctan2(vector_top[1], vector_top[0]))


def bb_detected_in_front_of_vehicle(
        detections: Sequence[np.ndarray], ego_speed: float,
        config: ControllerConfig) -> bool:
    """Predicted-box frontal collision check (latentTF safety,
    submission_agent.py:396-430). detections: list of (6, 2+) corner arrays
    in the ego metric frame."""
    if len(detections) < 1:
        return False
    # Emergency braking distance ("Bremsweg") heuristic.
    bremsweg = ((ego_speed * 3.6) / 10.0) ** 2 / 2.0
    safety_x = float(np.clip(bremsweg + 1.0, 2.0, 4.0))
    ego_corners = obb_corners(
        np.array([safety_x, 0.0]),
        np.array([config.ego_extent_x, config.ego_extent_y]), 0.0)

    for box in detections:
        yaw = bb_yaw(box)
        ext_x = 0.5 * np.linalg.norm(box[3, :2] - box[0, :2])
        ext_y = 0.5 * np.linalg.norm(box[0, :2] - box[1, :2])
        corners = obb_corners(box[4, :2], np.array([ext_x, ext_y]), yaw)
        if obb_intersect(ego_corners, corners):
            return True
    return False
