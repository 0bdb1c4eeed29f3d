"""(Copy of transfuser_tpu/control/pid.py.)

PID controller + waypoint-to-control law.

Reference: model.py:517-535 (window-deque PID) and model.py:648-683
(control_pid). Host-side, pure numpy — this runs in the 20 Hz sim loop, not
on the accelerator.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Tuple

import numpy as np

from ..config import ControllerConfig


class PIDController:
    """PID with mean-of-window integral and last-difference derivative."""

    def __init__(self, k_p: float = 1.0, k_i: float = 0.0, k_d: float = 0.0,
                 n: int = 20):
        self.k_p = k_p
        self.k_i = k_i
        self.k_d = k_d
        self.window: deque = deque([0.0] * n, maxlen=n)
        self._saved: deque = deque(self.window, maxlen=n)
        # Running window sum: np.mean over the deque every step was 16 s
        # of a benchmark route (the expert steps 4 PIDs per forecast
        # frame). load() re-derives it exactly (math.fsum), so drift
        # cannot accumulate across the expert's save/load cycles.
        self._sum = 0.0

    def step(self, error: float) -> float:
        w = self.window
        if len(w) == w.maxlen:
            self._sum -= w[0]
        w.append(error)
        self._sum += error
        if len(w) >= 2:
            integral = self._sum / len(w)
            derivative = w[-1] - w[-2]
        else:
            integral = 0.0
            derivative = 0.0
        return self.k_p * error + self.k_i * integral + self.k_d * derivative

    # State save/load used by the expert (nav_planner.py:61-65).
    def save(self) -> None:
        self._saved = deque(self.window, maxlen=self.window.maxlen)

    def load(self) -> None:
        self.window = deque(self._saved, maxlen=self._saved.maxlen)
        self._sum = math.fsum(self.window)


def control_pid(waypoints: np.ndarray, speed: float,
                turn_controller: PIDController,
                speed_controller: PIDController,
                config: ControllerConfig, is_stuck: bool = False,
                lidar_pos_x: float = 1.3) -> Tuple[float, float, bool]:
    """Waypoints (pred_len, 2) in lidar frame -> (steer, throttle, brake)."""
    waypoints = np.asarray(waypoints, dtype=np.float64).copy()
    waypoints[:, 0] += lidar_pos_x  # back to vehicle frame

    desired_speed = float(np.linalg.norm(waypoints[0] - waypoints[1]) * 2.0)
    if is_stuck:
        desired_speed = config.default_speed

    brake = (desired_speed < config.brake_speed) or \
        ((speed / max(desired_speed, 1e-9)) > config.brake_ratio)

    delta = float(np.clip(desired_speed - speed, 0.0, config.clip_delta))
    throttle = speed_controller.step(delta)
    throttle = float(np.clip(throttle, 0.0, config.clip_throttle))
    throttle = 0.0 if brake else throttle

    aim = (waypoints[1] + waypoints[0]) / 2.0
    angle = float(np.degrees(np.arctan2(aim[1], aim[0])) / 90.0)
    if speed < 0.01:
        angle = 0.0  # don't accumulate integral error while standing
    if brake:
        angle = 0.0
    steer = turn_controller.step(angle)
    steer = float(np.clip(steer, -1.0, 1.0))
    return steer, throttle, bool(brake)
