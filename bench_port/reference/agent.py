"""Plain numpy copy of the agent's host side around the model
(``transfuser_torch.agents.hybrid_agent``; reference
team_code_transfuser/submission_agent.py): camera crop, LiDAR histogram,
target-point raster, GPS denoising, route planner, PID control, box decode
to metric corners and the ensemble NMS. Imports nothing of the port.

``Replay`` follows a run of the agent frame by frame. The GPS buffer rolls
forward with the controls that the agent applied, so the replay takes
those controls as given (the program's own state) and recomputes
everything else from the raw sensor frames.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np

GPS_CARLA_SCALE = np.array([111324.60662786, 111319.490945])
HIST_MAX = 5
Z_SPLIT = -2.3


# ----------------------------------------------------------------- inputs

def crop_strip(input_data: Dict, img_width: int, img_hw: Tuple[int, int]
               ) -> np.ndarray:
    """Three cameras centre-cropped to img_width x H, side by side (left,
    front, right), then centre-cropped to the network's width."""
    h, w = img_hw

    def crop(img):
        x0 = img.shape[1] // 2 - img_width // 2
        y0 = img.shape[0] // 2 - h // 2
        return img[y0:y0 + h, x0:x0 + img_width]

    strip = np.concatenate([crop(np.asarray(input_data[c][1])[:, :, :3])
                            for c in ("rgb_left", "rgb_front", "rgb_right")],
                           axis=1)
    x0 = strip.shape[1] // 2 - w // 2
    return strip[:, x0:x0 + w]


def lidar_histogram(points: np.ndarray, grid: int = 256) -> np.ndarray:
    """(N, 3+) points in the agent's frame (y negated) -> (grid, grid, 2)
    hit counts clipped at 5 and over 5, [above, below] the z split;
    32 m x 32 m ahead."""
    def splat(p):
        xb = np.linspace(-16.0, 16.0, grid + 1)
        yb = np.linspace(-32.0, 0.0, grid + 1)
        hist, _, _ = np.histogram2d(p[:, 0], p[:, 1], bins=(xb, yb))
        return np.minimum(hist, HIST_MAX) / HIST_MAX

    below = points[points[:, 2] <= Z_SPLIT]
    above = points[points[:, 2] > Z_SPLIT]
    feat = np.rot90(np.stack([splat(above), splat(below)]), k=-1, axes=(1, 2))
    return np.ascontiguousarray(np.transpose(feat, (1, 2, 0)))


def target_point_raster(tp: np.ndarray, size: int = 256) -> np.ndarray:
    """A filled disc of radius 6 px at the target point."""
    img = np.zeros((size, size), np.float32)
    p = tp.astype(np.float64).copy()
    p[1] += 1.3
    p *= 8.0
    p[1] *= -1
    p[1] = size - p[1]
    p[0] += size // 2
    p = np.clip(p.astype(np.int64), 0, size)
    ys, xs = np.ogrid[:size, :size]
    img[(xs - int(p[0])) ** 2 + (ys - int(p[1])) ** 2 <= 36] = 1.0
    return img[..., None]


# ----------------------------------------------------------------- GPS

class EgoModel:
    """World-on-Rails kinematic bicycle model."""

    def __init__(self, dt):
        self.dt = dt
        self.front_wb = -0.090769015
        self.rear_wb = 1.4178275
        self.steer_gain = 0.36848336
        self.brake_accel = -4.952399
        self.throt_accel = 0.5633837

    def forward(self, locs, yaws, spds, acts):
        steer, throt = acts[..., 0:1], acts[..., 1:2]
        brake = acts[..., 2:3].astype(np.uint8)
        beta = np.arctan(self.rear_wb / (self.front_wb + self.rear_wb)
                         * np.tan(self.steer_gain * steer))
        yaws = np.asarray(yaws, dtype=np.float64)
        return locs + spds * np.concatenate(
            [np.cos(yaws + beta), np.sin(yaws + beta)], -1) * self.dt


class GPSBuffer:
    def __init__(self, maxlen, fps):
        self.buffer = deque(maxlen=maxlen)
        self.ego = EgoModel(1.0 / fps)

    def append(self, gps):
        self.buffer.append(np.asarray(gps, dtype=np.float64))

    def update(self, steer, throttle, brake, theta, speed):
        if not self.buffer:
            return
        locs = np.stack(list(self.buffer))
        temp = np.stack([locs[:, 1], -locs[:, 0]], axis=1)
        nxt = self.ego.forward(temp, np.array([[theta - np.pi / 2.0]]),
                               np.array([[speed]]),
                               np.array([[steer, throttle, float(brake)]]))
        out = np.stack([-nxt[:, 1], nxt[:, 0]], axis=1)
        for i in range(len(self.buffer)):
            self.buffer[i] = out[i]

    def denoised(self):
        return np.mean(self.buffer, axis=0)


class RoutePlanner:
    def __init__(self, min_distance, max_distance, plan):
        self.min_distance = min_distance
        self.max_distance = max_distance
        self.mean = np.array([0.0, 0.0])
        self.scale = GPS_CARLA_SCALE.copy()
        self.route = deque(
            ((np.array([p["lat"], p["lon"]]) - self.mean) * self.scale, cmd)
            for p, cmd in plan)

    def run_step(self, gps):
        if len(self.route) <= 2:
            return self.route
        to_pop, farthest, cumulative = 0, -math.inf, 0.0
        prev = self.route[0][0]
        for i in range(1, len(self.route)):
            if cumulative > self.max_distance:
                break
            pos = self.route[i][0]
            cumulative += math.hypot(pos[0] - prev[0], pos[1] - prev[1])
            prev = pos
            d = math.hypot(pos[0] - gps[0], pos[1] - gps[1])
            if d <= self.min_distance and d > farthest:
                farthest, to_pop = d, i
        for _ in range(to_pop):
            if len(self.route) > 2:
                self.route.popleft()
        return self.route


# ----------------------------------------------------------------- control

class PID:
    def __init__(self, kp, ki, kd, n):
        self.kp, self.ki, self.kd = kp, ki, kd
        self.window = deque([0.0] * n, maxlen=n)

    def step(self, error):
        self.window.append(error)
        integral = float(np.mean(self.window))
        derivative = self.window[-1] - self.window[-2]
        return self.kp * error + self.ki * integral + self.kd * derivative


def control_pid(wp, speed, turn, speed_pid, c, is_stuck, lidar_x):
    """Waypoints (pred_len, 2) in the LiDAR frame -> (steer, throttle,
    brake)."""
    wp = np.asarray(wp, dtype=np.float64).copy()
    wp[:, 0] += lidar_x
    desired = float(np.linalg.norm(wp[0] - wp[1]) * 2.0)
    if is_stuck:
        desired = c.default_speed
    brake = desired < c.brake_speed or speed / max(desired, 1e-9) \
        > c.brake_ratio
    delta = float(np.clip(desired - speed, 0.0, c.clip_delta))
    throttle = float(np.clip(speed_pid.step(delta), 0.0, c.clip_throttle))
    throttle = 0.0 if brake else throttle
    aim = (wp[1] + wp[0]) / 2.0
    angle = float(np.degrees(np.arctan2(aim[1], aim[0])) / 90.0)
    if speed < 0.01 or brake:
        angle = 0.0
    steer = float(np.clip(turn.step(angle), -1.0, 1.0))
    return steer, throttle, bool(brake)


# ----------------------------------------------------------------- boxes

def metric_boxes(boxes: np.ndarray, cfg) -> List[Tuple[np.ndarray, float,
                                                          float]]:
    """(k, 8) image-space boxes -> metric corner tuples above the
    confidence threshold."""
    c = cfg.model.centernet
    ppm = cfg.sensors.pixels_per_meter
    t = np.array([[0, -1, 16], [-1, 0, 32], [0, 0, 1]], dtype=np.float32)
    t[:2, :] *= 8.0
    t_inv = np.linalg.inv(t)
    out = []
    for x, y, w, h, yaw, speed, brake, conf in \
            boxes[boxes[:, 7] > c.bb_confidence_threshold]:
        w = w / c.bounding_box_divisor / ppm
        h = h / c.bounding_box_divisor / ppm
        center = (t_inv @ np.array([x, y, 1.0]))[:2] \
            + np.asarray(cfg.sensors.lidar_pos[:2])
        center[1] *= -1.0
        local = np.array([[-h, -w], [-h, w], [h, w], [h, -w], [0.0, 0.0],
                          [0.0, h * speed * 0.5]])
        cs, sn = np.cos(yaw), np.sin(yaw)
        out.append((local @ np.array([[cs, -sn], [sn, cs]]).T + center,
                    float(brake), float(conf)))
    return out


def _area(p):
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))


def _ccw(p):
    x, y = p[:, 0], p[:, 1]
    s = np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)
    return p if s > 0 else p[::-1]


def convex_iou(a, b):
    a, b = _ccw(a), _ccw(b)
    out = list(a)
    for i in range(len(b)):
        e0, e1 = b[i], b[(i + 1) % len(b)]
        edge = e1 - e0
        inp, out = out, []
        if not inp:
            break
        s = inp[-1]
        for e in inp:
            es, ss = np.cross(edge, e - e0), np.cross(edge, s - e0)
            if es >= 0:
                if ss < 0:
                    out.append(s + ss / (ss - es) * (e - s))
                out.append(e)
            elif ss >= 0:
                out.append(s + ss / (ss - es) * (e - s))
            s = e
    if len(out) < 3:
        return 0.0
    ai = _area(np.array(out))
    union = _area(a) + _area(b) - ai
    return 0.0 if union <= 0 else float(ai / union)


def nms(members: Sequence[Sequence[Tuple[np.ndarray, float, float]]],
        threshold: float) -> List[np.ndarray]:
    flat = [d for m in members for d in m]
    order = list(np.argsort(np.array([d[2] for d in flat], np.float64)))
    kept = []
    while order:
        cur = flat[order.pop()][0]
        kept.append(cur)
        order = [j for j in order
                 if convex_iou(cur[:4, :2], flat[j][0][:4, :2]) <= threshold]
    return kept


# ----------------------------------------------------------------- replay

class Replay:
    """The agent's host loop over the same frames. ``frame(i, data,
    applied)`` returns, on a compute frame, the model inputs (rgb uint8,
    histogram, raster, target point, speed) and a ``control(wps)``
    function that gives the control from the members' waypoints;
    ``applied`` is the control the agent returned, which the GPS buffer
    rolls forward with."""

    def __init__(self, cfg, plan):
        self.cfg = cfg
        c = cfg.controller
        self.gps = GPSBuffer(c.gps_buffer_max_len, c.carla_fps)
        self.route = RoutePlanner(c.route_planner_min_distance,
                                  c.route_planner_max_distance, plan)
        self.turn = PID(c.turn_kp, c.turn_ki, c.turn_kd, c.turn_n)
        self.speed = PID(c.speed_kp, c.speed_ki, c.speed_kd, c.speed_n)
        self.stuck_detector = 0
        self.forced_move = 0

    def _pose(self, data):
        gps = np.asarray(data["gps"][1][:2], np.float64)
        speed = float(data["speed"][1]["speed"])
        compass = float(data["imu"][1][-1])
        compass = 0.0 if math.isnan(compass) else compass
        pos = (gps - self.route.mean) * self.route.scale
        self.gps.append(pos)
        denoised = self.gps.denoised()
        r = self.route.run_step(denoised)
        next_wp = (r[1] if len(r) > 1 else r[0])[0]
        theta = compass + np.pi / 2.0
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]])
        return speed, compass, rot.T @ (np.asarray(next_wp) - denoised)

    def roll(self, applied, compass, speed):
        steer, throttle, brake = applied
        self.gps.update(steer, throttle, brake > 0.5, compass, speed)

    def frame(self, i: int, data: Dict, need_inputs: bool):
        """The frame's pose work; on a compute frame also (inputs or None,
        control function)."""
        cfg = self.cfg
        c = cfg.controller
        speed, compass, tp = self._pose(data)
        if i % c.action_repeat == 1:
            return speed, compass, None
        inputs = None
        if need_inputs:
            s = cfg.sensors
            pts = np.asarray(data["lidar"][1])[:, :3].copy()
            pts[:, 1] *= -1.0
            rgb = crop_strip(data, s.img_width, s.img_resolution)
            hist = np.round(lidar_histogram(pts, s.lidar_resolution_width)
                            * HIST_MAX) / HIST_MAX
            inputs = dict(rgb=np.ascontiguousarray(rgb).astype(np.float32),
                          lidar=hist.astype(np.float32),
                          target_point=tp.astype(np.float32),
                          target_point_image=target_point_raster(
                              tp.astype(np.float32),
                              s.lidar_resolution_width),
                          speed=np.float32(speed))
        is_stuck = False
        if self.stuck_detector > c.stuck_threshold and \
                self.forced_move < c.creep_duration:
            is_stuck = True
            self.forced_move += 1

        def control(pred_wp):
            steer, throttle, brake = control_pid(
                pred_wp, speed, self.turn, self.speed, c, is_stuck,
                cfg.sensors.lidar_pos[0])
            if is_stuck and self.forced_move == 1:
                steer = 0.0
            if brake or is_stuck:
                steer *= c.steer_damping
            if speed < 0.1:
                self.stuck_detector += 1
            elif not is_stuck:
                self.stuck_detector = 0
                self.forced_move = 0
            return steer, throttle, float(brake)

        return speed, compass, (inputs, control)
