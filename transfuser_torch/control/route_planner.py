"""(Copy of transfuser_tpu/control/route_planner.py.)

GPS-space route planner with min/max-distance pop window.

Reference: submission_agent.py:604-660 (agent variant) and
team_code_autopilot/nav_planner.py:96-188 (expert variant with precomputed
leg distances). CARLA 0.9.10 lat/lon scale constants.
"""

from __future__ import annotations

import math
from collections import deque
from itertools import islice
from typing import Deque, List, Tuple

import numpy as np

GPS_CARLA_SCALE = np.array([111324.60662786, 111319.490945])


class RoutePlanner:
    def __init__(self, min_distance: float, max_distance: float):
        self.route: Deque[Tuple[np.ndarray, object]] = deque()
        self.saved_route: Deque = deque()
        # Parallel (x, y) python-float view of self.route, popped in
        # lockstep: run_step's scan runs once per expert forecast step
        # (~400k/route) and float(ndarray[i]) conversions dominated it.
        self._xy: Deque[Tuple[float, float]] = deque()
        self._saved_xy: Deque = deque()
        self.min_distance = min_distance
        self.max_distance = max_distance
        self.is_last = False
        self.mean = np.array([0.0, 0.0])
        self.scale = GPS_CARLA_SCALE.copy()

    def set_route(self, global_plan: List[Tuple[object, object]],
                  gps: bool = False) -> None:
        self.route.clear()
        self._xy.clear()
        for pos, cmd in global_plan:
            if gps:
                pos = np.array([pos["lat"], pos["lon"]])
                pos = (pos - self.mean) * self.scale
            else:
                # pos is a transform-like with .location.x/.y
                pos = np.array([pos.location.x, pos.location.y]) - self.mean
            self.route.append((pos, cmd))
            self._xy.append((float(pos[0]), float(pos[1])))

    def run_step(self, gps: np.ndarray) -> Deque:
        """Pop waypoints the vehicle has passed; returns the active route.

        Same per-waypoint scan as the reference (submission_agent.py:
        628-646) — early break once the cumulative arclength passes
        max_distance — but with scalar math.hypot instead of
        np.linalg.norm on 2-vectors: this loop runs 20+ times per expert
        tick (once per forecast step) and the tiny-array numpy overhead
        dominated it."""
        if len(self.route) <= 2:
            self.is_last = True
            return self.route

        gx, gy = float(gps[0]), float(gps[1])
        to_pop = 0
        farthest_in_range = -math.inf
        cumulative_distance = 0.0
        max_distance = self.max_distance
        min_distance = self.min_distance
        px, py = self._xy[0]
        for i, (x, y) in enumerate(islice(self._xy, 1, None), 1):
            if cumulative_distance > max_distance:
                break
            cumulative_distance += math.hypot(x - px, y - py)
            px, py = x, y
            distance = math.hypot(x - gx, y - gy)
            if distance <= min_distance \
                    and distance > farthest_in_range:
                farthest_in_range = distance
                to_pop = i

        for _ in range(to_pop):
            if len(self.route) > 2:
                self.route.popleft()
                self._xy.popleft()
        return self.route

    def save(self) -> None:
        # Entries are immutable (ndarray, RoadOption) tuples and the
        # arrays are never written in place (set_route builds fresh ones,
        # run_step only pops) — a C-speed shallow deque copy is therefore
        # equivalent to the reference's deepcopy (nav_planner.py save/
        # load), which was 33% of expert-benchmark wall-clock.
        self.saved_route = deque(self.route)
        self._saved_xy = deque(self._xy)

    def load(self) -> None:
        # Copy again so pops on the restored route never mutate the
        # saved snapshot (deepcopy semantics, both directions).
        self.route = deque(self.saved_route)
        self._xy = deque(self._saved_xy)
        self.is_last = False
