"""(Copy of transfuser_tpu/agents/demo_agents.py: the dummy and NPC agents.)

Demo agents: dummy, NPC (route-following).

Behavioral spec: leaderboard/autoagents/{dummy_agent, npc_agent}.py —
minimal agents exercising the agent API.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..control.pid import PIDController
from ..control.route_planner import RoutePlanner
from ..sim.types import VehicleControl
from .base import AutonomousAgent


class DummyAgent(AutonomousAgent):
    """Applies zero control forever (dummy_agent.py)."""

    def sensors(self) -> List[Dict]:
        return [
            {"type": "sensor.camera.rgb", "x": 0.7, "y": 0.0, "z": 1.6,
             "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "width": 800,
             "height": 600, "fov": 100, "id": "rgb_front"},
            {"type": "sensor.other.gnss", "x": 0.7, "y": -0.4, "z": 1.6,
             "id": "gps"},
            {"type": "sensor.speedometer", "reading_frequency": 20,
             "id": "speed"},
        ]

    def run_step(self, input_data, timestamp) -> VehicleControl:
        return VehicleControl()


class NpcAgent(AutonomousAgent):
    """Follows the route plan with simple P control (npc_agent.py uses
    carla's BasicAgent; this is the sim-agnostic equivalent)."""

    def setup(self, path_to_conf_file="", route_index=None):
        self._planner = RoutePlanner(min_distance=7.5, max_distance=50.0)
        self._turn = PIDController(k_p=1.2, k_i=0.1, k_d=0.2, n=20)
        self._speed_pid = PIDController(k_p=1.0, k_i=0.1, k_d=0.1, n=20)
        self._initialized = False
        self.target_speed = 5.0

    def sensors(self) -> List[Dict]:
        return [
            {"type": "sensor.other.gnss", "x": 0.0, "y": 0.0, "z": 0.0,
             "sensor_tick": 0.01, "id": "gps"},
            {"type": "sensor.other.imu", "x": 0.0, "y": 0.0, "z": 0.0,
             "sensor_tick": 0.05, "id": "imu"},
            {"type": "sensor.speedometer", "reading_frequency": 20,
             "id": "speed"},
        ]

    def run_step(self, input_data, timestamp) -> VehicleControl:
        if not self._initialized:
            self._planner.set_route(self._global_plan, gps=True)
            self._initialized = True
        from ..control.route_planner import GPS_CARLA_SCALE
        pos = np.asarray(input_data["gps"][1][:2]) * GPS_CARLA_SCALE
        compass = float(np.asarray(input_data["imu"][1])[-1])
        speed = float(input_data["speed"][1]["speed"])

        route = self._planner.run_step(pos)
        target = route[1][0] if len(route) > 1 else route[0][0]
        delta = np.asarray(target) - pos
        heading = math.atan2(delta[1], delta[0]) - compass
        heading = (heading + math.pi) % (2 * math.pi) - math.pi
        steer = float(np.clip(self._turn.step(heading / math.pi), -1, 1))
        throttle = float(np.clip(
            self._speed_pid.step(self.target_speed - speed), 0.0, 0.75))
        return VehicleControl(steer=steer, throttle=throttle)
