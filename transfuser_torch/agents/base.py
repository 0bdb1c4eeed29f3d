"""(Copy of transfuser_tpu/agents/base.py; setup() also takes keyword options.)

Autonomous-agent API.

Behavioral spec: leaderboard/autoagents/autonomous_agent.py:29-126 —
setup(), sensors(), run_step(input_data, timestamp) -> VehicleControl,
set_global_plan(); __call__ pulls the sensor barrier then steps the agent.
Keyword options (``device=...``) pass through to ``setup``.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional, Tuple

from ..harness.sensor_interface import SensorInterface
from ..sim.types import VehicleControl


class Track(enum.Enum):
    SENSORS = "SENSORS"
    MAP = "MAP"


class AutonomousAgent:
    def __init__(self, path_to_conf_file: str = "",
                 route_index: Optional[int] = None, **kwargs: Any):
        self.track = Track.SENSORS
        self.sensor_interface = SensorInterface()
        self.wallclock_t0 = None
        self._global_plan: Optional[List[Tuple[dict, Any]]] = None
        self._global_plan_world_coord: Optional[List[Tuple[Any, Any]]] = None
        self.setup(path_to_conf_file, route_index, **kwargs)

    # ------------------------------------------------------------ overrides
    def setup(self, path_to_conf_file: str,
              route_index: Optional[int] = None, **kwargs: Any) -> None:
        pass

    def sensors(self) -> List[Dict[str, Any]]:
        """List of sensor specs: dicts with type/id/x/y/z/... keys
        (autonomous_agent.py:73-92)."""
        return []

    def run_step(self, input_data: Dict[str, Tuple[int, Any]],
                 timestamp: float) -> VehicleControl:
        raise NotImplementedError

    def destroy(self) -> None:
        pass

    # ------------------------------------------------------------- plumbing
    def __call__(self, timestamp: float) -> VehicleControl:
        input_data = self.sensor_interface.get_data()
        control = self.run_step(input_data, timestamp)
        control.manual_gear_shift = False
        return control

    def set_global_plan(self, global_plan_gps, global_plan_world_coord
                        ) -> None:
        """Store the sparse (~50 m) plan (autonomous_agent.py:104-126; the
        evaluator downsamples before calling)."""
        self._global_plan = global_plan_gps
        self._global_plan_world_coord = global_plan_world_coord
