"""(Copy of transfuser_tpu/harness/events.py.)

Traffic event vocabulary shared by criteria and scoring.

Reference: srunner/scenariomanager/traffic_events.py (enum) — the event
types are the contract between criteria (§2.8) and the statistics engine.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class TrafficEventType(enum.Enum):
    NORMAL_DRIVING = 0
    COLLISION_STATIC = 1
    COLLISION_VEHICLE = 2
    COLLISION_PEDESTRIAN = 3
    ROUTE_DEVIATION = 4
    ROUTE_COMPLETION = 5
    ROUTE_COMPLETED = 6
    TRAFFIC_LIGHT_INFRACTION = 7
    WRONG_WAY_INFRACTION = 8
    ON_SIDEWALK_INFRACTION = 9
    STOP_INFRACTION = 10
    OUTSIDE_LANE_INFRACTION = 11
    OUTSIDE_ROUTE_LANES_INFRACTION = 12
    VEHICLE_BLOCKED = 13


@dataclass
class TrafficEvent:
    event_type: TrafficEventType
    message: str = ""
    dictionary: Dict[str, Any] = field(default_factory=dict)

    def get_type(self) -> TrafficEventType:
        return self.event_type

    def get_message(self) -> str:
        return self.message

    def get_dict(self) -> Dict[str, Any]:
        return self.dictionary
