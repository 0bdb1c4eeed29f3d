"""(Copy of transfuser_tpu/harness/statistics.py.)

Driving-score statistics engine with resumable JSON checkpoints.

Behavioral spec (reference statistics_manager_local.py): per-route
score_penalty = product of infraction penalties (pedestrian 0.50 /
vehicle 0.60 / static 0.65 / red-light 0.70 / stop 1.00 in the Longest6
local fork vs 0.80 upstream), outside-lanes multiplies by
(1 - percentage/100); score_composed = route_completion x penalty. Global
record averages scores over routes and normalizes infraction counts per
driven km. The results JSON doubles as the resume checkpoint.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from .events import TrafficEvent, TrafficEventType

PENALTIES = {
    TrafficEventType.COLLISION_PEDESTRIAN: 0.50,
    TrafficEventType.COLLISION_VEHICLE: 0.60,
    TrafficEventType.COLLISION_STATIC: 0.65,
    TrafficEventType.TRAFFIC_LIGHT_INFRACTION: 0.70,
    TrafficEventType.STOP_INFRACTION: 1.00,  # local fork; upstream 0.80
}

INFRACTION_KEYS = (
    "collisions_pedestrian", "collisions_vehicle", "collisions_layout",
    "red_light", "stop_infraction", "outside_route_lanes", "route_dev",
    "route_timeout", "vehicle_blocked",
)

_EVENT_TO_KEY = {
    TrafficEventType.COLLISION_PEDESTRIAN: "collisions_pedestrian",
    TrafficEventType.COLLISION_VEHICLE: "collisions_vehicle",
    TrafficEventType.COLLISION_STATIC: "collisions_layout",
    TrafficEventType.TRAFFIC_LIGHT_INFRACTION: "red_light",
    TrafficEventType.STOP_INFRACTION: "stop_infraction",
    TrafficEventType.OUTSIDE_ROUTE_LANES_INFRACTION: "outside_route_lanes",
    TrafficEventType.ROUTE_DEVIATION: "route_dev",
    TrafficEventType.VEHICLE_BLOCKED: "vehicle_blocked",
}

RESULT_LABELS = [
    "Avg. driving score", "Avg. route completion", "Avg. infraction penalty",
    "Collisions with pedestrians", "Collisions with vehicles",
    "Collisions with layout", "Red lights infractions",
    "Stop sign infractions", "Off-road infractions", "Route deviations",
    "Route timeouts", "Agent blocked",
]


def default_checkpoint() -> Dict[str, Any]:
    return {
        "sensors": [],
        "values": [],
        "labels": [],
        "entry_status": "Started",
        "eligible": False,
        "_checkpoint": {"progress": [], "records": [], "global_record": {}},
    }


@dataclass
class RouteRecord:
    route_id: Optional[str] = None
    index: Optional[int] = None
    status: str = "Started"
    infractions: Dict[str, Any] = field(
        default_factory=lambda: {k: [] for k in INFRACTION_KEYS})
    scores: Dict[str, float] = field(default_factory=lambda: {
        "score_route": 0.0, "score_penalty": 0.0, "score_composed": 0.0})
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"route_id": self.route_id, "index": self.index,
                "status": self.status, "infractions": self.infractions,
                "scores": self.scores, "meta": self.meta}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RouteRecord":
        r = RouteRecord()
        for k, v in d.items():
            setattr(r, k, v)
        return r


def route_length(trajectory: Sequence) -> float:
    total = 0.0
    prev = None
    for loc in trajectory:
        if hasattr(loc, "location"):  # Transform
            loc = loc.location
        if hasattr(loc, "x"):
            p = (loc.x, loc.y, getattr(loc, "z", 0.0))
        else:
            p = tuple(loc[:3]) if len(loc) >= 3 else (loc[0], loc[1], 0.0)
        if prev is not None:
            total += math.dist(p, prev)
        prev = p
    return total


class StatisticsEngine:
    def __init__(self) -> None:
        self.records: List[RouteRecord] = []

    # ------------------------------------------------------------- lifecycle
    def resume(self, endpoint: str) -> None:
        data = load_checkpoint(endpoint)
        if data:
            for rec in data.get("_checkpoint", {}).get("records", []):
                self.records.append(RouteRecord.from_dict(rec))

    def set_route(self, route_id: str, index: int) -> None:
        record = RouteRecord(route_id=route_id, index=index)
        if index < len(self.records):
            self.records[index] = record
        else:
            self.records.append(record)

    # --------------------------------------------------------------- scoring
    def compute_route_statistics(self, index: int,
                                 events: Sequence[TrafficEvent],
                                 trajectory: Sequence,
                                 duration_system: float = -1.0,
                                 duration_game: float = -1.0,
                                 timed_out: bool = False,
                                 failure: str = "") -> RouteRecord:
        record = self.records[index]
        record.meta["duration_system"] = duration_system
        record.meta["duration_game"] = duration_game
        record.meta["route_length"] = route_length(trajectory)

        penalty = 1.0
        score_route = 0.0
        target_reached = False
        if timed_out:
            record.infractions["route_timeout"].append("Route timeout.")
            failure = "Agent timed out"

        for event in events:
            etype = event.get_type()
            if etype in PENALTIES:
                penalty *= PENALTIES[etype]
            if etype == TrafficEventType.OUTSIDE_ROUTE_LANES_INFRACTION:
                penalty *= 1.0 - event.get_dict().get("percentage", 0.0) / 100.0
            if etype in _EVENT_TO_KEY:
                record.infractions[_EVENT_TO_KEY[etype]].append(
                    event.get_message())
            if etype == TrafficEventType.ROUTE_DEVIATION:
                failure = "Agent deviated from the route"
            elif etype == TrafficEventType.VEHICLE_BLOCKED:
                failure = "Agent got blocked"
            elif etype == TrafficEventType.ROUTE_COMPLETED:
                score_route = 100.0
                target_reached = True
            elif etype == TrafficEventType.ROUTE_COMPLETION and not target_reached:
                score_route = event.get_dict().get("route_completed", 0.0)

        record.scores["score_route"] = score_route
        record.scores["score_penalty"] = penalty
        record.scores["score_composed"] = max(score_route * penalty, 0.0)
        record.status = "Completed" if target_reached else (
            "Failed" + (f" - {failure}" if failure else ""))
        return record

    def compute_global_statistics(self, total_routes: int) -> RouteRecord:
        g = RouteRecord(route_id="-1", index=-1, status="Completed")
        g.infractions = {k: 0.0 for k in INFRACTION_KEYS}
        for rec in self.records:
            for key in g.scores:
                g.scores[key] += rec.scores[key]
            km = max(rec.scores["score_route"]
                     * rec.meta.get("route_length", 0.0) / 1000.0, 0.001)
            for key in INFRACTION_KEYS:
                g.infractions[key] += len(rec.infractions[key]) / km
            if rec.status != "Completed":
                g.status = "Failed"
                g.meta.setdefault("exceptions", []).append(
                    (rec.route_id, rec.index, rec.status))
        for key in g.scores:
            g.scores[key] /= float(total_routes)
        return g

    # ----------------------------------------------------------- persistence
    def save_record(self, record: RouteRecord, index: int,
                    endpoint: str) -> None:
        data = load_checkpoint(endpoint) or default_checkpoint()
        records = data["_checkpoint"]["records"]
        if index == len(records):
            records.append(record.to_dict())
        elif index < len(records):
            records[index] = record.to_dict()
        else:
            raise IndexError("route record index out of sequence")
        save_checkpoint(endpoint, data)

    def save_global_record(self, global_record: RouteRecord,
                           sensors: List[str], total_routes: int,
                           endpoint: str) -> None:
        data = load_checkpoint(endpoint) or default_checkpoint()
        d = global_record.to_dict()
        data["_checkpoint"]["global_record"] = d
        data["values"] = (
            ["{:.3f}".format(d["scores"][k]) for k in
             ("score_composed", "score_route", "score_penalty")]
            + ["{:.3f}".format(d["infractions"][k]) for k in (
                "collisions_pedestrian", "collisions_vehicle",
                "collisions_layout", "red_light", "stop_infraction",
                "outside_route_lanes", "route_dev", "route_timeout",
                "vehicle_blocked")]
        )
        data["labels"] = list(RESULT_LABELS)

        entry_status, eligible = "Finished", True
        records = data["_checkpoint"]["records"]
        progress = data["_checkpoint"]["progress"]
        if len(records) != total_routes or \
                (progress and progress[0] != progress[1]):
            entry_status, eligible = "Finished with missing data", False
        else:
            for route in records:
                if "Agent" in route["status"]:
                    entry_status = "Finished with agent errors"
                    break
        data["entry_status"] = entry_status
        data["eligible"] = eligible
        save_checkpoint(endpoint, data)

    def save_progress(self, done: int, total: int, endpoint: str) -> None:
        data = load_checkpoint(endpoint) or default_checkpoint()
        data["_checkpoint"]["progress"] = [done, total]
        save_checkpoint(endpoint, data)

    def save_sensors(self, sensors: List[str], endpoint: str) -> None:
        data = load_checkpoint(endpoint) or default_checkpoint()
        if not data.get("sensors"):
            data["sensors"] = sensors
            save_checkpoint(endpoint, data)

    def save_entry_status(self, entry_status: str, eligible: bool,
                          endpoint: str) -> None:
        data = load_checkpoint(endpoint) or default_checkpoint()
        data["entry_status"] = entry_status
        data["eligible"] = eligible
        save_checkpoint(endpoint, data)


def load_checkpoint(endpoint: str) -> Optional[Dict[str, Any]]:
    if not endpoint or not os.path.exists(endpoint):
        return None
    try:
        with open(endpoint) as f:
            text = f.read().strip()
        return json.loads(text) if text else None
    except (json.JSONDecodeError, OSError):
        return None


def save_checkpoint(endpoint: str, data: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(endpoint)), exist_ok=True)
    with open(endpoint, "w") as f:
        json.dump(data, f, indent=2)
