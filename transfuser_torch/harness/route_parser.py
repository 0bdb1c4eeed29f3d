"""(Copy of transfuser_tpu/harness/route_parser.py.)

Route XML + scenario JSON parsing, route indexing, interpolation.

Behavioral spec:
  * routes XML (leaderboard/data/longest6/longest6.xml): <route id town>
    with <waypoint x y z pitch yaw roll/> and optional <weather .../>
    (reference utils/route_parser.py:30-121).
  * scenario JSON: {"available_scenarios": [{town: [{"available_event_
    configurations": [{"transform": {...}}], "scenario_type": "ScenarioN"}]}]}
    matched to routes by trigger-point proximity
    (route_parser.py:150-214: dist < TRIGGER_THRESHOLD, yaw within
    TRIGGER_ANGLE_THRESHOLD).
  * RouteIndexer: route x repetition iterator with save/resume
    (utils/route_indexer.py:13-72).
  * interpolation: dense 1 m hops (linear in hermetic mode; a live CARLA
    adapter can substitute road-following interpolation) + 50 m
    downsampling with command-change preservation
    (utils/route_manipulation.py:86-131).
"""

from __future__ import annotations

import enum
import json
import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..sim.types import Location, Rotation, Transform

TRIGGER_THRESHOLD = 2.0
TRIGGER_ANGLE_THRESHOLD = 10.0


class RoadOption(enum.IntEnum):
    """High-level navigation command (mirrors agents.navigation.local_planner)."""

    VOID = -1
    LEFT = 1
    RIGHT = 2
    STRAIGHT = 3
    LANEFOLLOW = 4
    CHANGELANELEFT = 5
    CHANGELANERIGHT = 6


@dataclass
class Weather:
    attrs: Dict[str, float] = field(default_factory=dict)
    id: str = "ClearNoon"


@dataclass
class RouteConfig:
    name: str
    town: str
    index: int
    trajectory: List[Transform]
    weather: Weather = field(default_factory=Weather)
    scenario_configs: List[dict] = field(default_factory=list)
    repetition: int = 0

    @property
    def route_id(self) -> str:
        return self.name


def parse_routes_file(path: str,
                      single_route: Optional[str] = None) -> List[RouteConfig]:
    tree = ET.parse(path)
    configs: List[RouteConfig] = []
    for idx, route in enumerate(tree.iter("route")):
        rid = route.attrib["id"]
        if single_route is not None and rid != single_route:
            continue
        waypoints = []
        for wp in route.iter("waypoint"):
            waypoints.append(Transform(
                Location(float(wp.attrib["x"]), float(wp.attrib["y"]),
                         float(wp.attrib.get("z", 0.0))),
                Rotation(float(wp.attrib.get("pitch", 0.0)),
                         float(wp.attrib.get("yaw", 0.0)),
                         float(wp.attrib.get("roll", 0.0)))))
        weather = Weather()
        welem = route.find("weather")
        if welem is not None:
            weather = Weather(
                attrs={k: float(v) for k, v in welem.attrib.items()
                       if k != "id"},
                id=welem.attrib.get("id", "Custom"))
        configs.append(RouteConfig(name=f"RouteScenario_{rid}",
                                   town=route.attrib["town"], index=idx,
                                   trajectory=waypoints, weather=weather))
    return configs


def load_scenario_annotations(path: Optional[str]) -> Dict[str, List[dict]]:
    if not path:
        return {}
    with open(path) as f:
        data = json.load(f)
    out: Dict[str, List[dict]] = {}
    for block in data.get("available_scenarios", []):
        for town, scenarios in block.items():
            out.setdefault(town, []).extend(scenarios)
    return out


def _angle_close(a: float, b: float, threshold: float) -> bool:
    d = abs((a - b + 180.0) % 360.0 - 180.0)
    return d < threshold


def scan_route_for_scenarios(town: str, trajectory: List[Transform],
                             annotations: Dict[str, List[dict]]
                             ) -> List[dict]:
    """Match scenario trigger transforms against the dense route."""
    matches: List[dict] = []
    town_scenarios = annotations.get(town, [])
    for scenario in town_scenarios:
        stype = scenario.get("scenario_type", "Scenario1")
        for event in scenario.get("available_event_configurations", []):
            t = event["transform"]
            trigger = np.array([float(t["x"]), float(t["y"])])
            yaw = float(t.get("yaw", 0.0))
            for wp in trajectory:
                d = math.hypot(wp.location.x - trigger[0],
                               wp.location.y - trigger[1])
                if d < TRIGGER_THRESHOLD and _angle_close(
                        wp.rotation.yaw, yaw, TRIGGER_ANGLE_THRESHOLD):
                    matches.append({
                        "scenario_type": stype,
                        "trigger_position": Transform(
                            Location(float(t["x"]), float(t["y"]),
                                     float(t.get("z", 0.0))),
                            Rotation(yaw=yaw)),
                        "other_parameters": {
                            k: v for k, v in event.items()
                            if k != "transform"},
                    })
                    break
    return matches


# ------------------------------------------------------------- interpolation

def interpolate_trajectory(trajectory: List[Transform], hop: float = 1.0,
                           town_map=None
                           ) -> List[Tuple[Transform, RoadOption]]:
    """Densify sparse keypoints at ~hop meters.

    With a `town_map`, each keypoint pair is routed ALONG the lane network
    (TownMap.route lane-graph BFS — the hermetic equivalent of the
    reference's GlobalRoutePlanner trace, nav_planner.py:191-285), and
    junction spans are labeled LEFT/RIGHT/STRAIGHT from the signed
    entry->exit yaw delta. Without one: straight-line densification —
    which CUTS CORNERS between keypoints on different roads, so every
    consumer that has a map must pass it (a corner-cutting dense route
    both misleads the expert's waypoint planner and mis-scores
    OutsideRouteLanes)."""
    if town_map is not None:
        return _interpolate_on_map(trajectory, town_map, hop)
    dense: List[Tuple[Transform, RoadOption]] = []
    for a, b in zip(trajectory[:-1], trajectory[1:]):
        pa, pb = a.location.as_array(), b.location.as_array()
        seg = pb - pa
        dist = float(np.linalg.norm(seg[:2]))
        steps = max(1, int(dist // hop))
        yaw = math.degrees(math.atan2(seg[1], seg[0]))
        for i in range(steps):
            p = pa + seg * (i / steps)
            dense.append((Transform(Location(*p), Rotation(yaw=yaw)),
                          RoadOption.LANEFOLLOW))
    last = trajectory[-1]
    dense.append((last, RoadOption.LANEFOLLOW))
    return dense


def _interpolate_on_map(trajectory: List[Transform], town_map,
                        hop: float) -> List[Tuple[Transform, RoadOption]]:
    # Drop INTERMEDIATE keypoints that lie inside a junction: several
    # connectors share the junction interior, so projecting such a point
    # to its nearest lane is ambiguous — snapping to the straight-through
    # connector when the plan meant the turn re-routes the whole leg the
    # long way around. The keypoints on either side of the junction
    # determine the correct connector via the shortest-hop BFS.
    # (Downsampled plans put a command-change keypoint AT the junction
    # entry, route_manipulation.py:86-131, so this case is the norm.)
    if len(trajectory) > 2:
        kept = [trajectory[0]]
        kept += [t for t in trajectory[1:-1]
                 if not town_map.is_junction(t.location.x, t.location.y)]
        kept.append(trajectory[-1])
        if len(kept) >= 2:
            trajectory = kept
    pts: List[Transform] = []
    for a, b in zip(trajectory[:-1], trajectory[1:]):
        try:
            seg = town_map.route((a.location.x, a.location.y),
                                 (b.location.x, b.location.y), step=hop)
        except ValueError:
            # keypoint off the lane network: straight-line this leg
            seg = [tf for tf, _ in interpolate_trajectory([a, b], hop)]
        if pts and seg and pts[-1].location.distance(
                seg[0].location) < 0.5 * hop:
            seg = seg[1:]
        pts.extend(seg)
    if not pts:
        pts = [trajectory[0]]

    # Label junction spans by signed yaw delta (route_gen._turn_of
    # convention; CARLA's GlobalRoutePlanner likewise emits turn
    # commands through junctions) so the downsampled plan keeps a
    # command point at each junction entry (route_manipulation.py:86-131
    # preserves command changes).
    options = [RoadOption.LANEFOLLOW] * len(pts)
    i = 0
    while i < len(pts):
        if town_map.is_junction(pts[i].location.x, pts[i].location.y):
            j = i
            while j + 1 < len(pts) and town_map.is_junction(
                    pts[j + 1].location.x, pts[j + 1].location.y):
                j += 1
            d = (pts[j].rotation.yaw - pts[i].rotation.yaw
                 + 540.0) % 360.0 - 180.0
            opt = RoadOption.LEFT if d > 30.0 else \
                RoadOption.RIGHT if d < -30.0 else RoadOption.STRAIGHT
            for k in range(i, j + 1):
                options[k] = opt
            i = j + 1
        else:
            i += 1
    return list(zip(pts, options))


def downsample_route(route: List[Tuple[Transform, RoadOption]],
                     sample_factor: float = 50.0) -> List[int]:
    """Indices of a sparse plan: keep command changes and ~every
    sample_factor meters (route_manipulation.py:86-131)."""
    ids: List[int] = []
    prev_option = None
    dist = sample_factor + 1.0
    for i, (tf, option) in enumerate(route):
        if prev_option is not None:
            step = route[i - 1][0].location.distance(tf.location)
            dist += step
        changed = option != prev_option and \
            option not in (RoadOption.LANEFOLLOW, RoadOption.VOID)
        if changed or dist > sample_factor or i == len(route) - 1 or i == 0:
            ids.append(i)
            dist = 0.0
        prev_option = option
    return ids


def location_route_to_gps(route: List[Tuple[Transform, RoadOption]]
                          ) -> List[Tuple[dict, RoadOption]]:
    """Transforms -> {lat, lon, z} with the CARLA 9.10 convention
    (route_manipulation.py:12-45): lat ~ -y/scale, lon ~ x/scale, so
    GPS-space positions are (-y, x) and the IMU compass (= yaw + pi/2) is
    the GPS-frame heading — the identities every agent formula relies on."""
    from ..control.route_planner import GPS_CARLA_SCALE
    out = []
    for tf, option in route:
        lat = -tf.location.y / GPS_CARLA_SCALE[0]
        lon = tf.location.x / GPS_CARLA_SCALE[1]
        out.append(({"lat": lat, "lon": lon, "z": tf.location.z}, option))
    return out


def gps_to_location_xy(gps_pos: np.ndarray) -> np.ndarray:
    """GPS-space (-y, x) -> world (x, y)."""
    return np.array([gps_pos[1], -gps_pos[0]])


def location_xy_to_gps(world_xy: np.ndarray) -> np.ndarray:
    """World (x, y) -> GPS-space (-y, x)."""
    return np.array([-world_xy[1], world_xy[0]])


# ------------------------------------------------------------------ indexer

class RouteIndexer:
    def __init__(self, routes_file: str, scenarios_file: Optional[str],
                 repetitions: int = 1,
                 single_route: Optional[str] = None,
                 route_subset: Optional[str] = None):
        self._configs: List[RouteConfig] = []
        self._index = 0
        base = parse_routes_file(routes_file, single_route)
        if route_subset:
            # comma-separated route ids/names ("8,25" or
            # "RouteScenario_8"); the leaderboard's single-route knob
            # generalized (leaderboard_evaluator.py route-id filtering)
            tokens = {t.strip() for t in route_subset.split(",")}
            base = [cfg for cfg in base
                    if cfg.name in tokens
                    or any(cfg.name.endswith(f"_{t}") for t in tokens)]
        annotations = load_scenario_annotations(scenarios_file)
        n = 0
        for rep in range(repetitions):
            for cfg in base:
                c = RouteConfig(
                    name=cfg.name, town=cfg.town, index=n,
                    trajectory=cfg.trajectory, weather=cfg.weather,
                    repetition=rep)
                # Match triggers on the dense route (the reference scans the
                # interpolated trajectory, route_scenario_local.py:190-205).
                dense = [tf for tf, _ in
                         interpolate_trajectory(cfg.trajectory)]
                c.scenario_configs = scan_route_for_scenarios(
                    cfg.town, dense, annotations)
                self._configs.append(c)
                n += 1
        self.total = len(self._configs)

    def peek(self) -> bool:
        return self._index < self.total

    def next(self) -> Optional[RouteConfig]:
        if not self.peek():
            return None
        cfg = self._configs[self._index]
        self._index += 1
        return cfg

    def save_state(self, endpoint: str) -> None:
        from .statistics import default_checkpoint, load_checkpoint, \
            save_checkpoint
        data = load_checkpoint(endpoint) or default_checkpoint()
        data["_checkpoint"]["progress"] = [self._index, self.total]
        save_checkpoint(endpoint, data)

    def resume(self, endpoint: str) -> None:
        from .statistics import load_checkpoint
        data = load_checkpoint(endpoint)
        if data:
            progress = data.get("_checkpoint", {}).get("progress", [])
            if progress:
                self._index = min(progress[0], self.total)
