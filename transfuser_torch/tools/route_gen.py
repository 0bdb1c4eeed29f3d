"""(Copy of transfuser_tpu/tools/route_gen.py.)

Route + scenario dataset generators.

Behavioral spec: tools/dataset/gen_routes/* and gen_scenarios/* — walk a
town's road topology, extract route segments of interest (curved highways,
junction traversals, lane changes) and emit route XMLs; sample trigger
transforms and emit scenario JSONs. The reference needs a live CARLA
server for the OpenDRIVE topology; here the topology source is pluggable —
a `TownGraph` built either from a live adapter or from a JSON description.
"""

from __future__ import annotations

import json
import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class TopologyEdge:
    """One directed road segment: dense polyline + junction flag +
    topology links (edge indices)."""

    points: List[Tuple[float, float, float]]  # (x, y, yaw_deg)
    is_junction: bool = False
    successors: List[int] = field(default_factory=list)
    predecessors: List[int] = field(default_factory=list)
    signalized: bool = False
    # same-direction adjacent edges (lane-change targets), edge indices
    left: Optional[int] = None
    right: Optional[int] = None


@dataclass
class TownGraph:
    name: str
    edges: List[TopologyEdge] = field(default_factory=list)

    @staticmethod
    def from_json(path: str) -> "TownGraph":
        with open(path) as f:
            raw = json.load(f)
        return TownGraph(
            name=raw["name"],
            edges=[TopologyEdge(points=[tuple(p) for p in e["points"]],
                                is_junction=e.get("is_junction", False),
                                successors=list(e.get("successors", [])),
                                predecessors=list(e.get("predecessors", [])),
                                signalized=e.get("signalized", False),
                                left=e.get("left"), right=e.get("right"))
                   for e in raw["edges"]])

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"name": self.name,
                       "edges": [{"points": e.points,
                                  "is_junction": e.is_junction,
                                  "successors": e.successors,
                                  "predecessors": e.predecessors,
                                  "signalized": e.signalized,
                                  "left": e.left, "right": e.right}
                                 for e in self.edges]}, f)

    @staticmethod
    def from_town_map(town_map, precision: float = 2.0) -> "TownGraph":
        """Bridge from the hermetic road network (sim/town_map.TownMap) —
        the stand-in for `carla_map.get_topology()` that the reference
        generators walk (gen_routes_for_scen_1_3_4.py:25-27)."""
        lane_ids = sorted(town_map.lanes)
        index_of = {lid: i for i, lid in enumerate(lane_ids)}
        signalized_lanes = set()
        for tl in town_map.traffic_lights:
            signalized_lanes.update(tl.controlled_lanes)
        edges = []
        for lid in lane_ids:
            lane = town_map.lanes[lid]
            pts = []
            s = 0.0
            while s < lane.length:
                xy, yaw = lane.position(s)
                pts.append((float(xy[0]), float(xy[1]), float(yaw)))
                s += precision
            xy, yaw = lane.position(lane.length)
            pts.append((float(xy[0]), float(xy[1]), float(yaw)))
            edges.append(TopologyEdge(
                points=pts, is_junction=lane.is_junction,
                successors=[index_of[i] for i in lane.successors
                            if i in index_of],
                predecessors=[index_of[i] for i in lane.predecessors
                              if i in index_of],
                signalized=lid in signalized_lanes,
                left=index_of.get(lane.left_neighbor),
                right=index_of.get(lane.right_neighbor)))
        return TownGraph(name=town_map.name, edges=edges)


def _curvature(points: Sequence[Tuple[float, float, float]]) -> float:
    if len(points) < 3:
        return 0.0
    yaws = np.unwrap(np.radians([p[2] for p in points]))
    return float(np.abs(np.diff(yaws)).sum())


def curved_route_segments(graph: TownGraph, min_curvature: float = 0.3,
                          min_length: float = 50.0) -> List[TopologyEdge]:
    """Curved (highway) segments for scenarios 1/3
    (gen_routes_for_scen_1_3_4.py topology walk)."""
    out = []
    for edge in graph.edges:
        if edge.is_junction:
            continue
        pts = np.array([(p[0], p[1]) for p in edge.points])
        length = float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())
        if length >= min_length and _curvature(edge.points) >= min_curvature:
            out.append(edge)
    return out


def junction_entries(graph: TownGraph) -> List[Tuple[float, float, float]]:
    """Entry transforms of junction edges (scenarios 7/8/9/10 generators)."""
    return [e.points[0] for e in graph.edges if e.is_junction and e.points]


def _length(points: Sequence[Tuple[float, float, float]]) -> float:
    pts = np.array([(p[0], p[1]) for p in points])
    if len(pts) < 2:
        return 0.0
    return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())


def is_straight(points: Sequence[Tuple[float, float, float]],
                slack: float = 0.02) -> bool:
    """The reference's dot-product straightness test
    (gen_routes_for_scen_1_3_4.py:84-99): vectors from the midpoint to the
    two endpoints are antiparallel (dot in [-1-slack, -1+slack]) on a
    straight segment."""
    if len(points) < 3:
        return True
    cur = np.array(points[len(points) // 2][:2])
    prev = np.array(points[0][:2])
    nxt = np.array(points[-1][:2])
    v_nxt = cur - nxt
    v_prev = cur - prev
    norm = np.linalg.norm(v_nxt) * np.linalg.norm(v_prev)
    if norm < 1e-9:
        return True
    dot = float(np.dot(v_nxt, v_prev)) / norm
    return -1.0 - slack < dot < -1.0 + slack


def topology_walks(graph: TownGraph, max_len: float = 380.0,
                   min_len: float = 20.0
                   ) -> List[List[Tuple[float, float, float]]]:
    """Non-junction road walks, reference-style: seed every non-junction
    edge, extend backward through predecessors and forward through
    successors until a junction/dead end, dedupe by endpoints, chunk to
    `max_len` (gen_routes_for_scen_1_3_4.py:40-130, MAX_LEN=380)."""
    walks: List[List[Tuple[float, float, float]]] = []
    seen_endpoints: List[Tuple[float, float, float, float]] = []
    for start_idx, edge in enumerate(graph.edges):
        if edge.is_junction:
            continue
        chain = [start_idx]
        # backward
        cur = start_idx
        guard = 0
        while guard < 200:
            guard += 1
            preds = [p for p in graph.edges[cur].predecessors
                     if not graph.edges[p].is_junction]
            if not preds or preds[0] in chain:
                break
            chain.insert(0, preds[0])
            cur = preds[0]
        # forward
        cur = start_idx
        guard = 0
        while guard < 200:
            guard += 1
            succs = [s for s in graph.edges[cur].successors
                     if not graph.edges[s].is_junction]
            if not succs or succs[0] in chain:
                break
            chain.append(succs[0])
            cur = succs[0]
        pts: List[Tuple[float, float, float]] = []
        for ei in chain:
            pts.extend(graph.edges[ei].points)
        if _length(pts) < min_len:
            continue
        # duplicate pruning by (start, end) proximity (ref :66-82)
        key = (pts[0][0], pts[0][1], pts[-1][0], pts[-1][1])
        if any(all(abs(a - b) <= 2.0 for a, b in zip(key, k))
               for k in seen_endpoints):
            continue
        seen_endpoints.append(key)
        # chunk to max_len
        acc: List[Tuple[float, float, float]] = []
        acc_len = 0.0
        for i, p in enumerate(pts):
            if acc:
                acc_len += math.hypot(p[0] - acc[-1][0], p[1] - acc[-1][1])
            acc.append(p)
            if acc_len >= max_len:
                walks.append(acc)
                acc, acc_len = [p], 0.0
        if _length(acc) >= min_len:
            walks.append(acc)
    return walks


def _keypoints(points: Sequence[Tuple[float, float, float]],
               spacing: float = 25.0) -> List[Tuple[float, float, float]]:
    """Sparse route keypoints every ~`spacing` m along a dense polyline
    (the densifier — harness.route_parser.interpolate_trajectory — routes
    along the lane graph between consecutive keypoints)."""
    out = [points[0]]
    acc = 0.0
    for prev, p in zip(points, points[1:]):
        acc += math.hypot(p[0] - prev[0], p[1] - prev[1])
        if acc >= spacing:
            out.append(p)
            acc = 0.0
    if out[-1] != points[-1]:
        out.append(points[-1])
    return out


def long_routes(graph: TownGraph, n: int = 36,
                target_len: float = 1200.0, seed: int = 0
                ) -> List[List[Tuple[float, float, float]]]:
    """Longest6-style long multi-junction routes: seeded random successor
    walks over the topology until `target_len` metres, turn choice
    randomized at each junction, deduped by endpoint+length signature.

    Reference shape: leaderboard/data/longest6/README.md — 36 routes
    averaging ~1.5 km, each crossing many junctions under dense traffic."""
    rng = np.random.default_rng(seed)
    starts = [i for i, e in enumerate(graph.edges)
              if not e.is_junction and e.points]
    out: List[List[Tuple[float, float, float]]] = []
    seen = set()
    attempts = 0
    while len(out) < n and attempts < n * 50:
        attempts += 1
        cur = int(starts[int(rng.integers(len(starts)))])
        pts = list(graph.edges[cur].points)
        length = _length(pts)
        hops = 0
        while length < target_len and hops < 120:
            hops += 1
            succs = graph.edges[cur].successors
            if not succs:
                break
            cur = int(succs[int(rng.integers(len(succs)))])
            seg = graph.edges[cur].points
            if seg:
                length += math.hypot(seg[0][0] - pts[-1][0],
                                     seg[0][1] - pts[-1][1])
                length += _length(seg)
                pts.extend(seg)
        if length < 0.6 * target_len:
            continue
        sig = (round(pts[0][0]), round(pts[0][1]),
               round(pts[-1][0]), round(pts[-1][1]), round(length, -1))
        if sig in seen:
            continue
        seen.add(sig)
        out.append(_keypoints(pts))
    return out


def _turn_of(edge: TopologyEdge) -> str:
    """Classify a junction connector by signed yaw delta."""
    d = (edge.points[-1][2] - edge.points[0][2] + 540.0) % 360.0 - 180.0
    if d > 30.0:
        return "left"
    if d < -30.0:
        return "right"
    return "straight"


def junction_routes(graph: TownGraph, turn: Optional[str] = None,
                    signalized: Optional[bool] = None
                    ) -> List[List[Tuple[float, float, float]]]:
    """Approach + connector + exit walks through junctions
    (gen_routes_for_scen_7_8_9.py / _10.py). Filter by turn direction
    ('straight'|'left'|'right') and/or signalization."""
    out = []
    for ci, conn in enumerate(graph.edges):
        if not conn.is_junction:
            continue
        if turn is not None and _turn_of(conn) != turn:
            continue
        if signalized is not None and conn.signalized != signalized:
            continue
        for pi in conn.predecessors:
            for si in conn.successors:
                pts = (graph.edges[pi].points + conn.points
                       + graph.edges[si].points)
                out.append(pts)
    return out


def lane_change_routes(graph: TownGraph, min_length: float = 60.0
                       ) -> Dict[str, List[List[Tuple[float, float,
                                                      float]]]]:
    """Sparse 3-keypoint lane-change routes, categorized like the
    reference generator (gen_routes_lane_change.py: 'lr'/'ll'/'rr'/'rl'
    = first/second change direction; 'l'+'r' means change left then come
    back right): start on a non-junction edge, mid-route keypoint on the
    adjacent lane, end either back on the original lane or staying on
    the neighbor. Densification through TownMap.route / the harness's
    interpolate_trajectory renders the diagonal."""
    out: Dict[str, List[List[Tuple[float, float, float]]]] = {
        "lr": [], "ll": [], "rr": [], "rl": []}
    for edge in graph.edges:
        if edge.is_junction or len(edge.points) < 3:
            continue
        pts = np.array([(p[0], p[1]) for p in edge.points])
        length = float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())
        if length < min_length:
            continue
        start = edge.points[1]
        end_own = edge.points[-2]
        for side, nb_idx in (("l", edge.left), ("r", edge.right)):
            if nb_idx is None:
                continue
            nb = graph.edges[nb_idx]
            if nb.is_junction or len(nb.points) < 3:
                continue
            mid = nb.points[len(nb.points) // 2]
            back = "r" if side == "l" else "l"
            out[side + back].append([start, mid, end_own])
            out[side + side].append([start, mid, nb.points[-2]])
    return out


def routes_to_xml(routes: List[List[Tuple[float, float, float]]], town: str,
                  path: str) -> None:
    root = ET.Element("routes")
    for i, pts in enumerate(routes):
        r = ET.SubElement(root, "route", id=str(i), town=town)
        for x, y, yaw in pts:
            ET.SubElement(r, "waypoint", x=f"{x}", y=f"{y}", z="0.0",
                          pitch="0.0", roll="0.0", yaw=f"{yaw}")
    ET.ElementTree(root).write(path, xml_declaration=True, encoding="UTF-8")


def scenarios_to_json(triggers: List[Tuple[float, float, float]],
                      scenario_type: str, town: str, path: str) -> None:
    # event schema per gen_scenario_*.py: transform + other_actors
    events = [{"transform": {"x": x, "y": y, "z": 0.0, "yaw": yaw,
                             "pitch": 0.0},
               "other_actors": {}}
              for x, y, yaw in triggers]
    data = {"available_scenarios": [{town: [{
        "available_event_configurations": events,
        "scenario_type": scenario_type}]}]}
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def generate_routes(graph: TownGraph, out_xml: str,
                    kind: str = "curved") -> int:
    """Emit a route XML for the requested kind; returns route count.

    kinds (reference generator mapping):
      curved / straight  — topology walks split by the dot-product test
                           (gen_routes_for_scen_1_3_4.py)
      junction           — approach+connector+exit walks (scen 7-10 gens)
      junction_left / junction_right / junction_straight — by turn
      lane_change        — all lane-change routes
      lane_change_lr / _ll / _rr / _rl — one category
                           (gen_routes_lane_change.py)
      all                — every walk + every junction crossing
    """
    walks = topology_walks(graph)
    if kind == "curved":
        routes = [w for w in walks if not is_straight(w)]
    elif kind == "straight":
        routes = [w for w in walks if is_straight(w)]
    elif kind == "junction":
        routes = junction_routes(graph)
    elif kind.startswith("junction_"):
        routes = junction_routes(graph, turn=kind.split("_", 1)[1])
    elif kind == "lane_change":
        routes = [r for rs in lane_change_routes(graph).values()
                  for r in rs]
    elif kind.startswith("lane_change_"):
        routes = lane_change_routes(graph)[kind.rsplit("_", 1)[1]]
    elif kind == "all":
        routes = walks + junction_routes(graph)
    else:
        raise ValueError(f"unknown route kind {kind!r}")
    if kind.startswith("lane_change"):
        # already sparse 3-keypoint routes; thinning would drop the mid
        # (lane-change) keypoint
        routes = [r for r in routes if len(r) >= 2]
    else:
        # thin to ~every 5th waypoint: route XMLs carry sparse keypoints,
        # the harness re-densifies via interpolate_trajectory
        routes = [r[:: 5] + [r[-1]] for r in routes if len(r) >= 2]
    routes_to_xml(routes, graph.name, out_xml)
    return len(routes)


# scenario_type -> trigger selection over the topology
# (tools/dataset/gen_scenarios/*: 1=ControlLoss on curved roads,
#  3=DynamicObjectCrossing on straights, 4=VehicleTurning near junction
#  entries, 7/8/9=signalized junction straight/left/right, 10=unsignalized)
def _scenario_triggers(graph: TownGraph, scenario_type: str
                       ) -> List[Tuple[float, float, float]]:
    if scenario_type == "Scenario1":
        return [w[len(w) // 2] for w in topology_walks(graph)
                if not is_straight(w)]
    if scenario_type == "Scenario3":
        return [w[len(w) // 2] for w in topology_walks(graph)
                if is_straight(w)]
    if scenario_type == "Scenario4":
        # 5 m past the start of each junction approach (gen_scenario_4:89)
        out = []
        for conn in graph.edges:
            if conn.is_junction:
                for pi in conn.predecessors:
                    pts = graph.edges[pi].points
                    if len(pts) > 3:
                        out.append(pts[min(3, len(pts) - 1)])
        return out
    turn = {"Scenario7": "straight", "Scenario8": "left",
            "Scenario9": "right"}.get(scenario_type)
    if turn is not None:
        conns = [e for e in graph.edges
                 if e.is_junction and e.signalized and _turn_of(e) == turn]
        return [graph.edges[p].points[-1]
                for e in conns for p in e.predecessors]
    if scenario_type == "Scenario10":
        conns = [e for e in graph.edges
                 if e.is_junction and not e.signalized]
        return [graph.edges[p].points[-1]
                for e in conns for p in e.predecessors]
    raise ValueError(f"unknown scenario type {scenario_type!r}")


def generate_scenarios(graph: TownGraph, out_json: str,
                       scenario_type: str = "Scenario7") -> int:
    triggers = _scenario_triggers(graph, scenario_type)
    # dedupe identical trigger transforms
    triggers = sorted({(round(x, 1), round(y, 1), round(yaw, 0))
                       for x, y, yaw in triggers})
    scenarios_to_json(list(triggers), scenario_type, graph.name, out_json)
    return len(triggers)
