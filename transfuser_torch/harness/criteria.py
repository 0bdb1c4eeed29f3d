"""(Copy of transfuser_tpu/harness/criteria.py.)

Evaluation criteria producing TrafficEvents.

Behavioral spec: srunner scenarioatomics/atomic_criteria_local.py:32-1883 +
the criteria set wired by RouteScenario (route_scenario_local.py:532-567):
Collision / InRoute (offroad_max 30, terminating) / RouteCompletion /
OutsideRouteLanes / RunningRedLight / RunningStop / AgentBlocked
(<0.1 m/s for 180 s, terminating). Simplified to the hermetic backend's
actor model; a live-CARLA adapter can reuse the same event vocabulary.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from ..sim.replay import Actor, ReplaySimulation
from ..sim.types import Transform
from .events import TrafficEvent, TrafficEventType


class Criterion:
    name = "criterion"
    terminates = False

    def __init__(self) -> None:
        self.events: List[TrafficEvent] = []
        self.test_status = "INIT"

    def update(self, sim: ReplaySimulation) -> None:
        raise NotImplementedError


class CollisionTest(Criterion):
    """Reference debounce semantics (atomic_criteria_local.py:299-301,
    376, 397-403): a re-collision with the SAME actor id is ignored for
    MAX_ID_TIME game-seconds after the last counted one, and ANY
    collision while the ego is within MIN_AREA_OF_COLLISION of a
    previously counted collision point is a micro-collision and ignored;
    counted points are forgotten once the ego moves more than
    MAX_AREA_OF_COLLISION away. On top of that, the hermetic backend
    reports sustained OBB contact every tick (the CARLA sensor fires per
    impulse event), so one continuous contact is still one event."""

    name = "CollisionTest"
    MIN_AREA_OF_COLLISION = 3.0
    MAX_AREA_OF_COLLISION = 5.0
    MAX_ID_TIME = 5.0

    def __init__(self) -> None:
        super().__init__()
        self._colliding_ids: set = set()
        self._registered: List[tuple] = []  # ego (x, y) at counted events
        self._last_id = None
        self._last_time = 0.0

    def update(self, sim: ReplaySimulation) -> None:
        ego = sim.ego_transform.location
        now = sim.game_time
        self._registered = [
            p for p in self._registered
            if math.hypot(ego.x - p[0], ego.y - p[1])
            <= self.MAX_AREA_OF_COLLISION]
        if self._last_id is not None and \
                now - self._last_time > self.MAX_ID_TIME:
            self._last_id = None
        current = set()
        for actor in sim.collision_events:
            current.add(actor.actor_id)
            if actor.actor_id in self._colliding_ids:
                continue  # debounce: one event per continuous contact
            if actor.actor_id == self._last_id:
                continue  # same actor within MAX_ID_TIME
            if any(math.hypot(ego.x - p[0], ego.y - p[1])
                   <= self.MIN_AREA_OF_COLLISION
                   for p in self._registered):
                continue  # micro-collision near a counted one
            if actor.type_id.startswith("walker"):
                etype = TrafficEventType.COLLISION_PEDESTRIAN
            elif actor.type_id.startswith("vehicle"):
                etype = TrafficEventType.COLLISION_VEHICLE
            else:
                etype = TrafficEventType.COLLISION_STATIC
            loc = actor.transform.location
            self.events.append(TrafficEvent(
                etype,
                message=(f"Agent collided against object with type="
                         f"{actor.type_id} and id={actor.actor_id} at "
                         f"(x={loc.x:.3f}, y={loc.y:.3f}, z={loc.z:.3f})"),
                dictionary={"type": actor.type_id, "id": actor.actor_id,
                            "x": loc.x, "y": loc.y, "z": loc.z}))
            self.test_status = "FAILURE"
            self._registered.append((ego.x, ego.y))
            self._last_id = actor.actor_id
            self._last_time = now
        self._colliding_ids = current


class RouteCompletionTest(Criterion):
    name = "RouteCompletionTest"
    DISTANCE_THRESHOLD = 10.0

    def __init__(self, route: Sequence[Transform]):
        super().__init__()
        self._points = np.array([[t.location.x, t.location.y]
                                 for t in route])
        seg = np.diff(self._points, axis=0)
        self._cum = np.concatenate(
            [[0.0], np.cumsum(np.linalg.norm(seg, axis=1))])
        self._total = max(self._cum[-1], 1e-6)
        self._index = 0
        self.percentage = 0.0
        self._done = False

    def update(self, sim: ReplaySimulation) -> None:
        if self._done:
            return
        ego = np.array([sim.ego_transform.location.x,
                        sim.ego_transform.location.y])
        # advance monotonically along the route within a search window
        window = slice(self._index, min(self._index + 200,
                                        len(self._points)))
        d = np.linalg.norm(self._points[window] - ego, axis=1)
        best = int(np.argmin(d)) + self._index
        if d[best - self._index] < self.DISTANCE_THRESHOLD:
            self._index = best
            self.percentage = 100.0 * self._cum[best] / self._total
        # Done at >99% arclength, at the final points, or STOPPED AT THE
        # GOAL: within DISTANCE_THRESHOLD of the terminus with the route
        # otherwise consumed (the reference treats <10 m from the final
        # transform as arrival, atomic_criteria RouteCompletionTest — on
        # its ~1.5 km routes that IS >99%; on short hermetic routes the
        # expert's end-of-route braking stops ~5 m early, which is
        # arrival, not a 94% timeout).
        d_final = float(np.linalg.norm(self._points[-1] - ego))
        at_goal = (d_final < self.DISTANCE_THRESHOLD
                   and self._cum[self._index]
                   >= self._total - self.DISTANCE_THRESHOLD)
        if self.percentage > 99.0 or best >= len(self._points) - 2 \
                or at_goal:
            self._done = True
            self.percentage = 100.0
            self.events.append(TrafficEvent(
                TrafficEventType.ROUTE_COMPLETED,
                message="Destination was successfully reached"))
            self.test_status = "SUCCESS"

    def finalize(self) -> None:
        if not self._done:
            self.events.append(TrafficEvent(
                TrafficEventType.ROUTE_COMPLETION,
                message=f"Agent went off-route or stopped; completed "
                        f"{self.percentage:.2f}%",
                dictionary={"route_completed": self.percentage}))


class InRouteTest(Criterion):
    name = "InRouteTest"
    terminates = True
    MAX_ROUTE_PERCENTAGE = 30.0
    WINDOWS_SIZE = 5

    def __init__(self, route: Sequence[Transform],
                 offroad_max: float = 30.0):
        super().__init__()
        self._points = np.array([[t.location.x, t.location.y]
                                 for t in route])
        self._offroad_max = offroad_max
        self.failed = False

    def update(self, sim: ReplaySimulation) -> None:
        if self.failed:
            return
        ego = np.array([sim.ego_transform.location.x,
                        sim.ego_transform.location.y])
        d = np.linalg.norm(self._points - ego, axis=1).min()
        if d > self._offroad_max:
            self.failed = True
            self.test_status = "FAILURE"
            self.events.append(TrafficEvent(
                TrafficEventType.ROUTE_DEVIATION,
                message=(f"Agent deviated from the route at (x={ego[0]:.3f}, "
                         f"y={ego[1]:.3f})"),
                dictionary={"x": ego[0], "y": ego[1]}))


class OutsideRouteLanesTest(Criterion):
    """With a town map: outside = not within any lane's paved width
    (OutsideRouteLanesTest's lane-membership test,
    atomic_criteria_local.py); without one: distance-to-route proxy."""

    name = "OutsideRouteLanesTest"
    ALLOWED_OUT_DISTANCE = 2.0  # lane half-width proxy (no-map fallback)

    def __init__(self, route: Sequence[Transform], town_map=None):
        super().__init__()
        self._points = np.array([[t.location.x, t.location.y]
                                 for t in route])
        self._map = town_map
        self._outside_distance = 0.0
        self._driven_distance = 0.0
        self._last: Optional[np.ndarray] = None

    def _is_outside(self, ego: np.ndarray) -> bool:
        if self._map is not None:
            return not self._map.on_road(float(ego[0]), float(ego[1]))
        return bool(np.linalg.norm(self._points - ego, axis=1).min()
                    > self.ALLOWED_OUT_DISTANCE)

    def update(self, sim: ReplaySimulation) -> None:
        ego = np.array([sim.ego_transform.location.x,
                        sim.ego_transform.location.y])
        if self._last is not None:
            step = float(np.linalg.norm(ego - self._last))
            self._driven_distance += step
            if step > 0 and self._is_outside(ego):
                self._outside_distance += step
        self._last = ego

    def finalize(self) -> None:
        if self._driven_distance > 0 and self._outside_distance > 0:
            pct = 100.0 * self._outside_distance / self._driven_distance
            self.events.append(TrafficEvent(
                TrafficEventType.OUTSIDE_ROUTE_LANES_INFRACTION,
                message=(f"Agent went outside its route lanes for about "
                         f"{self._outside_distance:.3f} meters "
                         f"({pct:.3f}% of the completed route)"),
                dictionary={"percentage": pct}))


def _segments_cross(a0: np.ndarray, a1: np.ndarray,
                    b0: np.ndarray, b1: np.ndarray) -> bool:
    """True if segment a0-a1 intersects b0-b1 (2D orientation test)."""
    def orient(p, q, r):
        v = (q[0] - p[0]) * (r[1] - p[1]) - (q[1] - p[1]) * (r[0] - p[0])
        return 0 if abs(v) < 1e-12 else (1 if v > 0 else -1)
    o1, o2 = orient(a0, a1, b0), orient(a0, a1, b1)
    o3, o4 = orient(b0, b1, a0), orient(b0, b1, a1)
    return o1 != o2 and o3 != o4


class RunningRedLightTest(Criterion):
    """With traffic-light specs (town map): infraction exactly when the
    ego's motion segment crosses the light's STOP LINE while that light is
    red — the trigger-volume/stop-line semantics of
    atomic_criteria_local.py RunningRedLightTest. Without specs: radial
    proxy on light actors (legacy hermetic behavior)."""

    name = "RunningRedLightTest"
    DISTANCE_LIGHT = 15.0

    def __init__(self, light_specs=None, light_actors=None):
        super().__init__()
        # light_specs: List[TrafficLightSpec]; light_actors: {light_id:
        # Actor} holding the live state string.
        self._specs = list(light_specs or [])
        self._light_actors = light_actors or {}
        self._last_ego: Optional[np.ndarray] = None
        self._scored: set = set()

    def _light_state(self, spec) -> str:
        actor = self._light_actors.get(spec.light_id)
        return actor.state if actor is not None else "Red"

    def update(self, sim: ReplaySimulation) -> None:
        ego = sim.ego_transform
        ego_xy = np.array([ego.location.x, ego.location.y])
        if self._specs:
            if self._last_ego is not None:
                for spec in self._specs:
                    if spec.light_id in self._scored:
                        continue
                    if self._light_state(spec) != "Red":
                        continue
                    near = spec.trigger.contains(
                        float(ego_xy[0]), float(ego_xy[1]), margin=3.0)
                    if not near and not spec.trigger.contains(
                            float(self._last_ego[0]),
                            float(self._last_ego[1]), margin=3.0):
                        continue
                    if _segments_cross(self._last_ego, ego_xy,
                                       spec.stop_line[0],
                                       spec.stop_line[1]):
                        self._scored.add(spec.light_id)
                        self._emit(spec.light_id,
                                   spec.transform.location.x,
                                   spec.transform.location.y)
            self._last_ego = ego_xy
            return
        # legacy radial proxy (no map)
        heading = np.array([
            math.cos(math.radians(ego.rotation.yaw)),
            math.sin(math.radians(ego.rotation.yaw))])
        for light in sim.actors_of_type("traffic_light"):
            if light.state != "Red":
                continue
            delta = np.array([
                light.transform.location.x - ego.location.x,
                light.transform.location.y - ego.location.y])
            dist = np.linalg.norm(delta)
            if dist < light.trigger_extent and sim.ego_speed > 0.5 \
                    and heading @ delta > 0 \
                    and light.actor_id not in self._scored:
                self._scored.add(light.actor_id)
                self._emit(light.actor_id, light.transform.location.x,
                           light.transform.location.y)

    def _emit(self, light_id, x, y) -> None:
        self.events.append(TrafficEvent(
            TrafficEventType.TRAFFIC_LIGHT_INFRACTION,
            message=(f"Agent ran a red light {light_id} at "
                     f"(x={x:.3f}, y={y:.3f})"),
            dictionary={"id": light_id, "x": x, "y": y}))
        self.test_status = "FAILURE"


class RunningStopTest(Criterion):
    """With stop-sign specs: the ego must come to <0.1 m/s while inside the
    sign's TRIGGER VOLUME; scored when it leaves (RunningStopTest,
    atomic_criteria_local.py). Without specs: radial proxy on stop actors."""

    name = "RunningStopTest"
    SPEED_THRESHOLD = 0.1

    def __init__(self, stop_specs=None) -> None:
        super().__init__()
        self._specs = list(stop_specs or [])
        self._pending: dict = {}

    def update(self, sim: ReplaySimulation) -> None:
        ego = sim.ego_transform
        if self._specs:
            for spec in self._specs:
                inside = spec.trigger.contains(ego.location.x,
                                               ego.location.y)
                self._score(f"map_stop_{spec.sign_id}", inside,
                            sim.ego_speed)
            return
        for stop in sim.actors_of_type("static.prop.stop"):
            delta = np.array([
                stop.transform.location.x - ego.location.x,
                stop.transform.location.y - ego.location.y])
            inside = float(np.linalg.norm(delta)) < stop.trigger_extent
            self._score(stop.actor_id, inside, sim.ego_speed)

    def _score(self, sid, inside: bool, ego_speed: float) -> None:
        rec = self._pending.setdefault(
            sid, {"inside": False, "stopped": False, "scored": False})
        if inside:
            rec["inside"] = True
            if ego_speed < self.SPEED_THRESHOLD:
                rec["stopped"] = True
        elif rec["inside"] and not rec["scored"]:
            rec["scored"] = True
            if not rec["stopped"]:
                self.events.append(TrafficEvent(
                    TrafficEventType.STOP_INFRACTION,
                    message=f"Agent ran a stop sign {sid}",
                    dictionary={"id": sid}))
                self.test_status = "FAILURE"


class AgentBlockedTest(Criterion):
    name = "AgentBlockedTest"
    terminates = True
    SPEED_THRESHOLD = 0.1

    def __init__(self, max_blocked_seconds: float = 180.0, fps: int = 20):
        super().__init__()
        self._max_ticks = int(max_blocked_seconds * fps)
        self._below = 0
        self.failed = False

    def update(self, sim: ReplaySimulation) -> None:
        if self.failed:
            return
        if sim.ego_speed < self.SPEED_THRESHOLD:
            self._below += 1
            if self._below > self._max_ticks:
                self.failed = True
                self.test_status = "FAILURE"
                loc = sim.ego_transform.location
                self.events.append(TrafficEvent(
                    TrafficEventType.VEHICLE_BLOCKED,
                    message=(f"Agent got blocked at (x={loc.x:.3f}, "
                             f"y={loc.y:.3f}, z={loc.z:.3f})"),
                    dictionary={"x": loc.x, "y": loc.y, "z": loc.z}))
        else:
            self._below = 0
