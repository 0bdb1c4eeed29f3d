"""(Copy of transfuser_tpu/harness/scenarios.py.)

Scripted scenario behaviors (the srunner scenario-class subset).

Behavioral spec: route_scenario_local.py:56-67 maps Scenario1-10 onto the
srunner classes (srunner/scenarios/*.py); each is a triggered adversary
maneuver. The hermetic equivalents reproduce the trigger ("ScenarioTriggerer"
+ oneshot, route_scenario_local.py:486-530) and maneuver semantics against
the replay backend's actor model:

  Scenario1  ControlLoss               — transient ego steering noise
  Scenario2  FollowLeadingVehicle      — lead vehicle drives then brakes
  Scenario3  DynamicObjectCrossing     — walker crosses in front
  Scenario4  VehicleTurningRoute       — vehicle cuts across at a junction
  Scenario5  OtherLeadingVehicle       — lead vehicle decelerates abruptly
  Scenario6  ManeuverOppositeDirection — oncoming vehicle invades the lane
  Scenario7-10 (No)SignalJunctionCrossing — crossing traffic at a junction
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from ..sim.replay import Actor, ReplaySimulation
from ..sim.types import Location, Rotation, Transform


class ScenarioBehavior:
    """Triggered, oneshot scripted behavior."""

    TRIGGER_DISTANCE = 15.0  # ScenarioTriggerer proximity

    def __init__(self, trigger: Transform, actor_id: int, seed: int = 0,
                 params: Optional[dict] = None):
        self.trigger = trigger
        self.actor_id = actor_id
        self.triggered = False
        self.done = False
        self.elapsed = 0.0
        self.params = params or {}
        self._rng = np.random.default_rng(seed + actor_id)

    def _param(self, name: str, default: float) -> float:
        """Per-event tunable from the scenario JSON's `other_parameters`
        (srunner convention: values may be wrapped as {"value": x},
        basic_scenario.py config.other_parameters)."""
        v = self.params.get(name, default)
        if isinstance(v, dict):
            v = v.get("value", default)
        try:
            return float(v)
        except (TypeError, ValueError):
            return default

    # ------------------------------------------------------------ lifecycle
    def setup(self, sim: ReplaySimulation) -> List[Actor]:
        """Actors to pre-spawn (before trigger)."""
        return []

    def on_trigger(self, sim: ReplaySimulation) -> None:
        pass

    def behave(self, sim: ReplaySimulation, dt: float) -> None:
        pass

    def tick(self, sim: ReplaySimulation) -> None:
        if self.done:
            return
        ego = sim.ego_transform.location
        if not self.triggered:
            d = math.hypot(ego.x - self.trigger.location.x,
                           ego.y - self.trigger.location.y)
            if d >= self.TRIGGER_DISTANCE:
                # A pre-spawned VEHICLE adversary parked on a live lane
                # also wakes when the ego closes on the actor itself —
                # on looping routes the trigger arm may be unreachable
                # while the parked car blocks the ego's own approach
                # (srunner scenarios engage as the ego nears the hazard).
                a = self._actor(sim)
                if a is None or not a.type_id.startswith("vehicle"):
                    return
                d = math.hypot(ego.x - a.transform.location.x,
                               ego.y - a.transform.location.y)
            if d < self.TRIGGER_DISTANCE:
                self.triggered = True
                self.on_trigger(sim)
            return
        self.elapsed += sim.dt
        self.behave(sim, sim.dt)
        if self.done:
            # srunner destroys scenario actors when the maneuver ends
            # (basic_scenario.remove_all_actors). Leaving them parked on
            # real lanes gridlocks the TrafficManager (which brakes for
            # them) and blocks the ego's route behind queued traffic.
            self._despawn(sim)

    def _despawn(self, sim: ReplaySimulation) -> None:
        sim.actors[:] = [a for a in sim.actors
                         if a.actor_id != self.actor_id]

    def _actor(self, sim: ReplaySimulation) -> Optional[Actor]:
        for a in sim.actors:
            if a.actor_id == self.actor_id:
                return a
        return None

    def _offset_transform(self, forward: float, lateral: float,
                          yaw_add: float = 0.0) -> Transform:
        yaw = math.radians(self.trigger.rotation.yaw)
        c, s = math.cos(yaw), math.sin(yaw)
        x = self.trigger.location.x + forward * c - lateral * s
        y = self.trigger.location.y + forward * s + lateral * c
        return Transform(Location(x, y, 0.0),
                         Rotation(yaw=self.trigger.rotation.yaw + yaw_add))


class _LaneRider:
    """Advances an actor along the lane graph — the hermetic equivalent of
    srunner's WaypointFollower (atomic_behaviors.py), which drives scenario
    adversaries on map waypoint plans rather than straight-line kinematics.
    """

    def __init__(self, town_map, lane_id: int, s: float,
                 rng: np.random.Generator, choose: Optional[int] = None):
        self.map = town_map
        self.lane_id = int(lane_id)
        self.s = float(s)
        self._rng = rng
        self.choose = choose
        self.dead_end = False

    def advance(self, dist: float) -> None:
        self.lane_id, self.s, ok = self.map.advance(
            self.lane_id, self.s, dist,
            rng=None if self.choose is not None else self._rng,
            choose=self.choose)
        if not ok:
            self.dead_end = True

    def transform(self, lateral: float = 0.0) -> Transform:
        """Pose at the current arclength; `lateral` shifts left (+) of the
        direction of travel — used for lane-invasion maneuvers."""
        xy, yaw = self.map.lanes[self.lane_id].position(self.s)
        rad = math.radians(yaw)
        x = float(xy[0]) - lateral * math.sin(rad)
        y = float(xy[1]) + lateral * math.cos(rad)
        return Transform(Location(x, y, 0.0), Rotation(yaw=yaw))

    def on_junction(self) -> bool:
        return bool(self.map.lanes[self.lane_id].is_junction)


def _nearest_lane_rider(town_map, tf: Transform,
                        rng: np.random.Generator) -> Optional[_LaneRider]:
    hit = town_map.nearest_lane(tf.location.x, tf.location.y)
    if hit is None:
        return None
    return _LaneRider(town_map, hit[0].lane_id, hit[1], rng)


def _yaw_diff(a: float, b: float) -> float:
    return abs((a - b + 180.0) % 360.0 - 180.0)


def _find_crossing_approach(town_map, trigger: Transform):
    """Approach lane of CROSS traffic at the junction ahead of `trigger`.

    Walks the ego's lane chain to the next junction entry, then picks the
    non-junction lane feeding that junction whose heading is roughly
    perpendicular to the ego's — the srunner junction scenarios
    (no_signal_junction_crossing.py, object_crash_intersection.py) place
    their adversary on exactly such an approach via map waypoints.
    Returns (lane, straight_successor_index) or None.
    """
    hit = town_map.nearest_lane(trigger.location.x, trigger.location.y)
    if hit is None:
        return None
    lane_id = hit[0].lane_id
    for _ in range(6):
        lane = town_map.lanes[lane_id]
        if lane.is_junction:
            break
        junction_next = [i for i in lane.successors
                         if town_map.lanes[i].is_junction]
        if junction_next:
            entry_xy, entry_yaw = lane.position(lane.length)
            best = None
            for cand in town_map.lanes_near(float(entry_xy[0]),
                                            float(entry_xy[1]), 30.0):
                if cand.is_junction or cand.lane_id == lane.lane_id:
                    continue
                if not any(town_map.lanes[i].is_junction
                           for i in cand.successors):
                    continue
                end_xy, end_yaw = cand.position(cand.length)
                ang = _yaw_diff(end_yaw, entry_yaw)
                if not 45.0 <= ang <= 135.0:
                    continue
                d = math.hypot(float(end_xy[0]) - float(entry_xy[0]),
                               float(end_xy[1]) - float(entry_xy[1]))
                if d < 35.0 and (best is None or d < best[0]):
                    best = (d, cand)
            if best is None:
                return None
            cand = best[1]
            # "straight through": the connector whose exit heading stays
            # closest to the approach heading crosses the ego's path.
            _, a_yaw = cand.position(cand.length)
            straight_i, straight_ang = 0, 1e9
            for i, si in enumerate(cand.successors):
                conn = town_map.lanes[si]
                _, e_yaw = conn.position(conn.length)
                ang = _yaw_diff(e_yaw, a_yaw)
                if ang < straight_ang:
                    straight_ang, straight_i = ang, i
            return cand, straight_i
        if not lane.successors:
            return None
        lane_id = lane.successors[0]
    return None


class ControlLoss(ScenarioBehavior):
    """Scenario1: steering perturbation for ~1.5 s (control_loss.py)."""

    DURATION = 1.5
    NOISE = 0.12

    def behave(self, sim: ReplaySimulation, dt: float) -> None:
        if self.elapsed > self._param("duration", self.DURATION):
            self.done = True
            return
        noise = float(self._rng.normal(
            0.0, self._param("noise_std", self.NOISE)))
        sim.perturb_steer(noise)


class FollowLeadingVehicle(ScenarioBehavior):
    """Scenario2: lead vehicle ahead; drives then stops, ego must react."""

    def setup(self, sim: ReplaySimulation) -> List[Actor]:
        # srunner follow_leading_vehicle.py: _first_vehicle_location=25
        ahead = self._param("first_vehicle_location", 25.0)
        self._rider: Optional[_LaneRider] = None
        town_map = getattr(sim, "town_map", None)
        if town_map is not None:
            rider = _nearest_lane_rider(town_map, self.trigger, self._rng)
            if rider is not None:
                rider.advance(ahead)
                self._rider = rider
        tf = (self._rider.transform() if self._rider is not None
              else self._offset_transform(ahead, 0.0))
        self._lead = Actor(actor_id=self.actor_id, type_id="vehicle.lead",
                           transform=tf, speed=0.0)
        return [self._lead]

    def _speed_profile(self) -> float:
        if self.elapsed < 6.0:
            return self._param("first_vehicle_speed", 3.0)
        return 0.0  # stop; ego must brake behind

    def behave(self, sim: ReplaySimulation, dt: float) -> None:
        lead = self._actor(sim)
        if lead is None:
            self.done = True
            return
        # End like srunner's follow_leading_vehicle: once the ego has
        # reacted (closed in and come to a near-stop behind the lead) or
        # after a failsafe window, the maneuver is over (the despawn in
        # tick() then clears the lane, srunner ActorDestroy).
        ego = sim.ego_transform.location
        d_ego = math.hypot(ego.x - lead.transform.location.x,
                           ego.y - lead.transform.location.y)
        reacted = (self.elapsed > 6.0 and d_ego < 25.0
                   and sim.ego_speed < 1.0)
        if reacted or self.elapsed > 25.0:
            self.done = True
            return
        lead.speed = self._speed_profile()
        if self._rider is not None:
            # follow the lane chain (curves included), not a straight ray
            self._rider.advance(lead.speed * dt)
            lead.transform = self._rider.transform()
        else:
            yaw = math.radians(lead.transform.rotation.yaw)
            lead.transform = Transform(
                Location(lead.transform.location.x + lead.speed * dt
                         * math.cos(yaw),
                         lead.transform.location.y + lead.speed * dt
                         * math.sin(yaw), 0.0),
                lead.transform.rotation)
        lead.control.throttle = 0.5 if lead.speed > 0 else 0.0
        lead.control.brake = 0.0 if lead.speed > 0 else 1.0


class DynamicObjectCrossing(ScenarioBehavior):
    """Scenario3: walker steps onto the road in front of the ego."""

    def setup(self, sim: ReplaySimulation) -> List[Actor]:
        # srunner object_crossing.py: _start_distance; walker speed 1.8
        tf = self._offset_transform(self._param("distance", 12.0), -5.0,
                                    yaw_add=90.0)
        yaw = math.radians(tf.rotation.yaw)
        walker = Actor(actor_id=self.actor_id, type_id="walker.pedestrian",
                       transform=tf, extent=Location(0.4, 0.4, 1.0),
                       speed=0.0,
                       direction=(math.cos(yaw), math.sin(yaw), 0.0))
        return [walker]

    def on_trigger(self, sim: ReplaySimulation) -> None:
        w = self._actor(sim)
        if w is not None:
            w.speed = self._param("walker_speed", 1.8)

    def behave(self, sim: ReplaySimulation, dt: float) -> None:
        if self.elapsed > 8.0:
            w = self._actor(sim)
            if w is not None:
                w.speed = 0.0
            self.done = True


class _CrossingVehicle(ScenarioBehavior):
    """Vehicle crossing the ego path at a junction (base for 4, 7-10).

    With a town map the adversary spawns on a REAL perpendicular approach
    lane into the junction ahead of the trigger and, once triggered,
    drives through the junction's connector lane — matching srunner's
    map-waypoint adversaries (no_signal_junction_crossing.py,
    object_crash_intersection.py generate_target_waypoint). Without a map
    it falls back to straight-line kinematics from a lateral offset.
    """

    APPROACH = 20.0
    SPEED = 6.0

    def setup(self, sim: ReplaySimulation) -> List[Actor]:
        approach = self._param("approach", self.APPROACH)
        self._rider: Optional[_LaneRider] = None
        self._crossed_junction = False
        town_map = getattr(sim, "town_map", None)
        if town_map is not None:
            found = _find_crossing_approach(town_map, self.trigger)
            if found is not None:
                lane, straight_i = found
                s0 = max(lane.length - approach, 0.0)
                self._rider = _LaneRider(town_map, lane.lane_id, s0,
                                         self._rng, choose=straight_i)
        tf = (self._rider.transform() if self._rider is not None
              else self._offset_transform(10.0, -approach, yaw_add=90.0))
        self._veh = Actor(actor_id=self.actor_id,
                          type_id="vehicle.crossing", transform=tf,
                          speed=0.0)
        return [self._veh]

    def on_trigger(self, sim: ReplaySimulation) -> None:
        v = self._actor(sim)
        if v is not None:
            v.speed = self._param("speed", self.SPEED)
            v.control.throttle = 0.7

    def behave(self, sim: ReplaySimulation, dt: float) -> None:
        v = self._actor(sim)
        if v is None or self.elapsed > 10.0:
            self.done = True
            return
        if self._rider is not None:
            if self._rider.on_junction():
                self._crossed_junction = True
            elif self._crossed_junction or self._rider.dead_end:
                # exited the far side (or hit a dead end): maneuver over
                v.speed = 0.0
                v.control.throttle = 0.0
                self.done = True
                return
            self._rider.advance(v.speed * dt)
            v.transform = self._rider.transform()
        else:
            yaw = math.radians(v.transform.rotation.yaw)
            v.transform = Transform(
                Location(v.transform.location.x + v.speed * dt
                         * math.cos(yaw),
                         v.transform.location.y + v.speed * dt
                         * math.sin(yaw), 0.0), v.transform.rotation)


class VehicleTurningRoute(_CrossingVehicle):
    SPEED = 4.0


class OtherLeadingVehicle(FollowLeadingVehicle):
    """Scenario5: leading vehicle decelerates abruptly
    (other_leading_vehicle.py: drive at speed, then sudden slowdown)."""

    def _speed_profile(self) -> float:
        return 6.0 if self.elapsed < 4.0 else 1.0


class ManeuverOppositeDirection(ScenarioBehavior):
    """Scenario6: oncoming vehicle briefly invades the ego lane
    (maneuver_opposite_direction.py: the adversary pulls out of its lane
    to overtake and forces the ego to evade).

    With a map the adversary rides the actual OPPOSING lane toward the
    ego and swings left into the ego's lane for the middle of the run;
    without one it runs head-on down the ego's own lane (legacy)."""

    def setup(self, sim: ReplaySimulation) -> List[Actor]:
        # srunner maneuver_opposite_direction.py: _first_vehicle_location=50
        start = self._param("start_distance", 45.0)
        self._rider: Optional[_LaneRider] = None
        ref = self._offset_transform(start, 0.0, yaw_add=180.0)
        town_map = getattr(sim, "town_map", None)
        if town_map is not None:
            for cand in town_map.lanes_near(ref.location.x,
                                            ref.location.y, 2.0 * 3.5):
                if cand.is_junction:
                    continue
                s, lat = cand.project(ref.location.x, ref.location.y)
                _, yaw = cand.position(s)
                if (_yaw_diff(yaw, ref.rotation.yaw) < 45.0
                        and abs(lat) < 1.5 * cand.width):
                    self._rider = _LaneRider(town_map, cand.lane_id, s,
                                             self._rng)
                    break
        tf = self._rider.transform() if self._rider is not None else ref
        self._veh = Actor(actor_id=self.actor_id, type_id="vehicle.oncoming",
                          transform=tf, speed=0.0)
        return [self._veh]

    def on_trigger(self, sim: ReplaySimulation) -> None:
        v = self._actor(sim)
        if v is not None:
            v.speed = self._param("speed", 7.0)

    def behave(self, sim: ReplaySimulation, dt: float) -> None:
        v = self._actor(sim)
        if v is None or self.elapsed > 8.0:
            self.done = True
            return
        if self._rider is not None:
            self._rider.advance(v.speed * dt)
            # smooth excursion into the ego lane (left of travel in
            # right-hand traffic) between t=1.5 s and t=4.5 s
            t = self.elapsed
            blend = max(0.0, min((t - 1.5) / 0.75, (4.5 - t) / 0.75, 1.0))
            width = self._rider.map.lanes[self._rider.lane_id].width
            v.transform = self._rider.transform(lateral=blend * width)
        else:
            yaw = math.radians(v.transform.rotation.yaw)
            v.transform = Transform(
                Location(v.transform.location.x + v.speed * dt
                         * math.cos(yaw),
                         v.transform.location.y + v.speed * dt
                         * math.sin(yaw), 0.0), v.transform.rotation)


class SignalJunctionCrossing(_CrossingVehicle):
    pass


class NoSignalJunctionCrossing(_CrossingVehicle):
    pass


BEHAVIOR_CLASSES = {
    "Scenario1": ControlLoss,
    "Scenario2": FollowLeadingVehicle,
    "Scenario3": DynamicObjectCrossing,
    "Scenario4": VehicleTurningRoute,
    "Scenario5": OtherLeadingVehicle,
    "Scenario6": ManeuverOppositeDirection,
    "Scenario7": SignalJunctionCrossing,
    "Scenario8": NoSignalJunctionCrossing,
    "Scenario9": NoSignalJunctionCrossing,
    "Scenario10": NoSignalJunctionCrossing,
}


def build_behaviors(scenario_configs: List[dict],
                    seed: int = 0) -> List[ScenarioBehavior]:
    behaviors: List[ScenarioBehavior] = []
    next_id = 1000
    for sc in scenario_configs:
        cls = BEHAVIOR_CLASSES.get(sc["scenario_type"])
        if cls is None:
            continue
        behaviors.append(cls(sc["trigger_position"], next_id, seed,
                             params=sc.get("other_parameters")))
        next_id += 1
    return behaviors
