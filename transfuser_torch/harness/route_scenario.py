"""(Copy of transfuser_tpu/harness/route_scenario.py.)

Route scenario: ego route + criteria + scenario actor placement.

Behavioral spec: leaderboard/scenarios/route_scenario_local.py:173-572 —
interpolate the route, downsample the 50 m plan, sample at most one
scenario instance per trigger, spawn background traffic, and wire the
criteria list (:532-567). The hermetic backend models scenario adversaries
and background traffic as scripted actors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..sim.replay import Actor, ReplaySimulation
from ..sim.types import Location, Rotation, Transform
from .criteria import (AgentBlockedTest, CollisionTest, Criterion,
                       InRouteTest, OutsideRouteLanesTest,
                       RouteCompletionTest, RunningRedLightTest,
                       RunningStopTest)
from .route_parser import (RoadOption, RouteConfig, downsample_route,
                           interpolate_trajectory, location_route_to_gps)

@dataclass
class RouteScenario:
    config: RouteConfig
    fps: int = 20
    background_vehicles: int = 0
    seed: int = 0
    datagen: bool = False  # datagen profile: no lidar dropoff (wrapper :125)
    # Optional sim.town_map.TownMap. With a map, background traffic DRIVES
    # (TrafficManager car-following, red-light compliance — the moving-
    # traffic semantics of route_scenario_local.py:449-467), traffic
    # lights/stop signs come from the map's signal specs, and the
    # red-light/stop/lane criteria use trigger-volume + stop-line + lane-
    # membership semantics. Without one: legacy parked actors + radial
    # proxies.
    town_map: object = None
    dense_route: List[Tuple[Transform, RoadOption]] = field(init=False)
    global_plan_gps: list = field(init=False)
    global_plan_world: list = field(init=False)
    criteria: List[Criterion] = field(init=False)
    sim: ReplaySimulation = field(init=False)

    def __post_init__(self) -> None:
        self.dense_route = interpolate_trajectory(self.config.trajectory,
                                                  town_map=self.town_map)
        # Route-length-scaled evaluation budget
        # (route_scenario_local.py:52-53,261-273): 0.8 s/m + 5 s. A flat
        # cap penalized long routes as harness-artifact timeouts
        # (VERDICT r2 Missing #3).
        length = 0.0
        prev = self.dense_route[0][0].location
        for tf, _ in self.dense_route[1:]:
            length += tf.location.distance(prev)
            prev = tf.location
        self.route_length_m = length
        self.timeout = int(0.8 * length + 5.0)
        ids = downsample_route(self.dense_route, 50.0)
        sparse = [self.dense_route[i] for i in ids]
        self.global_plan_world = [(tf, opt) for tf, opt in sparse]
        self.global_plan_gps = location_route_to_gps(sparse)

        from .scenarios import build_behaviors
        self.behaviors = build_behaviors(self.config.scenario_configs,
                                         self.seed)
        from .agent_wrapper import (GNSS_NOISE, IMU_NOISE,
                                    pinned_lidar_attributes)
        lidar_attrs = pinned_lidar_attributes(self.datagen)
        actors, light_actors = self._build_signal_actors()
        self.sim = ReplaySimulation(
            [tf for tf, _ in self.dense_route], fps=self.fps,
            actors=actors, seed=self.seed,
            gnss_noise=GNSS_NOISE, imu_noise=IMU_NOISE,
            lidar_dropoff=lidar_attrs.get("dropoff_general_rate", 0.0),
            town_map=self.town_map)
        self._light_actors = light_actors
        if self.town_map is not None:
            from ..sim.traffic import TrafficLightController, TrafficManager
            controller = TrafficLightController(self.town_map)
            tm = TrafficManager(self.town_map, seed=self.seed,
                                controller=controller)
            tm.light_actors = light_actors
            start = self.dense_route[0][0].location
            self.sim.actors.extend(tm.spawn(
                self.background_vehicles, avoid_xy=(start.x, start.y)))
            controller.apply_to_actors(light_actors)
            self.sim.traffic = tm
        else:
            self.sim.actors.extend(self._build_background_traffic())
        # Distinct scenario types can sample the SAME junction approach
        # (Scenario4/7/8/9 trigger pools overlap) — two adversaries
        # stacked on one spawn overlap from t=0 and ram the ego together
        # when woken. Keep the first behavior per spawn spot, drop the
        # rest (srunner's scenario sampling likewise picks one scenario
        # per trigger location, route_scenario_local.py:_scenario_sampling).
        spawned_at: List[Tuple[float, float]] = []
        kept = []
        for behavior in self.behaviors:
            actors = behavior.setup(self.sim)
            spots = [(a.transform.location.x, a.transform.location.y)
                     for a in actors]
            if any(math.hypot(x - px, y - py) < 3.0
                   for x, y in spots for px, py in spawned_at):
                continue  # stacked spawn: this behavior never runs
            spawned_at.extend(spots)
            kept.append(behavior)
            self.sim.actors.extend(actors)
        self.behaviors = kept

        route_tfs = [tf for tf, _ in self.dense_route]
        self._completion = RouteCompletionTest(route_tfs)
        self._outside = OutsideRouteLanesTest(route_tfs,
                                              town_map=self.town_map)
        if self.town_map is not None:
            red_light = RunningRedLightTest(
                light_specs=self.town_map.traffic_lights,
                light_actors=light_actors)
            stop_sign = RunningStopTest(
                stop_specs=self.town_map.stop_signs)
        else:
            red_light = RunningRedLightTest()
            stop_sign = RunningStopTest()
        self.criteria = [
            CollisionTest(),
            InRouteTest(route_tfs),
            self._completion,
            self._outside,
            red_light,
            stop_sign,
            AgentBlockedTest(fps=self.fps),
        ]

    def _build_signal_actors(self):
        """Materialize traffic-light / stop-sign actors from the map specs
        (trigger volumes exposed in the Actor local-offset convention the
        expert's privileged brake predicate reads)."""
        if self.town_map is None:
            return [], {}
        actors: List[Actor] = []
        light_actors: Dict[int, Actor] = {}
        for spec in self.town_map.traffic_lights:
            pole = spec.transform
            yaw = math.radians(pole.rotation.yaw)
            c, s = math.cos(yaw), math.sin(yaw)
            dx = spec.trigger.center[0] - pole.location.x
            dy = spec.trigger.center[1] - pole.location.y
            local = ( dx * c + dy * s, -dx * s + dy * c)
            actor = Actor(
                actor_id=3000 + spec.light_id, type_id="traffic_light",
                transform=pole, state="Green",
                trigger_location=Location(local[0], local[1], 0.0),
                trigger_box=Location(float(spec.trigger.half_extent[0]),
                                     float(spec.trigger.half_extent[1]),
                                     2.0))
            actors.append(actor)
            light_actors[spec.light_id] = actor
        for spec in self.town_map.stop_signs:
            pole = spec.transform
            yaw = math.radians(pole.rotation.yaw)
            c, s = math.cos(yaw), math.sin(yaw)
            dx = spec.trigger.center[0] - pole.location.x
            dy = spec.trigger.center[1] - pole.location.y
            local = ( dx * c + dy * s, -dx * s + dy * c)
            actors.append(Actor(
                actor_id=3500 + spec.sign_id, type_id="static.prop.stop",
                transform=pole,
                # signpost-sized hitbox — the Actor default is a CAR-sized
                # extent, which made curb-side poles collide with vehicles
                # sweeping an adjacent right-turn arc
                extent=Location(0.3, 0.3, 2.0),
                trigger_location=Location(local[0], local[1], 0.0),
                trigger_box=Location(float(spec.trigger.half_extent[0]),
                                     float(spec.trigger.half_extent[1]),
                                     2.0)))
        return actors, light_actors

    # ------------------------------------------------------------- actors
    def _build_background_traffic(self) -> List[Actor]:
        """Dense-traffic spawning (route_scenario_local.py:449-467 uses 500
        vehicles for Longest6); here parked along offsets of the route."""
        actors: List[Actor] = []
        if self.background_vehicles <= 0:
            return actors
        rng = np.random.default_rng(self.seed)
        n_pts = len(self.dense_route)
        for i in range(self.background_vehicles):
            idx = int(rng.integers(0, n_pts))
            tf, _ = self.dense_route[idx]
            side = 6.0 * (1 if i % 2 == 0 else -1)
            yaw = tf.rotation.yaw
            dx = side * math.cos(math.radians(yaw + 90.0))
            dy = side * math.sin(math.radians(yaw + 90.0))
            actors.append(Actor(
                actor_id=2000 + i, type_id="vehicle.background",
                transform=Transform(
                    Location(tf.location.x + dx, tf.location.y + dy, 0.0),
                    Rotation(yaw=yaw))))
        return actors

    # ------------------------------------------------------------ lifecycle
    def tick_criteria(self) -> None:
        for behavior in self.behaviors:
            behavior.tick(self.sim)
        for c in self.criteria:
            c.update(self.sim)

    def should_terminate(self) -> bool:
        return any(getattr(c, "failed", False) for c in self.criteria
                   if c.terminates) or self._completion._done

    def collect_events(self) -> list:
        self._completion.finalize()
        self._outside.finalize()
        events = []
        for c in self.criteria:
            events.extend(c.events)
        return events
