"""(Copy of transfuser_tpu/agents/autopilot.py.)

Privileged rule-based expert ("autopilot").

Behavioral spec: team_code_autopilot/autopilot.py:24-1190. The expert has
world access through the sim backend:
  * PID route following with controller-state save/load semantics
    (:350-455; nav_planner.py:14-65) — target 4.0 m/s, 3.0 at junctions,
  * privileged brake predicate (:457-796):
      red light  — ego light-detector OBB vs traffic-light trigger volumes,
      stop sign  — trigger OBB + cleared-set bookkeeping,
      walkers    — constant-velocity forecast over 4 s (80 frames),
      vehicles   — kinematic-bicycle forecast of every actor within 30 m,
                   front/back ego half-box OBB tests per future frame,
                   stuck-vehicle override, safety box while standing,
  * steering noise 1e-3 (:59,276), steer buffer, slope throttle hack,
  * future ego boxes for waypoint labels (:1025-1059) and the measurement
    JSON schema (:304-345).

The OBB tests run on the xy plane with a z-interval overlap check — with
upright boxes the reference's 15-axis 3D SAT reduces to exactly this.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..control.gps import GPSBuffer
from ..control.pid import PIDController
from ..control.route_planner import RoutePlanner
from ..geometry import EgoModel, normalize_angle, obb_corners, obb_intersect
from ..harness.route_parser import interpolate_trajectory, \
    location_route_to_gps, RoadOption
from ..sim.replay import Actor, ReplaySimulation
from ..sim.types import Location, Rotation as _Rotation, Transform, \
    VehicleControl
from .base import AutonomousAgent, Track


def _obb3_intersect(center_a, extent_a, yaw_a, za, center_b, extent_b,
                    yaw_b, zb) -> bool:
    """Upright-box intersection: 2D SAT + z-interval overlap."""
    if za[1] < zb[0] or zb[1] < za[0]:
        return False
    # cheap circumscribed-circle reject before the full SAT: boxes whose
    # center distance exceeds the sum of their half-diagonals cannot
    # intersect (the forecast loop tests every nearby box every step)
    dx = float(center_b[0]) - float(center_a[0])
    dy = float(center_b[1]) - float(center_a[1])
    ra = math.hypot(float(extent_a[0]), float(extent_a[1]))
    rb = math.hypot(float(extent_b[0]), float(extent_b[1]))
    if dx * dx + dy * dy > (ra + rb) ** 2:
        return False
    ca = obb_corners(np.asarray(center_a, float), np.asarray(extent_a, float),
                     yaw_a)
    cb = obb_corners(np.asarray(center_b, float), np.asarray(extent_b, float),
                     yaw_b)
    return obb_intersect(ca, cb)


class AutoPilot(AutonomousAgent):
    def setup(self, path_to_conf_file: str = "",
              route_index: Optional[int] = None) -> None:
        self.track = Track.MAP
        self.step = -1
        self.initialized = False
        self.route_index = route_index
        self.save_path: Optional[pathlib.Path] = None
        self.sim: Optional[ReplaySimulation] = None  # injected by harness

        self.frame_rate = 20
        self.frame_rate_sim = 20
        self.save_freq = self.frame_rate_sim // 2

        # Kinematic GPS denoise buffer (autopilot.py:37,215-228): every
        # stored fix is rolled forward through the bicycle model with the
        # applied control each tick, so the average estimates the CURRENT
        # position. A plain boxcar average of raw fixes lags ~speed*2.5 s
        # behind (10 m at 4 m/s) and made the expert spiral on tight
        # junction turns.
        self.gps_buffer = GPSBuffer(maxlen=100, carla_fps=self.frame_rate)
        self.ego_model = EgoModel(dt=1.0 / self.frame_rate)
        self.vehicle_model = EgoModel(dt=1.0 / self.frame_rate)

        # Controller constants (autopilot.py:49-65).
        self.steer_buffer_size = 1
        self.target_speed_slow = 3.0
        self.target_speed_fast = 4.0
        self.clip_delta = 0.25
        self.clip_throttle = 0.75
        self.steer_damping = 0.5
        self.slope_pitch = 10.0
        self.slope_throttle = 0.4
        self.angle_search_range = 0
        self.steer_noise = 1e-3
        self.steer_buffer: deque = deque(maxlen=self.steer_buffer_size)

        self._turn_controller = PIDController(1.25, 0.75, 0.3, n=40)
        self._turn_controller_extrapolation = PIDController(1.25, 0.75, 0.3,
                                                            n=40)
        self._speed_controller = PIDController(5.0, 0.5, 1.0, n=40)
        self._speed_controller_extrapolation = PIDController(5.0, 0.5, 1.0,
                                                             n=40)

        # Red-light detector box (local frame, half extents).
        self.center_bb_light = np.array([-2.0, 0.0, 0.0])
        self.extent_bb_light = np.array([4.5, 1.5, 2.0])

        # Forecasting (autopilot.py:80-90).
        self.extrapolation_seconds_no_junction = 1.0
        self.extrapolation_seconds = 4.0
        self.waypoint_seconds = 4.0
        self.detection_radius = 30.0
        self.light_radius = 15.0
        self.vehicle_speed_buffer: Dict = defaultdict(
            lambda: {"velocity": [], "throttle": [], "brake": []})
        self.stuck_buffer_size = 30
        self.stuck_vel_threshold = 0.1
        self.stuck_throttle_threshold = 0.1
        self.stuck_brake_threshold = 0.1

        self.commands: deque = deque(maxlen=2)
        self.commands.append(4)
        self.commands.append(4)
        self.far_node_prev = np.array([1e5, 1e5])

        self.steer = 0.0
        self.throttle = 0.0
        self.brake = 0.0
        self.target_speed = 4.0
        self.angle = 0.0
        self.junction = False
        self.stop_sign_hazard = False
        self.traffic_light_hazard = False
        self.vehicle_hazard: List[bool] = []
        self.walker_hazard: List[bool] = []
        # The reference expert ships with ignore_stop_signs=True
        # (autopilot.py:110) and eats a 0.8x penalty per sign (0.143/km on
        # Longest6). Its _check_stop_signs machinery works, so we default
        # to COMPLIANT: the expert is the imitation-data ceiling, and our
        # grid towns are dense with stop signs.
        self.ignore_stop_signs = False
        self.cleared_stop_signs: List[int] = []
        self.future_states: Dict = {}
        self._rng = np.random.default_rng(route_index or 0)

        save_root = os.environ.get("SAVE_PATH")
        if save_root:
            name = f"route{route_index}" if route_index is not None else "route"
            self.save_path = pathlib.Path(save_root) / name
            (self.save_path / "measurements").mkdir(parents=True,
                                                    exist_ok=True)

    # -------------------------------------------------------------- sensors
    def sensors(self) -> List[Dict]:
        return [
            {"type": "sensor.opendrive_map", "reading_frequency": 1e-6,
             "id": "hd_map"},
            {"type": "sensor.other.imu", "x": 0.0, "y": 0.0, "z": 0.0,
             "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
             "sensor_tick": 0.05, "id": "imu"},
            {"type": "sensor.other.gnss", "x": 0.0, "y": 0.0, "z": 0.0,
             "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "sensor_tick": 0.01,
             "id": "gps"},
            {"type": "sensor.speedometer", "reading_frequency": 20,
             "id": "speed"},
        ]

    # ----------------------------------------------------------------- init
    def _init(self) -> None:
        # Dense route (1 m hops) for steering; sparse commands for labels.
        self._waypoint_planner = RoutePlanner(3.5, 50.0)
        self._waypoint_planner.set_route(self._dense_plan_gps(), gps=True)
        self._waypoint_planner.save()
        self._waypoint_planner_extrapolation = RoutePlanner(3.5, 50.0)
        self._waypoint_planner_extrapolation.set_route(
            self._dense_plan_gps(), gps=True)
        self._waypoint_planner_extrapolation.save()
        self._command_planner = RoutePlanner(7.5, 50.0)
        self._command_planner.set_route(self._global_plan, gps=True)
        self.initialized = True

    def _dense_plan_gps(self):
        # The expert is privileged: densify ALONG the lane network when
        # the sim map is available (autopilot.py:133 interpolates with
        # the CARLA world map) — linear interpolation of the 50 m plan
        # cuts junction corners and the planner would steer off-road.
        dense = interpolate_trajectory(
            [tf for tf, _ in self._global_plan_world_coord],
            town_map=getattr(self.sim, "town_map", None))
        return location_route_to_gps(dense)

    def _get_position(self, gps: np.ndarray) -> np.ndarray:
        from ..control.route_planner import GPS_CARLA_SCALE
        return np.asarray(gps[:2], np.float64) * GPS_CARLA_SCALE

    # ------------------------------------------------------------- run_step
    def run_step(self, input_data: Dict, timestamp: float) -> VehicleControl:
        self.step += 1
        if not self.initialized:
            self._init()
        return self._get_control(input_data)

    def _get_control(self, input_data: Dict,
                     steer: Optional[float] = None,
                     throttle: Optional[float] = None) -> VehicleControl:
        sim = self.sim
        brake = self._get_brake()

        # Junction flag with an 8 m heading lookahead: the long forecast
        # horizon must engage on the APPROACH, not only once inside —
        # with the 1 s no-junction horizon the ego brakes for a crossing
        # vehicle too late and its nose ends up inside the crosser's
        # swept path (mutual stand-off the blocked criterion then
        # converts into a DNF). Reference surface: autopilot.py junction
        # detection via the ego waypoint; the lookahead is a deliberate
        # robustness extension for dense traffic.
        if sim:
            loc = sim.ego_transform.location
            yaw_r = math.radians(sim.ego_transform.rotation.yaw)
            from ..sim.types import Location as _Loc
            ahead = _Loc(loc.x + 8.0 * math.cos(yaw_r),
                         loc.y + 8.0 * math.sin(yaw_r))
            self.junction = (sim.is_junction(loc)
                             or sim.is_junction(ahead))
        else:
            self.junction = False
        speed = float(input_data["speed"][1]["speed"])
        target_speed = self.target_speed_slow if self.junction \
            else self.target_speed_fast

        theta = float(np.asarray(input_data["imu"][1])[-1])
        if math.isnan(theta):
            theta = 0.0
        pos = self._get_position(np.asarray(input_data["gps"][1]))
        self.gps_buffer.append(pos)
        pos = self.gps_buffer.denoised()

        self._waypoint_planner.load()
        waypoint_route = self._waypoint_planner.run_step(pos)
        self._waypoint_planner.save()
        self._waypoint_planner_extrapolation.load()
        self._waypoint_planner_extrapolation.run_step(pos)
        self._waypoint_planner_extrapolation.save()

        if throttle is None:
            throttle = self._get_throttle(brake, target_speed, speed)
            pitch = sim.ego_transform.rotation.pitch if sim else 0.0
            if pitch > self.slope_pitch:
                throttle += self.slope_throttle

        if steer is None:
            steer = self._get_steer(brake, waypoint_route, pos, theta, speed)

        self.steer_buffer.append(steer)
        control = VehicleControl(
            steer=float(np.mean(self.steer_buffer)
                        + self.steer_noise * self._rng.standard_normal()),
            throttle=float(throttle), brake=float(brake))

        self.steer = control.steer
        self.throttle = control.throttle
        self.brake = control.brake
        self.target_speed = target_speed
        # Roll the GPS buffer forward with the applied control
        # (reference run_step order: control -> update_gps_buffer,
        # autopilot.py:210-213).
        self.gps_buffer.update(control.steer, control.throttle,
                               control.brake > 0.5, theta, speed)
        self._save_waypoints()

        if self.step % self.save_freq == 0 and self.save_path is not None:
            command_route = self._command_planner.run_step(pos)
            far_node, far_command = command_route[1] \
                if len(command_route) > 1 else command_route[0]
            if (np.asarray(far_node) != self.far_node_prev).all():
                self.far_node_prev = np.asarray(far_node)
                self.commands.append(getattr(far_command, "value",
                                             far_command))
            self._save_measurements(pos, input_data, far_node, steer,
                                    throttle, brake, target_speed)
        return control

    # ----------------------------------------------------------------- steer
    def _angle_to(self, pos: np.ndarray, theta: float,
                  target: np.ndarray) -> float:
        # Scalar expansion of r(theta).T @ (target - pos): this runs once
        # per forecast step per tick; the 2x2 matrix construction
        # dominated it (profiled at 6 s/route).
        dx = float(target[0]) - float(pos[0])
        dy = float(target[1]) - float(pos[1])
        c, s = math.cos(theta), math.sin(theta)
        aim_x = c * dx + s * dy
        aim_y = -s * dx + c * dy
        return -math.degrees(math.atan2(-aim_y, aim_x))

    def _route_angle(self, route, pos, theta) -> float:
        if len(route) == 1 or self.angle_search_range <= 2:
            target = route[1][0] if len(route) > 1 else route[0][0]
            return self._angle_to(pos, theta, target) / 90.0
        search = min(len(route), self.angle_search_range)
        best = None
        for i in range(1, search):
            a = self._angle_to(pos, theta, route[i][0]) / 90.0
            if best is None or abs(a) < abs(best):
                best = a
        return best if best is not None else 0.0

    def _get_steer(self, brake: bool, route, pos, theta, speed,
                   restore: bool = True) -> float:
        angle = self._route_angle(route, pos, theta)
        if self._waypoint_planner.is_last:
            angle = 0.0
        if speed < 0.01 and brake:
            angle = 0.0
        self.angle = angle
        if restore:
            self._turn_controller.load()
        steer = self._turn_controller.step(angle)
        if restore:
            self._turn_controller.save()
        steer = round(float(np.clip(steer, -1.0, 1.0)), 3)
        if brake:
            steer *= self.steer_damping
        return steer

    def _get_steer_extrapolation(self, route, pos, theta, speed,
                                 restore: bool = True) -> float:
        angle = self._route_angle(route, pos, theta)
        if self._waypoint_planner_extrapolation.is_last:
            angle = 0.0
        if restore:
            self._turn_controller_extrapolation.load()
        steer = self._turn_controller_extrapolation.step(angle)
        if restore:
            self._turn_controller_extrapolation.save()
        return round(min(max(steer, -1.0), 1.0), 3)

    def _get_throttle(self, brake: bool, target_speed: float, speed: float,
                      restore: bool = True) -> float:
        target_speed = target_speed if not brake else 0.0
        if self._waypoint_planner.is_last:
            target_speed = 0.0
        delta = float(np.clip(target_speed - speed, 0.0, self.clip_delta))
        if restore:
            self._speed_controller.load()
        throttle = self._speed_controller.step(delta)
        if restore:
            self._speed_controller.save()
        throttle = float(np.clip(throttle, 0.0, self.clip_throttle))
        return 0.0 if brake else throttle

    def _get_throttle_extrapolation(self, target_speed: float, speed: float,
                                    restore: bool = True) -> float:
        if self._waypoint_planner_extrapolation.is_last:
            target_speed = 0.0
        delta = min(max(target_speed - speed, 0.0), self.clip_delta)
        if restore:
            self._speed_controller_extrapolation.load()
        throttle = self._speed_controller_extrapolation.step(delta)
        if restore:
            self._speed_controller_extrapolation.save()
        return min(max(throttle, 0.0), self.clip_throttle)

    # ----------------------------------------------------------------- brake
    def _ego_state(self):
        sim = self.sim
        tf = sim.ego_transform
        return (np.array([tf.location.x, tf.location.y]),
                math.radians(tf.rotation.yaw), sim.ego_speed,
                np.array([sim.ego_extent.x, sim.ego_extent.y]),
                tf.location.z)

    def _nearby(self, prefix: str) -> List[Actor]:
        sim = self.sim
        ego = sim.ego_transform.location
        return [a for a in sim.actors_of_type(prefix)
                if a.transform.location.distance(ego) < self.detection_radius]

    def _get_brake(self) -> bool:
        sim = self.sim
        if sim is None:
            return False
        ego_xy, ego_yaw, speed, ego_extent, ego_z = self._ego_state()

        light_hazard = self._check_red_light(ego_xy, ego_yaw, ego_z)
        stop_sign_hazard = self._check_stop_signs(ego_xy, ego_yaw, speed,
                                                  ego_extent, ego_z)

        n_future = int(self.extrapolation_seconds * self.frame_rate)
        n_future_no_junction = int(
            self.extrapolation_seconds_no_junction * self.frame_rate)
        horizon = n_future if self.junction else n_future_no_junction

        self.vehicle_hazard = [False] * n_future
        self.walker_hazard = [False] * n_future
        self.hazard_vids: set = set()  # actor ids that tripped the hazard

        # Forecast walkers (constant velocity).
        nearby_walkers = []
        for walker in self._nearby("walker"):
            loc = np.array([walker.transform.location.x,
                            walker.transform.location.y])
            d = np.asarray(walker.direction[:2])
            boxes = []
            for _ in range(horizon):
                loc = loc + d * walker.speed * (1.0 / self.frame_rate)
                boxes.append((loc.copy(),
                              np.array([walker.extent.x, walker.extent.y]),
                              math.radians(walker.transform.rotation.yaw)))
            nearby_walkers.append(boxes)

        # Forecast vehicles (bicycle model under their current control).
        # All nearby vehicles step through the batched bicycle model
        # together — one forward() per horizon step instead of one per
        # (vehicle, step); elementwise numerics are identical.
        nearby_vehicles: Dict[int, list] = {}
        stuck_ids: List[int] = []
        near_ids: List[int] = []
        vehs = self._nearby("vehicle")
        for veh in vehs:
            near_ids.append(veh.actor_id)
            buf = self.vehicle_speed_buffer[veh.actor_id]
            buf["velocity"].append(veh.speed)
            buf["throttle"].append(veh.control.throttle)
            buf["brake"].append(veh.control.brake)
            for k in buf:
                buf[k] = buf[k][-self.stuck_buffer_size:]
            nbuf = len(buf["velocity"])
            if nbuf and \
                    sum(buf["velocity"]) / nbuf < self.stuck_vel_threshold \
                    and sum(buf["throttle"]) / nbuf \
                    > self.stuck_throttle_threshold \
                    and sum(buf["brake"]) / nbuf \
                    < self.stuck_brake_threshold:
                stuck_ids.append(veh.actor_id)
        if vehs:
            locs = np.array([[v.transform.location.x,
                              v.transform.location.y] for v in vehs])
            yaws = np.array([[math.radians(v.transform.rotation.yaw)]
                             for v in vehs])
            spds = np.array([[v.speed] for v in vehs])
            actions = np.array([[v.control.steer, v.control.throttle,
                                 v.control.brake] for v in vehs])
            extents = [np.array([v.extent.x, v.extent.y]) for v in vehs]
            steps = []
            for _ in range(horizon):
                locs, yaws, spds = self.vehicle_model.forward(
                    locs, yaws, spds, actions)
                steps.append((locs, yaws))
            for k, veh in enumerate(vehs):
                nearby_vehicles[veh.actor_id] = [
                    (locs_i[k].copy(), extents[k], float(yaws_i[k, 0]))
                    for locs_i, yaws_i in steps]

        for dead in set(self.vehicle_speed_buffer) - set(near_ids):
            del self.vehicle_speed_buffer[dead]

        # Forecast ego assuming no braking, re-steering along the route.
        # Pure-scalar state: this loop runs `horizon` times per tick and
        # was 46% of benchmark-route wall-clock as (1,)-shaped numpy.
        vehicle_hazard = False
        walker_hazard = False
        lx, ly = float(ego_xy[0]), float(ego_xy[1])
        yaw_s = float(ego_yaw)
        spd_s = float(speed)
        throttle_ex = self._get_throttle_extrapolation(self.target_speed,
                                                       speed)
        steer_a, throt_a, brake_a = float(self.steer), throttle_ex, 0.0
        half = ego_extent.copy()
        half[0] /= 2.0  # front/back half boxes (autopilot.py:713-724)
        half0 = float(half[0])
        z_iv = (ego_z - 1.0, ego_z + 1.0)
        # Vehicles that only ever intersect the ego's BACK half box (a
        # tailgater riding the rear bumper) never become hazards while
        # the back-contact persists (autopilot.py:727-742
        # back_only_vehicle_id) — braking for them would freeze the ego.
        back_only_vids: set = set()
        fwd_scalar = self.ego_model.forward_scalar
        half_pi = math.pi / 2.0

        for i in range(horizon):
            lx, ly, yaw_s, spd_s = fwd_scalar(lx, ly, yaw_s, spd_s,
                                              steer_a, throt_a, brake_a)
            # Re-plan steering from the forecast position (gps frame trick,
            # autopilot.py:697-703).
            pos_gps = (-ly, lx)
            route_ex = self._waypoint_planner_extrapolation.run_step(pos_gps)
            steer_a = self._get_steer_extrapolation(
                route_ex, pos_gps, yaw_s + half_pi, spd_s, restore=False)
            throt_a = self._get_throttle_extrapolation(
                self.target_speed, spd_s, restore=False)
            brake_a = 1.0 if self._waypoint_planner_extrapolation.is_last \
                else 0.0

            cos_y, sin_y = math.cos(yaw_s), math.sin(yaw_s)
            front = (lx + half0 * cos_y, ly + half0 * sin_y)
            back = (lx - half0 * cos_y, ly - half0 * sin_y)

            for vid, boxes in nearby_vehicles.items():
                j = 0 if vid in stuck_ids else i
                c, e, y = boxes[j]
                back_int = _obb3_intersect(back, half, yaw_s, z_iv,
                                           c, e, y, z_iv)
                if vid in back_only_vids:
                    # stays exempt while back-contact persists; once it
                    # clears, it re-enters evaluation NEXT step
                    # (reference semantics: unconditional continue).
                    back_only_vids.discard(vid)
                    if back_int:
                        back_only_vids.add(vid)
                    continue
                front_int = _obb3_intersect(front, half, yaw_s, z_iv,
                                            c, e, y, z_iv)
                if back_int and not front_int:
                    back_only_vids.add(vid)
                if front_int:
                    vehicle_hazard = True
                    self.vehicle_hazard[i] = True
                    self.hazard_vids.add(vid)
            for boxes in nearby_walkers:
                c, e, y = boxes[i]
                if _obb3_intersect(front, half, yaw_s, z_iv, c, e, y, z_iv):
                    walker_hazard = True
                    self.walker_hazard[i] = True

        # Safety box while standing (autopilot.py:762-781).
        bremsweg = ((speed * 3.6) / 10.0) ** 2 / 2.0
        safety_x = float(np.clip(bremsweg + 1.0, 2.0, 4.0))
        cos_y, sin_y = math.cos(ego_yaw), math.sin(ego_yaw)
        safety_center = ego_xy + np.array([safety_x * cos_y,
                                           safety_x * sin_y])
        for vid, boxes in nearby_vehicles.items():
            c, e, y = boxes[0]
            if _obb3_intersect(safety_center, ego_extent, ego_yaw, z_iv,
                               c, e, y, z_iv):
                vehicle_hazard = True
                self.vehicle_hazard[0] = True
                self.hazard_vids.add(vid)
        for boxes in nearby_walkers:
            c, e, y = boxes[0]
            if _obb3_intersect(safety_center, ego_extent, ego_yaw, z_iv,
                               c, e, y, z_iv):
                walker_hazard = True
                self.walker_hazard[0] = True

        self.future_states = {"walker": nearby_walkers,
                              "vehicle": nearby_vehicles}
        self.stop_sign_hazard = stop_sign_hazard
        self.traffic_light_hazard = light_hazard
        return bool(vehicle_hazard or light_hazard or walker_hazard
                    or stop_sign_hazard)

    def _check_red_light(self, ego_xy, ego_yaw, ego_z) -> bool:
        sim = self.sim
        hazard = False
        c, s = math.cos(ego_yaw), math.sin(ego_yaw)
        det_center = ego_xy + np.array([
            self.center_bb_light[0] * c - self.center_bb_light[1] * s,
            self.center_bb_light[0] * s + self.center_bb_light[1] * c])
        z_iv = (ego_z + self.center_bb_light[2] - self.extent_bb_light[2],
                ego_z + self.center_bb_light[2] + self.extent_bb_light[2])
        for light in sim.actors_of_type("traffic_light"):
            if light.transform.location.distance(
                    sim.ego_transform.location) > self.light_radius:
                continue
            if light.state not in ("Red", "Yellow"):
                continue
            lyaw = math.radians(light.transform.rotation.yaw)
            lc, ls = math.cos(lyaw), math.sin(lyaw)
            trig = np.array([light.transform.location.x,
                             light.transform.location.y]) + np.array([
                light.trigger_location.x * lc - light.trigger_location.y * ls,
                light.trigger_location.x * ls + light.trigger_location.y * lc])
            tz = (light.transform.location.z - light.trigger_box.z,
                  light.transform.location.z + light.trigger_box.z)
            if _obb3_intersect(det_center, self.extent_bb_light[:2], ego_yaw,
                               z_iv, trig,
                               np.array([light.trigger_box.x,
                                         light.trigger_box.y]), lyaw, tz):
                hazard = True
        return hazard

    def _check_stop_signs(self, ego_xy, ego_yaw, speed, ego_extent,
                          ego_z) -> bool:
        if self.ignore_stop_signs:
            return False
        sim = self.sim
        hazard = False
        z_iv = (ego_z - 1.0, ego_z + 1.0)
        near_ids = []
        for stop in sim.actors_of_type("static.prop.stop"):
            if stop.transform.location.distance(
                    sim.ego_transform.location) > self.light_radius:
                continue
            near_ids.append(stop.actor_id)
            syaw = math.radians(stop.transform.rotation.yaw)
            sc_, ss_ = math.cos(syaw), math.sin(syaw)
            # trigger volume center = pole transform + rotated local offset
            # (reference transforms trigger_volume.location the same way)
            trig = np.array([
                stop.transform.location.x
                + stop.trigger_location.x * sc_
                - stop.trigger_location.y * ss_,
                stop.transform.location.y
                + stop.trigger_location.x * ss_
                + stop.trigger_location.y * sc_])
            extents = np.array([stop.trigger_box.x, stop.trigger_box.y])
            if _obb3_intersect(ego_xy, ego_extent, ego_yaw, z_iv, trig,
                               extents, syaw, z_iv):
                # RunningStopTest scores the ego CENTER: it must come to
                # <0.1 m/s while the center is inside the trigger
                # (atomic_criteria RunningStopTest). The reference clears
                # on a bb-touch full stop (autopilot.py:540-545), which in
                # our tighter trigger geometry leaves the center outside
                # and still scores an infraction — so the approach bleeds
                # speed to a creep and the full stop happens inside.
                rel = ego_xy - trig
                local = np.array([rel[0] * sc_ + rel[1] * ss_,
                                  -rel[0] * ss_ + rel[1] * sc_])
                center_inside = bool(np.all(np.abs(local) <= extents))
                if stop.actor_id not in self.cleared_stop_signs:
                    if center_inside and speed < 0.1:
                        self.cleared_stop_signs.append(stop.actor_id)
                    elif center_inside or speed > 1.5:
                        hazard = True
        self.cleared_stop_signs = [i for i in self.cleared_stop_signs
                                   if i in near_ids]
        return hazard

    # -------------------------------------------------------------- labels
    def _save_waypoints(self) -> None:
        """Forecast the ego's own future boxes for waypoint labels
        (autopilot.py:1025-1059)."""
        sim = self.sim
        if sim is None:
            return
        ego_xy, ego_yaw, speed, ego_extent, ego_z = self._ego_state()
        n = int(self.waypoint_seconds * self.frame_rate)
        lx, ly = float(ego_xy[0]), float(ego_xy[1])
        yaw_s, spd_s = float(ego_yaw), float(speed)
        steer, throt, brake = (float(self.steer), float(self.throttle),
                               float(self.brake))
        fwd_scalar = self.ego_model.forward_scalar
        boxes = []
        for _ in range(n):
            lx, ly, yaw_s, spd_s = fwd_scalar(lx, ly, yaw_s, spd_s,
                                              steer, throt, brake)
            boxes.append(_SimpleBox(lx, ly, ego_z, math.degrees(yaw_s)))
        self.future_states["ego"] = boxes

    def _save_measurements(self, pos, input_data, far_node, steer, throttle,
                           brake, target_speed) -> None:
        frame = self.step // self.save_freq
        theta = float(np.asarray(input_data["imu"][1])[-1])
        speed = float(input_data["speed"][1]["speed"])

        waypoints = []
        for i, box in enumerate(self.future_states.get("ego", [])):
            if (i + 1) % (self.frame_rate / 2) == 0:
                wx = -box.location.y
                wy = box.location.x
                wtheta = box.rotation.yaw * np.pi / 180.0 + np.pi / 2
                if wtheta < 0:
                    wtheta += 2 * np.pi
                waypoints.append((wx, wy, wtheta))

        data = {
            "x": pos[0], "y": pos[1], "theta": theta, "speed": speed,
            "target_speed": target_speed,
            "x_command": float(np.asarray(far_node)[0]),
            "y_command": float(np.asarray(far_node)[1]),
            "command": self.commands[-2],
            "waypoints": waypoints,
            "steer": steer, "throttle": throttle, "brake": brake,
            "junction": self.junction,
            "vehicle_hazard": any(self.vehicle_hazard),
            "light_hazard": self.traffic_light_hazard,
            "walker_hazard": any(self.walker_hazard),
            "stop_sign_hazard": self.stop_sign_hazard,
            "angle": self.angle,
            "ego_matrix": self.sim.ego_transform.matrix().tolist()
            if self.sim else np.eye(4).tolist(),
        }
        path = self.save_path / "measurements" / f"{frame:04d}.json"
        with open(path, "w") as f:
            json.dump(data, f, indent=4)


class _SimpleBox:
    def __init__(self, x: float, y: float, z: float, yaw_deg: float):
        self.location = Location(x, y, z)
        self.rotation = _Rotation(yaw=yaw_deg)
