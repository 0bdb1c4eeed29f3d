"""Learned driving agent: ensemble inference on the card + control heuristics
(counterpart of transfuser_tpu/agents/hybrid_agent.py).

Behavioral spec (team_code_transfuser/submission_agent.py:34-537):
  * setup reads the run-config snapshot and loads EVERY model_*.pth in the
    directory as an ensemble member (:84-99),
  * 3 cameras are center-cropped to 320x160 and concatenated to one
    160x960 strip, then center-cropped to 160x704 (:184-234, 520-536),
  * GPS is denoised with a 100-deep buffer rolled forward through the
    bicycle model (:456-469),
  * action repeat 2: the model runs every 2nd sim frame (:252-254),
  * ensemble fusion: waypoint mean; detection boxes fused by polygon-IoU
    NMS (:321-339),
  * stuck/creep logic + LiDAR safety box emergency stop (:284-288,
    341-390); latentTF, which has no LiDAR, checks the fused predicted
    boxes instead (:396-430).

Each compute frame packs the sensor inputs into one uint8 buffer (camera
pixels, LiDAR hit counts 0..5, target-point raster, the three float32
scalars and, under geometric_fusion, the frame's correspondence grids:
cell indices below 22), uploads it once through pinned memory, widens it
on the device, runs every member's ``forward_ego`` in bf16 and brings the
waypoints and boxes of all members back in one copy. On the card each
member replays its ``forward_ego`` from a CUDA graph from its second
compute frame on (``graphs.py``); members appended to
``members`` after setup are opted in at their first frame. latentTF lists
no LiDAR sensor and reads none: its histogram is zeros (the model replaces
it with a positional grid); geometric_fusion computes the correspondences
on the host from the frame's cloud.

Timing modes (``ControllerConfig``, read on every frame, so a config
swapped after ``setup`` holds):
  * default: the reference's; the frame's forward runs and its outputs
    come back (a full sync) before the control is computed;
  * ``pipelined_fetch``: the frame's forward is dispatched and its outputs
    are copied back without blocking (``non_blocking`` into a pinned
    buffer, then a recorded event); the control comes from the forward
    dispatched at the previous compute frame, whose event the frame
    waits on alone;
  * ``async_inference`` (takes precedence): ``_InferenceWorker``'s thread
    runs the upload, the forwards and the copy back on a CUDA stream the
    agent owns, and hands the previous compute frame's host result back.
  Both lagged modes give the same controls: the first compute frame only
  primes the pipe (it holds the last control and updates the GPS buffer
  as a repeat frame does), and compute frame k drives with the forward
  of compute frame k - 1. With a forward in flight while the next frame
  packs, the frame buffers are two slots (pinned host, device, pinned
  output), each reused only after its event says its last frame is done.
  On the CPU there are no streams or events: copies are synchronous.

Members of any backbone family from reference ``.pth`` files or natively
trained ``model_*.msgpack`` files (the JAX package's inference format,
written by either package's training CLI).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import queue
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import geometry
from ..config import GlobalConfig
from ..control.gps import GPSBuffer
from ..control.nms_ensemble import non_maximum_suppression
from ..control.pid import PIDController, control_pid
from ..control.route_planner import RoutePlanner
from ..control.safety import (bb_detected_in_front_of_vehicle,
                              num_points_in_safety_box)
from ..data.correspondences import lidar_cam_correspondences
from ..data.decoders import rasterize_target_point
from ..data.lidar_np import lidar_to_histogram
from ..data.pack import LIDAR_HIST_MAX
from ..models import LidarCenterNet
from ..sim.types import VehicleControl
from ..train.checkpoint import (CONFIG_SNAPSHOT, list_ensemble_weights,
                                load_inference_weights)
from ..train.jax_import import load_reference_checkpoint, state_dict_from_jax
from ..tracing import span
from .base import AutonomousAgent, Track

_SCALARS = 16  # bytes at the head of the packed frame: tp x, tp y, speed
_SLOTS = 2     # frame buffers: one frame in flight while the next packs


class _InferenceWorker:
    """One daemon thread that runs ``fn(slot)`` (upload, every member's
    forward, copy back, wait) for the frames handed to it, under ``stream``
    (None on the CPU), off the control thread.

    ``submit(slot)`` hands compute frame N's slot over and returns frame
    N-1's host result (None while priming): the one-frame lag of
    ``pipelined_fetch``. An exception raised by ``fn`` is re-raised by the
    next ``submit`` on the control thread. (Counterpart of the JAX agent's
    ``_InferenceWorker``, transfuser_tpu/agents/hybrid_agent.py:54-107.)
    """

    def __init__(self, fn, stream=None):
        self._fn = fn
        self._stream = stream
        self._in: "queue.Queue" = queue.Queue(maxsize=1)
        self._out: "queue.Queue" = queue.Queue(maxsize=1)
        self._pending = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="hybrid-agent-inference")
        self._thread.start()

    def _loop(self) -> None:
        ctx = (contextlib.nullcontext() if self._stream is None
               else torch.cuda.stream(self._stream))
        with ctx:
            while True:
                slot = self._in.get()
                if slot is None:
                    return
                try:
                    self._out.put(self._fn(slot))
                except BaseException as e:  # re-raised on the control side
                    self._out.put(e)

    def submit(self, slot: int):
        prev = None
        if self._pending:
            prev = self._out.get()
            if isinstance(prev, BaseException):
                self._pending = False
                raise prev
        self._in.put(slot)
        self._pending = True
        return prev

    def close(self) -> None:
        if self._pending:
            self._out.get()
            self._pending = False
        self._in.put(None)
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            raise RuntimeError("the inference worker did not stop in 30 s")


class HybridAgent(AutonomousAgent):
    def setup(self, path_to_conf_file: str,
              route_index: Optional[int] = None, device="cuda") -> None:
        self.track = Track.SENSORS
        self.step = -1
        self.initialized = False
        self.config_path = path_to_conf_file
        self.device = torch.device(device)

        if path_to_conf_file and os.path.isdir(path_to_conf_file):
            self.config = GlobalConfig.load(
                os.path.join(path_to_conf_file, CONFIG_SNAPSHOT))
            weight_files = list_ensemble_weights(path_to_conf_file)
        else:
            self.config = GlobalConfig()
            weight_files = []
        ctrl = self.config.controller
        n_pth = sum(p.endswith(".pth") for p in weight_files)
        if n_pth and not self.config.model.gpt.reference_view_unpack:
            # Reference torch checkpoints carry the GPT token-unpack view
            # quirk (models/gpt.py) and, under geometric_fusion, the
            # correspondence-grid view quirk (models/geometric_fusion.py);
            # natively trained members do not. Flip them only when EVERY
            # member needs them, as the JAX agent does.
            if n_pth != len(weight_files):
                raise ValueError(
                    "ensemble mixes reference .pth members (which need "
                    "the GPT view-unpack quirk) with natively trained "
                    "members (which don't): split them into separate "
                    f"model dirs ({path_to_conf_file})")
            gpt = dataclasses.replace(self.config.model.gpt,
                                      reference_view_unpack=True)
            model = dataclasses.replace(self.config.model, gpt=gpt)
            if model.backbone == "geometric_fusion":
                model = dataclasses.replace(model,
                                            geometric_reference_view=True)
            self.config = self.config.replace(model=model)

        cfg = self.config
        self.backbone = cfg.model.backbone
        self.geometric = self.backbone == "geometric_fusion"
        self.members: List[LidarCenterNet] = []
        for i, path in enumerate(weight_files or [None]):
            model = LidarCenterNet(cfg, dtype=torch.bfloat16, device="cpu",
                                   seed=i)
            if path is not None and path.endswith(".pth"):
                model.load_state_dict(load_reference_checkpoint(path, cfg),
                                      strict=True)
            elif path is not None:
                model.load_state_dict(state_dict_from_jax(
                    load_inference_weights(path), cfg), strict=True)
            self.members.append(model.to(self.device))
        self.model_count = len(self.members)
        self._alloc_frame_buffers()

        self.gps_buffer = GPSBuffer(maxlen=ctrl.gps_buffer_max_len,
                                    carla_fps=ctrl.carla_fps)
        self.bb_buffer: deque = deque(maxlen=1)
        self.turn_controller = PIDController(ctrl.turn_kp, ctrl.turn_ki,
                                             ctrl.turn_kd, ctrl.turn_n)
        self.speed_controller = PIDController(ctrl.speed_kp, ctrl.speed_ki,
                                              ctrl.speed_kd, ctrl.speed_n)
        self.stuck_detector = 0
        self.forced_move = 0
        self.use_lidar_safe_check = True
        self.control = VehicleControl(brake=1.0)
        self.pred_wp: Optional[np.ndarray] = None
        # the lagged modes: the slot of the last dispatched forward
        # (pipelined_fetch), the worker thread (async_inference)
        self._pending: Optional[int] = None
        self._worker: Optional[_InferenceWorker] = None

    # ------------------------------------------------------------ frame I/O
    def _alloc_frame_buffers(self) -> None:
        s = self.config.sensors
        self._rgb_shape = (1, s.img_resolution[0], s.img_resolution[1], 3)
        self._lidar_shape = (1, s.lidar_resolution_height,
                             s.lidar_resolution_width, 2)
        self._tpi_shape = (1, s.lidar_resolution_height,
                           s.lidar_resolution_width, 1)
        shapes = [self._rgb_shape, self._lidar_shape, self._tpi_shape]
        if self.geometric:
            g = self.config.model.gpt
            shapes += [(1, g.lidar_vert_anchors, g.lidar_horz_anchors, 5, 2),
                       (1, g.img_vert_anchors, g.img_horz_anchors, 5, 2)]
        self._geo_shapes = shapes[3:]
        sizes = [_SCALARS] + [int(np.prod(sh)) for sh in shapes]
        self._offsets = np.cumsum([0] + sizes)
        cuda = self.device.type == "cuda"
        self._host = [torch.empty(int(self._offsets[-1]), dtype=torch.uint8,
                                  pin_memory=cuda) for _ in range(_SLOTS)]
        self._dev = [torch.empty_like(h, device=self.device)
                     for h in self._host]
        # the lagged modes' outputs, copied back without blocking (made at
        # a slot's first lagged forward), and per slot the event recorded
        # after that copy (a blocking one: a thread that waits on it sleeps
        # instead of spinning on a core)
        self._out: List[Optional[torch.Tensor]] = [None] * _SLOTS
        self._done = [torch.cuda.Event(blocking=True) if cuda else None
                      for _ in range(_SLOTS)]
        self._slot = 0

    def _pack(self, slot: int, rgb: np.ndarray, lidar: np.ndarray,
              tpi: np.ndarray, target_point: np.ndarray, speed: float,
              geo: Tuple[np.ndarray, ...] = ()) -> None:
        """The frame's inputs into the slot's pinned host buffer, once the
        slot's last upload has been read. ``geo``: geometric_fusion's
        (bev_points, cam_points)."""
        with span("agent.pack"):
            if self._done[slot] is not None:
                self._done[slot].synchronize()
            o = self._offsets
            host = self._host[slot].numpy()
            scal = np.zeros(_SCALARS // 4, np.float32)
            scal[:2] = target_point
            scal[2] = speed
            host[o[0]:o[1]] = scal.view(np.uint8)
            host[o[1]:o[2]] = rgb.reshape(-1)
            host[o[2]:o[3]] = lidar.reshape(-1)
            host[o[3]:o[4]] = tpi.reshape(-1)
            for j, pts in enumerate(geo):
                host[o[4 + j]:o[5 + j]] = pts.reshape(-1)

    def _forward(self, slot: int) -> torch.Tensor:
        """One packed upload of the slot, every member's forward_ego; the
        waypoints and boxes of all members flattened, on the device."""
        o = self._offsets
        dev = self._dev[slot]
        with span("agent.upload"):
            dev.copy_(self._host[slot], non_blocking=True)
            sc = dev[o[0]:o[1]].view(torch.float32)
            rgb_d = dev[o[1]:o[2]].reshape(self._rgb_shape).to(torch.float32)
            lidar_d = (dev[o[2]:o[3]].reshape(self._lidar_shape)
                       .to(torch.float32) / LIDAR_HIST_MAX)
            tpi_d = dev[o[3]:o[4]].reshape(self._tpi_shape).to(torch.float32)
            tp_d, speed_d = sc[None, :2], sc[2:3]
            geo_d = [dev[o[4 + j]:o[5 + j]].reshape(sh)
                     for j, sh in enumerate(self._geo_shapes)]
        outs = []
        for model in self.members:
            # the members' weights change only in place and the frame's
            # shapes never change: each forward replays a CUDA graph
            model.replay_forward_ego()
            wp, boxes, _labels = model.forward_ego(rgb_d, lidar_d, tp_d,
                                                   tpi_d, speed_d, *geo_d)
            outs += [wp.to(torch.float32).reshape(-1),
                     boxes.to(torch.float32).reshape(-1)]
        self._out_shapes = (tuple(wp.shape), tuple(boxes.shape))
        return torch.cat(outs)

    def _split(self, flat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Flat outputs -> wp (n_models, 1, 4, 2), boxes (n_models, 1, k,
        8)."""
        wp_shape, boxes_shape = self._out_shapes
        n_wp = int(np.prod(wp_shape))
        per = n_wp + int(np.prod(boxes_shape))
        wps = np.stack([flat[m * per:m * per + n_wp]
                        for m in range(self.model_count)])
        bxs = np.stack([flat[m * per + n_wp:(m + 1) * per]
                        for m in range(self.model_count)])
        return (wps.reshape((self.model_count,) + wp_shape),
                bxs.reshape((self.model_count,) + boxes_shape))

    def _infer(self, *frame) -> Tuple[np.ndarray, np.ndarray]:
        """The reference's timing: pack, forward and the one device->host
        copy, which waits for the device."""
        self._pack(0, *frame)
        flat = self._forward(0)
        with span("agent.readback"):
            flat = flat.cpu().numpy()
        return self._split(flat)

    def _dispatch(self, slot: int) -> int:
        """The packed slot's forward, its outputs copied back into the
        slot's pinned output buffer without blocking, then the slot's event
        recorded on the current stream."""
        flat = self._forward(slot)
        if self._out[slot] is None:
            self._out[slot] = torch.empty(
                flat.shape, dtype=flat.dtype,
                pin_memory=self.device.type == "cuda")
        self._out[slot].copy_(flat, non_blocking=True)
        if self._done[slot] is not None:
            self._done[slot].record()
        return slot

    def _fetch(self, slot: int) -> Tuple[np.ndarray, np.ndarray]:
        """The slot's outputs, after waiting on its event alone."""
        with span("agent.readback"):
            if self._done[slot] is not None:
                self._done[slot].synchronize()
        return self._split(self._out[slot].numpy())

    def _next_slot(self) -> int:
        slot = self._slot
        self._slot = (slot + 1) % _SLOTS
        return slot

    def _start_worker(self) -> _InferenceWorker:
        """The async_inference worker, on a CUDA stream of its own that
        first waits for the work that made the weights and buffers."""
        stream = None
        if self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
        return _InferenceWorker(
            lambda slot: self._fetch(self._dispatch(slot)), stream)

    # -------------------------------------------------------------- sensors
    def sensors(self) -> List[Dict[str, Any]]:
        cfg = self.config
        s = cfg.sensors
        ctrl = cfg.controller
        cams = [("rgb_front", s.camera_rot_0), ("rgb_left", s.camera_rot_1),
                ("rgb_right", s.camera_rot_2)]
        if s.crop_equivalent_rig:
            # crop-equivalent pinhole: same fx, same principal axis as the
            # center crop of the full rig (see SensorConfig docstring)
            cam_w, cam_h = s.img_width, s.img_resolution[0]
            fx = s.camera_width / (2.0 * math.tan(
                math.radians(s.camera_fov) / 2.0))
            cam_fov = math.degrees(2.0 * math.atan(cam_w / (2.0 * fx)))
        else:
            cam_w, cam_h, cam_fov = (s.camera_width, s.camera_height,
                                     s.camera_fov)
        out = [
            {"type": "sensor.camera.rgb",
             "x": s.camera_pos[0], "y": s.camera_pos[1], "z": s.camera_pos[2],
             "roll": rot[0], "pitch": rot[1], "yaw": rot[2],
             "width": cam_w, "height": cam_h,
             "fov": cam_fov, "id": cam_id}
            for cam_id, rot in cams
        ] + [
            {"type": "sensor.other.imu", "x": 0.0, "y": 0.0, "z": 0.0,
             "roll": 0.0, "pitch": 0.0, "yaw": 0.0,
             "sensor_tick": 1.0 / ctrl.carla_fps, "id": "imu"},
            {"type": "sensor.other.gnss", "x": 0.0, "y": 0.0, "z": 0.0,
             "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "sensor_tick": 0.01,
             "id": "gps"},
            {"type": "sensor.speedometer",
             "reading_frequency": ctrl.carla_fps, "id": "speed"},
        ]
        if self.backbone != "latentTF":  # the camera-only family
            out.append({
                "type": "sensor.lidar.ray_cast",
                "x": s.lidar_pos[0], "y": s.lidar_pos[1], "z": s.lidar_pos[2],
                "roll": s.lidar_rot[0], "pitch": s.lidar_rot[1],
                "yaw": s.lidar_rot[2], "id": "lidar"})
        return out

    # ----------------------------------------------------------------- tick
    def _init(self) -> None:
        ctrl = self.config.controller
        self._route_planner = RoutePlanner(ctrl.route_planner_min_distance,
                                           ctrl.route_planner_max_distance)
        self._route_planner.set_route(self._global_plan, gps=True)
        self.initialized = True

    def _crop_camera(self, img: np.ndarray) -> np.ndarray:
        """Camera frame -> center 320x160 crop."""
        s = self.config.sensors
        w3 = s.img_width
        h = s.img_resolution[0]
        start_x = img.shape[1] // 2 - w3 // 2
        start_y = img.shape[0] // 2 - h // 2
        return img[start_y:start_y + h, start_x:start_x + w3]

    def tick(self, input_data: Dict, lite: bool = False) -> Dict[str, Any]:
        """lite=True: pose/speed only (action-repeat frames never look at
        the model inputs)."""
        s = self.config.sensors
        rgb = None
        if not lite:
            strip = np.concatenate([
                self._crop_camera(np.asarray(input_data[cam][1])[:, :, :3])
                for cam in ("rgb_left", "rgb_front", "rgb_right")], axis=1)
            w = s.img_resolution[1]
            start = strip.shape[1] // 2 - w // 2
            rgb = strip[:, start:start + w]

        gps = np.asarray(input_data["gps"][1][:2], np.float64)
        speed = float(input_data["speed"][1]["speed"])
        compass = float(input_data["imu"][1][-1])
        if math.isnan(compass):  # CARLA 0.9.10 NaN guard
            compass = 0.0

        pos = (gps - self._route_planner.mean) * self._route_planner.scale
        self.gps_buffer.append(pos)
        denoised = self.gps_buffer.denoised()
        route = self._route_planner.run_step(denoised)
        next_wp, next_cmd = route[1] if len(route) > 1 else route[0]

        theta = compass + np.pi / 2.0
        r = np.array([[np.cos(theta), -np.sin(theta)],
                      [np.sin(theta), np.cos(theta)]])
        local_command = r.T @ (np.asarray(next_wp) - denoised)

        result = {"rgb": rgb, "gps": pos, "speed": speed, "compass": compass,
                  "target_point": local_command,
                  "next_command": getattr(next_cmd, "value", next_cmd)}
        if not lite and self.backbone != "latentTF":
            result["lidar"] = np.asarray(input_data["lidar"][1])[:, :3]
        return result

    # ------------------------------------------------------------- run_step
    def run_step(self, input_data: Dict, timestamp: float) -> VehicleControl:
        with span("agent.run_step"):
            return self._run_step(input_data)

    def _run_step(self, input_data: Dict) -> VehicleControl:
        self.step += 1
        cfg = self.config
        ctrl = cfg.controller
        if not self.initialized:
            self._init()

        repeat = self.step % ctrl.action_repeat == 1
        with span("agent.tick"):
            tick_data = self.tick(input_data, lite=repeat)

        # action repeat: reuse the previous action on odd frames
        if repeat:
            self.gps_buffer.update(self.control.steer, self.control.throttle,
                                   self.control.brake > 0.5,
                                   tick_data["compass"], tick_data["speed"])
            return self.control

        with span("agent.inputs"):
            frame, is_stuck = self._inputs(tick_data)
        if ctrl.async_inference or ctrl.pipelined_fetch:
            slot = self._next_slot()
            self._pack(slot, *frame)
            if ctrl.async_inference:
                if self._worker is None:
                    self._worker = self._start_worker()
                out = self._worker.submit(slot)
            else:
                pending, self._pending = self._pending, self._dispatch(slot)
                out = None if pending is None else self._fetch(pending)
            if out is None:  # pipeline priming: hold the last control
                self.gps_buffer.update(
                    self.control.steer, self.control.throttle,
                    self.control.brake > 0.5, tick_data["compass"],
                    tick_data["speed"])
                return self.control
            wp, boxes = out
        else:
            wp, boxes = self._infer(*frame)

        # ensemble fusion
        pred_wp = wp.mean(axis=0)[0]   # mean over members
        with span("agent.boxes"):
            member_boxes = [self._metric_boxes(boxes[m, 0])
                            for m in range(self.model_count)]
            fused_boxes = non_maximum_suppression(member_boxes,
                                                  ctrl.iou_threshold_nms)
        self.bb_buffer.append(fused_boxes)
        self.pred_wp = pred_wp

        with span("agent.control"):
            self.control = self._control(pred_wp, fused_boxes, tick_data,
                                         is_stuck)
        return self.control

    def _inputs(self, tick_data: Dict[str, Any]) -> Tuple[tuple, bool]:
        """The frame's model inputs, packed as uint8 (camera pixels are
        uint8 at the source and the histogram takes values k/5, so packing
        is exact), and whether the creep logic holds this frame."""
        cfg = self.config
        ctrl = cfg.controller
        rgb = np.asarray(tick_data["rgb"])
        if rgb.dtype != np.uint8:
            rgb = np.round(rgb).astype(np.uint8)
        if self.backbone == "latentTF":
            lidar_bev = np.zeros(self._lidar_shape[1:], np.uint8)
        else:
            pts = tick_data["lidar"].copy()
            pts[:, 1] *= -1.0
            lidar_bev = np.round(lidar_to_histogram(
                pts, grid=cfg.sensors.lidar_resolution_width)
                * LIDAR_HIST_MAX).astype(np.uint8)
        target_point = np.asarray(tick_data["target_point"], np.float32)
        tp_image = rasterize_target_point(
            target_point, size=cfg.sensors.lidar_resolution_width
        ).astype(np.uint8)

        is_stuck = False
        if self.stuck_detector > ctrl.stuck_threshold and \
                self.forced_move < ctrl.creep_duration:
            is_stuck = True
            self.forced_move += 1

        geo = ()
        if self.geometric:
            # per-frame correspondence grids from the raw cloud
            # (submission_agent.py:302-312); cell indices < 22, so the
            # uint8 upload carries them exactly
            geo = tuple(p.astype(np.uint8) for p in
                        lidar_cam_correspondences(tick_data["lidar"][:, :3]))
        frame = (rgb, lidar_bev, tp_image, target_point, tick_data["speed"],
                 geo)
        return frame, is_stuck

    def _control(self, pred_wp: np.ndarray, fused_boxes: list,
                 tick_data: Dict[str, Any], is_stuck: bool
                 ) -> VehicleControl:
        """PID on the fused waypoints, the stuck logic, the safety box; the
        GPS buffer rolled forward with the control applied."""
        cfg = self.config
        ctrl = cfg.controller
        steer, throttle, brake = control_pid(
            pred_wp, tick_data["speed"], self.turn_controller,
            self.speed_controller, ctrl, is_stuck=is_stuck,
            lidar_pos_x=cfg.sensors.lidar_pos[0])
        if is_stuck and self.forced_move == 1:
            steer = 0.0  # no steer on the first unblocking frame
        if brake or is_stuck:
            steer *= ctrl.steer_damping

        if tick_data["speed"] < 0.1:
            self.stuck_detector += 1
        elif not is_stuck:
            self.stuck_detector = 0
            self.forced_move = 0

        control = VehicleControl(steer=float(steer), throttle=float(throttle),
                                 brake=float(brake))

        # safety override (only while creeping)
        if self.use_lidar_safe_check and is_stuck:
            if self.backbone == "latentTF":
                danger = bb_detected_in_front_of_vehicle(
                    fused_boxes, tick_data["speed"], ctrl)
            else:
                pts = tick_data["lidar"].copy()
                pts[:, 1] *= -1.0
                danger = num_points_in_safety_box(pts, ctrl) > 0
            if danger:
                control = VehicleControl(steer=float(steer), throttle=0.0,
                                         brake=1.0)

        self.gps_buffer.update(control.steer, control.throttle,
                               control.brake > 0.5, tick_data["compass"],
                               tick_data["speed"])
        return control

    # ----------------------------------------------------------- box decode
    def _metric_boxes(self, boxes: np.ndarray
                      ) -> List[Tuple[np.ndarray, float, float]]:
        """Decoded (k, 8) image-space boxes -> metric-frame corner tuples
        (corners(6,2), brake, confidence) above the confidence threshold
        (model.py:713, 808-843)."""
        cfg = self.config
        cnc = cfg.model.centernet
        keep = boxes[:, 7] > cnc.bb_confidence_threshold
        out: List[Tuple[np.ndarray, float, float]] = []
        t_inv = np.linalg.inv(geometry.lidar_to_bevimage())
        ppm = cfg.sensors.pixels_per_meter
        for b in boxes[keep]:
            x, y, w, h, yaw, speed, brake, conf = b
            w = w / cnc.bounding_box_divisor / ppm
            h = h / cnc.bounding_box_divisor / ppm
            center = t_inv @ np.array([x, y, 1.0])
            center = center[:2] + np.asarray(cfg.sensors.lidar_pos[:2])
            center[1] *= -1.0  # back to CARLA right-hand frame
            local = np.array([
                [-h, -w], [-h, w], [h, w], [h, -w],
                [0.0, 0.0], [0.0, h * speed * 0.5]])
            c, s = np.cos(yaw), np.sin(yaw)
            rot = np.array([[c, -s], [s, c]])
            corners = local @ rot.T + center
            out.append((corners, float(brake), float(conf)))
        return out

    def destroy(self) -> None:
        if self._worker is not None:
            self._worker.close()
            self._worker = None
        self.members = []
