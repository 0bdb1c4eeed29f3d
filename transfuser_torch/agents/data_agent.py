"""(Copy of transfuser_tpu/agents/data_agent.py with OpenCV's PNG writer
replaced by data/png.py.)

Dataset-collection agent: the expert + sensor/label writers.

Behavioral spec: team_code_autopilot/data_agent.py:20-613 — subclasses the
AutoPilot, adds the datagen camera rig (3x rgb + 3x semantics + 3x depth at
320x160 fov60 + high-rate lidar), saves every `save_freq`th frame (0.5 s):
rgb/semantics/depth concat strips, raw lidar .npy, per-actor label_raw
json (get_bev_cars, :282-361), bit-packed topdown BEV and weather
shuffling (:222-242, applied by the hermetic backend's camera and LiDAR
synthesis).

The PNGs hold what the OpenCV writer of the JAX package stores: RGB for
rgb and topdown (its RGB->BGR conversion undone by the BGR writer), the
raw class ids for semantics, and the depth strip's channels in reverse
order (written without a conversion, so OpenCV stores its third channel
as red). ``png.write`` stores filter None where OpenCV filters
adaptively, so the files decode to equal arrays but differ in bytes.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
from typing import Dict, List, Optional

import numpy as np

from ..data import png
from ..data.bev_raster import BevRasterizer, encode_bev_to_png
from ..sim.types import VehicleControl
from .autopilot import AutoPilot

# 7 weathers x 6 daytimes cycled per save tick (data_agent.py:222-242).
WEATHER_PRESETS = [
    "Clear", "Cloudy", "Wet", "MidRain", "WetCloudy", "HardRain", "SoftRain",
]
DAYTIMES = ["Night", "Twilight", "Dawn", "Morning", "Noon", "Sunset"]


class DataAgent(AutoPilot):
    def setup(self, path_to_conf_file: str = "",
              route_index: Optional[int] = None) -> None:
        super().setup(path_to_conf_file, route_index)
        self.weather_index = 0
        self._rasterizer: Optional[BevRasterizer] = None
        if self.save_path is not None:
            for sub in ("rgb", "depth", "semantics", "lidar", "topdown",
                        "label_raw"):
                (self.save_path / sub).mkdir(parents=True, exist_ok=True)

    def sensors(self) -> List[Dict]:
        out = super().sensors()
        # Datagen rig (data_agent.py:87-165): 3 cams x 3 modalities + lidar.
        for mod, stype in (("rgb", "sensor.camera.rgb"),
                           ("semantics", "sensor.camera.semantic_segmentation"),
                           ("depth", "sensor.camera.depth")):
            for pos, yaw in (("front", 0.0), ("left", -60.0),
                             ("right", 60.0)):
                out.append({
                    "type": stype, "x": 1.3, "y": 0.0, "z": 2.3,
                    "roll": 0.0, "pitch": 0.0, "yaw": yaw,
                    "width": 320, "height": 160, "fov": 60,
                    "id": f"{mod}_{pos}"})
        out.append({"type": "sensor.lidar.ray_cast", "x": 1.3, "y": 0.0,
                    "z": 2.5, "roll": 0.0, "pitch": 0.0, "yaw": -90.0,
                    "id": "lidar"})
        return out

    # ------------------------------------------------------------- run_step
    def run_step(self, input_data: Dict, timestamp: float) -> VehicleControl:
        control = super().run_step(input_data, timestamp)
        if self.step % self.save_freq == 0 and self.save_path is not None:
            self._save_sensors(input_data)
            self.shuffle_weather()
        return control

    def shuffle_weather(self) -> Dict[str, str]:
        """Cycle weather/daytime per save tick (data_agent.py:222-242); the
        hermetic backend records the setting instead of applying it."""
        self.weather_index += 1
        w = WEATHER_PRESETS[self.weather_index % len(WEATHER_PRESETS)]
        d = DAYTIMES[(self.weather_index // len(WEATHER_PRESETS))
                     % len(DAYTIMES)]
        setting = {"weather": w, "daytime": d}
        if self.sim is not None and hasattr(self.sim, "set_weather"):
            self.sim.set_weather(setting)
        return setting

    # ----------------------------------------------------------------- save
    def _strip(self, input_data: Dict, mod: str) -> Optional[np.ndarray]:
        keys = [f"{mod}_left", f"{mod}_front", f"{mod}_right"]
        imgs = []
        for k in keys:
            if k not in input_data:
                return None
            arr = np.asarray(input_data[k][1])
            imgs.append(arr[:, :, :3] if arr.ndim == 3 else arr)
        return np.concatenate(imgs, axis=1)

    def _save_sensors(self, input_data: Dict) -> None:
        frame = self.step // self.save_freq
        sp = self.save_path

        rgb = self._strip(input_data, "rgb")
        if rgb is not None:
            png.write(str(sp / "rgb" / f"{frame:04d}.png"),
                      rgb.astype(np.uint8))
        depth = self._strip(input_data, "depth")
        if depth is not None:
            png.write(str(sp / "depth" / f"{frame:04d}.png"),
                      depth.astype(np.uint8)[..., ::-1])
        sem = self._strip(input_data, "semantics")
        if sem is not None:
            sem2d = (sem[..., 0] if sem.ndim == 3 else sem).astype(np.uint8)
            if depth is not None:
                # traffic-light relabel on the strip (data_agent.py:562-581)
                self._change_seg_tl(sem2d, self._depth_strip_meters(depth))
            png.write(str(sp / "semantics" / f"{frame:04d}.png"), sem2d)

        pts = None
        if "lidar" in input_data:
            pts = np.asarray(input_data["lidar"][1], np.float32)
            np.save(str(sp / "lidar" / f"{frame:04d}.npy"),
                    np.array([None, pts], dtype=object), allow_pickle=True)

        self._save_labels(frame, lidar=pts)
        self._save_topdown(frame)

    @staticmethod
    def _depth_strip_meters(depth_rgb: np.ndarray) -> np.ndarray:
        """24-bit RGB depth strip -> meters (data_agent.py:601-613)."""
        d = depth_rgb.astype(np.float32)
        normalized = d[..., 0] * 65536.0 + d[..., 1] * 256.0 + d[..., 2]
        normalized /= (256.0 ** 3 - 1.0)
        return 1000.0 * normalized

    def _change_seg_tl(self, seg_img: np.ndarray, depth_m: np.ndarray,
                       region_size: float = 4.0) -> None:
        """Split the raw traffic-light class (18) into red (23) / yellow
        (24) using the state of the light affecting the ego, in place
        (data_agent.py:562-581). SEMANTIC_CONVERTER maps 23/24 -> training
        class 3, 18 -> 0."""
        sim = self.sim
        if sim is None:
            return
        ego = sim.ego_transform
        cam = np.array([ego.location.x, ego.location.y, 2.3])
        best = None
        for tl in sim.actors:
            if not tl.type_id.startswith("traffic_light"):
                continue
            if tl.state not in ("Red", "Yellow"):
                continue
            d = math.sqrt((tl.transform.location.x - cam[0]) ** 2
                          + (tl.transform.location.y - cam[1]) ** 2
                          + (tl.transform.location.z + 2.0 - cam[2]) ** 2)
            if d < 40.0 and (best is None or d < best[0]):
                best = (d, tl.state)
        if best is None:
            return
        dist, state = best
        state_id = 23 if state == "Red" else 24
        region = np.abs(depth_m - dist)
        seg_img[(region < region_size) & (seg_img == 18)] = state_id

    @staticmethod
    def _points_in_bbox(ego_matrix: np.ndarray, actor_matrix: np.ndarray,
                        extent_half: np.ndarray, lidar: np.ndarray) -> int:
        """Count raw-lidar-frame points inside an actor's box
        (data_agent.py:362-379, without the x/y swap quirk — our transform
        chain is self-consistent, verified by test_datagen)."""
        from .. import geometry
        tr = np.linalg.inv(actor_matrix) @ ego_matrix \
            @ geometry.lidar_to_vehicle()
        pts = tr[:3, :3] @ lidar[:, :3].T + tr[:3, 3:]
        ex, ey, ez = extent_half
        # actor origin sits on the ground plane in the hermetic backend;
        # box spans z in [0, 2*ez]
        return int(((np.abs(pts[0]) < ex) & (np.abs(pts[1]) < ey)
                    & (pts[2] > 0.0) & (pts[2] < 2 * ez)).sum())

    def _save_labels(self, frame: int,
                     lidar: Optional[np.ndarray] = None) -> None:
        """Per-actor label records; ego is record 0 (get_bev_cars,
        data_agent.py:282-361)."""
        sim = self.sim
        if sim is None:
            return
        ego_tf = sim.ego_transform
        records = [{
            "id": 0, "class": "Car",
            "extent": [sim.ego_extent.z, sim.ego_extent.x, sim.ego_extent.y],
            "position": [0.0, 0.0, 0.0],
            "yaw": 0.0, "speed": sim.ego_speed, "brake": self.brake,
            "num_points": -1, "distance": -1,
            "ego_matrix": ego_tf.matrix().tolist(),
        }]
        ego_xy = np.array([ego_tf.location.x, ego_tf.location.y])
        ego_yaw = math.radians(ego_tf.rotation.yaw)
        c, s = math.cos(ego_yaw), math.sin(ego_yaw)
        for actor in sim.actors:
            if actor.type_id.startswith("traffic_light") or \
                    actor.type_id.startswith("static"):
                continue
            a_xy = np.array([actor.transform.location.x,
                             actor.transform.location.y])
            rel = a_xy - ego_xy
            local = np.array([rel[0] * c + rel[1] * s,
                              -rel[0] * s + rel[1] * c])
            dist = float(np.linalg.norm(rel))
            if dist > 50.0:
                continue
            if lidar is not None:
                # real count: points of the saved cloud inside the box
                # (data_agent.py:357-362)
                num_points = self._points_in_bbox(
                    ego_tf.matrix(), actor.transform.matrix(),
                    np.array([actor.extent.x, actor.extent.y,
                              actor.extent.z]), lidar)
            else:
                # visibility proxy when no cloud is available this frame
                num_points = max(0, int(600 / max(dist, 1.0)))
            records.append({
                "id": actor.actor_id,
                "class": "Pedestrian" if actor.type_id.startswith("walker")
                else "Car",
                "extent": [actor.extent.z, actor.extent.x, actor.extent.y],
                "position": [float(local[0]), float(-local[1]), 0.0],
                "yaw": math.radians(actor.transform.rotation.yaw) - ego_yaw,
                "speed": actor.speed,
                "brake": actor.control.brake,
                "num_points": num_points,
                "distance": dist,
                "ego_matrix": actor.transform.matrix().tolist(),
            })
        with open(self.save_path / "label_raw" / f"{frame:04d}.json",
                  "w") as f:
            json.dump(records, f)

    def _save_topdown(self, frame: int) -> None:
        sim = self.sim
        if sim is None:
            return
        if self._rasterizer is None:
            dense = [tf for tf, _ in self._dense_route_world()]
            self._rasterizer = BevRasterizer(
                dense, town_map=getattr(sim, "town_map", None))
        bev = self._rasterizer.render(sim.ego_transform, sim.actors)
        packed = encode_bev_to_png(bev)
        png.write(str(self.save_path / "topdown"
                      / f"encoded_{frame:04d}.png"), packed)

    def _dense_route_world(self):
        from ..harness.route_parser import interpolate_trajectory
        return interpolate_trajectory(
            [tf for tf, _ in self._global_plan_world_coord],
            town_map=getattr(self.sim, "town_map", None))
