"""(Copy of transfuser_tpu/sim/sensors.py with OpenCV's rasterisers replaced by sim/raster.py.)

Procedural camera + lidar synthesis for the hermetic backend.

Gives the datagen path real (if stylized) sensor content so the label
machinery has something true to measure:

  * semantic cameras emit raw CARLA class ids (the input alphabet of
    SEMANTIC_CONVERTER, reference config.py:88-117): road 7, sidewalk 8,
    pedestrian 4, vehicle 10, traffic light 18, sky 13;
  * depth cameras emit the 24-bit RGB encoding the reference decodes with
    ``data_agent.py:_get_depth`` / our data/decoders.decode_depth;
  * lidar returns raycast-style points on actor bounding boxes (density
    ~ 1/distance^2) plus ground returns, in the RAW lidar sensor frame
    (data_agent.py:399-410) — so DataAgent's points-in-bbox counting
    (data_agent.py:362-379) measures the actual saved cloud.

Everything is numpy on the host.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from .. import geometry
from ..data.decoders import resize_nearest
from . import raster

SKY = 13
ROAD = 7
SIDEWALK = 8
VEHICLE = 10
PEDESTRIAN = 4
TRAFFIC_LIGHT = 18
# State-split light classes, same ids the reference's datagen assigns
# when it re-labels the ego-relevant light (data_agent.py:562-581:
# red -> 23, yellow -> 24, green stays 18). The RASTERIZER paints every
# light with its true state id so the rgb palette render can show the
# bulb color — in real CARLA the rgb camera sees the lit bulb, and a
# closed-loop policy that cannot tell red from green can never learn to
# pull away from a stop. The raw 'semantics' SENSOR output downgrades
# 23/24 back to 18 (CARLA's semantic camera is state-blind; datagen
# re-adds state with privileged access, agents/data_agent.py).
TL_RED = 23
TL_YELLOW = 24
# internal render-only id: the back/side of a light head (dark housing,
# state invisible — a camera behind a signal must not read its color).
# Never reaches the semantic sensor output (downgraded to 18 with 23/24).
TL_BACK = 25

# flat render colors for the synthetic rgb camera (id -> rgb)
_PALETTE = {
    SKY: (135, 206, 235), ROAD: (70, 70, 70), SIDEWALK: (160, 160, 160),
    VEHICLE: (0, 0, 142), PEDESTRIAN: (220, 20, 60),
    TRAFFIC_LIGHT: (45, 210, 80), TL_RED: (235, 40, 40),
    TL_YELLOW: (250, 200, 40), TL_BACK: (55, 55, 55), 0: (30, 60, 30),
}

# pooled rgb pixel noise (see semantic_to_rgb): amplitude -> int16 pool
_NOISE_POOLS: Dict[int, np.ndarray] = {}
_NOISE_SLACK = 1 << 16

# traffic-light bulbs are emissive: they keep full brightness at night
# and are not dimmed by weather (they are the brightest pixels in a real
# night frame, which is exactly what makes night driving learnable)
_EMISSIVE = (TRAFFIC_LIGHT, TL_RED, TL_YELLOW)


def encode_depth_rgb(depth_m: np.ndarray) -> np.ndarray:
    """Metric depth -> CARLA 24-bit RGB encoding (R is the high byte),
    inverse of data/decoders.decode_depth."""
    normalized = np.clip(depth_m / 1000.0, 0.0, 1.0)
    v = (normalized * (256.0 ** 3 - 1.0)).astype(np.uint32)
    out = np.zeros(depth_m.shape + (3,), np.uint8)
    out[..., 0] = (v >> 16) & 0xFF
    out[..., 1] = (v >> 8) & 0xFF
    out[..., 2] = v & 0xFF
    return out


# daytime -> brightness, weather -> extra pixel noise (rain droplets) and
# road darkening (wet surfaces); applied by the rgb synthesis so the
# datagen weather shuffle actually changes the recorded frames
_DAYTIME_BRIGHTNESS = {"Night": 0.25, "Twilight": 0.5, "Dawn": 0.6,
                       "Morning": 0.9, "Noon": 1.0, "Sunset": 0.7}
_WEATHER_NOISE = {"Clear": 12, "Cloudy": 14, "Wet": 18, "MidRain": 24,
                  "WetCloudy": 20, "HardRain": 36, "SoftRain": 20}
_RAIN_LIDAR_DROPOFF = {"MidRain": 0.05, "HardRain": 0.12, "SoftRain": 0.02}


def rain_dropoff(weather: Optional[Dict[str, str]]) -> float:
    """Extra lidar dropoff under rain presets (atmospheric attenuation)."""
    if not weather:
        return 0.0
    return _RAIN_LIDAR_DROPOFF.get(weather.get("weather", "Clear"), 0.0)


def semantic_to_rgb(sem: np.ndarray, rng: np.random.Generator,
                    weather: Optional[Dict[str, str]] = None) -> np.ndarray:
    """Palette-render a semantic id image into a plausible rgb frame,
    modulated by the sim's weather/daytime setting.

    One 256-entry LUT gather instead of per-class boolean masks (the
    mask loop was ~9 ms/call = most of the trained-eval camera cost,
    experiments/eval_sim_profile.py round 5); output is bit-identical
    (same float ops per entry, same rng draw order/shape)."""
    w = (weather or {}).get("weather", "Clear")
    d = (weather or {}).get("daytime", "Noon")
    lut = np.zeros((256, 3), np.float32)
    for cid, color in _PALETTE.items():
        lut[cid] = color
    if w in ("Wet", "WetCloudy", "MidRain", "HardRain", "SoftRain"):
        lut[ROAD] *= 0.6  # wet asphalt reads darker
    emissive = np.zeros(256, bool)
    emissive[list(_EMISSIVE)] = True
    lut[~emissive] *= _DAYTIME_BRIGHTNESS.get(d, 1.0)
    rgb = lut[sem]
    noise_amp = _WEATHER_NOISE.get(w, 12)
    # Per-pixel uniform noise from a pre-generated pool at a random
    # offset (one scalar draw) instead of ~150k fresh PCG64 samples per
    # frame — the fresh draw was ~40% of the rgb camera's cost in the
    # closed-loop eval. Same iid uniform[-amp, amp] marginal per frame.
    need = rgb.size
    pool = _NOISE_POOLS.get(noise_amp)
    if pool is None or pool.size < need + _NOISE_SLACK:
        pool = rng.integers(-noise_amp, noise_amp + 1,
                            need + _NOISE_SLACK, dtype=np.int16)
        _NOISE_POOLS[noise_amp] = pool
    off = int(rng.integers(0, pool.size - need + 1))
    noise = pool[off:off + need].reshape(rgb.shape)
    return np.clip(rgb + noise, 0, 255).astype(np.uint8)


class PinholeCamera:
    """Minimal z-buffered rasterizer for one declared camera spec."""

    def __init__(self, width: int, height: int, fov_deg: float,
                 x: float = 1.3, y: float = 0.0, z: float = 2.3,
                 yaw_deg: float = 0.0):
        self.w, self.h = int(width), int(height)
        self.fov = float(fov_deg)
        self.offset = np.array([x, y, z])
        self.yaw = math.radians(yaw_deg)
        self.fx = self.w / (2.0 * math.tan(math.radians(self.fov) / 2.0))
        self.fy = self.fx
        self.cx, self.cy = self.w / 2.0, self.h / 2.0
        # per-pixel ray directions in camera frame (x fwd, y right, z up)
        us, vs = np.meshgrid(np.arange(self.w) + 0.5,
                             np.arange(self.h) + 0.5)
        self.dir_y = (us - self.cx) / self.fx
        self.dir_z = -(vs - self.cy) / self.fy
        # Static ground-plane geometry: the camera is rigid in the ego
        # frame, so the ground-ray intersections never change — computed
        # once here instead of per render (the trained eval renders 3
        # cameras per compute frame, experiments/eval_sim_profile.py).
        dz = self.dir_z
        below = dz < -1e-4
        t = np.where(below, self.offset[2] / np.maximum(-dz, 1e-6), np.inf)
        ground_depth = t.astype(np.float32)
        hit = below & (ground_depth < 200.0)
        self._ground_hit = hit
        self._depth0 = np.where(hit, ground_depth, 1000.0).astype(np.float32)
        self._sem0 = np.where(hit, SIDEWALK, SKY).astype(np.uint8)
        # subsampled ground-hit points in the EGO frame (world pose is
        # applied per render with one rotation): road classification grid
        step = 4
        ys, xs = np.mgrid[0:self.h:step, 0:self.w:step]
        self._sub_hit = hit[ys, xs]
        sub_t = np.where(self._sub_hit, t[ys, xs], 0.0)
        dy = self.dir_y[ys, xs]
        cyw, syw = math.cos(self.yaw), math.sin(self.yaw)
        xc, yc = sub_t, sub_t * dy
        self._sub_xe = xc * cyw - yc * syw + self.offset[0]
        self._sub_ye = xc * syw + yc * cyw + self.offset[1]

    @classmethod
    def from_spec(cls, spec: Dict) -> "PinholeCamera":
        return cls(spec.get("width", 320), spec.get("height", 160),
                   spec.get("fov", 60), spec.get("x", 1.3),
                   spec.get("y", 0.0), spec.get("z", 2.3),
                   spec.get("yaw", 0.0))

    # ------------------------------------------------------------ helpers
    def _world_to_cam(self, pts_world: np.ndarray, ego_xy: np.ndarray,
                      ego_yaw: float) -> np.ndarray:
        """(N, 3) world -> camera frame (x fwd, y right, z up)."""
        c, s = math.cos(ego_yaw), math.sin(ego_yaw)
        rx = pts_world[:, 0] - ego_xy[0]
        ry = pts_world[:, 1] - ego_xy[1]
        # world -> ego vehicle frame (carla: x fwd, y right; local = R^T rel)
        xe = rx * c + ry * s - self.offset[0]
        ye = -rx * s + ry * c - self.offset[1]
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        out = np.empty((pts_world.shape[0], 3))
        out[:, 0] = xe * cy + ye * sy
        out[:, 1] = -xe * sy + ye * cy
        out[:, 2] = pts_world[:, 2] - self.offset[2]
        return out

    def _project(self, cam: np.ndarray) -> np.ndarray:
        """(N, 3) cam-frame -> (N, 2) pixel coords (no clipping)."""
        x = np.maximum(cam[:, 0], 1e-6)
        out = np.empty((cam.shape[0], 2))
        out[:, 0] = self.cx + self.fx * cam[:, 1] / x
        out[:, 1] = self.cy - self.fy * cam[:, 2] / x
        return out

    # ------------------------------------------------------------- render
    def render(self, sim) -> Tuple[np.ndarray, np.ndarray]:
        """-> (semantic raw-id (H, W) uint8, depth_m (H, W) float32)."""
        h, w = self.h, self.w
        # ground plane + sky come from the static per-camera geometry
        depth = self._depth0.copy()
        sem = self._sem0.copy()
        hit = self._ground_hit

        ego = sim.ego_transform
        ego_xy = np.array([ego.location.x, ego.location.y])
        ego_yaw = math.radians(ego.rotation.yaw)

        if sim.town_map is not None:
            # classify road pixels on a subsampled grid, then upsample;
            # the road raster itself is position-cached (see _road_mask)
            ce, se = math.cos(ego_yaw), math.sin(ego_yaw)
            xe, ye = self._sub_xe, self._sub_ye
            wx = ego_xy[0] + xe * ce - ye * se
            wy = ego_xy[1] + xe * se + ye * ce
            ox, oy, n, mask, res = _road_mask(sim.town_map, ego_xy[0],
                                              ego_xy[1])
            ix = np.clip(((wx - ox) / res).astype(np.int32), 0, n - 1)
            iy = np.clip(((wy - oy) / res).astype(np.int32), 0, n - 1)
            road_sub = (mask[iy, ix] > 0) & self._sub_hit
            road_full = resize_nearest(road_sub.astype(np.uint8),
                                       (h, w)) > 0
            sem[hit & road_full] = ROAD

        # actors: painter's algorithm far -> near
        actors = []
        for a in sim.actors:
            d = math.hypot(a.transform.location.x - ego_xy[0],
                           a.transform.location.y - ego_xy[1])
            if d < 120.0:
                actors.append((d, a))
        actors.sort(key=lambda p: -p[0])
        boxes = []  # (cx, cy, yaw_deg, half, base_z, cls_id)
        for d, a in actors:
            if a.type_id.startswith("traffic_light"):
                boxes.extend(_light_head_boxes(a, sim, ego_xy))
                continue
            if a.type_id.startswith("walker"):
                cls_id = PEDESTRIAN
            elif a.type_id.startswith("vehicle"):
                cls_id = VEHICLE
            else:
                continue
            boxes.append((a.transform.location.x, a.transform.location.y,
                          a.transform.rotation.yaw,
                          np.array([a.extent.x, a.extent.y, a.extent.z]),
                          0.0, cls_id))
        if not boxes:
            return sem, depth
        # one batched world->cam transform + projection for ALL boxes
        # (the per-box numpy round trips were ~40% of render time)
        all_corners = np.concatenate(
            [_box_corners_world(bx, by, byaw, half, base_z)
             for bx, by, byaw, half, base_z, _ in boxes])
        cam_all = self._world_to_cam(all_corners, ego_xy, ego_yaw
                                     ).reshape(len(boxes), 8, 3)
        front = cam_all[:, :, 0] > 0.2
        box_depths = np.min(np.maximum(cam_all[:, :, 0], 0.2), axis=1)
        cam_all[:, :, 0] = np.maximum(cam_all[:, :, 0], 0.2)
        px_all = self._project(cam_all.reshape(-1, 3)
                               ).reshape(len(boxes), 8, 2)
        for i, (_, _, _, _, _, cls_id) in enumerate(boxes):
            if not front[i].any():
                continue
            px = px_all[i]
            if np.all(px[:, 0] < 0) or np.all(px[:, 0] >= w) or \
                    np.all(px[:, 1] < 0) or np.all(px[:, 1] >= h):
                continue
            ipx = px.astype(np.int32)
            # fill only the hull's clipped bounding rect — identical
            # pixels, ~100x less memory traffic than full-frame masks
            x0 = max(0, int(ipx[:, 0].min()))
            x1 = min(w, int(ipx[:, 0].max()) + 1)
            y0 = max(0, int(ipx[:, 1].min()))
            y1 = min(h, int(ipx[:, 1].max()) + 1)
            if x0 >= x1 or y0 >= y1:
                continue
            hull = raster.convex_hull(ipx) - np.array([x0, y0], np.int32)
            sub = np.zeros((y1 - y0, x1 - x0), np.uint8)
            raster.fill_convex_polys(sub, hull[None], 1)
            box_depth = float(box_depths[i])
            dview = depth[y0:y1, x0:x1]
            nearer = sub.astype(bool) & (box_depth < dview)
            dview[nearer] = box_depth
            sem[y0:y1, x0:x1][nearer] = cls_id
        return sem, depth


# Road raster cache: a world-aligned 0.5 m/px rasterization of the lane
# network around the ego, rebuilt only when the ego leaves a 16 m box
# around the last build point (the per-render rebuild — ~200 polylines
# over an 880x880 grid, 3 cameras per compute frame — was the single
# largest cost of the trained closed-loop eval). Snapping the origin to
# the raster grid makes road classification a pure function of world
# position, so all cameras/frames sample one consistent raster.
_ROAD_MASK_RES = 0.5
_ROAD_MASK_RAD = 220.0
_ROAD_MASK_MARGIN = 16.0


def _road_mask(tm, ex: float, ey: float):
    cached = getattr(tm, "_road_mask_cache", None)
    if cached is not None:
        ox, oy, n, mask, res, bx, by = cached
        if abs(ex - bx) <= _ROAD_MASK_MARGIN and \
                abs(ey - by) <= _ROAD_MASK_MARGIN:
            return ox, oy, n, mask, res
    res = _ROAD_MASK_RES
    rad = _ROAD_MASK_RAD
    n = int(2 * rad / res)
    ox = math.floor((ex - rad) / res) * res
    oy = math.floor((ey - rad) / res) * res
    origin = np.array([ox, oy])
    mask = np.zeros((n, n), np.uint8)
    # one colour: lanes of one thickness are drawn in one call
    by_thickness: Dict[int, list] = {}
    for lane in tm.lanes_near(ex, ey, rad):
        px = ((lane.centerline - origin) / res).astype(np.int32)
        by_thickness.setdefault(max(1, round(lane.width / res)),
                                []).append(px)
    for thickness, lines in by_thickness.items():
        raster.polylines(mask, lines, 1, thickness)
    tm._road_mask_cache = (ox, oy, n, mask, res, ex, ey)
    return ox, oy, n, mask, res


_TL_STATE_ID = {"Red": TL_RED, "Yellow": TL_YELLOW, "Green": TRAFFIC_LIGHT}


def _light_head_boxes(actor, sim, ego_xy: np.ndarray):
    """Render boxes for one traffic-light actor: the near-side pole head
    plus a far-side head mirrored across the junction center along the
    approach axis (US-style far-side signal).

    Why two heads: real CARLA's rgb camera sees the lit bulb from the stop
    line because its towns hang far-side signals; with only the near pole
    (4 m right of the outer lane) a 60-degree camera loses the light
    exactly when the ego stops at the line, so a trained policy could
    never see its light turn green — measured as the round-5 trained-eval
    stall (car stops at the first red and never restarts).

    Heads are directional: a camera on the faced side (approaching
    traffic) sees the state id (18 green / 23 red / 24 yellow, the
    reference datagen's id convention, data_agent.py:562-581); any other
    view sees the dark housing TL_BACK — you must not be able to read the
    cross street's signal color off its back.
    """
    loc = actor.transform.location
    yaw_deg = actor.transform.rotation.yaw
    yaw = math.radians(yaw_deg)
    fwd = (math.cos(yaw), math.sin(yaw))
    state_id = _TL_STATE_ID.get(getattr(actor, "state", "Green"),
                                TRAFFIC_LIGHT)

    def _faced(hx: float, hy: float) -> bool:
        # the head faces approaching traffic: ego must be BEHIND it
        # along the approach direction to read the bulb
        return ((ego_xy[0] - hx) * fwd[0] + (ego_xy[1] - hy) * fwd[1]) < 0.0

    out = [(loc.x, loc.y, yaw_deg, np.array([0.3, 0.3, 1.5]), 2.0,
            state_id if _faced(loc.x, loc.y) else TL_BACK)]
    tm = getattr(sim, "town_map", None)
    for (cx, cy), half_box in (getattr(tm, "junction_boxes", None) or ()):
        along = (cx - loc.x) * fwd[0] + (cy - loc.y) * fwd[1]
        lat = abs((cy - loc.y) * fwd[0] - (cx - loc.x) * fwd[1])
        if 1.0 < along <= half_box + 14.0 and lat <= half_box + 14.0:
            # mirror the pole across the junction center along the
            # approach axis; mount the head mast-arm high (z 3.4-4.5 m)
            # so stopped vehicles never occlude it
            fx = loc.x + 2.0 * along * fwd[0]
            fy = loc.y + 2.0 * along * fwd[1]
            out.append((fx, fy, yaw_deg, np.array([0.3, 0.3, 0.55]), 3.4,
                        state_id if _faced(fx, fy) else TL_BACK))
            break
    return out


def _box_corners_world(cx: float, cy: float, yaw_deg: float,
                       half: np.ndarray, base_z: float) -> np.ndarray:
    """8 world-frame corners of an upright box sitting base_z above ground."""
    yaw = math.radians(yaw_deg)
    c, s = math.cos(yaw), math.sin(yaw)
    out = []
    for sx in (-1, 1):
        for sy in (-1, 1):
            lx, ly = sx * half[0], sy * half[1]
            wx = cx + lx * c - ly * s
            wy = cy + lx * s + ly * c
            for z in (base_z, base_z + 2 * half[2]):
                out.append([wx, wy, z])
    return np.array(out)


def synth_lidar(sim, max_range: float = 50.0,
                ground_points: int = 1200,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Raycast-style point cloud in the RAW lidar sensor frame (x, y, z, i).

    Points on actor bounding boxes with ~1/d^2 density (a 2 m-tall car at
    10 m gets a few hundred returns, matching the magnitude the reference's
    visibility filters assume) plus uniform ground returns.
    """
    rng = rng or np.random.default_rng(0)
    ego = sim.ego_transform
    ego_xy = np.array([ego.location.x, ego.location.y])
    ego_yaw = math.radians(ego.rotation.yaw)
    c, s = math.cos(ego_yaw), math.sin(ego_yaw)

    pts_v = []  # ego VEHICLE frame (carla: x fwd, y right, z up from ground)
    # ground disc
    r = np.sqrt(rng.random(ground_points)) * max_range
    th = rng.random(ground_points) * 2 * np.pi
    gx, gy = r * np.cos(th), r * np.sin(th)
    pts_v.append(np.stack([gx, gy, np.zeros_like(gx)], axis=1))

    for a in sim.actors:
        if a.type_id.startswith("traffic_light") or \
                a.type_id.startswith("static"):
            continue
        ax = a.transform.location.x - ego_xy[0]
        ay = a.transform.location.y - ego_xy[1]
        # world -> ego vehicle frame (carla: x fwd, y right)
        xe = ax * c + ay * s
        ye = -ax * s + ay * c
        d = math.hypot(xe, ye)
        if d > max_range or d < 0.1:
            continue
        area = 4.0 * a.extent.x * a.extent.z + 4.0 * a.extent.y * a.extent.z
        n = int(min(600.0, max(6.0, 4000.0 * area / (d * d))))
        dyaw = math.radians(a.transform.rotation.yaw) - ego_yaw
        ca, sa = math.cos(dyaw), math.sin(dyaw)
        lx = rng.uniform(-a.extent.x, a.extent.x, n)
        ly = rng.uniform(-a.extent.y, a.extent.y, n)
        lz = rng.uniform(0.05, 2 * a.extent.z - 0.05, n)
        wx = xe + lx * ca - ly * sa
        wy = ye + lx * sa + ly * ca
        pts_v.append(np.stack([wx, wy, lz], axis=1))

    p = np.concatenate(pts_v, axis=0)
    # vehicle frame -> raw lidar sensor frame (data_agent.py:399-410)
    t_v2l = geometry.vehicle_to_lidar()
    hom = np.concatenate([p, np.ones((p.shape[0], 1))], axis=1)
    pl = (t_v2l @ hom.T).T[:, :3]
    intensity = rng.random((pl.shape[0], 1)).astype(np.float64)
    return np.concatenate([pl, intensity], axis=1).astype(np.float32)
