"""(Copy of transfuser_tpu/data/bev_raster.py with OpenCV's polylines and
convex fill replaced by sim/raster.py, each primitive class drawn in one
batched call.)

Top-down BEV ground-truth rasterizer + bit-packing codec.

Replaces the reference's GPU (torch/CUDA grid_sample) rasterizer
`team_code_autopilot/utils/lts_rendering.py` and the pygame global-map
renderer `utils/map_utils.py` with a vectorized numpy rasterizer:

  * 15-channel local BEV (5 px/m, 500x500 window): ch10 road, ch11 lane
    markings (the two channels the training decode consumes,
    data.py:844-856 reads 10:12), ch5 vehicles, ch6 walkers, ch7-9 traffic
    lights; map_utils.encode_npy_to_pil:251 packs channel (ix + 5c) into
    bit (7-ix) of png channel c.
  * encode/decode round trip is golden-tested against data/decoders.py.

Every mask is one colour, so the strokes of one thickness and the boxes
of one channel are drawn as one union by ``sim/raster.py`` (equal to
OpenCV's ``polylines`` / ``fillConvexPoly`` pixel for pixel); drawing
them one at a time in numpy cost seconds per saved frame.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..sim import raster
from ..sim.replay import Actor
from ..sim.types import Transform

N_CHANNELS = 15
PIXELS_PER_METER = 5
WINDOW = 500  # local crop edge in px (100 m)


def encode_bev_to_png(bev: np.ndarray) -> np.ndarray:
    """(15, H, W) binary -> (H, W, 3) uint8 bit-packing."""
    assert bev.shape[0] == N_CHANNELS
    h, w = bev.shape[1:]
    out = np.zeros((3, h, w), np.uint8)
    for ix in range(5):
        bit_pos = 8 - ix - 1
        for c in range(3):
            out[c] |= (bev[ix + 5 * c] > 0).astype(np.uint8) << bit_pos
    return np.transpose(out, (1, 2, 0))


def _stroke_px(thickness: float) -> int:
    """Stroke width in px of a polyline with half-width `thickness`."""
    return max(int(round(2.0 * thickness)), 1)


def _line_mask(h: int, w: int, polylines: Sequence[np.ndarray],
               thickness: float) -> np.ndarray:
    """Stroke polylines with half-width `thickness` (px coords)."""
    mask = np.zeros((h, w), np.uint8)
    raster.polylines(mask, [np.round(p).astype(np.int32) for p in polylines],
                     1, _stroke_px(thickness))
    return mask.astype(bool)


def _box_corners(center: np.ndarray, extent: np.ndarray,
                 yaw: float) -> np.ndarray:
    """(4, 2) int corners of an oriented box (px coords), rounded as the
    fill takes them."""
    c, s = math.cos(yaw), math.sin(yaw)
    cx, cy = float(center[0]), float(center[1])
    ex, ey = float(extent[0]), float(extent[1])
    corners = np.array([
        [cx + c * ex - s * ey, cy + s * ex + c * ey],
        [cx + c * ex + s * ey, cy + s * ex - c * ey],
        [cx - c * ex + s * ey, cy - s * ex - c * ey],
        [cx - c * ex - s * ey, cy - s * ex + c * ey]])
    return np.round(corners).astype(np.int32)


class BevRasterizer:
    """Renders the ego-centric 15-channel BEV used for topdown labels.

    With a `town_map` (sim/town_map.TownMap) the road (ch10) and
    lane-marking (ch11) channels cover the WHOLE road network near the ego
    — including off-route roads — matching the reference's full-OpenDRIVE
    rendering (utils/lts_rendering.py:13-478, map_utils.py:89-268). The
    route-band path is the map-less fallback.
    """

    def __init__(self, route: Sequence[Transform] = (),
                 road_half_width_m: float = 3.5,
                 lane_marking_width_m: float = 0.2,
                 town_map=None):
        self.route_xy = np.array([[t.location.x, t.location.y]
                                  for t in route]).reshape(-1, 2)
        self.road_half_width = road_half_width_m
        self.lane_width = lane_marking_width_m
        self.town_map = town_map

    def _world_to_px(self, xy: np.ndarray, ego_xy: np.ndarray,
                     ego_yaw: float) -> np.ndarray:
        """World -> local window px: ego at (250, 250), heading up."""
        c, s = math.cos(ego_yaw), math.sin(ego_yaw)
        rel = xy - ego_xy
        fwd = rel[..., 0] * c + rel[..., 1] * s
        left = -rel[..., 0] * s + rel[..., 1] * c
        px = 250.0 + left * PIXELS_PER_METER
        py = 250.0 - fwd * PIXELS_PER_METER
        return np.stack([px, py], axis=-1)

    def _render_map(self, ego_xy: np.ndarray, ego_yaw: float
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Road + lane-marking masks from the full lane network near ego."""
        road = np.zeros((WINDOW, WINDOW), np.uint8)
        by_width: Dict[int, List[np.ndarray]] = {}
        edges: List[np.ndarray] = []
        radius = (WINDOW / 2.0) / PIXELS_PER_METER * 1.5
        for lane in self.town_map.lanes_near(ego_xy[0], ego_xy[1], radius):
            cl = lane.centerline
            px = self._world_to_px(cl, ego_xy, ego_yaw)
            half = lane.width / 2.0
            by_width.setdefault(_stroke_px(half * PIXELS_PER_METER),
                                []).append(np.round(px).astype(np.int32))
            if lane.is_junction:
                continue  # no painted markings inside junctions
            # boundary polylines at +-width/2 lateral offset
            d = np.gradient(cl, axis=0)
            norm = np.hypot(d[:, 0], d[:, 1])
            norm = np.where(norm < 1e-9, 1e-9, norm)
            n = np.stack([-d[:, 1] / norm, d[:, 0] / norm], axis=1)
            for side in (-1.0, 1.0):
                edge = cl + side * half * n
                edges.append(self._world_to_px(edge, ego_xy, ego_yaw))
        for width, lines in by_width.items():
            raster.polylines(road, lines, 1, width)
        marks = _line_mask(WINDOW, WINDOW, edges,
                           max(self.lane_width * PIXELS_PER_METER, 1.0))
        return road.astype(bool), marks

    def render(self, ego: Transform, actors: Sequence[Actor]) -> np.ndarray:
        """-> (15, 500, 500) uint8 local BEV."""
        bev = np.zeros((N_CHANNELS, WINDOW, WINDOW), np.uint8)
        ego_xy = np.array([ego.location.x, ego.location.y])
        ego_yaw = math.radians(ego.rotation.yaw)

        if self.town_map is not None:
            road, marks = self._render_map(ego_xy, ego_yaw)
            bev[10] = road
            bev[11] = marks
        else:
            route_px = self._world_to_px(self.route_xy, ego_xy, ego_yaw)
            road = _line_mask(WINDOW, WINDOW, [route_px],
                              self.road_half_width * PIXELS_PER_METER)
            inner = _line_mask(
                WINDOW, WINDOW, [route_px],
                (self.road_half_width - self.lane_width) * PIXELS_PER_METER)
            bev[10] = road
            bev[11] = road & ~inner  # lane boundary band

        boxes: Dict[int, List[np.ndarray]] = {}
        for actor in actors:
            a_xy = np.array([actor.transform.location.x,
                             actor.transform.location.y])
            center = self._world_to_px(a_xy, ego_xy, ego_yaw)
            yaw_local = math.radians(actor.transform.rotation.yaw) - ego_yaw
            extent_px = np.array([actor.extent.x, actor.extent.y]) \
                * PIXELS_PER_METER
            if actor.type_id.startswith("vehicle"):
                ch = 5
            elif actor.type_id.startswith("walker"):
                ch = 6
            elif actor.type_id.startswith("traffic_light"):
                ch = {"Green": 7, "Yellow": 8, "Red": 9}.get(actor.state, 7)
            else:
                continue
            # yaw measured in image frame: x right = left axis, y down = fwd
            boxes.setdefault(ch, []).append(
                _box_corners(center, extent_px, -yaw_local))
        for ch, corners in boxes.items():
            raster.fill_convex_polys(bev[ch], np.stack(corners), 1)
        return bev
