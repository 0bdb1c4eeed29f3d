"""(Copy of transfuser_tpu/tools/visualize.py; the figures are drawn with
sim/raster.py and written with data/png.py, without matplotlib.)

Debug visualizations: model I/O renders + route/scenario maps.

Behavioral spec: model.py:936-1030 (visualize_model_io: rgb / BEV +
pred/gt boxes + waypoints / depth / semantics panel saved per step when
config.debug) and tools/dataset/vis_points.py (route + scenario-trigger
maps). Purely host-side and numpy only (it never imports torch), so it
runs on the card's machine, which has no matplotlib. The JAX package
draws with matplotlib; the panels here hold the same content, drawn as
pixels: no titles, legends, axes or anti-aliasing (each function's
docstring says what stands in for them).
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from ..data import png
from ..sim import raster

# BGR->RGB of reference classes_list (config.py:79-87).
SEMANTIC_COLORS = np.array([
    [0, 0, 0], [0, 0, 255], [128, 64, 128], [255, 0, 0],
    [0, 255, 0], [157, 234, 50], [255, 255, 255],
], np.uint8)

# matplotlib's default colour cycle ("tab10"), for per-route colours
TAB10 = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
         (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
         (188, 189, 34), (23, 190, 207)]

ToPx = Callable[[np.ndarray], np.ndarray]


def semantic_to_rgb(class_ids: np.ndarray) -> np.ndarray:
    return SEMANTIC_COLORS[np.clip(class_ids, 0, len(SEMANTIC_COLORS) - 1)]


# ---------------------------------------------------------------- drawing

def identity_px(xy: np.ndarray) -> np.ndarray:
    """Coordinates that already are (column, row) pixels."""
    return np.rint(np.asarray(xy, np.float64)).astype(np.int64)


def world_canvas(xy: np.ndarray, pixels_per_meter: float, margin: float,
                 background: int = 255) -> Tuple[np.ndarray, ToPx]:
    """A blank RGB canvas spanning the (N, 2) world points plus ``margin``
    metres, and the map from world (x, y) to its pixels (y up, equal
    scales, as matplotlib's ``set_aspect("equal")``)."""
    xy = np.asarray(xy, np.float64).reshape(-1, 2)
    if len(xy) == 0:
        xy = np.zeros((1, 2))
    lo = xy.min(axis=0) - margin
    hi = xy.max(axis=0) + margin
    w = int((hi[0] - lo[0]) * pixels_per_meter) + 1
    h = int((hi[1] - lo[1]) * pixels_per_meter) + 1
    img = np.full((h, w, 3), background, np.uint8)

    def to_px(p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, np.float64).reshape(-1, 2)
        return np.rint(np.stack([(p[:, 0] - lo[0]) * pixels_per_meter,
                                 (hi[1] - p[:, 1]) * pixels_per_meter],
                                axis=1)).astype(np.int64)

    return img, to_px


def draw_dots(img: np.ndarray, px: np.ndarray, color, radius: int) -> None:
    """Filled discs of ``radius`` at the (N, 2) pixel points (a thick
    polyline of zero length is its round end cap)."""
    px = np.asarray(px, np.int64).reshape(-1, 2)
    raster.polylines(img, [np.stack([p, p]) for p in px], color,
                     2 * radius)


def draw_crosses(img: np.ndarray, px: np.ndarray, color, half: int,
                 thickness: int = 2) -> None:
    """'x' markers of half-width ``half`` at the (N, 2) pixel points."""
    d = np.array([[-half, -half], [half, half]])
    e = np.array([[-half, half], [half, -half]])
    raster.polylines(img, [p + k for p in np.asarray(px, np.int64)
                           for k in (d, e)], color, thickness)


def draw_line(img: np.ndarray, px: np.ndarray, color,
              thickness: int = 1) -> None:
    raster.polylines(img, [np.asarray(px, np.int64)], color, thickness)


def _gray(x: np.ndarray) -> np.ndarray:
    """Autoscaled to 0..255 as ``imshow`` scales a single-channel array
    (its minimum black, its maximum white)."""
    x = np.asarray(x, np.float64)
    span = x.max() - x.min() if x.size else 0.0
    g = (x - x.min()) / span if span > 0 else np.zeros_like(x)
    return np.repeat(np.rint(g * 255).astype(np.uint8)[..., None], 3, 2)


def _tile(panels: Sequence[Sequence[Optional[np.ndarray]]]) -> np.ndarray:
    """Rows of RGB panels on a white canvas, 8 px apart (an empty panel
    stays white)."""
    gap = 8
    rows = [[p for p in row if p is not None] for row in panels]
    heights = [max((p.shape[0] for p in row), default=0) for row in rows]
    widths = [sum(p.shape[1] for p in row) + gap * max(len(row) - 1, 0)
              for row in rows]
    img = np.full((sum(heights) + gap * (len(rows) - 1), max(widths), 3),
                  255, np.uint8)
    y = 0
    for row, h in zip(rows, heights):
        x = 0
        for p in row:
            img[y:y + p.shape[0], x:x + p.shape[1]] = p
            x += p.shape[1] + gap
        y += h + gap
    return img


# ---------------------------------------------------------------- figures

def render_model_io(save_path: str, step: int, rgb: np.ndarray,
                    lidar_bev: np.ndarray, target_point: np.ndarray,
                    pred_wp: np.ndarray,
                    pred_bev: Optional[np.ndarray] = None,
                    pred_semantic: Optional[np.ndarray] = None,
                    pred_depth: Optional[np.ndarray] = None,
                    boxes: Optional[np.ndarray] = None,
                    gt_wp: Optional[np.ndarray] = None,
                    pixels_per_meter: float = 8.0) -> str:
    """Write a combined debug panel; returns the png path.

    The JAX package's 2x2 matplotlib figure, as pixels: top row the
    camera and the LiDAR BEV (both slices summed, autoscaled gray) with
    the ground-truth waypoints (green), the predicted ones (red), the
    target point (a blue 'x') and the boxes (yellow outlines); bottom row
    the predicted depth (autoscaled gray; matplotlib used "magma") and
    the predicted semantics in ``SEMANTIC_COLORS``, or else the BEV
    classes in the same palette (matplotlib used "viridis"). A missing
    panel stays white; there are no titles or legend."""
    cam = np.clip(np.asarray(rgb, np.float64), 0, 255).astype(np.uint8)
    bev = _gray(lidar_bev[..., 0] + lidar_bev[..., 1])

    # waypoints in lidar frame -> BEV pixels (x fwd -> -row, y -> col)
    def to_px(points):
        points = np.asarray(points, np.float64).reshape(-1, 2)
        px = 128 + points[:, 1] * pixels_per_meter
        py = 256 - (points[:, 0] + 1.3) * pixels_per_meter
        return identity_px(np.stack([px, py], axis=1))

    if boxes is not None:
        for b in boxes:
            x, y, w, h, yaw = b[:5]
            c, s = math.cos(yaw), math.sin(yaw)
            local = np.array([[-h, -w], [-h, w], [h, w], [h, -w], [-h, -w]])
            rot = local @ np.array([[c, -s], [s, c]]).T
            draw_line(bev, identity_px(rot + [x, y]), (255, 255, 0))
    for wp, color in ((gt_wp, (0, 160, 0)), (pred_wp, (255, 0, 0))):
        if wp is not None:
            px = to_px(wp)
            draw_line(bev, px, color)
            draw_dots(bev, px, color, 2)
    draw_crosses(bev, to_px(target_point), (0, 0, 255), 5)

    depth = None if pred_depth is None else _gray(pred_depth)
    classes = None
    if pred_semantic is not None:
        ids = np.argmax(pred_semantic, axis=-1) \
            if pred_semantic.ndim == 3 else pred_semantic
        classes = semantic_to_rgb(ids)
    elif pred_bev is not None:
        classes = semantic_to_rgb(np.argmax(pred_bev, axis=-1)
                                  if pred_bev.ndim == 3 else pred_bev)

    os.makedirs(save_path, exist_ok=True)
    out = os.path.join(save_path, f"{step:05d}.png")
    png.write(out, _tile([[cam, bev], [depth, classes]]))
    return out


def render_routes_map(routes_xml: str, scenarios_json: Optional[str],
                      out_path: str, town_map=None) -> str:
    """Plot route polylines + scenario trigger points (vis_points.py /
    set_new_scenarios.py debug view). With a `town_map`
    (sim/town_map.TownMap), the road network is drawn underneath.

    As pixels, 2 px per metre with a 10 m margin, y up: the lanes light
    gray at their width, each route a polyline with dots at its
    waypoints in matplotlib's colour cycle, each scenario trigger a black
    'x'. No legend is drawn."""
    from ..harness.route_parser import (load_scenario_annotations,
                                        parse_routes_file)

    routes = [np.array([(t.location.x, t.location.y)
                        for t in cfg.trajectory], np.float64).reshape(-1, 2)
              for cfg in parse_routes_file(routes_xml)]
    triggers = []
    if scenarios_json:
        ann = load_scenario_annotations(scenarios_json)
        for town, scenarios in ann.items():
            for sc in scenarios:
                triggers += [(e["transform"]["x"], e["transform"]["y"])
                             for e in sc.get(
                                 "available_event_configurations", [])]
    triggers = np.array(triggers, np.float64).reshape(-1, 2)
    lanes = list(town_map.lanes.values()) if town_map is not None else []
    ppm = 2.0
    img, to_px = world_canvas(np.concatenate(
        [*routes, triggers, *(lane.centerline for lane in lanes)]),
        pixels_per_meter=ppm, margin=10.0)
    for lane in lanes:
        draw_line(img, to_px(lane.centerline), (204, 204, 204),
                  max(int(round(lane.width * ppm)), 1))
    for i, route in enumerate(routes):
        color = TAB10[i % len(TAB10)]
        draw_line(img, to_px(route), color, 2)
        draw_dots(img, to_px(route), color, 2)
    draw_crosses(img, to_px(triggers), (0, 0, 0), 4)
    png.write(out_path, img)
    return out_path
