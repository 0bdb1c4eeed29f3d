"""(Copy of transfuser_tpu/tools/result_parser.py; the figures are drawn
with sim/raster.py and written with data/png.py, without matplotlib or
OpenCV.)

Offline evaluation-result aggregation.

Behavioral spec: tools/result_parser.py:100-374 — aggregate one or more
evaluation checkpoint JSONs into a per-route CSV with score/infraction
columns, extract infraction coordinates from event messages, and
optionally render infraction locations onto a town map image.

    python -m transfuser_torch.tools.result_parser results.json \\
        [--csv out.csv] [--map_out map.png] [--town_overlay overlay.png]

runs on either machine (numpy only; it never imports torch).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data import png
from . import visualize

INFRACTION_COLUMNS = (
    "collisions_pedestrian", "collisions_vehicle", "collisions_layout",
    "red_light", "stop_infraction", "outside_route_lanes", "route_dev",
    "route_timeout", "vehicle_blocked",
)

_COORD_RE = re.compile(
    r"x=(-?\d+\.?\d*),\s*y=(-?\d+\.?\d*)(?:,\s*z=(-?\d+\.?\d*))?")


def extract_infraction_coords(message: str) -> Optional[Tuple[float, ...]]:
    """Regex-extract (x, y[, z]) from an infraction message
    (result_parser.py coordinate scraping)."""
    m = _COORD_RE.search(message)
    if not m:
        return None
    return tuple(float(g) for g in m.groups() if g is not None)


def load_results(paths: List[str]) -> List[Dict[str, Any]]:
    out = []
    for p in paths:
        with open(p) as f:
            out.append(json.load(f))
    return out


def per_route_rows(results: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    rows = []
    for data in results:
        for rec in data.get("_checkpoint", {}).get("records", []):
            row: Dict[str, Any] = {
                "route_id": rec.get("route_id"),
                "index": rec.get("index"),
                "status": rec.get("status"),
                "score_composed": rec["scores"]["score_composed"],
                "score_route": rec["scores"]["score_route"],
                "score_penalty": rec["scores"]["score_penalty"],
                "duration_game": rec.get("meta", {}).get("duration_game"),
                "route_length": rec.get("meta", {}).get("route_length"),
            }
            for key in INFRACTION_COLUMNS:
                row[f"n_{key}"] = len(rec["infractions"].get(key, []))
            rows.append(row)
    return rows


def aggregate(results: List[Dict[str, Any]]) -> Dict[str, Any]:
    rows = per_route_rows(results)
    n = max(len(rows), 1)
    agg = {
        "routes": len(rows),
        "avg_score_composed": sum(r["score_composed"] for r in rows) / n,
        "avg_score_route": sum(r["score_route"] for r in rows) / n,
        "avg_score_penalty": sum(r["score_penalty"] for r in rows) / n,
    }
    for key in INFRACTION_COLUMNS:
        agg[f"total_{key}"] = sum(r[f"n_{key}"] for r in rows)
    return agg


def infraction_locations(results: List[Dict[str, Any]]
                         ) -> List[Dict[str, Any]]:
    locations = []
    for data in results:
        for rec in data.get("_checkpoint", {}).get("records", []):
            for key, messages in rec["infractions"].items():
                for msg in messages:
                    coords = extract_infraction_coords(str(msg))
                    if coords:
                        locations.append({
                            "route_id": rec.get("route_id"),
                            "type": key, "x": coords[0], "y": coords[1]})
    return locations


def write_csv(rows: List[Dict[str, Any]], path: str) -> None:
    if not rows:
        return
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)


# World -> map-image pixel calibration for the CARLA town map PNGs
# (reference tools/result_parser.py:25-53, including the per-town axis
# flips baked into getPixel).
TOWN_REFERENCE_COORD = {
    "Town01": (-8.22, -8.187), "Town02": (-13.102, 0.148),
    "Town03": (-291.567, 320.126), "Town04": (-518.496, 398.342),
    "Town05": (-317.72, 217.554), "Town06": (-390.685, -160.232),
}
TOWN_SCALE = {
    "Town01": (757 / 410, 636 / 345), "Town02": (434 / 214, 637 / 314),
    "Town03": (651 / 605, 637 / 590), "Town04": (708 / 940, 627 / 844),
    "Town05": (784 / 540, 632 / 436), "Town06": (920 / 1050, 522 / 570),
}
INFRACTION_COLORS = {
    "collisions_layout": (255, 0, 0), "collisions_pedestrian": (0, 255, 0),
    "collisions_vehicle": (0, 0, 255), "outside_route_lanes": (0, 255, 255),
    "red_light": (255, 255, 0), "route_dev": (255, 0, 255),
    "route_timeout": (255, 255, 255), "stop_infraction": (119, 119, 119),
    "vehicle_blocked": (0, 0, 0),
}


def world_to_pixel(coord: Tuple[float, float], town_name: str,
                   reference_coord: Optional[Tuple[float, float]] = None,
                   scale: Optional[Tuple[float, float]] = None
                   ) -> Tuple[int, int]:
    """World (x, y) -> town-map pixel (getPixel, result_parser.py:42-53)."""
    x, y = coord
    ref = reference_coord or TOWN_REFERENCE_COORD[town_name]
    sc = scale or TOWN_SCALE[town_name]
    pix_x = int((x - ref[0]) * sc[0])
    pix_y = int(-(y - ref[1]) * sc[1])
    if town_name in ("Town03", "Town04"):
        pix_y = int(-(-y - ref[1]) * sc[1])
    if town_name in ("Town01", "Town02", "Town06"):
        pix_x, pix_y = abs(pix_x), abs(pix_y)
    return pix_x, pix_y


def plot_pixel(img, coord: Tuple[float, float], town_name: str,
               color: Tuple[int, int, int],
               reference_coord: Optional[Tuple[float, float]] = None,
               scale: Optional[Tuple[float, float]] = None):
    """Draw the reference's cross marker (plotPixel, result_parser.py:56-64)."""
    px, py = world_to_pixel(coord, town_name, reference_coord, scale)
    length, width = 6, 3
    h, w = img.shape[:2]
    if 0 <= px < w and 0 <= py < h:
        img[max(py - length, 0):py + length + 1,
            max(px - width, 0):px + width + 1] = color
        img[max(py - width, 0):py + width + 1,
            max(px - length, 0):px + length + 1] = color
    return img


def render_town_base_image(town_map, pixels_per_meter: float = 2.0):
    """Rasterize a sim.town_map.TownMap into a base image for overlays.

    Returns (img (H, W, 3) uint8, reference_coord, scale) in the same
    calibration convention as the CARLA PNG path, so world_to_pixel /
    plot_pixel work on hermetic towns too.
    """
    pts = np.concatenate([l.centerline for l in town_map.lanes.values()])
    lo = pts.min(axis=0) - 10.0
    hi = pts.max(axis=0) + 10.0
    w = int((hi[0] - lo[0]) * pixels_per_meter) + 1
    h = int((hi[1] - lo[1]) * pixels_per_meter) + 1
    img = np.full((h, w, 3), 40, np.uint8)
    ref = (float(lo[0]), float(hi[1]))   # pix_y = -(y - ref_y) * sc
    sc = (pixels_per_meter, pixels_per_meter)
    for lane in town_map.lanes.values():
        half_px = max(int(lane.width / 2.0 * pixels_per_meter), 1)
        for p in lane.centerline:
            px = int((p[0] - ref[0]) * sc[0])
            py = int(-(p[1] - ref[1]) * sc[1])
            img[max(py - half_px, 0):py + half_px + 1,
                max(px - half_px, 0):px + half_px + 1] = 90
    return img, ref, sc


def _read_rgb(path: str) -> np.ndarray:
    """A PNG as (H, W, 3) uint8 RGB: gray repeated, alpha dropped."""
    img = png.read(path)
    if img.dtype != np.uint8:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def render_town_overlay(locations: List[Dict[str, Any]], town_name: str,
                        out_path: str,
                        town_img_path: Optional[str] = None,
                        town_map=None) -> None:
    """Infraction crosses on the town map image (result_parser.py:345-371).

    Uses the calibrated CARLA PNG when `town_img_path` is given, else
    rasterizes the hermetic `town_map`. The pixels equal the JAX
    package's (which reads and writes with OpenCV); the file is written
    by data/png.py with filter None, so its bytes differ.
    """
    ref = sc = None
    if town_img_path and os.path.exists(town_img_path):
        img = _read_rgb(town_img_path)
    elif town_map is not None:
        img, ref, sc = render_town_base_image(town_map)
    else:
        raise ValueError("need town_img_path or town_map")
    for loc in locations:
        color = INFRACTION_COLORS.get(loc["type"], (255, 128, 0))
        plot_pixel(img, (loc["x"], loc["y"]), town_name,
                   np.array(color, np.uint8), ref, sc)
    png.write(out_path, img)


def render_infraction_map(locations: List[Dict[str, Any]], out_path: str,
                          town_map: Optional[str] = None) -> None:
    """Scatter infraction coordinates (onto a town map image if given).

    The JAX package's matplotlib figure scatters each type in the colour
    cycle with a legend. Here each infraction is a filled dot of radius 3
    in its ``INFRACTION_COLORS`` colour (the colour is the legend; no
    text is drawn). On a town map image, as on matplotlib's ``imshow``
    axes, (x, y) are read as (column, row); without one the canvas spans
    the points, 2 px per metre with a 10 m margin, y up.
    """
    dots = [(loc["type"], float(loc["x"]), float(loc["y"]))
            for loc in locations]
    if town_map and os.path.exists(town_map):
        img = _read_rgb(town_map)
        to_px = visualize.identity_px
    else:
        xy = np.array([(x, y) for _, x, y in dots], np.float64)
        img, to_px = visualize.world_canvas(
            xy.reshape(-1, 2), pixels_per_meter=2.0, margin=10.0)
    for kind, x, y in dots:
        visualize.draw_dots(img, to_px(np.array([[x, y]])),
                            INFRACTION_COLORS.get(kind, (255, 128, 0)), 3)
    png.write(out_path, img)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("results", nargs="+", help="evaluation checkpoint JSONs")
    p.add_argument("--csv", default="results.csv")
    p.add_argument("--map_out", default=None)
    p.add_argument("--town_map", default=None,
                   help="town map PNG (calibrated CARLA towns) for scatter")
    p.add_argument("--town_overlay", default=None,
                   help="write a pixel-calibrated infraction overlay here")
    p.add_argument("--town_name", default="Town01")
    p.add_argument("--grid_town", default=None,
                   help="hermetic town spec (e.g. 'grid:2x80') to rasterize "
                        "as the overlay base instead of a CARLA PNG")
    args = p.parse_args()

    results = load_results(args.results)
    rows = per_route_rows(results)
    write_csv(rows, args.csv)
    print(json.dumps(aggregate(results), indent=2))
    if args.map_out:
        render_infraction_map(infraction_locations(results), args.map_out,
                              args.town_map)
    if args.town_overlay:
        tm = None
        if args.grid_town:
            from ..harness.evaluator import build_town_map
            tm = build_town_map(args.grid_town)
        render_town_overlay(infraction_locations(results), args.town_name,
                            args.town_overlay,
                            town_img_path=args.town_map, town_map=tm)


if __name__ == "__main__":
    main()
