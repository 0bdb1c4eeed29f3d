"""(Copy of transfuser_tpu/data/decoders.py, with the augmentation's
rotation rewritten in numpy.)

Host-side sample decoders: depth, bit-packed BEV, crops, augmentation,
box labels, waypoints, target point. Behavioral parity with reference
data.py (cited per function); NHWC outputs.

The JAX package rotates the BEV crop with ``cv2.warpAffine``;
``rotate_bilinear`` computes what that call computes (fixed-point source
coordinates snapped to 1/32 pixel, float32 bilinear weights, zero border),
so the class maps are equal to the JAX reader's, without OpenCV.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import geometry
from ..config import SEMANTIC_CONVERTER

SEM_CONVERTER = np.asarray(SEMANTIC_CONVERTER, dtype=np.uint8)

# OpenCV's warpAffine fixed point (imgproc/src/imgwarp.cpp): source
# coordinates are computed in units of 1/AB_SCALE pixel, rounded, then cut
# to INTER_BITS fractional bits that index a table of bilinear weights.
_INTER_BITS = 5
_INTER_TAB = 1 << _INTER_BITS
_AB_BITS = 10
_AB_SCALE = 1 << _AB_BITS
_TAB_1D = np.arange(_INTER_TAB, dtype=np.float32) * np.float32(1 / _INTER_TAB)


# --------------------------------------------------------------------- depth

def decode_depth(rgb_depth: np.ndarray) -> np.ndarray:
    """24-bit RGB-encoded depth -> [0,1] clipped at 50 m (data.py:358-372).
    rgb_depth: (H, W, 3) uint8 RGB."""
    d = rgb_depth.astype(np.float32)
    normalized = d[..., 0] * 65536.0 + d[..., 1] * 256.0 + d[..., 2]
    normalized /= (256.0 ** 3 - 1.0)
    return np.clip(normalized, 0.0, 0.05) * 20.0


# ------------------------------------------------------------ bit-packed BEV

def decode_bev_channels(packed: np.ndarray) -> np.ndarray:
    """3-channel uint8 png -> road/lane channels 10:12 of the 15-channel
    bit-packing (data.py:844-856; encode side map_utils.encode_npy_to_pil).
    packed: (H, W, 3) uint8 -> (2, H, W) float."""
    img = np.transpose(packed, (2, 0, 1))  # (3, H, W)
    out = np.zeros((2, img.shape[1], img.shape[2]), np.float32)
    # channels 10, 11 come from packed plane 2 at bit positions 7 and 6
    for k, ix in enumerate((0, 1)):
        bit_pos = 8 - ix - 1
        out[k] = (img[2] & (1 << bit_pos)) >> bit_pos
    return out


def rotate_bilinear(src: np.ndarray, degree: float,
                    rows: Optional[Tuple[int, int]] = None,
                    cols: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """(H, W, C) float32 rotated by ``degree`` (counter-clockwise) about
    ((W-1)/2, (H-1)/2), bilinear, zero outside: what
    ``cv2.warpAffine(src, cv2.getRotationMatrix2D(center, degree, 1),
    (W, H), INTER_LINEAR, BORDER_CONSTANT, 0)`` computes, step for step.
    ``rows`` / ``cols`` ([start, stop)) compute only that window of the
    output; each output pixel depends on its own coordinates alone."""
    h, w = src.shape[:2]
    rows, cols = rows or (0, h), cols or (0, w)
    # getRotationMatrix2D (center is a float32 point), then warpAffine's
    # inversion of the 2x3 map, both in double
    cx, cy = float(np.float32((w - 1) / 2.0)), float(np.float32((h - 1) / 2.0))
    rad = degree * np.pi / 180.0
    a, b = np.cos(rad), np.sin(rad)
    m = np.array([[a, b, (1 - a) * cx - b * cy],
                  [-b, a, b * cx + (1 - a) * cy]])
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    i0, i1, i3, i4 = m[1, 1] * det, -m[0, 1] * det, -m[1, 0] * det, \
        m[0, 0] * det
    i2 = -i0 * m[0, 2] - i1 * m[1, 2]
    i5 = -i3 * m[0, 2] - i4 * m[1, 2]
    # source coordinates in 1/1024 px, rounded half to even as cvRound
    # does, then cut to 1/32 px
    xs = np.arange(*cols, dtype=np.float64)
    ys = np.arange(*rows, dtype=np.float64)
    round_delta = _AB_SCALE // _INTER_TAB // 2
    x0 = np.rint((i1 * ys + i2) * _AB_SCALE).astype(np.int64) + round_delta
    y0 = np.rint((i4 * ys + i5) * _AB_SCALE).astype(np.int64) + round_delta
    shift = _AB_BITS - _INTER_BITS
    fx_all = (x0[:, None] + np.rint(i0 * xs * _AB_SCALE).astype(np.int64)) \
        >> shift
    fy_all = (y0[:, None] + np.rint(i3 * xs * _AB_SCALE).astype(np.int64)) \
        >> shift
    sx, sy = fx_all >> _INTER_BITS, fy_all >> _INTER_BITS
    tx1 = _TAB_1D[fx_all & (_INTER_TAB - 1)]
    ty1 = _TAB_1D[fy_all & (_INTER_TAB - 1)]
    tx0, ty0 = np.float32(1) - tx1, np.float32(1) - ty1
    # zero border: a one-pixel frame of zeros, indices clamped into it
    pad = np.zeros((h + 2, w + 2) + src.shape[2:], np.float32)
    pad[1:-1, 1:-1] = src

    def tap(dy, dx):
        return pad[np.clip(sy + dy + 1, 0, h + 1),
                   np.clip(sx + dx + 1, 0, w + 1)]

    wt = [(ty0 * tx0), (ty0 * tx1), (ty1 * tx0), (ty1 * tx1)]
    if src.ndim == 3:
        wt = [v[..., None] for v in wt]
    # the sum in OpenCV's order, in float32
    return tap(0, 0) * wt[0] + tap(0, 1) * wt[1] + tap(1, 0) * wt[2] + \
        tap(1, 1) * wt[3]


def crop_and_encode_bev(bev_road_lane: np.ndarray, degree: float,
                        out_px: int = 160,
                        pixels_per_meter: int = 5) -> np.ndarray:
    """(2, 500, 500)-ish global crop -> (160,160) class map {0,1,2}
    (data.py:586-611): shift 7px for lidar x offset, rotate by augmentation
    angle, crop 160x160, argmax over [zeros, road, road+lane]."""
    arr = np.moveaxis(bev_road_lane, 0, -1).astype(np.float32)  # (H, W, 2)
    shifted = np.zeros_like(arr)
    shifted[7:] = arr[:-7]
    px = 32 * pixels_per_meter
    start_x = 250 - px // 2
    start_y = 250 - px
    window = (start_y, start_y + px), (start_x, start_x + px)
    if degree != 0.0:
        crop = rotate_bilinear(shifted, degree, *window)
    else:
        crop = shifted[start_y:start_y + px, start_x:start_x + px]
    stacked = np.stack([
        np.zeros_like(crop[..., 0]),
        crop[..., 0],
        crop[..., 0] + crop[..., 1],
    ], axis=0)
    return np.argmax(stacked, axis=0).astype(np.int32)


def resize_nearest(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_NEAREST)``: source
    index floor(dst_index / (dst / src)), clamped to the last row/column."""
    def index(dst: int, src: int) -> np.ndarray:
        inv = 1.0 / (dst / src)
        return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64),
                          src - 1)

    return img[index(hw[0], img.shape[0])[:, None],
               index(hw[1], img.shape[1])[None, :]]


# ------------------------------------------------------------------ cropping

def crop_image(image: np.ndarray, crop_hw: Tuple[int, int],
               crop_shift: float = 0.0) -> np.ndarray:
    """Center crop with x shift; HWC in, HWC out (data.py:545-560).

    The stored datagen strip (160x960) always has >=128 px of margin for
    the reference's +-107 px max shift; for sources with less margin the
    shift is clamped so the crop never runs off the edge.
    """
    h, w = image.shape[:2]
    ch, cw = crop_hw
    if h < ch or w < cw:
        raise ValueError(
            f"source {image.shape[:2]} smaller than crop {crop_hw}")
    start_y = h // 2 - ch // 2
    start_x = w // 2 - cw // 2 + int(crop_shift)
    start_x = min(max(start_x, 0), w - cw)
    return image[start_y:start_y + ch, start_x:start_x + cw]


def convert_semantics(seg: np.ndarray) -> np.ndarray:
    """CARLA semantic ids -> 7-class ids (config.py:88-117)."""
    return SEM_CONVERTER[seg]


# ------------------------------------------------------------------- labels

def encode_bbox_label(extent: Sequence[float], position: Sequence[float],
                      yaw: float, speed: float, brake: float,
                      rad: float = 0.0) -> np.ndarray:
    """One actor record -> [cx, cy, w, h, yaw, speed, brake] in 256px BEV
    image space with augmentation rotation (data.py:472-494)."""
    dz, dx, dy = extent
    x, y = position[0], position[1]
    ppm = 8.0
    c, s = np.cos(rad), np.sin(rad)
    aug = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    t = geometry.lidar_to_bevimage() @ aug
    pos = t @ np.array([x, y, 1.0])
    pos = np.clip(pos, 0.0, 255.0)
    return np.array([pos[0], pos[1], dy * ppm, dx * ppm, yaw + rad, speed,
                     brake], dtype=np.float32)


def parse_box_labels(records: List[dict], rad: float = 0.0,
                     max_boxes: int = 20) -> Tuple[np.ndarray, Dict[int, int]]:
    """label_raw records -> padded (max_boxes, 7) + id->slot map. Filters
    boxes with <=1 lidar hits or centers outside the grid (data.py:497-514).
    """
    out = np.zeros((max_boxes, 7), np.float32)
    id_to_slot: Dict[int, int] = {}
    slot = 0
    for rec in records:
        bbox = encode_bbox_label(rec["extent"], rec["position"], rec["yaw"],
                                 rec["speed"], rec["brake"], rad)
        if rec.get("num_points", 2) <= 1:
            continue
        if not (0.0 < bbox[0] < 255.0 and 0.0 < bbox[1] < 255.0):
            continue
        if slot < max_boxes:
            out[slot] = bbox
            id_to_slot[rec["id"]] = slot
            slot += 1
    return out, id_to_slot


# ----------------------------------------------------------------- waypoints

def ego_waypoints_from_labels(label_seq: List[List[dict]], pred_len: int,
                              aug_rad: float = 0.0) -> np.ndarray:
    """Future ego positions in the virtual-lidar frame (data.py:375-409,
    297-305). label_seq: seq of label_raw record lists; ego is record 0."""
    ego_id = label_seq[0][0]["id"]
    base = np.asarray(label_seq[0][0]["ego_matrix"], np.float64)
    base_inv = np.linalg.inv(base)
    t = geometry.vehicle_to_virtual_lidar()
    wps = []
    for i in range(1, pred_len + 1):
        match = next((r for r in label_seq[i] if r["id"] == ego_id), None)
        if match is None:
            m = np.eye(4)
        else:
            m = t @ base_inv @ np.asarray(match["ego_matrix"], np.float64)
        wps.append(m[:2, 3])
    wps = np.asarray(wps, np.float32)
    c, s = np.cos(aug_rad), np.sin(aug_rad)
    rot = np.array([[c, s], [-s, c]], np.float32)
    return (rot @ wps.T).T


# -------------------------------------------------------------- target point

def local_command_point(ego_x: float, ego_y: float, ego_theta: float,
                        x_command: float, y_command: float,
                        aug_rad: float = 0.0) -> np.ndarray:
    """Far-command goal in the ego frame (data.py:338-353; LBC's 90+theta
    convention)."""
    theta = ego_theta + aug_rad
    a = np.pi / 2 + theta
    r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    local = r.T @ np.array([x_command - ego_x, y_command - ego_y])
    return local.astype(np.float32)


def rasterize_target_point(target_point: np.ndarray,
                           size: int = 256) -> np.ndarray:
    """Target point -> (size, size, 1) raster with a filled disc
    (data.py:616-630 draws a cv2 circle radius 5 thickness 3; we draw an
    anti-alias-free disc of outer radius 6.5 to cover the same pixels)."""
    img = np.zeros((size, size), np.float32)
    p = target_point.astype(np.float64).copy()
    p[1] += 1.3
    p *= 8.0
    p[1] *= -1
    p[1] = size - p[1]
    p[0] += size // 2
    p = np.clip(p.astype(np.int64), 0, size)
    cx, cy = int(p[0]), int(p[1])
    rr = 6  # radius 5 + thickness 3 => covered band ~[3.5, 6.5]
    ys, xs = np.ogrid[:size, :size]
    mask = (xs - cx) ** 2 + (ys - cy) ** 2 <= rr * rr
    img[mask] = 1.0
    return img[..., None]
