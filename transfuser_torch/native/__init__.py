"""The port's native host library (counterpart of transfuser_tpu/native/):
the LiDAR histogram, the depth, semantic and BEV decodes, the crop to
float and the PNG row unfilter, in C++ (``fastloader.cpp``), bound with
ctypes.

At first use ``load`` compiles the source with ``g++ -O3 -fPIC -shared
-std=c++17`` (``CXX`` overrides the compiler) into
``transfuser_torch/_build/`` (git-ignored), under a name that carries a
hash of the source and flags. Each build writes a ``mkstemp`` file there
and renames it into place, so processes that build at once (test
workers) never see a partial library. No library beyond the C++ standard
one is linked: there is no libpng (``data/png.py`` inflates with zlib and
calls ``png_unfilter``).

Unlike the JAX package's loader, a failed build raises with the
compiler's output instead of falling back to numpy. The numpy versions
stay reachable only by an explicit argument (``lidar_to_histogram(...,
use_native=False)``, ``png.decode(..., use_native=False)``) or by calling
``data/decoders.py`` directly. Each wrapper returns exactly what its numpy
version returns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).with_name("fastloader.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: install g++ or set CXX to "
                           "build transfuser_torch/native/fastloader.cpp")
    return cxx


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() +
                          " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfastloader-{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    RuntimeError with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built first if needed, with every argument type set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            for name, args, res in (
                    ("lidar_histogram_f32", [ptr, i64, i64, ptr], None),
                    ("lidar_histogram_f64", [ptr, i64, i64, ptr], None),
                    ("decode_depth", [ptr, i64, ptr], None),
                    ("semantic_convert", [ptr, i64, ptr, i64, ptr], i64),
                    ("decode_bev_roadlane", [ptr, i64, i64, ptr], None),
                    ("crop_to_float", [ptr] + [i64] * 6 + [ptr], None),
                    ("png_unfilter", [ptr, i64, i64, i64, ptr], i64)):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _hwc(img: np.ndarray, channels: int) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != channels:
        raise ValueError(f"expected (H, W, {channels}) uint8, got "
                         f"{img.shape}")
    return img


def lidar_histogram(points: np.ndarray) -> np.ndarray:
    """(N, 3+) points -> (256, 256, 2) float32, equal to
    ``lidar_np.lidar_to_histogram(points, use_native=False)``. A float32
    cloud is read in place (any row stride); any other dtype is read as
    float64."""
    pts = np.asarray(points)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"expected (N, 3+) points, got {pts.shape}")
    if pts.dtype == np.float32:
        fn = load().lidar_histogram_f32
    else:
        pts = pts.astype(np.float64, copy=False)
        fn = load().lidar_histogram_f64
    item = pts.itemsize
    if pts.strides[1] != item or pts.strides[0] % item:
        pts = np.ascontiguousarray(pts)
    out = np.empty((256, 256, 2), np.float32)
    fn(_ptr(pts), pts.shape[0], pts.strides[0] // item, _ptr(out))
    return out


def decode_depth(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) float32, equal to
    ``decoders.decode_depth``."""
    img = _hwc(rgb, 3)
    out = np.empty(img.shape[:2], np.float32)
    load().decode_depth(_ptr(img), out.size, _ptr(out))
    return out


def semantic_convert(seg: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """uint8 ids through ``lut``, equal to ``lut[seg]`` (and so to
    ``decoders.convert_semantics`` with its table); an id outside the
    table raises IndexError, as numpy's indexing does."""
    arr = np.ascontiguousarray(seg, np.uint8)
    table = np.ascontiguousarray(lut, np.uint8)
    out = np.empty_like(arr)
    bad = load().semantic_convert(_ptr(arr), arr.size, _ptr(table),
                                  table.size, _ptr(out))
    if bad:
        raise IndexError(f"semantic id {arr.reshape(-1)[bad - 1]} is "
                         f"outside the table of {table.size}")
    return out


def decode_bev_roadlane(packed: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (2, H, W) float32, equal to
    ``decoders.decode_bev_channels``."""
    img = _hwc(packed, 3)
    h, w = img.shape[:2]
    out = np.empty((2, h, w), np.float32)
    load().decode_bev_roadlane(_ptr(img), h, w, _ptr(out))
    return out


def crop_to_float(image: np.ndarray, crop_hw: Tuple[int, int],
                  crop_shift: float = 0.0) -> np.ndarray:
    """(H, W, C) uint8 -> (crop_h, crop_w, C) float32, equal to
    ``decoders.crop_image(image, crop_hw, crop_shift).astype(np.float32)``
    (the same centre, shift and clamp)."""
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim != 3:
        raise ValueError(f"expected (H, W, C) uint8, got {img.shape}")
    h, w, c = img.shape
    ch, cw = crop_hw
    if h < ch or w < cw:
        raise ValueError(
            f"source {img.shape[:2]} smaller than crop {crop_hw}")
    start_y = h // 2 - ch // 2
    start_x = min(max(w // 2 - cw // 2 + int(crop_shift), 0), w - cw)
    out = np.empty((ch, cw, c), np.float32)
    load().crop_to_float(_ptr(img), w, c, start_y, start_x, ch, cw,
                         _ptr(out))
    return out


def png_unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Inflated PNG rows (H, 1 + stride) uint8, each a filter type byte and
    the filtered bytes, -> the (H, stride) unfiltered bytes. An unknown
    filter type raises ValueError."""
    rows = np.ascontiguousarray(raw, np.uint8)
    if rows.ndim != 2 or rows.shape[1] < 1:
        raise ValueError(f"expected (H, 1 + stride) rows, got {rows.shape}")
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    bad = load().png_unfilter(_ptr(rows), h, stride, bpp, _ptr(out))
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type "
                         f"{rows[bad - 1, 0]}")
    return out
