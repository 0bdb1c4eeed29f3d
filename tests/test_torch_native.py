"""The port's native host library (transfuser_torch/native) against the JAX
package's numpy paths (``lidar_to_histogram(..., use_native=False)``,
``data/decoders.py``), exactly; its PNG row unfilter against the Python
loop and OpenCV on rows of all five filter types; the default dispatch of
``lidar_to_histogram`` and ``png.decode`` to it; and a failed build
raising with the compiler's output."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.config import SEMANTIC_CONVERTER
from transfuser_tpu.data import decoders as jax_decoders
from transfuser_tpu.data import lidar_np as jax_lidar
from transfuser_torch import native
from transfuser_torch.data import lidar_np, png


def _cloud(rng, n=20000, cols=4, dtype=np.float32):
    pts = rng.uniform(-40, 40, (n, cols)).astype(dtype)
    pts[:, 2] = rng.uniform(-4, 2, n)
    # on the window's edges, the last edges included by numpy, and on the
    # height split in the cloud's own precision
    edges = np.zeros((8, cols), dtype)
    edges[:, :3] = [[16, 0, 1], [-16, -32, -3], [15.875, -0.125, -2.3],
                    [-16.0, 0.0, np.float32(-2.3)], [16.0001, -5, 0],
                    [0, 0.0001, 0], [np.nan, 1, 1], [1, -1, np.inf]]
    return np.concatenate([pts, edges])


@pytest.mark.parametrize("cols,dtype", [(4, np.float32), (3, np.float32),
                                        (4, np.float64)],
                         ids=["xyzi_f32", "xyz_f32", "xyzi_f64"])
def test_lidar_histogram_equals_jax_numpy(cols, dtype):
    pts = _cloud(np.random.default_rng(3), cols=cols, dtype=dtype)
    want = jax_lidar.lidar_to_histogram(pts, use_native=False)
    np.testing.assert_array_equal(native.lidar_histogram(pts), want)
    # the default path at grid 256 is the native one, as a strided view
    np.testing.assert_array_equal(lidar_np.lidar_to_histogram(pts), want)
    if cols == 4:
        np.testing.assert_array_equal(
            lidar_np.lidar_to_histogram(pts[:, :3]),
            jax_lidar.lidar_to_histogram(pts[:, :3], use_native=False))
    empty = np.zeros((0, cols), dtype)
    np.testing.assert_array_equal(
        native.lidar_histogram(empty),
        jax_lidar.lidar_to_histogram(empty, use_native=False))


def test_decoders_equal_jax_numpy():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    rgb[0, :3] = [[0, 0, 0], [255, 255, 255], [12, 204, 204]]  # 0, max, 50 m
    np.testing.assert_array_equal(native.decode_depth(rgb),
                                  jax_decoders.decode_depth(rgb))
    np.testing.assert_array_equal(native.decode_bev_roadlane(rgb),
                                  jax_decoders.decode_bev_channels(rgb))
    lut = np.asarray(SEMANTIC_CONVERTER, np.uint8)
    seg = rng.integers(0, len(lut), (64, 96)).astype(np.uint8)
    np.testing.assert_array_equal(native.semantic_convert(seg, lut),
                                  jax_decoders.convert_semantics(seg))
    with pytest.raises(IndexError, match="outside the table"):
        native.semantic_convert(np.full((2, 2), len(lut), np.uint8), lut)
    for hw, shift in (((32, 40), 7.6), ((32, 40), -100.0), ((64, 96), 0.0),
                      ((20, 50), 30.0)):
        np.testing.assert_array_equal(
            native.crop_to_float(rgb, hw, shift),
            jax_decoders.crop_image(rgb, hw, shift).astype(np.float32))
    with pytest.raises(ValueError, match="smaller than crop"):
        native.crop_to_float(rgb, (65, 10))


def _filtered_png(img, depth):
    """PNG bytes whose row r uses filter type r % 5."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    x = img.astype(img.dtype.newbyteorder(">")).view(np.uint8) \
        .reshape(h, -1).astype(np.int16)
    bpp = c * depth // 8
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    kinds = np.arange(h) % 5
    rows = np.stack([(x[r] - preds[k][r]) & 255
                     for r, k in enumerate(kinds)])
    raw = np.concatenate([kinds[:, None], rows], axis=1).astype(np.uint8)
    header = struct.pack(">IIBBBBB", w, h, depth, {1: 0, 3: 2, 4: 6}[c],
                         0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", header) +
            png._chunk(b"IDAT", zlib.compress(raw.tobytes())) +
            png._chunk(b"IEND", b""))


@pytest.mark.parametrize("shape,dtype", [
    ((23, 31, 3), np.uint8), ((23, 31, 4), np.uint8), ((23, 31), np.uint8),
    ((17, 9, 3), np.uint16)], ids=["rgb8", "rgba8", "gray8", "rgb16"])
def test_png_unfilter_equals_python_loop_and_opencv(shape, dtype):
    rng = np.random.default_rng(5)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    blob = _filtered_png(img, 8 * np.dtype(dtype).itemsize)
    ours = png.decode(blob)
    np.testing.assert_array_equal(ours, img)
    np.testing.assert_array_equal(png.decode(blob, use_native=False), img)
    cv = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    if cv.ndim == 3:
        cv = cv[..., [2, 1, 0, 3][:cv.shape[2]]]
    np.testing.assert_array_equal(ours, cv)


def test_png_unfilter_refuses_an_unknown_filter():
    raw = np.zeros((3, 7), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(ValueError, match="PNG row 1: unknown filter type 5"):
        native.png_unfilter(raw, 3)


def test_png_decode_runs_the_native_unfilter(monkeypatch):
    blob = png.encode(np.zeros((4, 4, 3), np.uint8))

    def refuse(raw, bpp):
        raise RuntimeError("native unfilter called")

    monkeypatch.setattr(native, "png_unfilter", refuse)
    with pytest.raises(RuntimeError, match="native unfilter called"):
        png.decode(blob)
    assert png.decode(blob, use_native=False).shape == (4, 4, 3)


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    broken = tmp_path / "fastloader.cpp"
    broken.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="fastloader.cpp failed") as err:
        native.build()
    assert "error" in str(err.value)
    assert list((tmp_path / "_build").iterdir()) == []  # no partial file
