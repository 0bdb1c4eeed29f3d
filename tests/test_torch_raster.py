"""The port's numpy rasterisers (transfuser_torch/sim/raster.py and
data/decoders.resize_nearest) against OpenCV, pixel for pixel, on seeded
inputs shaped like the hermetic camera's: the road-classification upsample,
actor-box hulls and their convex fills (degenerate, collinear, clipped by
the frame, projected from boxes beside the camera) and the thick lane
polylines of the road mask."""

import cv2
import numpy as np
import pytest

from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_torch.data.decoders import resize_nearest
from transfuser_torch.sim import raster


def _hull_and_fill(pts, shape):
    """Port and OpenCV hull of ``pts`` and its fill into ``shape``."""
    ref_hull = cv2.convexHull(pts)[:, 0]
    hull = raster.convex_hull(pts)
    np.testing.assert_array_equal(hull, ref_hull, err_msg=str(pts.tolist()))
    ref = np.zeros(shape, np.uint8)
    ours = np.zeros(shape, np.uint8)
    cv2.fillConvexPoly(ref, ref_hull, 1)
    raster.fill_convex_polys(ours, hull[None], 1)
    np.testing.assert_array_equal(ours, ref, err_msg=str(pts.tolist()))


def _point_sets(kind, rng, n_sets):
    for _ in range(n_sets):
        n = int(rng.integers(1, 12))
        if kind == "random":
            yield rng.integers(-5, 60, (n, 2))
        elif kind == "clipped":
            yield rng.integers(-300, 360, (n, 2))
        elif kind == "collinear":
            a, d = rng.integers(-20, 60, 2), rng.integers(-6, 7, 2)
            yield a + d * rng.integers(-8, 8, (n, 1))
        elif kind == "duplicates":
            yield rng.integers(0, 5, (n, 2))
        elif kind == "boxes":
            # 8 projected corners of a box, as PinholeCamera.render makes
            # them: a camera-frame x clamped at 0.2 m sends corners beside
            # the camera thousands of pixels out
            center = rng.uniform([-5, -30, -2], [60, 30, 1])
            corners = center + rng.uniform(-2.5, 2.5, (8, 3))
            x = np.maximum(corners[:, 0], 0.2)
            yield np.stack([48 + 40 * corners[:, 1] / x,
                            24 - 40 * corners[:, 2] / x], 1)


@pytest.mark.parametrize("kind", ["random", "clipped", "collinear",
                                  "duplicates", "boxes"])
def test_hull_and_convex_fill_match_opencv(kind):
    rng = np.random.default_rng(["random", "clipped", "collinear",
                                 "duplicates", "boxes"].index(kind))
    for pts in _point_sets(kind, rng, 300):
        shape = (int(rng.integers(1, 60)), int(rng.integers(1, 100)))
        _hull_and_fill(np.asarray(pts).astype(np.int32), shape)


def test_fixed_point_fill_matches_opencv():
    """The 16-bit fixed-point fill a thick segment's quad goes through."""
    rng = np.random.default_rng(5)
    for _ in range(300):
        n = int(rng.integers(3, 7))
        pts = rng.integers(-8 << 16, 48 << 16, (n, 2)).astype(np.int32)
        hull = cv2.convexHull(pts)
        ref = np.zeros((40, 40), np.uint8)
        ours = np.zeros((40, 40), np.uint8)
        cv2.fillConvexPoly(ref, hull, 1, cv2.LINE_8, 16)
        raster.fill_convex_polys(ours, hull[None, :, 0], 1, shift=16)
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("thickness", [1, 2, 6, 7, 8, 9])
def test_thick_polylines_match_opencv(thickness):
    """Open polylines at the thicknesses the road mask draws
    (round(lane width / 0.5 m): 7 for the 3.5 m lanes of the grid town),
    crossing the frame's edges."""
    rng = np.random.default_rng(thickness)
    for _ in range(150):
        shape = (int(rng.integers(5, 90)), int(rng.integers(5, 90)))
        lines = [rng.integers(-40, 130, (int(rng.integers(1, 9)), 2))
                 .astype(np.int32) for _ in range(int(rng.integers(1, 4)))]
        ref = np.zeros(shape, np.uint8)
        ours = np.zeros(shape, np.uint8)
        cv2.polylines(ref, [p.reshape(-1, 1, 2) for p in lines], False, 1,
                      thickness=thickness)
        raster.polylines(ours, lines, 1, thickness)
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("spec,xy", [
    ("grid", (0.0, 0.0)), ("grid", (140.0, 75.0)),
    ("grid:3x100x2", (95.0, -30.0))])
def test_road_mask_matches_jax(spec, xy):
    """The whole 880 x 880 road raster around the ego, port (numpy) vs
    the JAX package's (OpenCV)."""
    from transfuser_tpu.harness.evaluator import build_town_map as jax_map
    from transfuser_tpu.sim.sensors import _road_mask as jax_mask
    from transfuser_torch.harness.evaluator import build_town_map
    from transfuser_torch.sim.sensors import _road_mask

    ref = jax_mask(jax_map(spec), *xy)
    ours = _road_mask(build_town_map(spec), *xy)
    assert ours[:3] == ref[:3] and ours[4] == ref[4]
    np.testing.assert_array_equal(ours[3], ref[3])
    assert 0 < ours[3].mean() < 1


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((12, 24), (48, 96)), ((40, 80), (160, 320)), ((16, 80), (64, 320)),
    ((7, 13), (50, 97))])
def test_nearest_resize_matches_opencv(src_hw, dst_hw):
    """The road-classification upsample: ceil(H/4) x ceil(W/4) samples to
    the camera's H x W."""
    rng = np.random.default_rng(sum(src_hw))
    src = (rng.random(src_hw) > 0.5).astype(np.uint8)
    ref = cv2.resize(src, dst_hw[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(resize_nearest(src, dst_hw), ref)
