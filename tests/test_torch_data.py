"""The port's data path against the JAX package's: the PNG codec against
OpenCV, every decoder, the CarlaDataset reader on a written route, and the
three loaders, all exactly equal."""

import random
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

import jax

from helpers import tiny_config
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu import native as jax_native
from transfuser_tpu.config import GlobalConfig as JaxConfig
from transfuser_tpu.data import decoders as jdec
from transfuser_tpu.data import lidar_np as jlidar
from transfuser_tpu.data.dataset import CarlaDataset as JaxDataset
from transfuser_tpu.data.device_cache import DeviceCacheLoader as JaxDevCache
from transfuser_tpu.data.echo_cache import EchoCacheLoader as JaxEcho
from transfuser_tpu.data.loader import PrefetchLoader as JaxLoader
from transfuser_tpu.data.pack import pack_sample as jax_pack
from transfuser_tpu.data.pack import packed_nbytes as jax_packed_nbytes
from transfuser_torch.config import GlobalConfig
from transfuser_torch.data import decoders, lidar_np, png
from transfuser_torch.data.dataset import CarlaDataset
from transfuser_torch.data.device_cache import DeviceCacheLoader
from transfuser_torch.data.echo_cache import EchoCacheLoader
from transfuser_torch.data.loader import PrefetchLoader
from transfuser_torch.data.pack import pack_sample, packed_nbytes
from transfuser_torch.data.synthetic import write_route

PNG_KINDS = {
    "gray8": ((37, 53), np.uint8), "rgb8": ((37, 53, 3), np.uint8),
    "rgba8": ((37, 53, 4), np.uint8), "gray16": ((23, 29), np.uint16),
    "rgb16": ((23, 29, 3), np.uint16), "rgba16": ((23, 29, 4), np.uint16),
}
# OpenCV's default writes Sub rows; the others force each filter, and
# ALL_FILTERS is libpng's adaptive choice per row
CV2_FILTERS = [None, "IMWRITE_PNG_FILTER_NONE", "IMWRITE_PNG_FILTER_SUB",
               "IMWRITE_PNG_FILTER_UP", "IMWRITE_PNG_FILTER_AVG",
               "IMWRITE_PNG_FILTER_PAETH", "IMWRITE_PNG_ALL_FILTERS"]


def _image(kind, seed=0):
    shape, dtype = PNG_KINDS[kind]
    rng = np.random.default_rng(seed)
    # a smooth ramp plus noise: adaptive filtering picks several filters
    ramp = np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1]))
    ramp = ramp.reshape(shape[:2] + (1,) * (len(shape) - 2))
    top = np.iinfo(dtype).max + 1
    noise = rng.integers(0, 8 if dtype == np.uint8 else 2048, shape)
    return ((ramp * (top // 256) + noise) % top).astype(dtype)


def _rgb_order(img):
    """OpenCV's BGR(A) -> the file's RGB(A)."""
    if img.ndim == 2:
        return img
    return img[..., [2, 1, 0, 3][:img.shape[2]]]


def _row_filters(path):
    data = open(path, "rb").read()
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, depth, color = hdr
    stride = w * {0: 1, 2: 3, 6: 4}[color] * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(h, stride + 1)[:, 0].tolist())


@pytest.mark.parametrize("kind", sorted(PNG_KINDS))
def test_png_read_equals_cv2(tmp_path, kind):
    img = _image(kind)
    seen = set()
    for flag in CV2_FILTERS:
        path = str(tmp_path / f"{flag}.png")
        params = [] if flag is None else [cv2.IMWRITE_PNG_FILTER,
                                          getattr(cv2, flag)]
        assert cv2.imwrite(path, _rgb_order(img), params)
        seen |= _row_filters(path)
        want = _rgb_order(cv2.imread(path, cv2.IMREAD_UNCHANGED))
        got = png.read(path)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=str(flag))
    assert seen == {0, 1, 2, 3, 4}  # every filter type was decoded


@pytest.mark.parametrize("kind", sorted(PNG_KINDS))
def test_png_write_then_cv2_read(tmp_path, kind):
    img = _image(kind, seed=1)
    path = str(tmp_path / "w.png")
    png.write(path, img)
    assert _row_filters(path) == {0}
    back = _rgb_order(cv2.imread(path, cv2.IMREAD_UNCHANGED))
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(png.read(path), img)


def test_png_refuses_what_it_does_not_decode():
    blob = bytearray(png.encode(np.zeros((4, 4, 3), np.uint8)))
    blob[8 + 8 + 9] = 3  # IHDR colour type -> palette
    with pytest.raises(ValueError, match="colour type 3"):
        png.decode(bytes(blob))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a")
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4), np.float32))


# ------------------------------------------------------------------ decoders

@pytest.mark.parametrize("degree", [-20.0, -7.5, 0.0, 3.0, 20.0])
def test_crop_and_encode_bev_equals_jax(degree):
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 256, (500, 500, 3), np.uint8)
    road_lane = decoders.decode_bev_channels(packed)
    np.testing.assert_array_equal(road_lane, jdec.decode_bev_channels(packed))
    got = decoders.crop_and_encode_bev(road_lane, degree)
    want = jdec.crop_and_encode_bev(road_lane, degree)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("degree", [-13.3, 0.7, 19.9])
def test_rotation_equals_warp_affine_on_any_values(degree):
    """The whole rotated image, on real-valued inputs, equals OpenCV's."""
    src = np.random.default_rng(4).normal(size=(61, 47, 2)).astype(np.float32)
    h, w = src.shape[:2]
    m = cv2.getRotationMatrix2D(((w - 1) / 2.0, (h - 1) / 2.0), degree, 1.0)
    want = cv2.warpAffine(src, m, (w, h), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
    np.testing.assert_array_equal(decoders.rotate_bilinear(src, degree), want)


@pytest.mark.parametrize("hw", [(40, 40), (64, 64), (100, 37), (320, 320)])
def test_resize_nearest_equals_cv2(hw):
    bev = np.random.default_rng(5).integers(0, 3, (160, 160)).astype(np.int32)
    want = cv2.resize(bev, (hw[1], hw[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(decoders.resize_nearest(bev, hw), want)


def _labels(rng, n=6):
    recs = []
    for i in range(n):
        m = np.eye(4)
        m[:3, 3] = rng.uniform(-5, 5, 3)
        recs.append({"id": i, "extent": list(rng.uniform(0.5, 3, 3)),
                     "position": list(rng.uniform(-20, 30, 3)),
                     "yaw": float(rng.uniform(-3, 3)),
                     "speed": float(rng.uniform(0, 9)),
                     "brake": float(rng.integers(0, 2)),
                     "num_points": int(rng.integers(0, 4)),
                     "ego_matrix": m.tolist()})
    return recs


def test_decoders_equal_jax():
    rng = np.random.default_rng(6)
    depth = rng.integers(0, 256, (40, 90, 3), np.uint8)
    np.testing.assert_array_equal(decoders.decode_depth(depth),
                                  jdec.decode_depth(depth))
    seg = rng.integers(0, 28, (40, 90), np.uint8)
    np.testing.assert_array_equal(decoders.convert_semantics(seg),
                                  jdec.convert_semantics(seg))
    img = rng.integers(0, 256, (160, 960, 3), np.uint8)
    for shift in (-107.0, -3.4, 0.0, 55.5, 400.0):
        np.testing.assert_array_equal(
            decoders.crop_image(img, (160, 704), shift),
            jdec.crop_image(img, (160, 704), shift))
    with pytest.raises(ValueError):
        decoders.crop_image(img[:100], (160, 704))
    seq = [_labels(rng) for _ in range(5)]
    for rad in (0.0, 0.21, -0.3):
        r = seq[0][1]
        args = (r["extent"], r["position"], r["yaw"], r["speed"], r["brake"],
                rad)
        np.testing.assert_array_equal(decoders.encode_bbox_label(*args),
                                      jdec.encode_bbox_label(*args))
        got, got_slots = decoders.parse_box_labels(seq[0], rad, max_boxes=3)
        want, want_slots = jdec.parse_box_labels(seq[0], rad, max_boxes=3)
        np.testing.assert_array_equal(got, want)
        assert got_slots == want_slots
        np.testing.assert_array_equal(
            decoders.ego_waypoints_from_labels(seq, 4, rad),
            jdec.ego_waypoints_from_labels(seq, 4, rad))
        np.testing.assert_array_equal(
            decoders.local_command_point(3.0, -2.0, 0.4, 40.0, 7.0, rad),
            jdec.local_command_point(3.0, -2.0, 0.4, 40.0, 7.0, rad))
    tp = np.array([3.2, 11.0], np.float32)
    np.testing.assert_array_equal(decoders.rasterize_target_point(tp, 64),
                                  jdec.rasterize_target_point(tp, 64))
    pts = rng.uniform(-20, 20, (500, 4)).astype(np.float32)
    m0, m1 = np.eye(4), np.eye(4)
    m1[:3, 3] = [2.0, -1.0, 0.1]
    for degree in (0.0, 7.5):
        np.testing.assert_array_equal(
            lidar_np.align_lidar(pts, m0, m1, degree),
            jlidar.align_lidar(pts, m0, m1, degree))
    sample = {"rgb": img.astype(np.float32),
              "lidar": rng.integers(0, 6, (8, 8, 2)) / 5.0,
              "depth": rng.uniform(0, 1, (4, 5)).astype(np.float32),
              "bev": rng.integers(0, 3, (6, 6)).astype(np.int32),
              "label": rng.normal(size=(20, 7)).astype(np.float32)}
    got, want = pack_sample(sample), jax_pack(sample)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert packed_nbytes(sample) == jax_packed_nbytes(sample)


# ------------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("carla")
    write_route(str(root / "T" / "Town01_route0"), 12, seed=0,
                n_points=3000)
    write_route(str(root / "T" / "Town02_route0"), 11, seed=1, n_points=3000)
    return str(root)


def _configs(tiny: bool, pillars: bool, root: str):
    jcfg = tiny_config() if tiny else JaxConfig()
    jcfg = jcfg.replace(root_dir=root, setting="02_05_withheld")
    if pillars:
        import dataclasses
        jcfg = jcfg.replace(model=dataclasses.replace(
            jcfg.model, point_pillars=dataclasses.replace(
                jcfg.model.point_pillars, use_point_pillars=True)))
    return jcfg, GlobalConfig.from_json(jcfg.to_json())


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
@pytest.mark.parametrize("pillars", [False, True],
                         ids=["histogram", "pillars"])
@pytest.mark.parametrize("packed", [False, True], ids=["f32", "packed"])
def test_dataset_equals_jax_reader(data_root, monkeypatch, tiny, pillars,
                                   packed):
    # the JAX reader's cv2 / numpy paths (its C++ loader is held to them by
    # its own tests)
    monkeypatch.setattr(jax_native, "load", lambda: None)
    jcfg, cfg = _configs(tiny, pillars, data_root)
    train, val = cfg.resolve_splits()
    assert (train, val) == tuple(jcfg.resolve_splits())
    ours = CarlaDataset(train + val, cfg, augment=False, packed=packed)
    ref = JaxDataset(train + val, jcfg, augment=False, packed=packed)
    assert len(ours) == len(ref) == 3 + 2
    for i in (0, 4):
        got, want = ours[i], ref[i]
        assert got.keys() == want.keys()
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dataset_with_augmentation_equals_jax_reader(data_root, monkeypatch):
    """With one seed behind both readers' per-read generator, augmented
    samples (rotation, crop shift, rotated labels) are equal too."""
    monkeypatch.setattr(jax_native, "load", lambda: None)
    make = random.Random
    monkeypatch.setattr(random, "Random", lambda *a: make(11))
    jcfg, cfg = _configs(False, False, data_root)
    train, _ = cfg.resolve_splits()
    got = CarlaDataset(train, cfg, augment=True)[1]
    want = JaxDataset(train, jcfg, augment=True)[1]
    assert make(11).random() > jcfg.train.inv_augment_prob  # it rotated
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dataset_caches_and_refusals(data_root, tmp_path):
    _, cfg = _configs(True, False, data_root)
    train, _ = cfg.resolve_splits()
    plain = CarlaDataset(train, cfg, augment=False)[2]
    for cache in ("memory", str(tmp_path / "npz")):
        ds = CarlaDataset(train, cfg, augment=False, cache=cache)
        for _ in range(2):  # the second read comes from the cache
            s = ds[2]
            for k in plain:
                np.testing.assert_array_equal(s[k], plain[k])
    with pytest.raises(ValueError, match="augment"):
        CarlaDataset(train, cfg, augment=True, cache="memory")
    import dataclasses
    geo = cfg.replace(model=dataclasses.replace(cfg.model,
                                                backbone="geometric_fusion"))
    s = CarlaDataset(train, geo, augment=False)[0]
    # geometric_fusion's correspondences: cell indices into the other
    # branch's anchor grid, int32
    for key, shape, hi in (("bev_points", (8, 8, 5, 2), 22),
                           ("cam_points", (5, 22, 5, 2), 8)):
        assert s[key].shape == shape and s[key].dtype == np.int32, key
        assert 0 <= s[key].min() and s[key].max() < hi, key


# ------------------------------------------------------------------- loaders

class _Indexed:
    """A map-style dataset whose samples say which index they are."""

    cache = None

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((3,), i, np.float32), "i": np.int32(i),
                "b": np.full((2, 2), i % 251, np.uint8),
                "d": np.full((2,), 65535 - 1000 * i, np.uint16)}


def _np(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("shuffle", [True, False])
def test_prefetch_loader_equals_jax(shuffle):
    ds = _Indexed(29)
    for epoch in (0, 3):
        ours = PrefetchLoader(ds, 4, shuffle=shuffle, num_workers=3, seed=5)
        ref = JaxLoader(ds, 4, shuffle=shuffle, num_workers=3, seed=5)
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = [_np(b) for b in ours], [_np(b) for b in ref]
        assert len(got) == len(want) == len(ours) == 7
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_device_cache_loader_equals_jax():
    ds = _Indexed(23)
    ours = DeviceCacheLoader(ds, 4, seed=9, device="cpu")
    ref = JaxDevCache(ds, 4, seed=9)
    assert ours.upload_bytes == sum(v.nbytes for v in ds[0].values()) * 23
    for epoch in (0, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = [{k: v.numpy() for k, v in b.items()} for b in ours]
        want = [jax.device_get(b) for b in ref]
        assert len(got) == len(want) == len(ours) == 5
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))


def _stop_refresh(loader):
    """Stop the refresh thread and drop what it decoded, so the window
    stays the initial one."""
    loader.close()
    while not loader._fresh.empty():
        loader._fresh.get_nowait()


def test_echo_cache_loader_equals_jax():
    ds = _Indexed(40)
    ours = EchoCacheLoader(ds, 3, window=16, chunk=8, seed=4, device="cpu")
    ref = JaxEcho(ds, 3, window=16, chunk=8, seed=4)
    for loader in (ours, ref):
        _stop_refresh(loader)
    assert ours.n_chunks == ref.n_chunks == 2
    for c_ours, c_ref in zip(ours.chunks, ref.chunks):  # the first window
        for k in c_ref:
            np.testing.assert_array_equal(c_ours[k].numpy(),
                                          np.asarray(c_ref[k]))
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = [{k: v.numpy() for k, v in b.items()} for b in ours]
        want = [jax.device_get(b) for b in ref]
        assert len(got) == len(want) == 13
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    assert ours.echo_factor == ref.echo_factor


def test_echo_cache_refreshes_the_window():
    ds = _Indexed(40)
    loader = EchoCacheLoader(ds, 2, window=8, chunk=4, seed=1, device="cpu")
    first = [c["i"].clone() for c in loader.chunks]
    deadline = 50
    while loader._fresh.empty() and deadline:
        import time
        time.sleep(0.05)
        deadline -= 1
    for _ in loader:
        pass
    loader.close()
    assert not loader._thread.is_alive()
    assert any(not torch.equal(a, c["i"]) for a, c in
               zip(first, loader.chunks))
    assert loader.echo_factor > 0
