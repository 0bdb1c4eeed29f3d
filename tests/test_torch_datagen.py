"""The port's datagen against the JAX package's.

Each package's DataAgent runs through its own evaluator with the datagen
profile, on a straight map-less 200 m route and on a grid-town route
through a signalised junction with background traffic. The two dataset
trees are equal: the same files, every PNG equal as decoded arrays (the
JAX agent writes through OpenCV's adaptive filters, the port filter None,
so the bytes differ), the LiDAR ``.npy`` object arrays, the measurements
and the ``label_raw`` JSON. The BEV rasteriser is held to the JAX one on
seeded actor sets; the behaviours of tests/test_datagen.py hold for the
port; and both packages' readers load the port-written route into equal
samples.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from test_torch_harness import strip_wall_clock
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu import native as jax_native
from transfuser_tpu.agents.data_agent import DataAgent as JaxDataAgent
from transfuser_tpu.config import GlobalConfig as JaxConfig
from transfuser_tpu.data import bev_raster as jax_bev
from transfuser_tpu.data.dataset import CarlaDataset as JaxDataset
from transfuser_tpu.harness import evaluator as jax_evaluator
from transfuser_tpu.sim import replay as jax_replay
from transfuser_tpu.sim import sensors as jax_sensors
from transfuser_tpu.sim import town_map as jax_town
from transfuser_tpu.sim import types as jax_types
from transfuser_torch.agents.data_agent import DataAgent
from transfuser_torch.config import GlobalConfig
from transfuser_torch.data import bev_raster, png
from transfuser_torch.data.dataset import CarlaDataset
from transfuser_torch.harness import evaluator as port_evaluator
from transfuser_torch.sim import replay as port_replay
from transfuser_torch.sim import sensors as port_sensors
from transfuser_torch.sim import town_map as port_town
from transfuser_torch.sim import types as port_types
from transfuser_torch.sim.sensors import encode_depth_rgb, synth_lidar

STRAIGHT_XML = """<?xml version='1.0' encoding='UTF-8'?>
<routes><route id="0" town="Town01">
  <waypoint x="0.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
  <waypoint x="200.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
</route></routes>"""

# along the y = 80 road of the grid town, through the signalised junction
# (80, 80) at its centre
GRID_XML = """<?xml version='1.0' encoding='UTF-8'?>
<routes><route id="0" town="Town01">
  <waypoint x="50.0" y="78.25" z="0.0" pitch="0" roll="0" yaw="0"/>
  <waypoint x="120.0" y="78.25" z="0.0" pitch="0" roll="0" yaw="0"/>
</route></routes>"""

ROUTES = {
    "straight": dict(xml=STRAIGHT_XML, town_map=None, background=0,
                     seconds=11.0),
    "grid_junction": dict(xml=GRID_XML, town_map="grid", background=2,
                          seconds=14.0),
}

PACKAGES = {
    "jax": (JaxDataAgent, jax_evaluator, jax_sensors),
    "port": (DataAgent, port_evaluator, port_sensors),
}


def _datagen(package, route, tmp_path, monkeypatch):
    """One datagen run by ``package``'s evaluator -> (results JSON, the
    route's dataset directory)."""
    agent_cls, evaluator, sensors = PACKAGES[package]
    spec = ROUTES[route]
    monkeypatch.setattr(sensors, "_NOISE_POOLS", {})
    monkeypatch.setenv("SAVE_PATH", str(tmp_path / package))
    routes = tmp_path / "routes.xml"
    routes.write_text(spec["xml"])
    ckpt = tmp_path / f"{package}_results.json"
    evaluator.Evaluator(evaluator.EvaluatorArgs(
        routes=str(routes), checkpoint=str(ckpt),
        agent_factory=lambda cfg: agent_cls(route_index=cfg.index),
        max_game_seconds=spec["seconds"], town_map=spec["town_map"],
        background_vehicles=spec["background"], datagen=True,
        print_route_table=False)).run()
    return json.loads(ckpt.read_text()), tmp_path / package / "route0"


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _assert_same_file(a: Path, b: Path):
    if a.suffix == ".png":
        got, want = png.read(str(b)), png.read(str(a))
        assert got.dtype == want.dtype and got.shape == want.shape, a
        np.testing.assert_array_equal(got, want, err_msg=str(a))
    elif a.suffix == ".npy":
        got = np.load(b, allow_pickle=True)
        want = np.load(a, allow_pickle=True)
        assert got.dtype == want.dtype == object and got[0] is want[0] is None
        assert got[1].dtype == want[1].dtype == np.float32
        np.testing.assert_array_equal(got[1], want[1], err_msg=str(a))
    else:
        assert json.loads(b.read_text()) == json.loads(a.read_text()), a


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Both packages' datagen on both routes (one run each per module)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for route in ROUTES:
            base = tmp_path_factory.mktemp(route)
            out[route] = {pkg: _datagen(pkg, route, base, mp)
                          for pkg in PACKAGES}
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_datagen_tree_equals_jax(datasets, route):
    (jax_result, jax_dir), (port_result, port_dir) = (
        datasets[route]["jax"], datasets[route]["port"])
    assert strip_wall_clock(port_result) == strip_wall_clock(jax_result)
    files = _files(jax_dir)
    assert _files(port_dir) == files
    kinds = {f.split("/")[0] for f in files}
    assert kinds == {"rgb", "depth", "semantics", "lidar", "topdown",
                     "label_raw", "measurements"}
    n_frames = len([f for f in files if f.startswith("measurements/")])
    assert n_frames >= 20
    for kind in kinds:
        assert len([f for f in files if f.startswith(kind + "/")]) \
            == n_frames, kind
    for f in files:
        _assert_same_file(jax_dir / f, port_dir / f)


def test_grid_route_sees_traffic_and_lights(datasets):
    """The junction route's labels hold the background vehicles and its
    topdown the road network; its semantics hold a traffic light."""
    _, route = datasets["grid_junction"]["port"]
    labels = [json.loads(p.read_text())
              for p in sorted((route / "label_raw").glob("*.json"))]
    assert any(len(frame) > 1 for frame in labels)
    sem = np.stack([png.read(str(p)) for p in
                    sorted((route / "semantics").glob("*.png"))])
    assert np.isin(sem, (18, 23, 24)).any()
    top = png.read(str(sorted((route / "topdown").glob("*.png"))[0]))
    assert top.shape == (500, 500, 3) and top.any()


def _actor_set(seed):
    rng = np.random.default_rng(seed)
    kinds = ["vehicle.car", "walker.pedestrian", "traffic_light",
             "static.prop.stop"]
    return [(rng.uniform(-60.0, 220.0), rng.uniform(-60.0, 220.0),
             rng.uniform(-180.0, 180.0), kinds[rng.integers(4)],
             ["Red", "Green", "Yellow"][rng.integers(3)],
             rng.uniform(0.1, 3.0), rng.uniform(0.05, 2.0))
            for _ in range(16)]


def _build(replay, types, actors):
    return [replay.Actor(i, kind, types.Transform(
        types.Location(x, y), types.Rotation(yaw=yaw)),
        extent=types.Location(ex, ey, 1.0), state=state)
        for i, (x, y, yaw, kind, state, ex, ey) in enumerate(actors)]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("town", [None, (2, 80.0, 2), (3, 60.0, 1)],
                         ids=["mapless", "grid2x80x2", "grid3x60"])
def test_bev_rasterizer_equals_jax(town, seed):
    """Rotated boxes of every channel, thin lane markings, and lanes and
    boxes partly or wholly outside the window."""
    rng = np.random.default_rng(100 + seed)
    actors = _actor_set(seed)
    ego = (rng.uniform(0.0, 160.0), rng.uniform(0.0, 160.0),
           rng.uniform(-180.0, 180.0))
    renders = []
    for bev, replay, types, town_mod in (
            (jax_bev, jax_replay, jax_types, jax_town),
            (bev_raster, port_replay, port_types, port_town)):
        route = [types.Transform(types.Location(float(x), 1.75 * seed),
                                 types.Rotation(yaw=5.0 * seed))
                 for x in range(0, 150, 3)]
        town_map = None if town is None else town_mod.grid_town(
            blocks=town[0], block_size=town[1], lanes_per_dir=town[2])
        renders.append(bev.BevRasterizer(route, town_map=town_map).render(
            types.Transform(types.Location(ego[0], ego[1]),
                            types.Rotation(yaw=ego[2])),
            _build(replay, types, actors)))
    np.testing.assert_array_equal(renders[1], renders[0])
    assert renders[1][10].any() or town is None
    np.testing.assert_array_equal(bev_raster.encode_bev_to_png(renders[1]),
                                  jax_bev.encode_bev_to_png(renders[0]))


# ------------------------------------------------ test_datagen.py, the port

def _sim(actors, ego_yaw=0.0, town_map=None):
    t = port_types
    traj = [t.Transform(t.Location(0.0, 0.0), t.Rotation(yaw=ego_yaw)),
            t.Transform(t.Location(50.0, 0.0), t.Rotation(yaw=ego_yaw))]
    return port_replay.ReplaySimulation(traj, actors=actors,
                                        town_map=town_map)


def _count(sim, actor, cloud):
    return DataAgent._points_in_bbox(
        sim.ego_transform.matrix(), actor.transform.matrix(),
        np.array([actor.extent.x, actor.extent.y, actor.extent.z]), cloud)


@pytest.mark.parametrize("behaviour", [
    "lidar_counts", "points_in_bbox_rotated", "tl_relabel",
    "depth_roundtrip"])
def test_datagen_behaviours(behaviour):
    """The port's counterparts of tests/test_datagen.py's datagen
    behaviours."""
    t, Actor = port_types, port_replay.Actor
    if behaviour == "lidar_counts":
        near = Actor(1, "vehicle.car", t.Transform(t.Location(10.0, 0.0)))
        far = Actor(2, "vehicle.car", t.Transform(t.Location(40.0, 0.0)))
        sim = _sim([near, far])
        cloud = synth_lidar(sim, rng=np.random.default_rng(0))
        assert cloud.shape[1] == 4
        n_near, n_far = _count(sim, near, cloud), _count(sim, far, cloud)
        assert n_near > 30 and n_far > 0 and n_near > 3 * n_far
    elif behaviour == "points_in_bbox_rotated":
        actor = Actor(1, "vehicle.car", t.Transform(t.Location(0.0, 12.0),
                                                    t.Rotation(yaw=45.0)))
        sim = _sim([actor], ego_yaw=90.0)
        cloud = synth_lidar(sim, ground_points=500,
                            rng=np.random.default_rng(1))
        n = _count(sim, actor, cloud)
        assert n > 20 and n >= int(0.9 * (cloud.shape[0] - 500))
    elif behaviour == "tl_relabel":
        light = Actor(5, "traffic_light",
                      t.Transform(t.Location(15.0, -2.0, 0.0)), state="Red")
        car = Actor(6, "vehicle.car", t.Transform(t.Location(10.0, 2.0)))
        sim = _sim([light, car],
                   town_map=port_town.grid_town(blocks=1, block_size=60.0))
        spec = {"id": "semantics_front", "width": 160, "height": 80,
                "fov": 60, "x": 1.3, "y": 0.0, "z": 2.3, "yaw": 0.0}
        sem = sim.render_camera(spec, "semantic")[..., 0]
        depth_m = DataAgent._depth_strip_meters(
            sim.render_camera({**spec, "id": "d"}, "depth"))
        assert (sem == 18).any() and (sem == 10).any()
        vd = depth_m[sem == 10]
        assert np.all(vd > 5.0) and np.all(vd < 15.0)
        agent = DataAgent.__new__(DataAgent)  # only needs .sim
        agent.sim = sim
        before = (sem == 18).sum()
        agent._change_seg_tl(sem, depth_m)
        assert (sem == 23).sum() > 0 and (sem == 18).sum() < before
    else:
        d = np.array([[0.0, 1.0, 10.0, 42.5, 999.0]])
        back = DataAgent._depth_strip_meters(encode_depth_rgb(d))
        np.testing.assert_allclose(back, d, atol=1e-3)


def test_weather_shuffle_reaches_the_sensors():
    """shuffle_weather applies each setting to the sim (night darker than
    noon, the cameras re-rendered), as the JAX agent's does."""
    t = port_types
    car = port_replay.Actor(1, "vehicle.car", t.Transform(t.Location(12.0,
                                                                     0.0)))
    sim = _sim([car], town_map=port_town.grid_town(blocks=1,
                                                   block_size=60.0))
    spec = {"id": "rgb_front", "width": 80, "height": 40, "fov": 60}
    noon = sim.render_camera(spec, "rgb")
    agent = DataAgent.__new__(DataAgent)
    agent.sim, agent.weather_index = sim, 0
    settings = [agent.shuffle_weather() for _ in range(7 * 6)]
    assert settings[-1] == {"weather": "Clear", "daytime": "Night"}
    assert sim.weather == settings[-1]
    night = sim.render_camera(spec, "rgb")
    assert night.mean() < 0.55 * noon.mean()


def test_readers_load_the_port_route_alike(datasets, monkeypatch):
    """Both packages' CarlaDataset read a port-written route into equal
    samples (the JAX reader's cv2 path)."""
    monkeypatch.setattr(jax_native, "load", lambda: None)
    _, route = datasets["grid_junction"]["port"]
    jcfg = JaxConfig()
    ours = CarlaDataset([str(route)], GlobalConfig.from_json(jcfg.to_json()),
                        augment=False)
    ref = JaxDataset([str(route)], jcfg, augment=False)
    assert len(ours) == len(ref) > 0
    for i in (0, len(ref) - 1):
        got, want = ours[i], ref[i]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sample = ours[0]
    assert sample["rgb"].shape == (160, 704, 3)
    assert sample["bev"].shape == (160, 160)
    assert (sample["bev"] == 1).sum() > 100


def test_bench_datagen_equals_jax(tmp_path, monkeypatch):
    """``tools/bench_datagen.generate`` of both packages (the DataAgent on
    grid-town straights with the full rig) writes the same dataset and its
    completion marker, and restores the caller's SAVE_PATH."""
    from transfuser_tpu.tools import bench_datagen as jax_bench
    from transfuser_torch.tools import bench_datagen
    monkeypatch.setenv("SAVE_PATH", "caller")
    totals = {}
    for name, module, sensors in (("jax", jax_bench, jax_sensors),
                                  ("port", bench_datagen, port_sensors)):
        monkeypatch.setattr(sensors, "_NOISE_POOLS", {})
        totals[name] = module.generate(str(tmp_path / name), n_routes=2,
                                       ticks=60)
        assert (tmp_path / name / module.COMPLETE_MARKER).read_text() == \
            f"{totals[name]}\n"
    assert os.environ["SAVE_PATH"] == "caller"
    assert totals["port"] == totals["jax"] == 2 * 6
    files = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == files
    for f in files:
        if not f.startswith("."):
            _assert_same_file(tmp_path / "jax" / f, tmp_path / "port" / f)
