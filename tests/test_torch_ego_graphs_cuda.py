"""CUDA-graph replay of ``LidarCenterNet.forward_ego``
(``transfuser_torch/models/ego_graphs.py``) on a card. Every test is
marked ``cuda`` and skips without one; the file imports neither JAX nor
the JAX package:

    python -m pytest tests/test_torch_ego_graphs_cuda.py -q -m cuda

Every family on its full-size trunks, and PointPillars, replays bit for
bit what its eager ``forward_ego`` returns over four distinct frames (the
first runs eagerly, the second captures); a graph whose input copy is
skipped fails that comparison. The attention kernel's launch counter
grows by 16 a replayed flagship forward. A replay's outputs outlive the
next replay; an in-place load is read by the next replay, while ``.to()``
and ``load_state_dict(assign=True)`` drop the graph. ``graft_entry``'s
``functional_call`` with other weights (it never opts in) gives what an
eager model with those weights gives. The agent's three timing modes with
replay give the controls of their eager runs, and the lagged modes'
waypoints are the eager synchronous run's one compute frame earlier."""

import numpy as np
import pytest
import torch

from chip_smoke import (FAMILY_CASES, GEOMETRIC_CLOUD_POINTS, AGENT_MODES,
                        agent_run, family_config, flagship_inputs,
                        flagship_member, pillar_config, pillar_inputs,
                        synthetic_cloud, synthetic_sensor_frames)
from transfuser_torch.config import GlobalConfig
from transfuser_torch.models import LidarCenterNet, ego_graphs
from transfuser_torch.ops import kernels

FRAMES = 4
CASES = [("transFuser", "regnety_032", "regnety_032", 16)] + [
    case[1:] for case in FAMILY_CASES] + [("pillars", None, None, 16)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture on a card")


def _config(backbone, image, lidar):
    if backbone == "pillars":
        return pillar_config()
    return family_config(backbone, image, lidar)


def _frames(cfg, backbone, n=FRAMES):
    """n distinct frames of forward_ego's positional inputs, on the card."""
    frames = []
    for i in range(n):
        if backbone == "pillars":
            x = pillar_inputs(cfg, seed=10 + i)
            keys = ("rgb", "lidar", "tp", "tpi", "vel")
            extra = [None, None, torch.from_numpy(x["num_points"])]
        else:
            x = flagship_inputs(cfg, seed=10 + i)
            keys = ("rgb", "lidar", "tp", "tpi", "vel")
            extra = []
            if backbone == "geometric_fusion":
                from transfuser_torch.data.correspondences import \
                    lidar_cam_correspondences

                bev, cam = lidar_cam_correspondences(
                    synthetic_cloud(GEOMETRIC_CLOUD_POINTS, seed=20 + i))
                extra = [torch.from_numpy(bev[None]),
                         torch.from_numpy(cam[None])]
        frames.append([torch.from_numpy(x[k]) for k in keys] + extra)
    return [[None if a is None else a.to("cuda") for a in f] for f in frames]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _launched(model, frames):
    """forward_ego over the frames: outputs and what each call added to
    the kernels' launch counters."""
    outs, launched = [], []
    for f in frames:
        before = dict(kernels.launches)
        outs.append(model.forward_ego(*f))
        launched.append({k: n - before[k] for k, n in
                         kernels.launches.items()})
    torch.cuda.synchronize()
    return outs, launched


def _replayed(model, frames):
    model.replay_forward_ego()
    return _launched(model, frames)


@pytest.mark.cuda
@pytest.mark.parametrize("backbone, image, lidar, attention", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_replay_equals_eager_bit_for_bit(backbone, image, lidar, attention):
    _needs_card()
    cfg = _config(backbone, image, lidar)
    model = LidarCenterNet(cfg, dtype=torch.bfloat16, device="cuda", seed=3)
    frames = _frames(cfg, backbone)
    eager, eager_launched = _launched(model, frames)
    again = model.forward_ego(*frames[0])
    assert _same(again, eager[0]), "eager forward_ego is not reproducible"
    got, launched = _replayed(model, frames)
    assert len(model._ego_graphs.graphs) == 1
    for i, (g, e) in enumerate(zip(got, eager)):
        assert _same(g, e), f"frame {i} differs from eager"
    assert not _same(got[1], got[2])  # the frames are distinct
    assert launched == eager_launched
    assert [n["attention"] for n in launched] == [attention] * FRAMES


@pytest.mark.cuda
def test_a_stale_graph_fails_the_comparison(monkeypatch):
    """The comparison above catches a graph that replays the captured
    frame's inputs: the input copy skipped."""
    _needs_card()

    def stale(self, args):
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)

    monkeypatch.setattr(ego_graphs.Graph, "__call__", stale)
    cfg = GlobalConfig()
    model = LidarCenterNet(cfg, dtype=torch.bfloat16, device="cuda", seed=3)
    frames = _frames(cfg, "transFuser")
    eager = [model.forward_ego(*f) for f in frames]
    got, _ = _replayed(model, frames)
    assert _same(got[1], eager[1])  # the captured frame itself
    assert not _same(got[2], eager[2]) and not _same(got[3], eager[3])


@pytest.fixture(scope="module")
def flagship():
    """The flagship config, its frames and two eager models (seeds 3 and
    4) that are never opted in."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture on a card")
    cfg = GlobalConfig()
    return cfg, _frames(cfg, "transFuser"), *(
        LidarCenterNet(cfg, dtype=torch.bfloat16, device="cuda", seed=s)
        for s in (3, 4))


def _graphed(cfg, frames):
    """A seed-3 flagship model that has captured its graph."""
    model = LidarCenterNet(cfg, dtype=torch.bfloat16, device="cuda", seed=3)
    _replayed(model, frames[:2])
    assert len(model._ego_graphs.graphs) == 1
    return model


@pytest.mark.cuda
def test_outputs_outlive_the_next_replay(flagship):
    cfg, frames, a, _ = flagship
    model = _graphed(cfg, frames)
    first = model.forward_ego(*frames[2])
    kept = [x.clone() for x in first]
    second = model.forward_ego(*frames[3])
    torch.cuda.synchronize()
    assert _same(first, kept) and not _same(first, second)
    assert _same(first, a.forward_ego(*frames[2]))


@pytest.mark.cuda
def test_weights_loaded_in_place_reach_the_next_replay(flagship):
    cfg, frames, _, b = flagship
    model = _graphed(cfg, frames)
    graph = next(iter(model._ego_graphs.graphs.values()))
    model.load_state_dict(b.state_dict())
    for f in frames[2:]:
        assert _same(model.forward_ego(*f), b.forward_ego(*f))
    assert list(model._ego_graphs.graphs.values()) == [graph]


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["to", "assign"])
def test_a_move_or_an_assigning_load_drops_the_graph(flagship, how):
    cfg, frames, a, b = flagship
    model = _graphed(cfg, frames)
    if how == "to":
        model.to("cuda")
        want = a
    else:
        model.load_state_dict({k: v.clone() for k, v in
                               b.state_dict().items()}, assign=True)
        want = b
    assert not model._ego_graphs.graphs
    got, _ = _launched(model, frames)
    assert len(model._ego_graphs.graphs) == 1  # captured anew
    for f, g in zip(frames, got):
        assert _same(g, want.forward_ego(*f))


@pytest.mark.cuda
def test_graft_entry_with_other_weights_equals_eager_with_them():
    _needs_card()
    from transfuser_torch.tools.graft_entry import entry

    forward, args = entry("cuda")
    other = LidarCenterNet(GlobalConfig(), dtype=torch.bfloat16,
                           device="cuda", seed=7)
    weights = other.state_dict()
    with torch.no_grad():
        for _ in range(3):  # no graph: every call sees the weights passed
            got = forward(weights, *args[1:])
            assert _same(got, other.forward_ego(*args[1:]))
            assert not _same(got, forward(args[0], *args[1:]))


@pytest.mark.cuda
def test_agent_modes_with_replay_equal_their_eager_runs(monkeypatch):
    """Each timing mode with replay gives the controls and waypoints of the
    same mode run eagerly (the opt-in patched out); the lagged modes'
    waypoints are the eager synchronous run's one compute frame earlier.
    ``agent_run`` checks 16 attention launches a dispatched forward."""
    _needs_card()
    cfg, state = flagship_member()
    frames = list(synthetic_sensor_frames(cfg, 24, speed=0.0))
    runs = {}
    for mode in AGENT_MODES:
        runs[mode] = agent_run(cfg, state, mode, frames)
    with monkeypatch.context() as m:
        m.setattr(LidarCenterNet, "replay_forward_ego", lambda self: None)
        eager = {mode: agent_run(cfg, state, mode, frames)
                 for mode in AGENT_MODES}
    sync = eager["sync"]["wps"]
    for mode in AGENT_MODES:
        assert runs[mode]["controls"] == eager[mode]["controls"], mode
        wps = runs[mode]["wps"]
        pairs = zip(wps, sync) if mode == "sync" else zip(wps[1:], sync[:-1])
        for got, want in pairs:
            np.testing.assert_array_equal(got, want)
