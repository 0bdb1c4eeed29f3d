"""CUDA-graph replay of ``LidarCenterNet.forward_ego``
(``transfuser_torch/models/ego_graphs.py``) on the CPU: an agent on the
CPU never captures and returns the eager outputs; a model that was not
opted in stays eager whatever the device; and, with the capture stubbed
(a graph whose replay reruns the call into its static outputs), the
bookkeeping by input signature, the counters, the clones, the mode walks
and what drops the graphs. The capture itself runs on a card:
tests/test_torch_ego_graphs_cuda.py."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helpers import tiny_config
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_torch import tracing
from transfuser_torch.agents.hybrid_agent import HybridAgent
from transfuser_torch.config import GlobalConfig
from transfuser_torch.models import LidarCenterNet, ego_graphs
from transfuser_torch.ops import attention, flops, kernels


def _inputs(cfg, batch=1, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.sensors
    h, w = s.lidar_resolution_height, s.lidar_resolution_width

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    return (t(rng.uniform(0, 255, (batch,) + tuple(s.img_resolution) + (3,))),
            t(rng.uniform(0, 1, (batch, h, w, 2))),
            t(rng.uniform(-20, 20, (batch, 2))),
            t((rng.uniform(0, 1, (batch, h, w, 1)) > 0.99)),
            t(rng.uniform(0, 10, (batch,))))


def _model(seed=0):
    return LidarCenterNet(tiny_config(), dtype=torch.float32, device="cpu",
                          seed=seed)


_RERUN = []  # the stand-in graph replaying, if any


class _ReplayByRerun:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: replay reruns
    the captured call on the static inputs into the static outputs, and
    counts and opens nothing itself, as a graph's replay does not."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        before, enabled = dict(kernels.launches), tracing._profiler_enabled
        tracing._profiler_enabled = lambda: False  # a graph opens no span
        _RERUN.append(self)
        try:
            out = self.fn(*self.inputs)
        finally:
            tracing._profiler_enabled = enabled
            _RERUN.pop()
        kernels.launches.update(before)
        for dst, src in zip(self.outputs, out):
            dst.copy_(src)


def _stub_capture(self, fn, args):
    """``EgoGraphs.capture``'s bookkeeping without a card: the call on
    static copies, its launches recorded and taken back off the
    counter."""
    static = [None if a is None else a.clone() for a in args]
    before = dict(kernels.launches)
    outputs = tuple(fn(*static))
    launches = {k: kernels.launches[k] - before[k] for k in before}
    kernels.launches.update(before)
    self.captures.append(ego_graphs.signature(args, torch.float32))
    return ego_graphs.Graph(_ReplayByRerun(fn, static, outputs), static,
                            outputs, -1, {k: n for k, n in launches.items()
                                          if n})


@pytest.fixture
def stubbed(monkeypatch):
    """Every call counts as on the card, capture is stubbed, and the plain
    attention counts a launch as the kernel's wrapper does."""
    plain = attention.reference_attention

    def counted(q, k, v):
        kernels.count_launch("attention")
        return plain(q, k, v)

    monkeypatch.setattr(attention, "reference_attention", counted)
    monkeypatch.setattr(ego_graphs, "on_card", lambda args: True)
    monkeypatch.setattr(ego_graphs.EgoGraphs, "capture", _stub_capture)
    monkeypatch.setattr(ego_graphs.EgoGraphs, "captures", [], raising=False)
    return ego_graphs.EgoGraphs


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_replay_after_one_eager_call_equals_eager(stubbed):
    model, eager = _model(), _model()
    model.replay_forward_ego()
    frames = [_inputs(model.config, seed=s) for s in range(4)]
    for i, args in enumerate(frames):
        got = model.forward_ego(*args)
        assert _equal(got, eager.forward_ego(*args))
        # the first call runs eagerly, the second captures
        assert len(stubbed.captures) == (0 if i == 0 else 1)
    assert len(model._ego_graphs.graphs) == 1


def test_outputs_are_the_callers_not_the_graphs(stubbed):
    model = _model()
    model.replay_forward_ego()
    a, b = _inputs(model.config, seed=1), _inputs(model.config, seed=2)
    model.forward_ego(*a)
    first = model.forward_ego(*a)
    kept = [x.clone() for x in first]
    graph = next(iter(model._ego_graphs.graphs.values()))
    assert not any(x.data_ptr() == y.data_ptr()
                   for x, y in zip(first, graph.outputs))
    second = model.forward_ego(*b)
    assert _equal(first, kept)
    assert not torch.equal(first[0], second[0])
    # the caller's inputs are copied in, never held
    assert not any(x.data_ptr() == y.data_ptr()
                   for x, y in zip(b, graph.inputs))


def test_counters_grow_by_the_captured_calls_amounts(stubbed):
    """Launches: the captured call's at each replay, the capture's own
    call included. A call under a FLOP counter runs eagerly, so that the
    counter counts it, whether or not a graph exists."""
    model = _model()
    model.replay_forward_ego()
    args = _inputs(model.config)
    per_forward = 4 * model.config.model.gpt.n_layer  # 4 GPTs
    with flops.FlopCounter() as eager_count:
        model.forward_ego(*args)
    assert eager_count.counts["attention"] > 0
    for i in range(3):
        before = kernels.launches["attention"]
        with flops.FlopCounter() as count:
            model.forward_ego(*args)
        assert kernels.launches["attention"] == before + per_forward
        assert dict(count.counts) == dict(eager_count.counts)
        assert len(stubbed.captures) == 0
    for i in range(3):
        before = kernels.launches["attention"]
        model.forward_ego(*args)  # captures at first, then replays
        assert kernels.launches["attention"] == before + per_forward
    assert len(stubbed.captures) == 1
    with flops.FlopCounter() as count:
        model.forward_ego(*args)
    assert dict(count.counts) == dict(eager_count.counts)


@pytest.mark.parametrize("other", ["batch", "dtype", "layout", "none"])
def test_each_signature_gets_its_own_graph(stubbed, other):
    model = _model()
    model.replay_forward_ego()
    args = _inputs(model.config)
    if other == "batch":
        alt = _inputs(model.config, batch=2)
    elif other == "dtype":
        alt = args[:2] + (args[2].double(),) + args[3:]
    elif other == "layout":  # the same values through other strides
        alt = (args[0].transpose(1, 2).contiguous().transpose(1, 2),) \
            + args[1:]
    else:
        alt = args[:4]
    for _ in range(2):
        model.forward_ego(*args)
        model.forward_ego(*alt)
    assert len(stubbed.captures) == 2
    assert len(set(stubbed.captures)) == 2
    model.forward_ego(*args)
    model.forward_ego(*alt)
    assert len(stubbed.captures) == 2


def test_at_most_max_graphs_then_eager(stubbed):
    model = _model()
    model.replay_forward_ego()
    batches = range(1, ego_graphs.MAX_GRAPHS + 2)
    for _ in range(3):
        for b in batches:
            model.forward_ego(*_inputs(model.config, batch=b))
    assert len(stubbed.captures) == ego_graphs.MAX_GRAPHS
    assert len(model._ego_graphs.graphs) == ego_graphs.MAX_GRAPHS


def test_no_capture_while_a_profiler_records(stubbed):
    model = _model()
    model.replay_forward_ego()
    args = _inputs(model.config)
    model.forward_ego(*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.forward_ego(*args)
        model.forward_ego(*args)
    assert len(stubbed.captures) == 0
    assert not [e for e in prof.events() if e.name == "model.replay"]
    model.forward_ego(*args)
    assert len(stubbed.captures) == 1
    # a replay under the profiler: model.replay inside model.forward_ego,
    # and none of the eager stages
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.forward_ego(*args)
    names = [e.name for e in prof.events()]
    assert names.count("model.forward_ego") == names.count(
        "model.replay") == 1
    assert "model.encoders" not in names and "model.decode" not in names


def test_replay_skips_the_mode_walks(stubbed, monkeypatch):
    model = _model()
    model.replay_forward_ego()
    args = _inputs(model.config)
    walks = []
    train = LidarCenterNet.train

    def counted(self, mode=True):
        if not _RERUN:  # the stand-in's rerun is no walk of the replay's
            walks.append(mode)
        return train(self, mode)

    monkeypatch.setattr(LidarCenterNet, "train", counted)
    model.train()
    eager = model.forward_ego(*args)
    assert walks[-2:] == [False, True]
    model.forward_ego(*args)  # the capture
    n = len(walks)
    replayed = model.forward_ego(*args)
    assert len(walks) == n and model.training
    assert _equal(replayed, eager)


def test_what_drops_the_graphs(stubbed):
    model, other = _model(), _model(seed=1)
    model.replay_forward_ego()
    args = _inputs(model.config)

    def graphed():
        model.forward_ego(*args)
        model.forward_ego(*args)
        assert model._ego_graphs.graphs

    graphed()
    # in place: kept, and the next replay reads the new weights
    model.load_state_dict(other.state_dict())
    assert model._ego_graphs.graphs
    assert _equal(model.forward_ego(*args), other.forward_ego(*args))
    model.load_state_dict(_model().state_dict(), assign=True)
    assert not model._ego_graphs.graphs
    graphed()
    model.to(torch.float64)
    assert not model._ego_graphs.graphs
    assert model._ego_graphs is not None  # still opted in


def test_a_model_not_opted_in_stays_eager_on_any_device(stubbed):
    model = _model()
    args = _inputs(model.config)
    for _ in range(3):
        model.forward_ego(*args)
    assert model._ego_graphs is None
    assert len(stubbed.captures) == 0


def _agent(tmp_path, name):
    model_dir = str(tmp_path / name)
    os.makedirs(model_dir)
    GlobalConfig.from_json(tiny_config().to_json()).save(
        os.path.join(model_dir, "config.json"))
    agent = HybridAgent(model_dir, device="cpu")
    pts = [(float(x), 0.0) for x in range(0, 120, 10)]
    agent.set_global_plan(
        [({"lat": x / 111324.60662786, "lon": y / 111319.490945}, 4)
         for x, y in pts], pts)
    return agent


def _sensor_frames(cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    h, w = cfg.sensors.img_resolution[0], cfg.sensors.img_width
    for i in range(n):
        pts = np.concatenate([
            rng.uniform(-20, 20, (3000, 2)), rng.uniform(-4, 0, (3000, 1)),
            rng.uniform(0, 1, (3000, 1))], axis=1).astype(np.float32)
        cams = {c: (i, rng.integers(0, 256, (h, w, 4), np.uint8))
                for c in ("rgb_front", "rgb_left", "rgb_right")}
        yield dict(cams, gps=(i, np.array([0.4 * i / 111324.60662786,
                                           0.3 / 111319.490945, 0.0])),
                   speed=(i, {"speed": 2.0 + 0.1 * i}),
                   imu=(i, np.array([0, 0, 9.8, 0, 0, 0, 0.05 * i])),
                   lidar=(i, pts))


def test_an_agent_on_the_cpu_never_captures(tmp_path, monkeypatch):
    def refuse(*args):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(ego_graphs.EgoGraphs, "capture", refuse)
    ours = _agent(tmp_path, "ours")
    eager = _agent(tmp_path, "eager")
    eager.members[0].replay_forward_ego = lambda: None
    cfg = ours.config
    for i, frame in enumerate(_sensor_frames(cfg, 8)):
        a = ours.run_step(frame, 0.05 * i)
        b = eager.run_step(frame, 0.05 * i)
        assert (a.steer, a.throttle, a.brake) == (b.steer, b.throttle,
                                                   b.brake)
        np.testing.assert_array_equal(ours.pred_wp, eager.pred_wp)
    graphs = ours.members[0]._ego_graphs
    assert graphs is not None and not graphs.graphs
    assert eager.members[0]._ego_graphs is None
    ours.destroy()
    eager.destroy()
