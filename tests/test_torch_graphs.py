"""The CUDA-graph cache (``transfuser_torch/graphs.py``) on the CPU, for
both of its users: the agent's ``forward_ego`` (``frame``) and the
trainer's whole step (``train``). With the one CUDA seam stubbed (a
stand-in graph: its capture runs the call and puts the state back, as a
capture records without running; its replay reruns the call on the
static inputs into the static outputs), each user's calls go through the
policy that runs on a card: each signature its graph, at most
``MAX_GRAPHS``; no capture while a profiler records or a FLOP counter
counts; the launch counters; what drops the graphs. Without the stub the
CPU never captures. What is each path's own stays in
tests/test_torch_ego_graphs.py and tests/test_torch_train_graphs.py;
the capture itself runs on a card (their ``_cuda`` files)."""

import contextlib
import dataclasses
import functools
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helpers import tiny_config
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_torch import graphs, tracing
from transfuser_torch.agents.hybrid_agent import HybridAgent
from transfuser_torch.config import GlobalConfig
from transfuser_torch.data.synthetic import synthetic_batch
from transfuser_torch.models import LidarCenterNet
from transfuser_torch.ops import attention, flops, kernels, pillars
from transfuser_torch.train.trainer import Trainer, make_train_step

SMALL = dict(img_hw=(64, 128), lidar_hw=(64, 64), bev_hw=(40, 40))
RERUN = []  # the stand-in graph replaying, if any


def _optimizer(cache):
    return getattr(cache, "optimizer", None)


class _ReplayByRerun:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: replay reruns
    the captured call into the static outputs (and a step's gradients
    into the captured ones), and counts and opens nothing itself, as a
    graph's replay does not."""

    def __init__(self, cache, fn, outputs, grads):
        self.cache, self.fn, self.outputs, self.grads = \
            cache, fn, outputs, grads

    def replay(self):
        before, enabled = dict(kernels.launches), tracing._profiler_enabled
        tracing._profiler_enabled = lambda: False  # a graph opens no span
        RERUN.append(self)
        try:
            out = self.fn()
        finally:
            tracing._profiler_enabled = enabled
            RERUN.pop()
        kernels.launches.update(before)
        pairs = out.items() if isinstance(out, dict) else enumerate(out)
        for k, v in pairs:
            self.outputs[k].copy_(v)
        opt = _optimizer(self.cache)
        for g, p in zip(self.grads, opt.params if opt else ()):
            g.copy_(p.grad)


@contextlib.contextmanager
def _stub_side_stream(self, device):
    """The side stream of ``Graphs._card`` without a card: ``record(fn)``
    runs the call (launches counted, as a capture counts them) and puts
    back every state it touched (a frame's eval-mode call touches none),
    so that the capture updates nothing."""
    def record(fn):
        opt, model = _optimizer(self), getattr(self, "model", None)
        state = {k: v.clone() for k, v in model.state_dict().items()} \
            if model is not None else None
        moments = [[m.clone() for m in ms] for ms in
                   ((opt.mu, opt.nu) if opt else ())]
        outputs = fn()
        if model is not None:
            model.load_state_dict(state)
        for ms, saved in zip((opt.mu, opt.nu) if opt else (), moments):
            for m, s in zip(ms, saved):
                m.copy_(s)
        grads = [p.grad for p in opt.params] if opt else []
        type(self).captures.append(self)
        return _ReplayByRerun(self, fn, outputs, grads), outputs

    yield record


@pytest.fixture
def stubbed(monkeypatch):
    """The one CUDA seam stubbed: every call counts as on the card, and
    its side stream is the stub's. The plain attention and scatter-max
    count a launch as the kernels' wrappers do."""
    plain_attention = attention.reference_attention
    plain_max = pillars.reference_segment_max

    def counted_attention(q, k, v):
        kernels.count_launch("attention")
        return plain_attention(q, k, v)

    def counted_max(*args):
        kernels.count_launch("scatter_max")
        return plain_max(*args)

    monkeypatch.setattr(attention, "reference_attention", counted_attention)
    monkeypatch.setattr(pillars, "reference_segment_max", counted_max)
    monkeypatch.setattr(graphs.Graphs, "_card", lambda self, inputs:
                        functools.partial(_stub_side_stream, self))
    monkeypatch.setattr(graphs.Graphs, "captures", [], raising=False)
    return graphs.Graphs


def equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def frame_inputs(cfg, batch=1, seed=0):
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


def frame_model(seed=0) -> LidarCenterNet:
    return LidarCenterNet(tiny_config(), dtype=torch.float32, device="cpu",
                          seed=seed)


def train_config(pillar: bool = False, **train) -> GlobalConfig:
    cfg = tiny_config()
    if pillar:
        # 8 m x 8 m at 8 px/m: a 64 x 64 canvas, the tiny LiDAR size
        pp = dataclasses.replace(
            cfg.model.point_pillars, use_point_pillars=True,
            max_lidar_points=500, min_x=-4.0, max_x=4.0, min_y=-8.0,
            max_y=0.0)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    point_pillars=pp))
    if train:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train))
    return GlobalConfig.from_json(cfg.to_json())


def train_batches(trainer, n, size=2, first_seed=0):
    return [trainer.put_batch(synthetic_batch(trainer.config, size,
                                              seed=first_seed + i, **SMALL))
            for i in range(n)]


class Frame:
    """A tiny model's ``forward_ego``, opted in to replay; each call
    launches ``per_call`` attention kernels (``pillar``: the step's
    alone). It counts no updates."""
    kernel, updates = "attention", None
    root, replay_span = "model.forward_ego", "model.replay"
    eager_spans = ("model.encoders", "model.decode")

    def __init__(self, seed=0, pillar=False):
        self.owner = frame_model(seed)
        self.owner.replay_forward_ego()
        self.per_call = 4 * self.owner.config.model.gpt.n_layer  # 4 GPTs

    @property
    def cache(self):
        return self.owner.graphs

    def inputs(self, n=1, batch=1):
        return [frame_inputs(self.owner.config, batch, seed=s)
                for s in range(n)]

    def __call__(self, x):
        return self.owner.forward_ego(*x)

    def other(self, x, how):
        if how == "batch":
            return frame_inputs(self.owner.config, batch=2)
        if how == "dtype":
            return x[:2] + (x[2].double(),) + x[3:]
        if how == "layout":  # the same values through other strides
            return (x[0].transpose(1, 2).contiguous().transpose(1, 2),) \
                + x[1:]
        return x[:4]  # velocity None

    def load_in_place(self, other):
        self.owner.load_state_dict(other.owner.state_dict())

    def state(self):
        return {k: v.clone() for k, v in self.owner.state_dict().items()}


class Train:
    """A trainer's step on the CPU; each pillar step launches one
    scatter-max kernel. ``updates``: the optimizer's count."""
    kernel, per_call = "scatter_max", 1
    root, replay_span = "train.step", "train.replay"
    eager_spans = ("train.forward", "train.losses", "train.backward",
                   "train.clip", "train.update")

    def __init__(self, seed=0, pillar=False):
        self.trainer = Trainer(train_config(pillar), device="cpu", seed=seed)
        self.owner = self.trainer.model

    @property
    def cache(self):
        return self.trainer.train_step.graphs

    @property
    def updates(self):
        return self.trainer.optimizer.step_count

    def inputs(self, n=1, batch=2):
        return train_batches(self.trainer, n, size=batch)

    def __call__(self, x):
        return self.trainer.train_step(x)

    def other(self, x, how):
        if how == "batch":
            return self.inputs(batch=1)[0]
        # the same values through other strides
        return dict(x, rgb=x["rgb"].transpose(1, 2).contiguous()
                    .transpose(1, 2))

    def load_in_place(self, other):
        self.owner.load_state_dict(other.owner.state_dict())
        self.trainer.optimizer.load_state_dict(
            other.trainer.optimizer.state_dict())

    def state(self):
        opt = self.trainer.optimizer
        return dict({k: v.clone() for k, v in self.owner.state_dict().items()},
                    **{f"mu{i}": m.clone() for i, m in enumerate(opt.mu)},
                    **{f"nu{i}": v.clone() for i, v in enumerate(opt.nu)})


USERS = {"frame": Frame, "train": Train}


def _graphed(user, x):
    user(x)
    user(x)
    assert len(user.cache.graphs) == 1


def one_update_a_call(user, calls) -> bool:
    """A user that counts its updates (the trainer) made one a call,
    whichever way the call ran."""
    return user.updates is None or user.updates == calls


@pytest.mark.parametrize("user, how", [
    ("frame", "batch"), ("frame", "dtype"), ("frame", "layout"),
    ("frame", "none"), ("train", "batch"), ("train", "layout")])
def test_each_signature_gets_its_own_graph(stubbed, user, how):
    u = USERS[user]()
    x = u.inputs()[0]
    alt = u.other(x, how)
    for _ in range(2):
        u(x)
        u(alt)
    assert len(stubbed.captures) == len(u.cache.graphs) == 2
    u(x)
    u(alt)
    assert len(stubbed.captures) == 2


@pytest.mark.parametrize("user", USERS)
def test_at_most_max_graphs_then_eager(stubbed, user):
    u = USERS[user]()
    sizes = range(1, graphs.MAX_GRAPHS + 2)
    xs = {b: u.inputs(batch=b)[0] for b in sizes}
    for _ in range(3):
        for b in sizes:
            u(xs[b])
    assert len(stubbed.captures) == graphs.MAX_GRAPHS
    assert len(u.cache.graphs) == graphs.MAX_GRAPHS
    assert one_update_a_call(u, 3 * len(sizes))


@pytest.mark.parametrize("user", USERS)
def test_no_capture_while_a_profiler_records(stubbed, user):
    u = USERS[user]()
    x = u.inputs()[0]
    u(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        u(x)
        u(x)
    assert not stubbed.captures
    assert not [e for e in prof.events() if e.name == u.replay_span]
    u(x)
    assert len(stubbed.captures) == 1
    # a replay under the profiler: the replay span inside the root span,
    # and none of the eager stages
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        u(x)
    names = [e.name for e in prof.events()]
    assert names.count(u.root) == names.count(u.replay_span) == 1
    assert not [n for n in names if n in u.eager_spans]
    assert one_update_a_call(u, 5)


@pytest.mark.parametrize("user", USERS)
def test_no_capture_under_a_flop_counter(stubbed, user):
    """A call under a FLOP counter runs eagerly, so that the counter
    counts it, whether or not a graph exists; it launches one call's
    kernels and makes one update."""
    u = USERS[user](pillar=True)
    x = u.inputs()[0]
    with flops.FlopCounter() as eager_count:
        u(x)
    assert eager_count.total > 0

    def counted():
        before = kernels.launches[u.kernel]
        with flops.FlopCounter() as count:
            u(x)
        assert kernels.launches[u.kernel] == before + u.per_call
        assert dict(count.counts) == dict(eager_count.counts)

    for _ in range(2):
        counted()
    assert not stubbed.captures and not u.cache.seen
    assert one_update_a_call(u, 3)
    _graphed(u, x)
    for _ in range(2):
        counted()
    assert len(stubbed.captures) == 1
    assert one_update_a_call(u, 7)


@pytest.mark.parametrize("user", USERS)
def test_counters_grow_by_the_captured_calls_amounts(stubbed, user):
    """Launches: the eager call's, the capturing call's own run and the
    captured call's at each replay, all equal."""
    u = USERS[user](pillar=True)
    x = u.inputs()[0]
    for i in range(4):  # eager, capture, replays
        before = kernels.launches[u.kernel]
        u(x)
        assert kernels.launches[u.kernel] == before + u.per_call, i
    graph = next(iter(u.cache.graphs.values()))
    assert graph.launches == {u.kernel: u.per_call}
    assert len(stubbed.captures) == 1


@pytest.mark.parametrize("how", ["to", "assign"])
@pytest.mark.parametrize("user", USERS)
def test_a_moved_storage_version_drops_the_graphs(stubbed, user, how):
    """A move or an assigning load moves the owner's storage_version; the
    next call drops every graph, and the one after captures anew."""
    u, fresh = USERS[user](), USERS[user](seed=1)
    x = u.inputs()[0]
    _graphed(u, x)
    version = u.owner.storage_version
    if how == "to":
        u.owner.to("cpu")
    else:  # (a trainer's optimizer keeps the parameters it had)
        u.owner.load_state_dict(fresh.owner.state_dict(), assign=True)
    assert u.owner.storage_version == version + 1
    u(x)
    assert not u.cache.graphs
    assert len(stubbed.captures) == 1
    u(x)
    assert len(u.cache.graphs) == 1 and len(stubbed.captures) == 2


@pytest.mark.parametrize("user", USERS)
def test_an_in_place_load_keeps_the_graph(stubbed, user):
    """The next replay reads what was loaded in place: it gives what the
    loaded-from owner gives, and leaves its state."""
    u, other = USERS[user](), USERS[user](seed=1)
    x, y = u.inputs(2)
    _graphed(u, x)
    other(x)
    u.load_in_place(other)
    assert len(u.cache.graphs) == 1
    assert equal(u(y), other(y))
    assert stubbed.captures.count(u.cache) == 1
    assert equal(u.state(), other.state())


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


def _agent_on_the_cpu(tmp_path):
    """An agent's frames on the CPU, equal to those of an agent whose
    member never opts in: the member's cache."""
    ours, eager = _agent(tmp_path, "ours"), _agent(tmp_path, "eager")
    eager.members[0].replay_forward_ego = lambda: None
    for i, frame in enumerate(_sensor_frames(ours.config, 8)):
        a = ours.run_step(frame, 0.05 * i)
        b = eager.run_step(frame, 0.05 * i)
        assert (a.steer, a.throttle, a.brake) == (b.steer, b.throttle,
                                                   b.brake)
        np.testing.assert_array_equal(ours.pred_wp, eager.pred_wp)
    assert eager.members[0].graphs is None
    cache = ours.members[0].graphs
    ours.destroy()
    eager.destroy()
    return cache


def _trainer_on_the_cpu(tmp_path):
    """A trainer's steps on the CPU, equal to those of the eager step a
    one-rank mesh gets: the step's cache."""
    u = Train()
    trainer = u.trainer
    eager = Trainer(trainer.config, device="cpu", seed=0)
    eager.train_step = make_train_step(
        eager.model, eager.config, eager.optimizer,
        SimpleNamespace(data_group=None, data_index=0))
    for x in u.inputs(3):
        assert equal(u(x), eager.train_step(x))
    assert trainer.optimizer.step_count == 3
    return u.cache


@pytest.mark.parametrize("user", USERS)
def test_the_cpu_never_captures(user, tmp_path, monkeypatch):
    def refuse(*args):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(graphs.Graphs, "_side_stream", refuse)
    run = {"frame": _agent_on_the_cpu, "train": _trainer_on_the_cpu}[user]
    cache = run(tmp_path)
    assert cache is not None and not cache.graphs and not cache.seen
