"""CUDA-graph replay of the whole training step
(``transfuser_torch/train/step_graphs.py``) on the CPU, with the capture
stubbed: a stand-in graph whose capture runs the step and puts the
state back (a capture records without running), and whose replay reruns
the step on the static inputs into the static outputs and gradients, as
one that is being captured (``AdamW.step`` leaves its host part to the
replaying code). So the bookkeeping is what runs on a card: one update a
call whichever way it runs, the capturing call's own included; the
scalars and the generator's seed written by the host before each step;
the caller's losses; the signatures, the graphs' limit and what drops
them; the paths that stay eager; the launch counters. A trainer on the
CPU never captures. The capture itself runs on a card:
tests/test_torch_train_graphs_cuda.py."""

import dataclasses
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helpers import tiny_config
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_torch import tracing
from transfuser_torch.config import GlobalConfig
from transfuser_torch.data.synthetic import synthetic_batch
from transfuser_torch.ops import flops, kernels, pillars
from transfuser_torch.train import step_graphs, train_state
from transfuser_torch.train.checkpoint import restore_checkpoint, \
    save_checkpoint
from transfuser_torch.train.trainer import Trainer, make_train_step

SMALL = dict(img_hw=(64, 128), lidar_hw=(64, 64), bev_hw=(40, 40))


def _config(pillar: bool = False, **train) -> GlobalConfig:
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


def _trainer(cfg=None, seed=0, **kw) -> Trainer:
    return Trainer(cfg or _config(), device="cpu", seed=seed, **kw)


def _eager(cfg=None, seed=0, **kw) -> Trainer:
    """A trainer whose step never captures: the step a mesh gets (a
    stand-in mesh of one rank)."""
    trainer = _trainer(cfg, seed, **kw)
    trainer.train_step = make_train_step(
        trainer.model, trainer.config, trainer.optimizer,
        SimpleNamespace(data_group=None, data_index=0))
    assert trainer.train_step.graphs is None
    return trainer


def _batches(trainer, n, size=2, first_seed=0):
    return [trainer.put_batch(synthetic_batch(trainer.config, size,
                                              seed=first_seed + i, **SMALL))
            for i in range(n)]


class _ReplayByRerun:
    """A stand-in for the captured graph: replay reruns the step on the
    static inputs as a captured step runs, into the static outputs and
    the captured gradients, and counts and opens nothing itself."""

    def __init__(self, graphs, static, outputs, grads):
        self.graphs, self.static = graphs, static
        self.outputs, self.grads = outputs, grads

    def replay(self):
        before, enabled = dict(kernels.launches), tracing._profiler_enabled
        tracing._profiler_enabled = lambda: False  # a graph opens no span
        try:
            out = _as_captured(self.graphs.step, self.static)
        finally:
            tracing._profiler_enabled = enabled
        kernels.launches.update(before)
        for k, v in out.items():
            self.outputs[k].copy_(v)
        for g, p in zip(self.grads, self.graphs.optimizer.params):
            g.copy_(p.grad)


def _as_captured(step, batch):
    """The step as a capture sees it: ``AdamW.step`` without its host
    part."""
    old = train_state.capturing
    train_state.capturing = lambda: True
    try:
        return step(batch)
    finally:
        train_state.capturing = old


def _stub_record(self, static, stream):
    """``StepGraphs.record`` without a card: the step runs on the static
    inputs (launches counted, as a capture counts them) and every state
    it touched is put back, so that the capture updates nothing."""
    model, opt = self.model, self.optimizer
    state = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [[m.clone() for m in ms] for ms in (opt.mu, opt.nu)]
    outputs = _as_captured(self.step, static)
    model.load_state_dict(state)
    for ms, saved in zip((opt.mu, opt.nu), moments):
        for m, s in zip(ms, saved):
            m.copy_(s)
    grads = [p.grad for p in opt.params]
    type(self).captures.append(step_graphs.signature(static, model.dtype))
    return _ReplayByRerun(self, static, outputs, grads), outputs


@pytest.fixture
def stubbed(monkeypatch):
    """Every batch counts as on the card, the side stream is the current
    one, the capture is stubbed, and the plain scatter-max counts a
    launch as the kernel's wrapper does."""
    plain = pillars.reference_segment_max

    def counted(*args):
        kernels.count_launch("scatter_max")
        return plain(*args)

    monkeypatch.setattr(pillars, "reference_segment_max", counted)
    monkeypatch.setattr(step_graphs, "on_card", lambda batch: True)
    monkeypatch.setattr(step_graphs.StepGraphs, "record", _stub_record)
    monkeypatch.setattr(step_graphs.StepGraphs, "_side_stream",
                        lambda self, device: _null())
    monkeypatch.setattr(step_graphs.StepGraphs, "captures", [],
                        raising=False)
    return step_graphs.StepGraphs


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _state(trainer):
    opt = trainer.optimizer
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            [m.clone() for m in opt.mu], [v.clone() for v in opt.nu],
            opt.step_count)


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa[3] == sb[3]
    assert sa[0].keys() == sb[0].keys()
    for k in sa[0]:  # parameters and BatchNorm statistics
        assert torch.equal(sa[0][k], sb[0][k]), k
    for x, y in zip(sa[1] + sa[2], sb[1] + sb[2]):
        assert torch.equal(x, y)


def _equal_losses(a, b):
    assert a.keys() == b.keys()
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("pillar", [False, True])
def test_graphed_calls_equal_eager_calls(stubbed, pillar):
    """N calls (eager, capture, replays) equal N eager calls in the
    losses, parameters, BatchNorm statistics, moments and count; the
    capturing call updates once. Dropout is on, so the masks are the
    eager ones too."""
    cfg = _config(pillar)
    assert cfg.model.gpt.resid_pdrop > 0
    graphed, eager = _trainer(cfg), _eager(cfg)
    batches = _batches(graphed, 5)
    for i, batch in enumerate(batches):
        got = graphed.train_step(batch)
        want = eager.train_step(batch)
        assert _equal_losses(got, want), i
        _assert_same_state(graphed, eager)
        assert graphed.optimizer.step_count == i + 1
        assert len(stubbed.captures) == (0 if i == 0 else 1)
    assert len(graphed.train_step.graphs.graphs) == 1


def test_returned_losses_are_the_callers(stubbed):
    trainer = _trainer()
    a, b = _batches(trainer, 2)
    trainer.train_step(a)
    trainer.train_step(a)  # captures
    first = trainer.train_step(a)
    kept = {k: v.clone() for k, v in first.items()}
    graph = next(iter(trainer.train_step.graphs.graphs.values()))
    assert not any(v.data_ptr() == graph.outputs[k].data_ptr()
                   for k, v in first.items())
    second = trainer.train_step(b)
    assert _equal_losses(first, kept)
    assert not torch.equal(first["loss_total"], second["loss_total"])
    # the caller's batch is copied in, never held
    assert not any(b[k].data_ptr() == graph.inputs[k].data_ptr()
                   for k in b)


def test_scalars_and_seed_follow_the_count(stubbed):
    """The scalars that AdamW reads are the schedule's learning rate and
    the bias corrections of the update under way, written by the host
    before each step, through a linear warm-up (2 steps) and a drop (at
    epoch 1 after the warm-up, step 6); the generator is seeded from the
    count before each step. Graphed calls equal eager ones throughout."""
    cfg = _config(warmup_epochs=0.5, schedule_reduce_epoch_01=1,
                  schedule_reduce_epoch_02=100, lr=1e-3)
    graphed = _trainer(cfg, steps_per_epoch=4)
    eager = _eager(cfg, steps_per_epoch=4)
    opt = graphed.optimizer
    seeds = []
    graphs = graphed.train_step.graphs
    reseed = graphs.reseed

    def seeding():
        reseed()
        seeds.append(graphs.gen.initial_seed())

    graphs.reseed = seeding
    batches = _batches(graphed, 2)
    lrs = []
    for i in range(9):
        batch = batches[i % 2]
        got = graphed.train_step(batch)
        # the learning rate of eager's update, from its own host floats
        lrs.append(eager.optimizer.schedule(eager.optimizer.step_count))
        want = eager.train_step(batch)
        assert _equal_losses(got, want), i
        t = opt.step_count
        assert t == i + 1
        assert opt.scalars.tolist() == pytest.approx(
            [lrs[-1], 1 - opt.b1 ** t, 1 - opt.b2 ** t], rel=1e-6)
        assert seeds[-1] == cfg.train.seed * 2 ** 32 + i
    _assert_same_state(graphed, eager)
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(5e-4)  # warm-up
    assert lrs[5] == pytest.approx(1e-3)
    assert lrs[6] == pytest.approx(1e-3 * cfg.train.schedule_gamma)
    # one seed a call (the capture's warm-up is the call's own step)
    assert len(seeds) == 9 and len(stubbed.captures) == 1


def test_counters_grow_by_the_captured_amounts(stubbed):
    """One scatter-max launch a pillar step, eager, capturing or
    replayed; a call under a FLOP counter runs eagerly and counts the
    eager step's operations."""
    trainer = _trainer(_config(pillar=True))
    batch = _batches(trainer, 1)[0]
    with flops.FlopCounter() as eager_count:
        trainer.train_step(batch)
    assert eager_count.total > 0
    for i in range(4):
        before = kernels.launches["scatter_max"]
        trainer.train_step(batch)
        assert kernels.launches["scatter_max"] == before + 1, i
    graph = next(iter(trainer.train_step.graphs.graphs.values()))
    assert graph.launches == {"scatter_max": 1}
    for _ in range(2):
        before = kernels.launches["scatter_max"]
        with flops.FlopCounter() as count:
            trainer.train_step(batch)
        assert kernels.launches["scatter_max"] == before + 1
        assert dict(count.counts) == dict(eager_count.counts)
    assert len(stubbed.captures) == 1


def test_no_capture_under_a_counter_or_a_mesh(stubbed):
    trainer = _trainer()
    batch = _batches(trainer, 1)[0]
    for _ in range(3):
        with flops.FlopCounter():
            trainer.train_step(batch)
    assert not stubbed.captures and not trainer.train_step.graphs.seen
    assert trainer.optimizer.step_count == 3
    # under a mesh the step is eager and has no graphs
    mesh = SimpleNamespace(data_group=None, data_index=0)
    step = make_train_step(trainer.model, trainer.config, trainer.optimizer,
                           mesh)
    assert step.graphs is None
    for _ in range(3):
        step(batch)
    assert not stubbed.captures and trainer.optimizer.step_count == 6


def test_no_capture_while_a_profiler_records(stubbed):
    trainer = _trainer()
    batch = _batches(trainer, 1)[0]
    trainer.train_step(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(batch)
        trainer.train_step(batch)
    assert not stubbed.captures
    assert not [e for e in prof.events() if e.name == "train.replay"]
    trainer.train_step(batch)
    assert len(stubbed.captures) == 1
    # a replay under the profiler: train.replay inside train.step, and
    # none of the phases
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(batch)
    names = [e.name for e in prof.events()]
    assert names.count("train.step") == names.count("train.replay") == 1
    assert not [n for n in names if n in (
        "train.forward", "train.losses", "train.backward", "train.clip",
        "train.update")]
    assert trainer.optimizer.step_count == 5


def test_each_signature_its_graph_at_most_max_graphs(stubbed):
    trainer = _trainer()
    sizes = range(1, step_graphs.MAX_GRAPHS + 2)
    batches = {b: _batches(trainer, 1, size=b)[0] for b in sizes}
    for _ in range(3):
        for b in sizes:
            trainer.train_step(batches[b])
    assert len(stubbed.captures) == step_graphs.MAX_GRAPHS
    assert len(set(stubbed.captures)) == step_graphs.MAX_GRAPHS
    assert len(trainer.train_step.graphs.graphs) == step_graphs.MAX_GRAPHS
    assert trainer.optimizer.step_count == 3 * len(sizes)
    # the same values through other strides: another signature
    batch = batches[1]
    alt = dict(batch, rgb=batch["rgb"].transpose(1, 2).contiguous()
               .transpose(1, 2))
    assert step_graphs.signature(alt, torch.float32) != \
        step_graphs.signature(batch, torch.float32)


def _graphed(trainer, batch):
    for _ in range(2):
        trainer.train_step(batch)
    assert trainer.train_step.graphs.graphs


def test_what_drops_the_graphs(stubbed, tmp_path):
    """An in-place load keeps the graph and the next replay reads it (the
    model's, AdamW's, restore_checkpoint's); a move or an assigning load
    drops it; init_state makes a step with none."""
    trainer, other = _trainer(), _eager(seed=1)
    batches = _batches(trainer, 3)
    for batch in batches[:2]:
        other.train_step(batch)
    _graphed(trainer, batches[0])
    captures = len(stubbed.captures)
    trainer.model.load_state_dict(other.model.state_dict())
    trainer.optimizer.load_state_dict(other.optimizer.state_dict())
    assert trainer.train_step.graphs.graphs
    assert _equal_losses(trainer.train_step(batches[2]),
                         other.train_step(batches[2]))
    assert len(stubbed.captures) == captures
    _assert_same_state(trainer, other)
    # restore_checkpoint, in place
    save_checkpoint(str(tmp_path), other.model, other.optimizer, 0)
    restore_checkpoint(str(tmp_path), 0, trainer.model, trainer.optimizer)
    assert trainer.train_step.graphs.graphs
    assert _equal_losses(trainer.train_step(batches[1]),
                         other.train_step(batches[1]))
    _assert_same_state(trainer, other)
    trainer.model.to("cpu")
    trainer.train_step(batches[0])
    assert not trainer.train_step.graphs.graphs
    _graphed(trainer, batches[0])
    # (the optimizer keeps the parameters it had: train no further)
    trainer.model.load_state_dict(other.model.state_dict(), assign=True)
    trainer.train_step(batches[0])
    assert not trainer.train_step.graphs.graphs
    trainer.init_state()
    assert not trainer.train_step.graphs.graphs


def test_a_trainer_on_the_cpu_never_captures(monkeypatch):
    def refuse(*args):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(step_graphs.StepGraphs, "record", refuse)
    trainer = _trainer()
    batch = _batches(trainer, 1)[0]
    for _ in range(3):
        trainer.train_step(batch)
    graphs = trainer.train_step.graphs
    assert not graphs.graphs and not graphs.seen
    assert trainer.optimizer.step_count == 3
