"""CUDA-graph replay of the whole training step
(``transfuser_torch/train/step_graphs.py``) on a card. Every test is
marked ``cuda`` and skips without one; the file imports neither JAX nor
the JAX package:

    python -m pytest tests/test_torch_train_graphs_cuda.py -q -m cuda

Every family on its full-size trunks, and PointPillars, trains ``STEPS``
steps in bf16 from one state on distinct batches three ways: eagerly
(the step a one-rank mesh gets, which never captures), through the
trainer's own step (the first call eager, the second capturing, then
replays), and through it again from the same state loaded in place by
``restore_checkpoint`` (every call a replay). A second eager run gives
the card's run-to-run noise (the backward's atomics). Each graphed run
must match the eager one within limits set from that noise: each step's
loss, and the median leaf's gap of the parameters, the AdamW moments and
the BatchNorm statistics (``_leaf_gap``). The same holds with both
clippings on. At ``lr = 0`` the parameters stand still and each step's
loss depends on its batch and its dropout masks alone: a replay's equals
the eager step's. A stale graph fails these comparisons: a skipped
re-seed of the generator, a skipped write of the update's scalars and a
skipped copy of the batch, each planted on its own."""

import dataclasses
import gc
import statistics
from types import SimpleNamespace

import pytest
import torch

from chip_smoke import FAMILY_CASES, family_config, pillar_config
from transfuser_torch.config import GlobalConfig
from transfuser_torch.data.synthetic import synthetic_batch
from transfuser_torch.ops import kernels
from transfuser_torch.train.checkpoint import restore_checkpoint, \
    save_checkpoint
from transfuser_torch.train.trainer import Trainer, make_train_step

BATCH = 4
STEPS = 6  # eager, capture, then 4 replays
CASES = [("transFuser", "regnety_032", "regnety_032")] + [
    case[1:4] for case in FAMILY_CASES] + [("pillars", None, None)]
# the step a one-rank mesh gets: eager, never captured
ONE_RANK = SimpleNamespace(data_group=None, data_index=0)
# graphed against eager: the worst step's relative loss gap, above what
# the card gives over 6 bf16 steps of these cases (eager against eager
# 0.0003-0.0196 in 16 pairs, graphed against eager 0.0003-0.044 in 32
# runs: the backward's atomics move every step after the first), and the
# median leaf's gap (``_leaf_gap``: eager against eager 0.0003-0.043) at
# bench_port's limit on ``update_gap_median``. The first step starts
# from one state in both runs, and its forward is deterministic: its
# loss must be equal.
LOSS_LIMIT = 0.08
LEAF_LIMIT = 0.1
RUNNING = ("running_mean", "running_var")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture on a card")


def _config(backbone, image, lidar, **train) -> GlobalConfig:
    cfg = pillar_config() if backbone == "pillars" else \
        family_config(backbone, image, lidar)
    if train:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train))
    return cfg


def _snapshot(trainer) -> dict:
    opt, model = trainer.optimizer, trainer.model
    return dict(
        params={n: p.detach().clone() for n, p in model.named_parameters()
                if p.requires_grad},
        stats={k: v.clone() for k, v in model.state_dict().items()
               if k.endswith(RUNNING)},
        mu=dict(enumerate(m.clone() for m in opt.mu)),
        nu=dict(enumerate(v.clone() for v in opt.nu)),
        count=opt.step_count)


def _run(trainer, step, batches, scatter_max: int) -> dict:
    """The steps' losses (read after the last step: each call's own copy)
    and the state they leave; each call launches ``scatter_max``
    scatter-max kernels and no attention kernel."""
    losses = []
    for b in batches:
        before = dict(kernels.launches)
        losses.append(step(b)["loss_total"])
        assert {k: n - before[k] for k, n in kernels.launches.items()} == \
            {"attention": 0, "scatter_max": scatter_max}
    torch.cuda.synchronize()
    return dict(loss=[float(x) for x in losses], **_snapshot(trainer))


def _leaf_gap(got: dict, want: dict, start: dict) -> float:
    """bench_port's median-leaf gap: over leaves, the median of the gap
    between the norms of the two runs' changes from ``start``, over the
    larger of the eager change's norm and the median leaf's."""
    def norms(run):
        return {k: float(torch.linalg.vector_norm((run[k] - start[k])
                                                  .float())) for k in run}

    g, w = norms(got), norms(want)
    floor = statistics.median(w.values())
    if floor == 0.0:  # nothing moved (lr 0): the norms must be equal
        return 0.0 if g == w else float("inf")
    return statistics.median(abs(g[k] - w[k]) / max(w[k], floor)
                             for k in w)


def _gaps(got: dict, want: dict, start: dict) -> dict:
    out = {"loss": max(abs(a - b) / abs(b)
                       for a, b in zip(got["loss"], want["loss"]))}
    for key in ("params", "mu", "nu", "stats"):
        if want[key]:
            out[key] = _leaf_gap(got[key], want[key], start[key])
    out["count"] = got["count"] - want["count"]
    out["loss1_equal"] = got["loss"][0] == want["loss"][0]
    return out


def _passes(gaps: dict) -> bool:
    return gaps["count"] == 0 and gaps["loss1_equal"] and \
        gaps["loss"] <= LOSS_LIMIT and all(
            gaps[k] <= LEAF_LIMIT for k in ("params", "mu", "nu", "stats")
            if k in gaps)


class _Case:
    """One trainer on the card, its batches and the state it starts from
    (saved as a checkpoint under ``tmp``)."""

    def __init__(self, cfg, tmp):
        self.cfg, self.tmp = cfg, str(tmp)
        self.trainer = Trainer(cfg, dtype=torch.bfloat16, device="cuda",
                               seed=0)
        self.batches = [self.trainer.put_batch(synthetic_batch(
            cfg, BATCH, seed=i)) for i in range(STEPS)]
        self.scatter_max = int(cfg.model.point_pillars.use_point_pillars)
        self.start = _snapshot(self.trainer)
        save_checkpoint(self.tmp, self.trainer.model, self.trainer.optimizer,
                        0)
        self.eager_step = make_train_step(self.trainer.model, cfg,
                                          self.trainer.optimizer, ONE_RANK)
        assert self.eager_step.graphs is None

    def run(self, step) -> dict:
        """``step`` over the batches from the saved state, loaded in
        place."""
        restore_checkpoint(self.tmp, 0, self.trainer.model,
                           self.trainer.optimizer)
        return _run(self.trainer, step, self.batches, self.scatter_max)

    def graphed(self) -> dict:
        return self.run(self.trainer.train_step)

    def eager(self) -> dict:
        return self.run(self.eager_step)

    def gaps(self, got, want) -> dict:
        return _gaps(got, want, self.start)

    def close(self):
        del self.trainer, self.batches, self.eager_step
        gc.collect()
        torch.cuda.empty_cache()


def _compare(cfg, tmp) -> dict:
    """Eager twice, then graphed from the first call and from a restore
    into the captured graph: the gaps of the second eager run and of both
    graphed runs to the first eager run."""
    case = _Case(cfg, tmp)
    try:
        want = case.eager()
        noise = case.gaps(case.eager(), want)
        first = case.graphed()
        graphs = case.trainer.train_step.graphs
        assert len(graphs.graphs) == 1
        graph = next(iter(graphs.graphs.values()))
        restored = case.graphed()  # every call a replay
        assert list(graphs.graphs.values()) == [graph]
        out = dict(noise=noise, first=case.gaps(first, want),
                   restored=case.gaps(restored, want))
    finally:
        case.close()
    print("train graph gaps", cfg.model.backbone,
          cfg.model.image_architecture, out)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("backbone, image, lidar", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_replayed_steps_equal_eager_steps(backbone, image, lidar, tmp_path):
    _needs_card()
    got = _compare(_config(backbone, image, lidar), tmp_path)
    assert _passes(got["noise"]), f"eager runs differ: {got['noise']}"
    assert _passes(got["first"]), got
    assert _passes(got["restored"]), got


@pytest.mark.cuda
def test_with_both_clippings(tmp_path):
    _needs_card()
    got = _compare(_config("transFuser", "regnety_032", "regnety_032",
                           agc_clip=0.01, grad_clip_norm=1.0), tmp_path)
    assert _passes(got["first"]) and _passes(got["restored"]), got


@pytest.mark.cuda
def test_at_lr_0_a_replay_draws_the_eager_masks(tmp_path):
    """The parameters stand still, so each step's loss is its batch's
    under its dropout masks: graphed equals eager."""
    _needs_card()
    case = _Case(_config("transFuser", "regnety_032", "regnety_032",
                         lr=0.0), tmp_path)
    try:
        want = case.eager()
        first, restored = case.graphed(), case.graphed()
    finally:
        case.close()
    print("lr 0 losses", want["loss"], first["loss"], restored["loss"])
    assert first["loss"] == want["loss"]
    assert restored["loss"] == want["loss"]
    assert len(set(want["loss"])) == STEPS  # distinct batches


def _skip_reseed(trainer):
    trainer.train_step.graphs.reseed = lambda: None


def _skip_fill(trainer):
    opt = trainer.optimizer

    def count_only():
        opt.step_count += 1

    opt.advance = count_only


def _skip_copy(trainer):
    graph = next(iter(trainer.train_step.graphs.graphs.values()))
    graph.inputs = {k: v.clone() for k, v in graph.inputs.items()}


def _planted(lr, tmp) -> dict:
    """Each fault planted once the graph is captured, for one run of
    replays from the restored state: its gaps to the eager run, and
    whether its losses equal the eager ones."""
    train = {} if lr is None else dict(lr=lr)
    case = _Case(_config("transFuser", "regnety_032", "regnety_032",
                         **train), tmp)
    try:
        want = case.eager()
        case.graphed()
        found = {}
        for plant in (_skip_reseed, _skip_fill, _skip_copy):
            graphs = case.trainer.train_step.graphs
            graph = next(iter(graphs.graphs.values()))
            inputs, reseed = graph.inputs, graphs.reseed
            plant(case.trainer)
            got = case.graphed()
            graph.inputs, graphs.reseed = inputs, reseed
            case.trainer.optimizer.__dict__.pop("advance", None)
            found[plant.__name__] = (case.gaps(got, want),
                                     got["loss"] == want["loss"])
        clean = case.gaps(case.graphed(), want)  # all taken out
    finally:
        case.close()
    print("planted at lr", lr, found, "clean", clean)
    assert lr == 0.0 or _passes(clean), clean
    return found


@pytest.mark.cuda
def test_a_stale_graph_fails_the_comparisons(tmp_path):
    """Each planted fault fails the comparison at the default lr or the
    lr = 0 one (equal losses)."""
    _needs_card()
    default = _planted(None, tmp_path / "default")
    still = _planted(0.0, tmp_path / "lr0")
    for name, (gaps, _) in default.items():
        assert not _passes(gaps) or not still[name][1], (name, gaps,
                                                         still[name])
