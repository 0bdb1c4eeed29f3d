"""CUDA-graph replay of the whole training step on the CPU, with the one
CUDA seam of ``transfuser_torch/graphs.py`` stubbed
(tests/test_torch_graphs.py, which also holds the policy that the step
shares with the frame). So the bookkeeping is what runs on a card: one
update a call whichever way it runs, the capturing call's own included;
the host part (count, scalars and the generator's seed) run before the
device part, in the same order eager and replayed; the caller's losses;
in-place loads that reach the next replay; the paths that stay eager.
The capture itself runs on a card: tests/test_torch_train_graphs_cuda.py.
"""

from types import SimpleNamespace

import pytest
import torch

from test_torch_graphs import equal, train_batches, train_config
from test_torch_graphs import stubbed  # noqa: F401
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_torch.ops import flops
from transfuser_torch.train.checkpoint import restore_checkpoint, \
    save_checkpoint
from transfuser_torch.train.trainer import Trainer, make_train_step

ONE_RANK = SimpleNamespace(data_group=None, data_index=0)


def _trainer(cfg=None, seed=0, **kw) -> Trainer:
    return Trainer(cfg or train_config(), device="cpu", seed=seed, **kw)


def _eager(cfg=None, seed=0, **kw) -> Trainer:
    """A trainer whose step never captures: the step a mesh gets (a
    stand-in mesh of one rank)."""
    trainer = _trainer(cfg, seed, **kw)
    trainer.train_step = make_train_step(
        trainer.model, trainer.config, trainer.optimizer, ONE_RANK)
    assert trainer.train_step.graphs is None
    return trainer


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


@pytest.mark.parametrize("pillar", [False, True])
def test_graphed_calls_equal_eager_calls(stubbed, pillar):
    """N calls (eager, capture, replays) equal N eager calls in the
    losses, parameters, BatchNorm statistics, moments and count; the
    capturing call updates once. Dropout is on, so the masks are the
    eager ones too."""
    cfg = train_config(pillar)
    assert cfg.model.gpt.resid_pdrop > 0
    graphed, eager = _trainer(cfg), _eager(cfg)
    batches = train_batches(graphed, 5)
    for i, batch in enumerate(batches):
        got = graphed.train_step(batch)
        want = eager.train_step(batch)
        assert equal(got, want), i
        _assert_same_state(graphed, eager)
        assert graphed.optimizer.step_count == i + 1
        assert len(stubbed.captures) == (0 if i == 0 else 1)
    assert len(graphed.train_step.graphs.graphs) == 1


def test_returned_losses_are_the_callers(stubbed):
    trainer = _trainer()
    a, b = train_batches(trainer, 2)
    trainer.train_step(a)
    trainer.train_step(a)  # captures
    first = trainer.train_step(a)
    kept = {k: v.clone() for k, v in first.items()}
    graph = next(iter(trainer.train_step.graphs.graphs.values()))
    assert not any(v.data_ptr() == graph.outputs[k].data_ptr()
                   for k, v in first.items())
    second = trainer.train_step(b)
    assert equal(first, kept)
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
    cfg = train_config(warmup_epochs=0.5, schedule_reduce_epoch_01=1,
                       schedule_reduce_epoch_02=100, lr=1e-3)
    graphed = _trainer(cfg, steps_per_epoch=4)
    eager = _eager(cfg, steps_per_epoch=4)
    opt = graphed.optimizer
    seeds = []
    graphs = graphed.train_step.graphs
    host = graphs.host

    def seeding():
        host()
        seeds.append(graphs.generator.initial_seed())

    graphs.host = seeding
    batches = train_batches(graphed, 2)
    lrs = []
    for i in range(9):
        batch = batches[i % 2]
        got = graphed.train_step(batch)
        # the learning rate of eager's update, from its own host floats
        lrs.append(eager.optimizer.schedule(eager.optimizer.step_count))
        want = eager.train_step(batch)
        assert equal(got, want), i
        t = opt.step_count
        assert t == i + 1
        assert opt.scalars.tolist() == pytest.approx(
            [lrs[-1], 1 - opt.b1 ** t, 1 - opt.b2 ** t], rel=1e-6)
        assert seeds[-1] == cfg.train.seed * 2 ** 32 + i
    _assert_same_state(graphed, eager)
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(5e-4)  # warm-up
    assert lrs[5] == pytest.approx(1e-3)
    assert lrs[6] == pytest.approx(1e-3 * cfg.train.schedule_gamma)
    # one seed a call (the capture's own run is the call's step)
    assert len(seeds) == 9 and len(stubbed.captures) == 1


def _host_order(trainer):
    """What the host part leaves for each forward, in order: after each
    ``advance`` its count, then at the forward the count, the learning
    rate and the generator's seed the forward draws from."""
    opt, events = trainer.optimizer, []
    advance = opt.advance

    def advancing():
        advance()
        events.append(("advance", opt.step_count))

    def forward(module, args, kwargs):
        events.append(("forward", opt.step_count, float(opt.scalars[0]),
                       kwargs["gen"].initial_seed()))

    opt.advance = advancing
    trainer.model.register_forward_pre_hook(forward, with_kwargs=True)
    return events


def test_eager_and_replayed_steps_run_the_host_part_alike(stubbed):
    """Count, learning rate and seed are written before the forward, in
    the same order on an eager step (a mesh's), the capturing call and a
    replay (whose forward is the graph's)."""
    cfg = train_config(warmup_epochs=0.5, lr=1e-3)
    graphed = _trainer(cfg, steps_per_epoch=4)
    eager = _eager(cfg, steps_per_epoch=4)
    got, want = _host_order(graphed), _host_order(eager)
    batches = train_batches(graphed, 2)
    for i in range(4):  # eager, capture, replays
        graphed.train_step(batches[i % 2])
        eager.train_step(batches[i % 2])
    assert len(stubbed.captures) == 1
    seed = cfg.train.seed * 2 ** 32
    lrs = [eager.optimizer.schedule(n) for n in range(4)]
    assert want == [e for n in range(4) for e in (
        ("advance", n + 1), ("forward", n + 1, pytest.approx(lrs[n]),
                             seed + n))]
    # the capture's recording (a forward that updates nothing) aside
    assert got[:4] + got[5:] == want
    assert got[4] == got[3]


def test_in_place_loads_reach_the_next_replay(stubbed, tmp_path):
    """AdamW's in-place load and restore_checkpoint keep the graph, and
    the next replay reads them; init_state makes a step with none."""
    trainer, other = _trainer(), _eager(seed=1)
    batches = train_batches(trainer, 3)
    for batch in batches[:2]:
        other.train_step(batch)
    trainer.train_step(batches[0])
    trainer.train_step(batches[0])
    trainer.model.load_state_dict(other.model.state_dict())
    trainer.optimizer.load_state_dict(other.optimizer.state_dict())
    assert trainer.train_step.graphs.graphs
    assert equal(trainer.train_step(batches[2]),
                 other.train_step(batches[2]))
    assert len(stubbed.captures) == 1
    _assert_same_state(trainer, other)
    save_checkpoint(str(tmp_path), other.model, other.optimizer, 0)
    restore_checkpoint(str(tmp_path), 0, trainer.model, trainer.optimizer)
    assert trainer.train_step.graphs.graphs
    assert equal(trainer.train_step(batches[1]),
                 other.train_step(batches[1]))
    _assert_same_state(trainer, other)
    assert len(stubbed.captures) == 1
    trainer.init_state()
    assert not trainer.train_step.graphs.graphs


def test_a_mesh_stays_eager(stubbed):
    """Under a mesh the step has no graphs, and every call updates once,
    under a FLOP counter too."""
    trainer = _trainer()
    batch = train_batches(trainer, 1)[0]
    step = make_train_step(trainer.model, trainer.config, trainer.optimizer,
                           ONE_RANK)
    assert step.graphs is None
    for _ in range(3):
        step(batch)
    with flops.FlopCounter():
        step(batch)
    assert not stubbed.captures and trainer.optimizer.step_count == 4
