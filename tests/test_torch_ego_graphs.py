"""CUDA-graph replay of ``LidarCenterNet.forward_ego`` on the CPU, with
the one CUDA seam of ``transfuser_torch/graphs.py`` stubbed
(tests/test_torch_graphs.py, which also holds the policy that the frame
shares with the training step): replay after one eager call equals
eager, the outputs are the caller's, a replay skips the mode walks, a
model that was not opted in stays eager, a moved model's graphs go at
its next call whichever way it runs, and the cache keeps no model
alive. The capture itself runs on a
card: tests/test_torch_ego_graphs_cuda.py."""

import gc
import weakref

import torch

from test_torch_graphs import RERUN, equal, frame_inputs, frame_model
from test_torch_graphs import stubbed  # noqa: F401
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_torch.models import LidarCenterNet
from transfuser_torch.ops import flops


def test_replay_after_one_eager_call_equals_eager(stubbed):
    model, eager = frame_model(), frame_model()
    model.replay_forward_ego()
    frames = [frame_inputs(model.config, seed=s) for s in range(4)]
    for i, args in enumerate(frames):
        got = model.forward_ego(*args)
        assert equal(got, eager.forward_ego(*args))
        # the first call runs eagerly, the second captures
        assert len(stubbed.captures) == (0 if i == 0 else 1)
    assert len(model.graphs.graphs) == 1


def test_outputs_are_the_callers_not_the_graphs(stubbed):
    model = frame_model()
    model.replay_forward_ego()
    a, b = (frame_inputs(model.config, seed=s) for s in (1, 2))
    model.forward_ego(*a)
    first = model.forward_ego(*a)
    kept = [x.clone() for x in first]
    graph = next(iter(model.graphs.graphs.values()))
    assert not any(x.data_ptr() == y.data_ptr()
                   for x, y in zip(first, graph.outputs))
    second = model.forward_ego(*b)
    assert equal(first, kept)
    assert not torch.equal(first[0], second[0])
    # the caller's inputs are copied in, never held
    assert not any(x.data_ptr() == y.data_ptr()
                   for x, y in zip(b, graph.inputs.values()))


def test_replay_skips_the_mode_walks(stubbed, monkeypatch):
    model = frame_model()
    model.replay_forward_ego()
    args = frame_inputs(model.config)
    walks = []
    train = LidarCenterNet.train

    def counted(self, mode=True):
        if not RERUN:  # the stand-in's rerun is no walk of the replay's
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
    assert equal(replayed, eager)


def test_a_model_not_opted_in_stays_eager_on_any_device(stubbed):
    model = frame_model()
    args = frame_inputs(model.config)
    for _ in range(3):
        model.forward_ego(*args)
    assert model.graphs is None
    assert len(stubbed.captures) == 0


def test_a_moved_model_drops_its_graphs_at_its_next_call(stubbed):
    """Its next call drops them, an eager one too (here under a FLOP
    counter; on a card, a call with CPU inputs after ``.to("cpu")``)."""
    model = frame_model()
    model.replay_forward_ego()
    args = frame_inputs(model.config)
    model.forward_ego(*args)
    model.forward_ego(*args)
    assert len(model.graphs.graphs) == 1
    model.to("cpu")
    assert len(model.graphs.graphs) == 1  # the move itself clears nothing
    with flops.FlopCounter():
        model.forward_ego(*args)
    assert not model.graphs.graphs


def test_an_opted_in_model_is_freed_with_its_last_reference():
    """The cache holds no reference to its model: no cycle keeps a model,
    its weights and its graphs alive until the cyclic collector runs."""
    model = frame_model()
    model.replay_forward_ego()
    model.forward_ego(*frame_inputs(model.config))
    gone = weakref.ref(model)
    gc.disable()
    try:
        del model
        assert gone() is None
    finally:
        gc.enable()
