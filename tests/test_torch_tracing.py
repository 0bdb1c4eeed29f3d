"""The port's named spans (``transfuser_torch/tracing.py``) on the CPU:
the gate with no profiler recording, the spans a tiny agent frame and a
tiny train step open and how they nest, and outputs bit for bit the same
with the profiler on and off. The ``kernels.*`` spans sit in the CUDA
branches of the kernel wrappers: tests/test_torch_tracing_cuda.py checks
them, and the spans' clock against the device's, on a card."""

import dataclasses
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from helpers import tiny_config
from test_torch_agent import _frames, _plan
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_torch import tracing
from transfuser_torch.agents.hybrid_agent import HybridAgent
from transfuser_torch.config import GlobalConfig
from transfuser_torch.data.synthetic import synthetic_batch
from transfuser_torch.models import LidarCenterNet
from transfuser_torch.train.trainer import Trainer

LAYERS = ("agent.", "model.", "kernels.", "train.")
SMALL = dict(img_hw=(64, 128), lidar_hw=(64, 64), bev_hw=(40, 40))
AGENT_STAGES = ("agent.tick", "agent.inputs", "agent.pack", "agent.upload",
                "model.forward_ego", "agent.readback", "agent.boxes",
                "agent.control")
TRAIN_PHASES = ("train.forward", "train.losses", "train.backward",
                "train.clip", "train.update")


def _config(pillars: bool = False) -> GlobalConfig:
    cfg = tiny_config()
    if pillars:
        # 8 m x 8 m at 8 px/m: a 64 x 64 canvas, the tiny LiDAR size
        pp = dataclasses.replace(
            cfg.model.point_pillars, use_point_pillars=True,
            max_lidar_points=500, min_x=-4.0, max_x=4.0, min_y=-8.0,
            max_y=0.0)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    point_pillars=pp))
    return GlobalConfig.from_json(cfg.to_json())


def _spans(prof):
    """(name, start, end) of the program's spans, in order of start."""
    out = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.name().startswith(LAYERS)]
    return sorted(out, key=lambda s: s[1])


def _within(spans, outer):
    """The spans inside ``outer``, itself excluded."""
    _, s, e = outer
    return [x for x in spans if x is not outer and s <= x[1] and x[2] <= e]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _agent(tmp_path):
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    _config().save(os.path.join(model_dir, "config.json"))
    agent = HybridAgent(model_dir, device="cpu")
    agent.set_global_plan(*_plan())
    return agent


def test_span_off_is_one_gate_call_and_the_shared_no_op(monkeypatch):
    calls = []

    def enabled():
        calls.append(1)
        return False

    monkeypatch.setattr(tracing, "_profiler_enabled", enabled)
    a, b = tracing.span("agent.run_step"), tracing.span("train.step")
    assert a is b is tracing._OFF
    assert len(calls) == 2
    with a:
        with b:  # the shared no-op nests and is reused
            pass


def test_span_on_is_a_record_function():
    assert not torch._C._autograd._profiler_enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = tracing.span("model.fusion")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(4).sum()
    assert [x[0] for x in _spans(prof)] == ["model.fusion"]


def test_agent_frame_spans_nest_as_the_layers(tmp_path):
    """A compute frame: the agent's stages inside ``agent.run_step``, the
    model's inside ``model.forward_ego``, in the order they run. No
    ``kernels.*`` span on the CPU."""
    agent = _agent(tmp_path)
    frames = list(_frames(agent.config, 3))
    agent.run_step(frames[0], 0.0)
    agent.run_step(frames[1], 0.05)  # the next compute frame is frame 2
    _, spans = _profiled(lambda: [agent.run_step(f, 0.05 * i)
                                  for i, f in enumerate(frames[2:], 2)])
    roots = [s for s in spans if s[0] == "agent.run_step"]
    assert len(roots) == 1
    frame = roots[0]
    stages = [s for s in _within(spans, frame) if s[0].startswith("agent.")
              or s[0] == "model.forward_ego"]
    assert [s[0] for s in stages] == list(AGENT_STAGES)
    for a, b in zip(stages, stages[1:]):  # one after another
        assert a[2] <= b[1]
    (fwd,) = [s for s in stages if s[0] == "model.forward_ego"]
    inner = [s[0] for s in _within(spans, fwd)]
    assert inner == (["model.encoders"] * 2 + ["model.fusion",
                                               "model.encoders"] * 3
                     + ["model.fusion", "model.outputs", "model.outputs",
                        "model.decode"])
    assert not any(s[0].startswith("kernels.") for s in spans)
    assert all(s[0].startswith("model.") for s in _within(spans, fwd))


def test_action_repeat_frame_opens_tick_alone(tmp_path):
    agent = _agent(tmp_path)
    frames = list(_frames(agent.config, 2))
    agent.run_step(frames[0], 0.0)
    _, spans = _profiled(lambda: agent.run_step(frames[1], 0.05))
    assert [s[0] for s in spans] == ["agent.run_step", "agent.tick"]


@pytest.mark.parametrize("pillars", [False, True], ids=["histogram",
                                                        "pillars"])
def test_train_step_phases_inside_the_step(pillars):
    cfg = _config(pillars)
    trainer = Trainer(cfg, device="cpu")
    batch = trainer.put_batch(synthetic_batch(cfg, 2, seed=3, **SMALL))
    _, spans = _profiled(lambda: trainer.train_step(batch))
    (step,) = [s for s in spans if s[0] == "train.step"]
    phases = [s for s in _within(spans, step) if s[0].startswith("train.")]
    assert [s[0] for s in phases] == list(TRAIN_PHASES)
    for a, b in zip(phases, phases[1:]):
        assert a[2] <= b[1]
    forward = _within(spans, phases[0])
    want = {"model.encoders", "model.fusion", "model.outputs"}
    assert {s[0] for s in forward} == (
        want | {"model.pillars"} if pillars else want)
    # the model's spans all inside train.forward
    assert len(forward) == sum(s[0].startswith("model.") for s in spans)


def test_forward_ego_is_bit_identical_with_the_profiler_on():
    cfg = _config()
    model = LidarCenterNet(cfg, dtype=torch.float32, device="cpu", seed=4)
    b = {k: torch.from_numpy(v) for k, v in
         synthetic_batch(cfg, 1, seed=9, **SMALL).items()}
    args = (b["rgb"], b["lidar"], b["target_point"], b["target_point_image"],
            b["speed"])
    off = model.forward_ego(*args)
    on, spans = _profiled(lambda: model.forward_ego(*args))
    assert spans and spans[0][0] == "model.forward_ego"
    for x, y in zip(off, on):
        assert torch.equal(x, y)


@pytest.mark.parametrize("pillars", [False, True], ids=["histogram",
                                                        "pillars"])
def test_train_step_is_bit_identical_with_the_profiler_on(pillars):
    """Two trainers from one seed, two steps each on the same batches, one
    of them under the profiler: equal losses and equal parameters."""
    cfg = _config(pillars)
    results = []
    for traced in (False, True):
        trainer = Trainer(cfg, device="cpu", seed=1)
        steps = []
        for i in range(2):
            batch = trainer.put_batch(synthetic_batch(cfg, 2, seed=i,
                                                      **SMALL))
            if traced:
                steps.append(_profiled(lambda: trainer.train_step(batch))[0])
            else:
                steps.append(trainer.train_step(batch))
        results.append((steps, [p.detach().clone()
                                for p in trainer.model.parameters()]))
    (steps_off, params_off), (steps_on, params_on) = results
    for a, b in zip(steps_off, steps_on):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert all(torch.equal(a, b) for a, b in zip(params_off, params_on))
