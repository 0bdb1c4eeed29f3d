"""The program's spans and the card's work on one clock, on a card (the
test is marked ``cuda`` and skips without one; the file imports neither
JAX nor the JAX package):

    python -m pytest tests/test_torch_tracing_cuda.py -q -m cuda

A flagship compute frame of ``HybridAgent.run_step`` under
``tracing.profile_trace``: every kernel launched inside the frame's
``model.forward_ego`` span starts after that span starts and ends before
the frame's ``agent.readback`` span ends (the readback waits for them).
Kernels and launches are paired by the Chrome trace's ``correlation``
ids. The agent's members replay a CUDA graph from their second compute
frame on: the traced frame holds a ``model.replay`` span and the
attention kernels by name, where an eager frame (members not opted in)
holds a ``kernels.attention`` span per GPT layer."""

import json
import os

import numpy as np
import pytest
import torch

from transfuser_torch import tracing
from transfuser_torch.agents.hybrid_agent import HybridAgent
from transfuser_torch.config import GlobalConfig


def _frame(cfg, i, rng):
    s = cfg.sensors
    h, w = s.img_resolution[0], s.img_width
    pts = np.concatenate([rng.uniform(-30, 30, (40000, 2)),
                          rng.uniform(-2.5, 0, (40000, 1)),
                          rng.uniform(0, 1, (40000, 1))], axis=1)
    cams = {c: (i, rng.integers(0, 256, (h, w, 4), np.uint8))
            for c in ("rgb_front", "rgb_left", "rgb_right")}
    return dict(cams, gps=(i, np.array([0.4 * i / 111324.60662786, 0.0, 0.0])),
                speed=(i, {"speed": 3.0}),
                imu=(i, np.array([0, 0, 9.8, 0, 0, 0, 0.0])),
                lidar=(i, pts.astype(np.float32)))


ATTENTION_KERNELS = ("attention_tc_bf16", "attention_tc_f32", "attention_kt")


def _traced_frame(tmp_path, replay=True):
    """A flagship agent warmed up over 4 frames (2 compute frames: the
    first eager, the second captures the members' graphs), then compute
    frame 4 under the profiler; with ``replay`` False the members stay
    eager. Returns the trace's events and the config."""
    cfg = GlobalConfig()
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    cfg.save(os.path.join(model_dir, "config.json"))
    agent = HybridAgent(model_dir, device="cuda")
    if not replay:
        for m in agent.members:
            m.replay_forward_ego = lambda: None
    plan = [(float(x), 0.0) for x in range(0, 600, 10)]
    agent.set_global_plan(
        [({"lat": x / 111324.60662786, "lon": y / 111319.490945}, 4)
         for x, y in plan], plan)
    rng = np.random.default_rng(0)
    for i in range(4):  # warm-up: kernel builds, cuDNN's choices, capture
        agent.run_step(_frame(cfg, i, rng), 0.05 * i)
    torch.cuda.synchronize()
    with tracing.profile_trace(str(tmp_path)):
        agent.run_step(_frame(cfg, 4, rng), 0.2)  # a compute frame
    agent.destroy()
    trace = json.loads((tmp_path / "trace.json").read_text())
    return trace["traceEvents"], cfg


def _spans_and_kernels(events):
    """The frame's model.forward_ego and agent.readback spans, the program
    spans, and the kernels launched inside model.forward_ego (paired with
    their launches, a graph's replay among them, by ``correlation``)."""
    def one(name):
        (e,) = [e for e in events if e.get("name") == name
                and e.get("cat") == "user_annotation"]
        return e["ts"], e["ts"] + e["dur"]

    fwd0, fwd1 = one("model.forward_ego")
    _, read1 = one("agent.readback")
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and fwd0 <= e["ts"] <= fwd1}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e["args"].get("correlation") in launched]
    assert len(kernels) > 1000
    assert min(k["ts"] for k in kernels) >= fwd0
    assert max(k["ts"] + k["dur"] for k in kernels) <= read1
    return spans, kernels


@pytest.mark.cuda
def test_kernels_of_a_frame_lie_between_its_spans(tmp_path):
    """A replayed frame: one ``model.replay`` span inside
    ``model.forward_ego`` and no stage or kernel-wrapper span (the graph
    launches without Python); the attention kernels, found by name, are
    16 of the kernels launched inside ``model.forward_ego``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans are checked against "
                    "the card's kernels")
    events, cfg = _traced_frame(tmp_path)
    spans, kernels = _spans_and_kernels(events)
    names = [e["name"] for e in spans]
    assert names.count("model.forward_ego") == names.count(
        "model.replay") == 1
    assert not [n for n in names if n.startswith(
        ("kernels.", "model.encoders", "model.fusion", "model.outputs"))]
    attention = [k for k in kernels if any(p in k["name"]
                                           for p in ATTENTION_KERNELS)]
    assert len(attention) == 4 * cfg.model.gpt.n_layer


@pytest.mark.cuda
def test_an_eager_frame_opens_the_attention_wrapper_spans(tmp_path):
    """A frame of members that were not opted in: the ``kernels.attention``
    spans are there, one per GPT layer, and no ``model.replay``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans are checked against "
                    "the card's kernels")
    events, cfg = _traced_frame(tmp_path, replay=False)
    spans, _ = _spans_and_kernels(events)
    names = [e["name"] for e in spans]
    assert names.count("kernels.attention") == 4 * cfg.model.gpt.n_layer
    assert "model.replay" not in names
