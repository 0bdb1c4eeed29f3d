"""The program's spans and the card's work on one clock, on a card (the
test is marked ``cuda`` and skips without one; the file imports neither
JAX nor the JAX package):

    python -m pytest tests/test_torch_tracing_cuda.py -q -m cuda

A flagship compute frame of ``HybridAgent.run_step`` under
``tracing.profile_trace``: every kernel launched inside the frame's
``model.forward_ego`` span starts after that span starts and ends before
the frame's ``agent.readback`` span ends (the readback waits for them).
Kernels and launches are paired by the Chrome trace's ``correlation``
ids; the ``kernels.attention`` spans are there, one per GPT layer."""

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


@pytest.mark.cuda
def test_kernels_of_a_frame_lie_between_its_spans(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans are checked against "
                    "the card's kernels")
    cfg = GlobalConfig()
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    cfg.save(os.path.join(model_dir, "config.json"))
    agent = HybridAgent(model_dir, device="cuda")
    plan = [(float(x), 0.0) for x in range(0, 600, 10)]
    agent.set_global_plan(
        [({"lat": x / 111324.60662786, "lon": y / 111319.490945}, 4)
         for x, y in plan], plan)
    rng = np.random.default_rng(0)
    for i in range(4):  # warm-up: kernel builds, cuDNN's choices
        agent.run_step(_frame(cfg, i, rng), 0.05 * i)
    torch.cuda.synchronize()
    with tracing.profile_trace(str(tmp_path)):
        agent.run_step(_frame(cfg, 4, rng), 0.2)  # a compute frame
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]

    def one(name):
        (e,) = [e for e in events if e.get("name") == name
                and e.get("cat") == "user_annotation"]
        return e["ts"], e["ts"] + e["dur"]

    fwd0, fwd1 = one("model.forward_ego")
    _, read1 = one("agent.readback")
    attention = [e for e in events if e.get("name") == "kernels.attention"
                 and e.get("cat") == "user_annotation"]
    assert len(attention) == 4 * cfg.model.gpt.n_layer
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and fwd0 <= e["ts"] <= fwd1}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e["args"].get("correlation") in launched]
    assert len(kernels) > 1000
    assert min(k["ts"] for k in kernels) >= fwd0
    assert max(k["ts"] + k["dur"] for k in kernels) <= read1
    agent.destroy()
