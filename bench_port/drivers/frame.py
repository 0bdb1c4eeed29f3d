"""Frame cells: the port's ``HybridAgent.run_step`` in a closed loop, as
CARLA's synchronous mode drives it (the next frame is sent when the
control comes back). Action-repeat frames run but are not compute frames.

Set-up: the agent from the configuration (a model directory in
``TMPDIR`` that holds only its ``config.json``), each member's weights
made on the card from the seed, the route, the pool of sensor frames,
``warmup_frames`` frames. The window: frames until ``--seconds`` have
passed, each compute frame's ``run_step`` timed by the host clock. A
wrapper on each member's ``forward_ego`` (set on the instance from here)
times the model's dispatch and keeps the inputs and outputs of a seeded
sample of compute frames.

``compare``, once the window has closed and the program is freed: the
replay of the agent's host loop (``reference/agent.py``) over every frame
of the run, fed the controls the agent applied, recomputes the sampled
frames' model inputs from the raw sensor frames and every compute frame's
control from the agent's waypoints; the reference model recomputes the
sampled frames' waypoints and top box score in fp32 from its own inputs.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import generate, harness, trace
from ..reference import agent as ref_agent
from ..weights import seeded_state_dict


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Sample:
    """A seeded reservoir of ``k`` compute frames of the window."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed), 7])
        self.seen = 0

    def offer(self) -> Optional[int]:
        """The slot the next compute frame takes, or None."""
        n = self.seen
        self.seen += 1
        if n < self.k:
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.k else None


def _percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q))


@dataclass
class Outcome:
    """What the window left for ``compare``: the frames run, the controls
    the agent applied, its waypoints and fused boxes, and each sampled
    frame's model inputs and outputs (on the host)."""
    cfg: object
    frames: object
    plan: list
    n_frames: int
    controls: List[tuple]
    pred_wps: List[np.ndarray]
    port: Dict[int, Dict]
    fused: Dict[int, list]


def run(r: harness.Run) -> Outcome:
    """Set up, warm up, time the window, keep what ``compare`` needs; the
    agent is freed on return."""
    from transfuser_torch.agents.hybrid_agent import HybridAgent
    from transfuser_torch.config import GlobalConfig

    device, ref = r.device, r.ref
    mix = r.mix
    cfg = ref.namespace(r.config["config"])
    r.cfg = cfg
    port_cfg = GlobalConfig.from_json(json.dumps(r.config["config"]))
    members = int(mix["members"])
    with tempfile.TemporaryDirectory() as model_dir:
        port_cfg.save(os.path.join(model_dir, "config.json"))
        agent = HybridAgent(model_dir, device=str(device))
    while len(agent.members) < members:
        agent.members.append(type(agent.members[0])(
            port_cfg, dtype=torch.bfloat16, device=device))
    agent.model_count = members
    for i, m in enumerate(agent.members):
        sd = seeded_state_dict(ref, cfg, harness.member_seed(r.seed, i),
                               device)
        m.load_state_dict(sd)
        del sd
    plan = generate.route_plan(mix)
    agent.set_global_plan(plan, [(0.0, 0.0)] * len(plan))
    frames = generate.SensorFrames(cfg, mix, r.seed)
    repeat = cfg.controller.action_repeat

    span = {"s": 0.0, "capture": None}
    kept: Dict[int, Dict] = {}

    def wrap(member, idx):
        forward_ego = member.forward_ego

        def timed(*args):
            t0 = time.perf_counter()
            wp, boxes, labels = forward_ego(*args)
            span["s"] += time.perf_counter() - t0
            slot = span["capture"]
            if slot is not None:
                rgb, lidar, tp, tpi, speed = args[:5]
                kept.setdefault(slot, {})[idx] = dict(
                    rgb=rgb, lidar=lidar, tp=tp.clone(), tpi=tpi,
                    speed=speed.clone(), wp=wp, boxes=boxes)
            return wp, boxes, labels

        member.forward_ego = timed

    for i, m in enumerate(agent.members):
        wrap(m, i)

    controls: List[tuple] = []
    pred_wps: List[np.ndarray] = []
    fused: Dict[int, list] = {}
    slot_frame: Dict[int, int] = {}

    def step(i: int) -> float:
        t0 = time.perf_counter()
        c = agent.run_step(frames(i), 0.05 * i)
        dt = time.perf_counter() - t0
        controls.append((c.steer, c.throttle, c.brake))
        if i % repeat == 0:
            pred_wps.append(np.array(agent.pred_wp, copy=True))
        return dt

    i = 0
    for _ in range(int(mix["warmup_frames"])):
        step(i)
        i += 1
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    sample = _Sample(int(mix["sample_compute_frames"]), r.seed)
    frame_s: List[float] = []
    model_s: List[float] = []

    def timed_frames(deadline: float, limit: int = 1 << 30) -> int:
        nonlocal i
        n = 0
        while n < limit and time.perf_counter() < deadline:
            compute = i % repeat == 0
            slot = sample.offer() if compute else None
            span["capture"], span["s"] = slot, 0.0
            if slot is not None:
                kept.pop(slot, None)
                slot_frame[slot] = i
            dt = step(i)
            if compute:
                frame_s.append(dt)
                model_s.append(span["s"])
                if slot is not None:
                    fused[i] = [np.array(b) for b in agent.bb_buffer[-1]]
                n += 1
            i += 1
        span["capture"] = None
        return n

    r.setup_s = time.perf_counter() - r.t_start
    if r.trace:  # the traced frames first, then the timed window
        with trace.traced(lambda: _sync(device)) as got:
            traced = timed_frames(float("inf"),
                                  int(mix["trace_compute_frames"]))
        r.traced = got["trace"]
        r.traced.units = traced
        harness.log(f"traced {traced} compute frames, "
                    f"{r.traced.kernel_count()} kernels; reduced in "
                    f"{got['reduce_s']:.2f} s")
        frame_s, model_s = [], []
    with harness.host_load(r):
        t_window = time.perf_counter()
        if not timed_frames(t_window + r.seconds):
            raise RuntimeError("the window held no compute frame")
        _sync(device)
        r.window_s = time.perf_counter() - t_window
    r.units = len(frame_s)
    r.attempted = len(frame_s)
    ms = [1e3 * s for s in frame_s]
    r.e2e = {"frame_ms_p50": statistics.median(ms),
             "frame_ms_p95": _percentile(ms, 95)}
    r.host = {"run_step_s": float(np.sum(frame_s)),
              "forward_ego_s": float(np.sum(model_s))}
    from ..flops import forward_flops
    r.flops_per_unit = forward_flops(ref, cfg) * members
    if device.type == "cuda":
        r.memory_peak = torch.cuda.max_memory_allocated(device)
    harness.log(f"{r.units} compute frames in {r.window_s:.2f} s, p50 "
                f"{r.e2e['frame_ms_p50']:.2f} ms, p95 "
                f"{r.e2e['frame_ms_p95']:.2f} ms; at most "
                f"{max(map(len, fused.values()), default=0)} fused boxes "
                "in a sampled frame")

    # ---- the program's outputs to the host, the program freed
    n_frames = i
    port = {}
    for slot, per_member in kept.items():
        port[slot_frame[slot]] = {
            idx: {k: v.detach().to("cpu", torch.float32).numpy()
                  for k, v in rec.items()} for idx, rec in per_member.items()}
    kept.clear()
    agent.destroy()
    del agent
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Outcome(cfg, frames, plan, n_frames, controls, pred_wps, port,
                   fused)


def compare(r: harness.Run, out: Outcome, control: bool = False
            ) -> Dict[str, float]:
    """The numbers: the program's inputs, controls and fused boxes against
    the replay's, its waypoints and top box scores against the reference
    model's; or with ``control`` the reference model's in fp8 (put in the
    program's place) against its own in fp32."""
    device, ref = r.device, r.ref
    cfg, frames, port = out.cfg, out.frames, out.port
    controls, pred_wps, fused = out.controls, out.pred_wps, out.fused
    n_frames = out.n_frames
    members = int(r.mix["members"])
    replay = ref_agent.Replay(cfg, out.plan)
    inputs: Dict[int, Dict] = {}
    post_gap = 0.0
    held = (0.0, 0.0, 1.0)  # a fresh agent's control: full brake
    k = 0
    for i in range(n_frames):
        speed, compass, res = replay.frame(i, frames(i), i in port)
        if res is None:
            want = held
        else:
            inp, pid = res
            want = pid(pred_wps[k])
            held = want
            k += 1
            if inp is not None:
                inputs[i] = inp
        got = controls[i]
        post_gap = max(post_gap, max(abs(a - b) for a, b in zip(got, want)))
        replay.roll(got, compass, speed)
    # the ensemble's fused boxes, from the members' own boxes
    for i, recs in port.items():
        boxes = [ref_agent.metric_boxes(recs[m]["boxes"][0], cfg)
                 for m in range(members)]
        want = ref_agent.nms(boxes, cfg.controller.iou_threshold_nms)
        got = fused[i]
        if len(want) != len(got):
            post_gap = float("inf")
        for a, b in zip(got, want):
            post_gap = max(post_gap, float(np.abs(a - b).max()))

    inputs_gap = 0.0
    pairs = {"rgb": "rgb", "lidar": "lidar", "tpi": "target_point_image",
             "tp": "target_point", "speed": "speed"}
    for i, recs in port.items():
        for m in range(members):
            for pk, rk in pairs.items():
                a = recs[m][pk].reshape(-1)
                b = np.asarray(inputs[i][rk], np.float32).reshape(-1)
                inputs_gap = max(inputs_gap, float(np.abs(a - b).max()))

    order = sorted(port)
    outs = {}
    modes = ["fp32"] + (["fp8"] if control else [])
    with ref.plain_fp32():
        model = ref.build(cfg, device)
        for m in range(members):
            model.load_state_dict(seeded_state_dict(
                ref, cfg, harness.member_seed(r.seed, m), device))
            for mode in modes:
                outs[(m, mode)] = _reference_outputs(ref, model, order,
                                                     inputs, device, mode)
        del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    wp_gap = score_gap = 0.0
    for m in range(members):
        wp_ref, sc_ref = outs[(m, "fp32")]
        if control:
            wp_got, sc_got = outs[(m, "fp8")]
        else:
            wp_got = np.stack([port[i][m]["wp"][0] for i in order])
            sc_got = np.stack([port[i][m]["boxes"][0, :, 7].max()
                               for i in order])
        wp_gap = max(wp_gap, float(np.abs(wp_got - wp_ref).max()))
        score_gap = max(score_gap, float(np.abs(sc_got - sc_ref).max()))
    if control:
        return {"wp_gap_m": wp_gap, "score_gap": score_gap}
    return {"inputs_gap": inputs_gap, "wp_gap_m": wp_gap,
            "score_gap": score_gap, "post_gap": post_gap}


def _reference_outputs(ref, model, order, inputs, device, mode,
                       block=16):
    """Waypoints (n, pred_len, 2) and the top box score (n,) of the
    sampled frames, in blocks of rows. The top score is the heatmap's
    maximum, a continuous function of the head's output; which peaks make
    up the rest of the top k flips with rounding (bf16 makes neighbours
    tie) and is not compared."""
    wps, scores = [], []
    with ref.lowp(mode):
        for a in range(0, len(order), block):
            rows = [inputs[i] for i in order[a:a + block]]

            def stack(key, rows=rows):
                return torch.from_numpy(np.stack(
                    [np.asarray(x[key], np.float32) for x in rows])).to(device)

            wp, boxes = model.forward_ego(
                stack("rgb"), stack("lidar"), stack("target_point"),
                stack("target_point_image"), stack("speed"))
            wps.append(wp.cpu().numpy())
            scores.append(boxes[:, :, 7].amax(dim=1).cpu().numpy())
    return np.concatenate(wps), np.concatenate(scores)
