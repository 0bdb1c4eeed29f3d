#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  env          the card (nvidia-smi), torch / CUDA versions, TF32 flags
  build        nvcc builds every kernel under transfuser_torch/csrc, one
               process per source, all started together (ptxas register
               and spill lines printed)
  launch_floor the device time of an empty kernel built the same way
  kernels      each kernel against its plain PyTorch version at the shapes
               the main path gives it, with the kernel's, the plain
               version's and (as a yardstick only) one PyTorch library
               call's median times (CUDA events, `ms`), the kernel's and
               the library call's device time (torch.profiler,
               `device_ms`, `library_device_ms`), the wrapper's host time
               per call (`host_ms`), the scatter-max's device launches per
               call, and the card's lower bound: attention
               in bf16 and fp32 (tolerances below), the pillar scatter-max
               exactly (max abs error 0) and its backward against a plain
               tie-splitting version (rtol 1e-6); and the attention wrapper
               refusing a CUDA input that needs a gradient
  forward_ego  the flagship config (regnety_032 both branches, 160x704
               RGB, 256x256 LiDAR) at seeded random init, batch 1, bf16:
               16 attention launches per forward, p50/p90 latency; the same
               weights in fp32 on the card and on the CPU (plain path)
  agent        HybridAgent from a model dir (config snapshot + .pth) drives
               synthetic sensor frames: finite controls, p50 run_step
  pillars_forward_ego
               the PointPillars config (the same trunks, a 40,000-point
               cloud with 20,000 valid) at seeded init, batch 1, bf16: 16
               attention + 1 scatter-max launches per forward, p50/p90;
               fp32 on the card vs fp32 on the CPU
  train        the PointPillars config with its default dropout, batch
               config.train.batch_size (12), bf16: 10 Trainer steps on one
               fixed synthetic batch (finite, falling loss_total; p50 step
               ms, samples/s, launches per step: scatter-max 1, attention
               0; peak memory), one eval step (16 attention launches), and
               a fp32 train-mode forward + loss dict (dropout 0, batch 2)
               on the card vs the same in fp64 on the CPU, rtol 1e-3 /
               atol 1e-4 (the CPU's fp32 error printed beside)

The main path's launches are counted in the agent, pillars_forward_ego
and train phases (counts set to 0 just before each, read just after).
Then a line with every kernel's numbers, the card's name and power limit,
and last {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile

adds two ``profile`` phases: torch.profiler over a few bf16 flagship
forwards (after forward_ego) and over a few pillar train steps (after the
timed steps, outside the launch count), giving device kernel time per
call (and attention's share of it), the device's idle share of the
wall time, kernels launched per call and the top kernels. Any failed
check raises: the script exits non-zero and prints no result. It needs a
CUDA card and the rest of the repository beside it.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

ATTN_MAIN_SHAPES = [(1, 174, 4, d) for d in (18, 54, 144, 378)]
ATTN_EXTRA_SHAPES = [(2, 174, 4, 18), (1, 200, 4, 40)]
PILLAR_POINTS, PILLAR_VALID = 40000, 20000
PILLAR_CELLS = 256 * 256  # per sample, + 1 sentinel
# (name, batch, points per sample, channels, segments per sample, kind)
SCATTER_CASES = [
    ("pillar_b1", 1, PILLAR_POINTS, 32, PILLAR_CELLS + 1, "pillar"),
    ("pillar_b12", 12, PILLAR_POINTS, 32, PILLAR_CELLS + 1, "pillar"),
    ("ragged", 1, 1000, 9, 1025, "uniform"),
    ("collisions", 1, PILLAR_POINTS, 32, 8, "ties"),
]
SCATTER_LINE_CASE = "pillar_b12"  # the train step's launch


def attention_tol(dtype, want: torch.Tensor) -> float:
    """fp32: only the summation order differs, 1e-5. bf16: the two fp32
    results may round to neighbouring bf16 values, one bf16 ulp (2^-7
    relative) at the output's largest magnitude."""
    if dtype == torch.float32:
        return 1e-5
    return float(want.float().abs().max()) * 2.0 ** -7


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    """Median over `rounds` of the mean per-call time of `reps` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_time(fn, reps: int = 50) -> tuple:
    """torch.profiler over `reps` warm calls: the device time of all the
    work they launched (kernels and memsets), per call, and the device
    activities per call. Host cost between launches is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise AssertionError("the profiler recorded no device work")
    return (sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps,
            len(events) / reps)


def host_ms(fn, reps: int = 200) -> float:
    """Host time per call: `reps` calls enqueued back to back, with no
    synchronisation inside the timed loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    per_call = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return per_call


def phase_launch_floor():
    """The device time of an empty kernel built by kernels.build: the floor
    under any launch, which a sub-microsecond bound cannot show."""
    import ctypes

    from transfuser_torch.ops import kernels

    fn = kernels.function("launch_floor", "tf_empty_kernel",
                          [ctypes.c_void_p])
    dev = torch.device("cuda", torch.cuda.current_device())

    def run():
        err = kernels.call(fn, dev)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")

    floor_ms, _ = device_time(run, reps=200)
    emit("launch_floor", launch_floor_ms=floor_ms, host_ms=host_ms(run))
    return floor_ms


def attention_bound_ms(shape, dtype) -> tuple:
    b, t, h, d = shape
    nbytes = 4 * b * t * h * d * torch.tensor([], dtype=dtype).element_size()
    flops = 4 * b * h * t * t * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scatter_inputs(batch, n, c, segments, kind, gen):
    """Flat (values, int32 ids) as the pillar path hands them to the
    kernel: per sample, ReLU features of the valid half in random cells,
    NEG_INF rows in the sentinel cell for the padded half; or uniform
    cells; or every point in a few cells with tied, negative values."""
    from transfuser_torch.ops.pillars import NEG_INF

    total = batch * n
    if kind == "ties":
        vals = torch.randint(-3, 4, (total, c), generator=gen,
                             device="cuda").float() / 2
    else:
        vals = torch.randn(total, c, generator=gen, device="cuda")
    ids = torch.randint(0, segments - (kind == "pillar"), (batch, n),
                        generator=gen, device="cuda", dtype=torch.int32)
    if kind == "pillar":
        vals = vals.relu()
        invalid = torch.arange(n, device="cuda") >= PILLAR_VALID
        ids[:, invalid] = segments - 1
        vals.view(batch, n, c)[:, invalid] = NEG_INF
    offset = torch.arange(batch, device="cuda", dtype=torch.int32) * segments
    return vals, (ids + offset[:, None]).reshape(-1), batch * segments


def scatter_bound_ms(batch, n, c, segments):
    nbytes = batch * n * (c + 1) * 4 + batch * segments * c * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def phase_scatter_max(gen):
    from transfuser_torch.ops import pillars

    def library(vals, ids, s):  # one PyTorch call + the same zero-fill
        out = vals.new_full((s, vals.shape[1]), pillars.NEG_INF)
        out.scatter_reduce_(0, ids.long()[:, None].expand_as(vals), vals,
                            "amax", include_self=True)
        return torch.where(out <= pillars.NEG_INF / 2, 0.0, out)

    rows = []
    for name, batch, n, c, seg, kind in SCATTER_CASES:
        vals, ids, s = scatter_inputs(batch, n, c, seg, kind, gen)
        got = pillars.segment_max(vals, ids, s)
        torch.cuda.synchronize()
        want = pillars.reference_segment_max(vals, ids, s)
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"scatter-max {name}: differs from the "
                                 f"plain version, max abs err {err}")
        kernel = lambda: pillars.segment_max(vals, ids, s)  # noqa: E731
        dev_ms, per_call = device_time(kernel)
        row = dict(case=name, batch=batch, points=n, channels=c,
                   segments=seg, max_abs_err=err,
                   ms=cuda_ms(kernel), device_ms=dev_ms,
                   cuda_launches_per_call=per_call, host_ms=host_ms(kernel),
                   plain_ms=cuda_ms(
                       lambda: pillars.reference_segment_max(vals, ids, s)),
                   library_ms=cuda_ms(lambda: library(vals, ids, s)),
                   library_device_ms=device_time(
                       lambda: library(vals, ids, s))[0],
                   bound_ms=scatter_bound_ms(batch, n, c, seg),
                   bound_by="bytes")
        if name in ("pillar_b12", "collisions"):
            # backward: the kernel path's tie-splitting VJP against
            # autograd through scatter_reduce (which also splits ties)
            cot = torch.randn(s, c, generator=gen, device="cuda")
            x = vals.clone().requires_grad_(True)
            (pillars.segment_max(x, ids, s) * cot).sum().backward()
            y = vals.clone().requires_grad_(True)
            (library(y, ids, s) * cot).sum().backward()
            scale = float(y.grad.abs().max())
            gerr = float((x.grad - y.grad).abs().max())
            if not gerr <= 1e-6 * scale:
                raise AssertionError(f"scatter-max {name} backward: max abs "
                                     f"err {gerr} > 1e-6 * {scale}")
            row["grad_max_abs_err"], row["grad_scale"] = gerr, scale
        rows.append(row)
    emit("kernels", kernels=["scatter_max"], scatter_max=rows)
    line = next(r for r in rows if r["case"] == SCATTER_LINE_CASE)
    return {k: line[k] for k in (
        "ms", "device_ms", "host_ms", "plain_ms", "library_ms",
        "library_device_ms", "bound_ms", "bound_by", "max_abs_err",
        "cuda_launches_per_call")}


def check_attention_refuses_grad(gen):
    from transfuser_torch.ops.attention import attention

    q = torch.randn(1, 174, 4, 18, generator=gen, device="cuda",
                    requires_grad=True)
    try:
        attention(q, q.detach(), q.detach())
    except RuntimeError as e:
        emit("attention_grad_check", refused=True, message=str(e)[:120])
        return
    raise AssertionError("the attention wrapper returned a CUDA output "
                         "with no backward for an input that needs a grad")


def phase_kernels():
    import torch.nn.functional as F

    from transfuser_torch.ops.attention import attention, reference_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for shape in ATTN_MAIN_SHAPES + ATTN_EXTRA_SHAPES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            got = attention(q, k, v)
            torch.cuda.synchronize()
            want = reference_attention(q, k, v)
            err = float((got.float() - want.float()).abs().max())
            tol = attention_tol(dtype, want)
            if not err <= tol:
                raise AssertionError(f"attention {shape} {dtype}: max abs "
                                     f"err {err} > {tol}")
            max_err = max(max_err, err)
            # both fp32 paths against fp64: shows each one's own error
            exact = reference_attention(q.double(), k.double(), v.double())
            err64 = float((got.double() - exact).abs().max())
            plain64 = float((want.double() - exact).abs().max())
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            bound, bound_by = attention_bound_ms(shape, dtype)
            kernel = lambda: attention(q, k, v)  # noqa: E731
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt)
            rows.append(dict(
                shape=list(shape), dtype=str(dtype).split(".")[-1],
                max_abs_err=err, tol=tol, max_abs_err_vs_fp64=err64,
                plain_max_abs_err_vs_fp64=plain64,
                ms=cuda_ms(kernel), device_ms=device_time(kernel)[0],
                host_ms=host_ms(kernel),
                plain_ms=cuda_ms(lambda: reference_attention(q, k, v)),
                library_ms=cuda_ms(library),
                library_device_ms=device_time(library)[0],
                bound_ms=bound, bound_by=bound_by,
                main_path=shape in ATTN_MAIN_SHAPES))
    emit("kernels", kernels=["attention"], attention=rows)
    # the kernel's line: the four shapes one forward_ego gives it (each
    # 4 times, once per GPT layer), bf16, one launch of each
    main = [r for r in rows if r["main_path"] and r["dtype"] == "bfloat16"]
    summary = {key: sum(r[key] for r in main)
               for key in ("ms", "device_ms", "host_ms", "plain_ms",
                           "library_ms", "library_device_ms", "bound_ms")}
    by_ops = sum(r["bound_by"] == "operations" for r in main)
    summary["bound_by"] = "operations" if 2 * by_ops > len(main) \
        else "bytes"
    summary["max_abs_err"] = max_err
    return summary


def flagship_inputs(cfg, seed=0):
    from transfuser_torch.data.decoders import rasterize_target_point

    rng = np.random.default_rng(seed)
    s = cfg.sensors
    h, w = s.img_resolution
    lh, lw = s.lidar_resolution_height, s.lidar_resolution_width
    tp = rng.uniform(-20, 20, (1, 2)).astype(np.float32)
    return dict(
        rgb=rng.integers(0, 256, (1, h, w, 3)).astype(np.float32),
        lidar=(rng.integers(0, 6, (1, lh, lw, 2)) / 5.0).astype(np.float32),
        tp=tp,
        tpi=rasterize_target_point(tp[0], size=lw)[None],
        vel=rng.uniform(0, 8, (1,)).astype(np.float32))


def phase_forward_ego(model, cfg):
    from transfuser_torch.ops import kernels

    x = flagship_inputs(cfg)
    args_on = lambda dev: [torch.from_numpy(x[k]).to(dev)  # noqa: E731
                           for k in ("rgb", "lidar", "tp", "tpi", "vel")]
    args = args_on("cuda")
    model.dtype = torch.bfloat16
    for _ in range(2):
        model.forward_ego(*args)
    torch.cuda.synchronize()
    n = 100  # p90 then has 10 samples beyond it
    kernels.reset_launches()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        wp_bf, boxes_bf, labels_bf = model.forward_ego(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    per_forward = kernels.launches["attention"] / n
    if per_forward != 16:
        raise AssertionError(f"{per_forward} attention launches per "
                             "forward_ego, expected 16")
    k = cfg.model.centernet.top_k_center_keypoints
    shapes = [tuple(t.shape) for t in (wp_bf, boxes_bf, labels_bf)]
    if shapes != [(1, cfg.model.pred_len, 2), (1, k, 8), (1, k)]:
        raise AssertionError(f"forward_ego output shapes {shapes}")
    if not (torch.isfinite(wp_bf).all() and torch.isfinite(boxes_bf).all()):
        raise AssertionError("forward_ego gave non-finite outputs")

    model.dtype = torch.float32
    wp32, boxes32, _ = model.forward_ego(*args)
    fp32_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.forward_ego(*args)
        torch.cuda.synchronize()
        fp32_ms.append((time.perf_counter() - t0) * 1e3)
    state = {k_: v.detach().cpu() for k_, v in model.state_dict().items()}

    from transfuser_torch.models import LidarCenterNet
    cpu_model = LidarCenterNet(cfg, dtype=torch.float32, device="cpu")
    cpu_model.load_state_dict(state, strict=True)
    t0 = time.perf_counter()
    wp_cpu, boxes_cpu, _ = cpu_model.forward_ego(*args_on("cpu"))
    cpu_s = time.perf_counter() - t0
    del cpu_model

    def top_scores(boxes, n_top=10):
        return boxes[0, :, 7].float().cpu().sort(descending=True)[0][:n_top]

    wp32_c, wp_bf_c = wp32.cpu(), wp_bf.float().cpu()
    scale = max(1.0, float(wp32_c.abs().max()))
    checks = {
        # fp32 card (CUDA kernel, cuDNN without TF32) vs fp32 CPU (plain
        # path): summation order only
        "wp_fp32_card_vs_cpu": (float((wp32_c - wp_cpu).abs().max()), 1e-3),
        "scores_fp32_card_vs_cpu": (float((top_scores(boxes32) -
                                           top_scores(boxes_cpu))
                                          .abs().max()), 1e-4),
        # bf16 vs fp32 on the card: bf16 rounding through ~70 layers;
        # waypoints within 5% of their scale, top-10 scores within 0.02
        "wp_bf16_vs_fp32": (float((wp_bf_c - wp32_c).abs().max()),
                            0.05 * scale),
        "scores_bf16_vs_fp32": (float((top_scores(boxes_bf) -
                                       top_scores(boxes32)).abs().max()),
                                0.02),
    }
    emit("forward_ego", launches_per_forward=per_forward, forwards=n,
         bf16_p50_ms=float(np.percentile(times, 50)),
         bf16_p90_ms=float(np.percentile(times, 90)),
         fp32_median_ms=statistics.median(fp32_ms), cpu_fp32_s=cpu_s,
         pred_wp_bf16=wp_bf_c[0].tolist(), pred_wp_fp32=wp32_c[0].tolist(),
         checks={k_: {"err": e, "tol": t} for k_, (e, t) in checks.items()})
    for name, (err, tol) in checks.items():
        if not err <= tol:
            raise AssertionError(f"forward_ego {name}: {err} > {tol}")
    return state


def profile_calls(fn, n):
    """torch.profiler over n calls of fn: device kernel time per call, the
    device's idle share of the wall time, kernels per call, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    device_ms = sum(t for t, _ in by_name.values()) / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    attn = [(t, c) for k, (t, c) in by_name.items() if "attention" in k]
    return dict(calls=n, wall_ms_per_call=wall_ms,
                device_kernel_ms_per_call=device_ms,
                attention_device_ms_per_call=sum(t for t, _ in attn) / n,
                attention_launches_per_call=sum(c for _, c in attn) / n,
                device_idle_share=1.0 - device_ms / wall_ms,
                kernels_per_call=sum(c for _, c in by_name.values()) / n,
                top_kernels=[{"name": k[:90], "ms_per_call": t / n,
                              "calls_per_call": c / n}
                             for k, (t, c) in top])


def phase_profile(model, cfg, n=5):
    x = flagship_inputs(cfg)
    args = [torch.from_numpy(x[k]).to("cuda")
            for k in ("rgb", "lidar", "tp", "tpi", "vel")]
    model.dtype = torch.bfloat16
    emit("profile", what="flagship forward_ego, bf16, batch 1",
         **profile_calls(lambda: model.forward_ego(*args), n))


def synthetic_sensor_frames(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    h, w = cfg.sensors.img_resolution[0], cfg.sensors.img_width
    for i in range(n):
        pts = np.concatenate([
            rng.uniform(-30, 30, (40000, 2)), rng.uniform(-4, 1, (40000, 1)),
            rng.uniform(0, 1, (40000, 1))], axis=1).astype(np.float32)
        x = 0.5 * i
        yield {
            "rgb_front": (i, rng.integers(0, 256, (h, w, 4), np.uint8)),
            "rgb_left": (i, rng.integers(0, 256, (h, w, 4), np.uint8)),
            "rgb_right": (i, rng.integers(0, 256, (h, w, 4), np.uint8)),
            "gps": (i, np.array([x / 111324.60662786, 0.0, 0.0])),
            "speed": (i, {"speed": 3.0}),
            "imu": (i, np.array([0, 0, 9.8, 0, 0, 0, 0.0])),
            "lidar": (i, pts),
        }


def phase_agent(cfg, state):
    from transfuser_torch.agents.hybrid_agent import HybridAgent
    from transfuser_torch.ops import kernels

    with tempfile.TemporaryDirectory() as model_dir:
        cfg.save(os.path.join(model_dir, "config.json"))
        torch.save(state, os.path.join(model_dir, "model_0.pth"))
        t0 = time.perf_counter()
        agent = HybridAgent(model_dir)
        setup_s = time.perf_counter() - t0
    plan = [({"lat": x / 111324.60662786, "lon": 0.0}, 4)
            for x in range(0, 200, 10)]
    agent.set_global_plan(plan, [(float(x), 0.0) for x in range(0, 200, 10)])
    frames = list(synthetic_sensor_frames(cfg, 42))  # 20 compute frames
    for i, frame in enumerate(frames[:2]):  # warm-up compute frame
        agent.run_step(frame, 0.05 * i)
    torch.cuda.synchronize()
    kernels.reset_launches()           # the main path's run starts here
    compute_ms, controls = [], []
    for i, frame in enumerate(frames[2:], start=2):
        compute = agent.step + 1
        t0 = time.perf_counter()
        control = agent.run_step(frame, 0.05 * i)
        wall = (time.perf_counter() - t0) * 1e3
        if compute % cfg.controller.action_repeat == 0:
            compute_ms.append(wall)
        controls.append([control.steer, control.throttle, control.brake])
    launches = dict(kernels.launches)  # ... and ends here
    if not np.isfinite(controls).all():
        raise AssertionError(f"non-finite controls {controls}")
    expected = 16 * len(compute_ms) * agent.model_count
    if launches["attention"] != expected:
        raise AssertionError(f"agent made {launches['attention']} attention "
                             f"launches, expected {expected}")
    emit("agent", setup_s=setup_s, compute_frames=len(compute_ms),
         run_step_p50_ms=float(np.percentile(compute_ms, 50)),
         run_step_ms=compute_ms, launches=launches,
         # random weights predict near-zero waypoints: the agent brakes,
         # so steer and throttle are not exercised here
         non_brake_frames=sum(c[2] < 0.5 for c in controls),
         last_control=controls[-1], pred_wp=agent.pred_wp.tolist())
    return launches


def pillar_config(**gpt):
    import dataclasses

    from transfuser_torch.config import GlobalConfig

    cfg = GlobalConfig()
    pp = dataclasses.replace(cfg.model.point_pillars, use_point_pillars=True)
    model = dataclasses.replace(
        cfg.model, point_pillars=pp,
        gpt=dataclasses.replace(cfg.model.gpt, **gpt))
    return cfg.replace(model=model)


def pillar_inputs(cfg, seed=2):
    """A 40,000-point cloud in the pillar grid, the first 20,000 valid."""
    rng = np.random.default_rng(seed)
    pp = cfg.model.point_pillars
    x = flagship_inputs(cfg, seed)
    pts = np.stack([rng.uniform(pp.min_x, pp.max_x, PILLAR_POINTS),
                    rng.uniform(pp.min_y, pp.max_y, PILLAR_POINTS),
                    rng.uniform(-3, 1, PILLAR_POINTS),
                    rng.uniform(0, 1, PILLAR_POINTS)], -1)
    x["lidar"] = pts[None].astype(np.float32)
    x["num_points"] = np.array([PILLAR_VALID], np.int32)
    return x


def phase_pillars_forward_ego(cfg):
    from transfuser_torch.models import LidarCenterNet
    from transfuser_torch.ops import kernels

    x = pillar_inputs(cfg)
    keys = ("rgb", "lidar", "tp", "tpi", "vel")
    args_on = lambda dev: [torch.from_numpy(x[k]).to(dev)  # noqa: E731
                           for k in keys]
    args, num = args_on("cuda"), torch.from_numpy(x["num_points"]).to("cuda")
    model = LidarCenterNet(cfg, dtype=torch.bfloat16, device="cuda", seed=1)
    for _ in range(2):
        model.forward_ego(*args, num_points=num)
    torch.cuda.synchronize()
    n = 100
    kernels.reset_launches()           # the main path's run starts here
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        wp_bf, boxes_bf, _ = model.forward_ego(*args, num_points=num)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launches)  # ... and ends here
    per_forward = {k: v / n for k, v in launches.items()}
    if per_forward != {"attention": 16, "scatter_max": 1}:
        raise AssertionError(f"pillar forward_ego launches per forward "
                             f"{per_forward}, expected 16 attention and 1 "
                             "scatter_max")
    if not (torch.isfinite(wp_bf).all() and torch.isfinite(boxes_bf).all()):
        raise AssertionError("pillar forward_ego gave non-finite outputs")

    model.dtype = torch.float32
    wp32, boxes32, _ = model.forward_ego(*args, num_points=num)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    cpu_model = LidarCenterNet(cfg, dtype=torch.float32, device="cpu")
    cpu_model.load_state_dict(state, strict=True)
    t0 = time.perf_counter()
    wp_cpu, boxes_cpu, _ = cpu_model.forward_ego(
        *args_on("cpu"), num_points=torch.from_numpy(x["num_points"]))
    cpu_s = time.perf_counter() - t0
    del cpu_model

    def top_scores(boxes, n_top=10):
        return boxes[0, :, 7].float().cpu().sort(descending=True)[0][:n_top]

    checks = {
        "wp_fp32_card_vs_cpu": (float((wp32.cpu() - wp_cpu).abs().max()),
                                1e-3),
        "scores_fp32_card_vs_cpu": (float((top_scores(boxes32) -
                                           top_scores(boxes_cpu))
                                          .abs().max()), 1e-4),
    }
    emit("pillars_forward_ego", launches_per_forward=per_forward,
         forwards=n, bf16_p50_ms=float(np.percentile(times, 50)),
         bf16_p90_ms=float(np.percentile(times, 90)), cpu_fp32_s=cpu_s,
         pred_wp_bf16=wp_bf.float().cpu()[0].tolist(),
         checks={k: {"err": e, "tol": t} for k, (e, t) in checks.items()})
    for name, (err, tol) in checks.items():
        if not err <= tol:
            raise AssertionError(f"pillars_forward_ego {name}: {err} > {tol}")
    return launches


def phase_train(cfg, steps=10, profile=False):
    from transfuser_torch.data.synthetic import synthetic_batch
    from transfuser_torch.models import LidarCenterNet
    from transfuser_torch.ops import kernels
    from transfuser_torch.train.losses import compute_losses
    from transfuser_torch.train.trainer import Trainer, _model_inputs

    bsz = cfg.train.batch_size
    host = synthetic_batch(cfg, bsz, seed=0)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    batch = trainer.put_batch(host)
    torch.cuda.synchronize()
    kernels.reset_launches()           # the main path's run starts here
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics)
    launches = dict(kernels.launches)  # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [{k: float(v) for k, v in m.items()} for m in losses]
    totals = [m["loss_total"] for m in losses]
    per_step = {k: v / steps for k, v in launches.items()}
    if per_step != {"attention": 0, "scatter_max": 1}:
        raise AssertionError(f"train launches per step {per_step}, expected "
                             "0 attention (dropout takes explicit probs) "
                             "and 1 scatter_max")
    if not all(np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"non-finite train losses {losses}")
    if not totals[-1] < totals[0]:
        raise AssertionError(f"loss_total did not fall: {totals}")
    if profile:
        emit("profile", what=f"pillar train step, bf16, batch {bsz}",
             **profile_calls(lambda: trainer.train_step(batch), 3))

    kernels.reset_launches()
    ev = trainer.eval_step(batch)
    torch.cuda.synchronize()
    eval_launches = dict(kernels.launches)
    if eval_launches != {"attention": 16, "scatter_max": 1}:
        raise AssertionError(f"eval step launches {eval_launches}")
    for k, v in eval_launches.items():
        launches[k] += v

    # fp32 train-mode forward + loss dict, dropout 0, batch 2: the card
    # against the CPU in fp64. The CPU's fp32 batch_norm in training takes
    # a one-pass variance on channels-last tensors and is the less
    # accurate side of the pair, so the exact reference is fp64; its fp32
    # error is printed beside.
    cfg0 = pillar_config(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
    state = {k: v.detach().cpu() for k, v in
             trainer.model.state_dict().items()}
    del trainer, batch
    torch.cuda.empty_cache()
    small = {k: torch.from_numpy(v[:2]) for k, v in host.items()}
    results = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64),
                       ("cpu", torch.float32)):
        model = LidarCenterNet(cfg0, dtype=dtype, device="cpu")
        model.load_state_dict(state, strict=True)
        model = model.to(dev, dtype)
        model.train()
        b = {k: v.to(dev) for k, v in small.items()}
        with torch.no_grad():
            args, extra = _model_inputs(b)
            out = model(*args, **extra, compute_aux=True)
            res = compute_losses(out, b, cfg0)
            res["pred_wp"] = out["pred_wp"]
        results[(dev, dtype)] = {k: v.double().cpu() for k, v in res.items()}
        del model
    exact = results[("cpu", torch.float64)]
    card = results[("cuda", torch.float32)]
    cpu32 = results[("cpu", torch.float32)]
    worst, cpu32_err = {}, {}
    for k, want in exact.items():
        got = card[k]
        worst[k] = float((got - want).abs().max())
        cpu32_err[k] = float((cpu32[k] - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"train-mode {k}: card fp32 vs CPU fp64 "
                                 f"beyond rtol 1e-3 / atol 1e-4 (max abs "
                                 f"err {worst[k]})")
    p50 = float(np.percentile(times[1:], 50))
    emit("train", batch=bsz, steps=steps, step_ms=times, p50_step_ms=p50,
         samples_per_s=bsz / p50 * 1e3, launches_per_step=per_step,
         eval_launches=eval_launches, peak_memory_gb=peak_gb,
         loss_total=totals, last_losses=losses[-1],
         eval={k: float(v) for k, v in ev.items()},
         fp32_card_vs_cpu_fp64_max_abs_err=worst,
         fp32_cpu_vs_cpu_fp64_max_abs_err=cpu32_err)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from transfuser_torch.config import GlobalConfig
    from transfuser_torch.models import LidarCenterNet
    from transfuser_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power()
    emit("env", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         ninja=shutil.which("ninja") is not None,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    built = kernels.build()
    emit("build", seconds=time.perf_counter() - t0,
         per_kernel={k: v["seconds"] for k, v in built.items()},
         ptxas=[line.strip() for v in built.values()
                for line in v["log"].splitlines()
                if "Compiling entry" in line or "Used" in line or
                "spill" in line])

    floor_ms = phase_launch_floor()
    numbers = {"attention": phase_kernels()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    numbers["scatter_max"] = phase_scatter_max(gen)
    check_attention_refuses_grad(gen)

    cfg = GlobalConfig()
    model = LidarCenterNet(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    state = phase_forward_ego(model, cfg)
    profile = "--profile" in sys.argv[1:]
    if profile:
        phase_profile(model, cfg)
    del model
    torch.cuda.empty_cache()
    launches = dict.fromkeys(kernels.KERNELS, 0)
    for phase in (lambda: phase_agent(cfg, state),
                  lambda: phase_pillars_forward_ego(pillar_config()),
                  lambda: phase_train(pillar_config(), profile=profile)):
        for name, count in phase().items():
            launches[name] += count
        torch.cuda.empty_cache()

    line = []
    for name, meta in kernels.KERNELS.items():
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} never ran on the main path")
        line.append(dict(name=name, route=meta["route"],
                         source=meta["source"], replaces=meta["replaces"],
                         launches=launches[name], **numbers[name],
                         launch_floor_ms=floor_ms))
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
