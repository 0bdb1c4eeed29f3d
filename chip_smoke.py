#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  env          the card (nvidia-smi), torch / CUDA versions, TF32 flags
  build        nvcc builds every kernel under transfuser_torch/csrc, one
               process per source, all started together (ptxas register
               and spill lines printed)
  native       g++ builds the port's native host library
               (transfuser_torch/native/fastloader.cpp); each entry point
               against its numpy version exactly (the LiDAR histogram on a
               40,000-point cloud, with 4 columns and as the agent's
               3-column view; the depth, semantic, BEV and crop decodes at
               160x960; the PNG unfilter on a 160x960 strip with adaptive
               row filters); the histogram timed against numpy and the PNG
               decode against the Python unfilter loop, in turns
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
               refusing a CUDA input that needs a gradient; then fp32
               attention at the shapes and layouts its tiling must mask
               (D = 1, 3, 17, 512; T = 1, 17, 1024; batch 3; inputs one
               float into a buffer; a permuted view), with each row's and
               the plain version's error against fp64, and the attention
               device time of one flagship forward per dtype (4 x the
               main-path rows) beside SDPA's; then, in both dtypes, the
               shapes of RegNetY-032 at 8, 2 and 1 heads ((1,174,8,D), D =
               9/27/72/189; (1,174,2,D), D = 36/108/288/756; (1,174,1,D),
               D = 72/216/576/1512) and of the token grids of anchors
               10x44 and 20x88 with 16x16 ((1,696,4,D), (1,2016,4,D), D =
               18/54/144/378), and q/k/v with a D stride of 2. Each row
               names the kernel the dispatch rule picks (`route`); where
               both kernels take the shape, the other one is checked and
               timed beside it (`key_tiled_*` or `resident_*`)
  adamw        the AdamW kernel (csrc/adamw.cu) at the flagship's
               parameter lists (924 fp32 tensors, 168,018,327 elements,
               weight decay 0.01) against the 16 plain _foreach passes,
               bit for bit on p, mu and nu; its `ms` (eager calls, which
               the host's checks and argument arrays bound), `graph_ms`
               (a captured graph's replays), `device_ms` and launches per
               call, `host_ms`, the plain passes' `plain_ms` and
               `plain_device_ms`,
               torch._fused_adamw_ as the yardstick (`library_ms`,
               `library_device_ms`; another update, timed only), and
               `bound_ms`: 28 bytes an element at the card's bandwidth
  forward_ego  the flagship config (regnety_032 both branches, 160x704
               RGB, 256x256 LiDAR) at seeded random init, batch 1, bf16:
               16 attention launches per forward, p50/p90 latency; the same
               weights in fp32 on the card and on the CPU (plain path)
  agent        HybridAgent from a model dir (config snapshot + .pth) drives
               42 synthetic sensor frames (speed 0, so the model inputs do
               not depend on the controls) in each timing mode, a fresh
               agent from the same weights per run, in turns: synchronous,
               pipelined_fetch, async_inference, then back. Finite
               controls, p50 / p90 run_step per mode (pooled and per run),
               16 attention launches per dispatched forward; each lagged
               run's priming frame returns the held control, the lagged
               runs' controls are equal, the lagged waypoints at compute
               frame k equal the synchronous run's at k - 1 and the two
               synchronous runs agree, bit for bit
  closed_loop  the port's evaluator (transfuser_torch.harness) drives the
               agent (one flagship member from a config snapshot + .pth,
               bf16) in process over a map-less 60 m route for 10 s of
               sim time (200 ticks, 100 compute frames), with the
               reference's timing and with async_inference in turns (sync,
               async, async, sync), one line per run: route
               status (any crashed status fails), driving score, route
               completion, ticks, compute frames, run_step p50/p90 per
               compute frame, and per tick the harness's own time, the
               camera render, the LiDAR synthesis and the criteria; at
               least 16 attention launches per compute frame and member
  family_forward_ego
               the other backbone families and trunks at full width
               (160x704 RGB, 256x256 LiDAR, seeded init, batch 1, bf16):
               latentTF, late_fusion and geometric_fusion on regnety_032,
               transFuser on resnet34 / resnet18 and on convnext_base;
               geometric's correspondences from a synthetic 30,000-point
               cloud through the port's lidar_cam_correspondences. Each:
               p50/p90 over 50 forwards, attention launches per forward
               (16 / 0 / 0 / 16 / 16), peak memory, fp32 on the card vs
               fp32 on the CPU
  config_forward_ego
               the flagship GlobalConfig() at full width (seeded init,
               batch 1) with (a) n_head=8 and a 256x1024 image (odd D,
               image pools that do not divide), (b) n_head=2 (D up to
               756), (c) image anchors 20x88 and LiDAR anchors 16x16 (T =
               2016, upsampling pools, antialiased downsampling resizes):
               bf16 p50/p90 over 20 forwards, 16 attention launches per
               forward, the attention kernels' device time per forward
               (torch.profiler over 3 more), peak memory; fp32 on the
               card vs fp32 on the CPU
               (1e-3 m / 1e-4) and bf16 vs fp32 waypoints within 5% of
               their scale
  family_agent HybridAgent for latentTF (frames without a LiDAR entry)
               and geometric_fusion (the reference grid view turned on by
               its .pth), each from a model dir with a config snapshot and
               a .pth: 20 compute frames, finite controls, p50 run_step,
               geometric's host ms per frame of lidar_cam_correspondences
  geometric_train
               3 bf16 Trainer steps of geometric_fusion at batch 12 on a
               synthetic batch: finite loss_total, step ms, no kernel
               launches (the family has no attention)
  pillars_forward_ego
               the PointPillars config (the same trunks, a 40,000-point
               cloud with 20,000 valid) at seeded init, batch 1, bf16: 16
               attention + 1 scatter-max launches per forward, p50/p90;
               fp32 on the card vs fp32 on the CPU
  train        the PointPillars config with its default dropout, batch
               config.train.batch_size (12), bf16: 10 Trainer steps on one
               fixed synthetic batch (finite, falling loss_total; p50 step
               ms, samples/s, launches per step: scatter-max 1, attention
               0, the AdamW kernel's launches over the trainer's
               parameters; peak memory), one eval step (16 attention
               launches, no AdamW launch), and
               a fp32 train-mode forward + loss dict (dropout 0, batch 2)
               on the card vs the same in fp64 on the CPU, rtol 1e-3 /
               atol 1e-4 (the CPU's fp32 error printed beside)
  cli          the training CLI (transfuser_torch.train.cli) on a
               CARLA-layout dataset it writes first at the DataAgent's
               sizes (57 + 21 frames: 48 train and 12 validation samples),
               02_05_withheld, 2 epochs at batch 12: (a) the flagship
               through the echo cache, (b) PointPillars through the device
               cache, both in process; (b) resumed from its epoch-2
               checkpoint for a third epoch in a fresh process on the plain
               loader; the agent on (a)'s export for 4 compute frames.
               Checks: finite history with val_ade, the checkpoint
               directories and exports exist, each export equals its
               epoch's checkpoint bit for bit, launches per train step
               (attention 0, scatter-max 1 under pillars) and per eval step
               (attention 16, scatter-max 1 under pillars), finite agent
               controls. Prints per run seconds, samples/s per epoch and
               peak memory, the checkpoint save times, the device-cache
               upload, the echo factor, the host decode ms per sample (one
               epoch of the plain loader alone), and the PNG decode ms
               (native unfilter) of a 160x960 strip with libpng-style
               adaptive row filters
  lifecycle    datagen -> train -> closed loop on the grid town
               (grid:2x80x2) with 4 moving background vehicles, on two
               route_gen junction routes through its signalised junction:
               (a) `python -m transfuser_torch.harness.cli datagen` in a
               subprocess for 25 s of sim time per route; it must not
               initialise CUDA (checked at its exit), and prints frames
               written, wall and sim seconds, game seconds per wall
               second and the BEV raster's ms per saved frame; (b) the
               flagship, bf16, through the training CLI in process for 2
               epochs on that dataset (route 0 trains, route 1 is the
               withheld Town02 validation): samples/s, the first and last
               loss, attention launches per train step (0) and per eval
               step (16); (c) its export driven by `python -m
               transfuser_torch.harness.cli evaluate` in process for 10 s
               of sim time on the first route: the closed_loop numbers
               above, at least 16 attention launches per compute frame;
               (d) the expert benchmark (transfuser_torch.tools.
               expert_benchmark) on 2 routes with its default town and 20
               vehicles: driving score and wall seconds. A crashed route
               fails the phase
  bench        transfuser_torch.tools.bench's functions at small counts
               (BENCH_COUNTS: 5 steps x 2 chains, 20 latency iterations, 8
               chained forwards): the flagship bf16 at batch 12 with the
               real-data modes on the lifecycle phase's dataset, then
               --pillars without real data (scatter-max launches), then
               transfuser_torch.tools.graft_entry.entry() once. Checks:
               finite losses, 0 < mfu <= 1, a positive FLOP count, 16
               attention launches per forward (and in the entry's
               forward). Prints every number of each bench JSON line

    python3 chip_smoke.py --only native agent closed_loop

runs the named phases alone (after the build) and prints no result; the
agent phases then use a seeded flagship member of their own.

The main path's launches are counted (a train step's AdamW launches
as the optimizer's ``launch_plan`` gives them) in the agent, closed_loop,
family_forward_ego, config_forward_ego, family_agent, geometric_train,
pillars_forward_ego, train, cli, lifecycle, bench and parallel phases
(counts set to 0 just before each run, read just after). The kernels phase also checks attention at the head
dims of the ResNet and ConvNeXt GPT stages (D = 16, 32, 64, 128, 256), each row
naming the configurations that give it; the attention summary in the
kernels line stays over the flagship's four shapes.
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

import contextlib
import importlib.util
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS = 495e12                # tensor cores, dense

ATTN_MAIN_SHAPES = [(1, 174, 4, d) for d in (18, 54, 144, 378)]
ATTN_EXTRA_SHAPES = [(2, 174, 4, 18), (1, 200, 4, 40)]
# the flagship's GPT under --mesh_model 2: 2 of the 4 heads per rank, at
# the parallel phase's global batch of 4
ATTN_TP_SHAPES = {(4, 174, 2, d): "flagship eval step at --mesh_model 2, "
                  "per rank" for d in (18, 54, 144, 378)}
# fp32 shapes and layouts the split-TF32 tiling must mask, after the rows
# above: (what it checks, shape, layout); "offset" views start one float
# into a buffer (only 4-byte aligned), "permuted" ones are a (B, H, T, D)
# tensor seen as (B, T, H, D)
ATTN_F32_EDGE_CASES = [
    ("D=1", (1, 174, 4, 1), "dense"),
    ("D=3", (1, 174, 4, 3), "dense"),
    ("D=17", (1, 174, 4, 17), "dense"),
    ("D=512", (1, 174, 4, 512), "dense"),
    ("T=1", (1, 1, 4, 64), "dense"),
    ("T=17", (1, 17, 4, 64), "dense"),
    ("T=1024", (1, 1024, 4, 64), "dense"),
    ("T=1024, D=512", (1, 1024, 2, 512), "dense"),
    ("batch 3", (3, 174, 4, 54), "dense"),
    ("one float into a buffer", (1, 174, 4, 54), "offset"),
    ("one float into a buffer, odd D", (2, 17, 3, 17), "offset"),
    ("(B, H, T, D) permuted to (B, T, H, D)", (1, 174, 4, 54), "permuted"),
]
# the GPT's other head counts on RegNetY-032 (stage widths 72 / 216 / 576
# / 1512) and its longer token grids (image + LiDAR anchors); the
# key-tiled kernel takes those the resident ones cannot (odd bf16 D,
# D > 512, T > 1024, bf16 K beyond shared memory)
ATTN_CONFIG_SHAPES = {
    **{(1, 174, 8, d): "regnety_032 at n_head=8" for d in (9, 27, 72, 189)},
    **{(1, 174, 2, d): "regnety_032 at n_head=2"
       for d in (36, 108, 288, 756)},
    **{(1, 174, 1, d): "regnety_032 at n_head=1"
       for d in (72, 216, 576, 1512)},
    **{(1, 696, 4, d): "anchors 10x44 + 16x16" for d in (18, 54, 144, 378)},
    **{(1, 2016, 4, d): "anchors 20x88 + 16x16"
       for d in (18, 54, 144, 378)},
}
# a layout the wrapper copies first: q/k/v with a D stride of 2
ATTN_LAYOUT_CASES = [("D stride 2", (1, 174, 4, 54), "d_stride")]
# the GPT stages' head dims (stage width / 4 heads) of the other trunks
ATTN_FAMILY_SHAPES = {
    (1, 174, 4, 16): "transFuser resnet34/resnet18 stage 1",
    (1, 174, 4, 32): "transFuser resnet34/resnet18 stage 2, "
                     "convnext_base stage 1",
    (1, 174, 4, 64): "transFuser resnet34/resnet18 stage 3, "
                     "convnext_base stage 2",
    (1, 174, 4, 128): "transFuser resnet34/resnet18 stage 4, "
                      "convnext_base stage 3",
    (1, 174, 4, 256): "transFuser convnext_base stage 4",
}
# the flagship's full-width forward at the GPT settings the key-tiled
# kernel opened: (name, what it reaches, GPT fields, sensor fields)
CONFIG_CASES = [
    ("n_head8_256x1024", "odd D = 9/27/72/189, image pools that do not "
     "divide (64x256 -> 5x22 ... 8x32 -> 5x22)", dict(n_head=8),
     dict(img_resolution=(256, 1024))),
    ("n_head2", "D = 36/108/288/756", dict(n_head=2), {}),
    ("anchors_20x88_16x16", "T = 2016, upsampling pools (10x44 and 5x22 -> "
     "20x88, 8x8 -> 16x16) and antialiased downsampling resizes",
     dict(img_vert_anchors=20, img_horz_anchors=88, lidar_vert_anchors=16,
          lidar_horz_anchors=16), {}),
]
# (name, backbone, image trunk, LiDAR trunk, attention launches per forward)
FAMILY_CASES = [
    ("latentTF", "latentTF", "regnety_032", "regnety_032", 16),
    ("late_fusion", "late_fusion", "regnety_032", "regnety_032", 0),
    ("geometric_fusion", "geometric_fusion", "regnety_032", "regnety_032",
     0),
    ("transFuser_resnet34_resnet18", "transFuser", "resnet34", "resnet18",
     16),
    ("transFuser_convnext_base", "transFuser", "convnext_base",
     "convnext_base", 16),
]
GEOMETRIC_CLOUD_POINTS = 30000
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
    """fp32: the summation order and the kernel's split-TF32 products
    (about 2^-22 relative) differ, 1e-5. bf16: the two fp32 results may
    round to neighbouring bf16 values, one bf16 ulp (2^-7 relative) at the
    output's largest magnitude."""
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


def device_time(fn, reps: int = 50, match: str = None) -> tuple:
    """torch.profiler over `reps` warm calls: the device time of all the
    work they launched (kernels and memsets; only the activities whose
    name holds `match`, where given), per call, and the device activities
    per call. Host cost between launches is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # CUPTI now and then hands back no device activity for a window (seen
    # once on an H100, for work it had recorded in an earlier call): the
    # window is profiled again, up to three times in all
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and
                  (match is None or match in e.name)]
        if events:
            return (sum(e.time_range.elapsed_us() for e in events) / 1e3 /
                    reps, len(events) / reps)
    raise AssertionError("the profiler recorded no device work")


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
    """(bound, "bytes" or "operations", the rate the operations were
    counted at). fp32 takes the lesser of two operation times: on the CUDA
    cores (67 TFLOP/s) and as split TF32, three TF32 products on the
    tensor cores (495 TFLOP/s)."""
    b, t, h, d = shape
    nbytes = 4 * b * t * h * d * torch.tensor([], dtype=dtype).element_size()
    flops = 4 * b * h * t * t * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    rate = ("bf16 tensor cores, 989 TFLOP/s" if dtype == torch.bfloat16
            else "fp32 CUDA cores, 67 TFLOP/s")
    if dtype == torch.float32 and 3 * flops / TF32_FLOPS * 1e3 < t_ops:
        t_ops = 3 * flops / TF32_FLOPS * 1e3
        rate = "split TF32: 3 TF32 products at 495 TFLOP/s"
    if t_bytes >= t_ops:
        return t_bytes, "bytes", rate
    return t_ops, "operations", rate


def attention_inputs(shape, layout, gen, dtype):
    """Seeded q, k, v of a (B, T, H, D) shape in `dtype`: dense, one
    element into a buffer ("offset": bf16 rows then only 2-byte aligned),
    a (B, H, T, D) tensor permuted ("permuted"), every other element of
    a buffer of twice the D ("d_stride"), or "rising": q scaled x30 along
    one direction u and k_j leaning towards u in proportion to j (the
    seeded parts x1e-3), so that every row's maximum lies in the last key
    tile and each key tile raises the running max of the key-tiled
    kernel's one-pass softmax (as tests/test_torch_attention.py's
    _rising_qkv)."""
    def randn(*size):
        return torch.randn(size, generator=gen, device="cuda").to(dtype)

    if layout == "rising":
        b, t, h, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(3))
        u = torch.full((d,), d ** -0.5, device="cuda")
        ramp = torch.arange(t, device="cuda").view(1, t, 1, 1) / t
        return [x.to(dtype) for x in (30 * (1e-3 * q + u),
                                      1e-3 * k + ramp * u, v)]

    def one():
        if layout == "d_stride":
            return randn(*shape, 2)[..., 0]
        if layout == "offset":
            return randn(math.prod(shape) + 1)[1:].view(shape)
        if layout == "permuted":
            b, t, h, d = shape
            return randn(b, h, t, d).transpose(1, 2)
        return randn(*shape)

    return [one() for _ in range(3)]


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


def adamw_launches(optimizer) -> int:
    """The AdamW kernel's launches in one update of ``optimizer``: one per
    launch of ``launch_plan`` over the parameters it owns."""
    from transfuser_torch.train.train_state import launch_plan

    return len(launch_plan([optimizer.params[i].numel()
                            for i in optimizer.owned]))


def adamw_launches_for(cfg) -> int:
    """``adamw_launches`` of a one-device trainer of ``cfg``, from the
    model's parameter shapes on the meta device."""
    from transfuser_torch.models import LidarCenterNet
    from transfuser_torch.train.train_state import launch_plan

    model = LidarCenterNet(cfg, device="meta")
    return len(launch_plan([p.numel() for p in model.parameters()
                            if p.requires_grad]))


def adamw_bound_ms(elements: int) -> float:
    """p, g, mu and nu read once and p, mu and nu written once, fp32."""
    return 28 * elements / HBM_BYTES_PER_S * 1e3


def phase_adamw():
    from transfuser_torch.config import GlobalConfig
    from transfuser_torch.models import LidarCenterNet
    from transfuser_torch.train.train_state import (fused_update,
                                                    launch_plan,
                                                    plain_update)

    shapes = [p.shape for p in LidarCenterNet(
        GlobalConfig(), device="meta").parameters() if p.requires_grad]
    elements = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device="cuda").manual_seed(5)
    p, g, m, v = ([torch.randn(s, generator=gen, device="cuda")
                   for s in shapes] for _ in range(4))
    v = [t.abs_() for t in v]
    scalars = torch.tensor([1e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3],
                           device="cuda")
    args = (scalars, 0.9, 0.999, 1e-8, 0.01)
    got, want = ([[t.clone() for t in lst] for lst in (p, m, v)]
                 for _ in range(2))
    fused_update(got[0], g, got[1], got[2], *args)
    plain_update(want[0], g, want[1], want[2], *args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for x, y in zip(got, want)
              for a, b in zip(x, y) if a.numel())
    if not all(torch.equal(a, b) for x, y in zip(got, want)
               for a, b in zip(x, y)):
        raise AssertionError(f"adamw: the kernel differs from the plain "
                             f"passes, max abs err {err}")
    del got, want
    steps = [torch.zeros((), device="cuda") for _ in shapes]

    def kernel():
        fused_update(p, g, m, v, *args)

    def plain():
        plain_update(p, g, m, v, *args)

    def library():  # the yardstick only: another update, timed
        torch._fused_adamw_(p, g, m, v, [], steps, lr=1e-4, beta1=0.9,
                            beta2=0.999, weight_decay=0.01, eps=1e-8,
                            amsgrad=False, maximize=False)

    # the kernels alone: the profiler also lists the wrapper's
    # kernels.adamw span as a device activity
    dev_ms, per_call = device_time(kernel, reps=20, match="tf_adamw")
    kernel()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        kernel()
    torch.cuda.current_stream().wait_stream(side)
    row = dict(case="flagship", tensors=len(shapes), elements=elements,
               max_abs_err=err, ms=cuda_ms(kernel, reps=20),
               graph_ms=cuda_ms(graph.replay, reps=20),
               device_ms=dev_ms, cuda_launches_per_call=per_call,
               launches_per_call=len(launch_plan(
                   [math.prod(s) for s in shapes])),
               host_ms=host_ms(kernel, reps=50),
               plain_ms=cuda_ms(plain, reps=10),
               plain_device_ms=device_time(plain, reps=10)[0],
               library_ms=cuda_ms(library, reps=20),
               library_device_ms=device_time(library, reps=20)[0],
               bound_ms=adamw_bound_ms(elements), bound_by="bytes")
    row["roofline"] = row["bound_ms"] / dev_ms
    row["tb_per_s"] = 28 * elements / dev_ms / 1e9
    emit("kernels", kernels=["adamw"], adamw=[row])
    return {k: row[k] for k in (
        "ms", "graph_ms", "device_ms", "host_ms", "plain_ms",
        "plain_device_ms", "library_ms",
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


def attention_row(q, k, v, **fields) -> dict:
    """Check the kernel against its plain version on q, k, v (raises past
    the tolerance) and time it, the plain version and SDPA. The row names
    the kernel the dispatch rule picks (`route`); where both kernels take
    the shape, the other one is checked and timed beside it (`key_tiled_*`
    beside the resident kernel, `resident_*` beside the key-tiled one),
    the measurement the rule rests on."""
    import torch.nn.functional as F

    from transfuser_torch.ops.attention import (_attention_key_tiled,
                                                _attention_resident,
                                                _resident_takes, attention,
                                                kernel_route,
                                                reference_attention)

    shape, dtype = tuple(q.shape), q.dtype
    route = kernel_route(q, k, v)
    other = ("key_tiled" if route == "resident" else
             "resident" if _resident_takes(q, k, v) else None)
    forced = {"key_tiled": _attention_key_tiled,
              "resident": _attention_resident}
    want = reference_attention(q, k, v)
    tol = attention_tol(dtype, want)
    errs = {r: float((fn(q, k, v).float() - want.float()).abs().max())
            for r, fn in [("rule", attention)] +
            ([(other, forced[other])] if other else [])}
    for r, e in errs.items():
        if not e <= tol:
            raise AssertionError(f"attention {shape} {dtype} {fields} "
                                 f"{r}: max abs err {e} > {tol}")
    got, err = attention(q, k, v), errs["rule"]
    extra = {}
    if other:
        fn = forced[other]
        run = lambda: fn(q, k, v)  # noqa: E731
        extra = {f"{other}_max_abs_err": errs[other],
                 f"{other}_ms": cuda_ms(run),
                 f"{other}_device_ms": device_time(run)[0]}
    # both fp32 paths against fp64: shows each one's own error
    exact = reference_attention(q.double(), k.double(), v.double())
    err64 = float((got.double() - exact).abs().max())
    plain64 = float((want.double() - exact).abs().max())
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bound, bound_by, ops_rate = attention_bound_ms(shape, dtype)
    kernel = lambda: attention(q, k, v)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt)
    return dict(
        shape=list(shape), dtype=str(dtype).split(".")[-1],
        max_abs_err=err, tol=tol, max_abs_err_vs_fp64=err64,
        plain_max_abs_err_vs_fp64=plain64,
        ms=cuda_ms(kernel), device_ms=device_time(kernel)[0],
        host_ms=host_ms(kernel),
        plain_ms=cuda_ms(lambda: reference_attention(q, k, v)),
        library_ms=cuda_ms(library),
        library_device_ms=device_time(library)[0],
        bound_ms=bound, bound_by=bound_by, ops_rate=ops_rate, route=route,
        **extra, **fields)


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in (ATTN_MAIN_SHAPES + ATTN_EXTRA_SHAPES +
                      list(ATTN_FAMILY_SHAPES) + list(ATTN_TP_SHAPES)):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            rows.append(attention_row(
                q, k, v, main_path=shape in ATTN_MAIN_SHAPES,
                used_by=ATTN_FAMILY_SHAPES.get(shape,
                                               ATTN_TP_SHAPES.get(shape))))
    for name, shape, layout in ATTN_F32_EDGE_CASES:
        q, k, v = attention_inputs(shape, layout, gen, torch.float32)
        rows.append(attention_row(q, k, v, main_path=False, edge=name,
                                  strides=list(q.stride())))
    for dtype in (torch.bfloat16, torch.float32):
        for shape, used_by in ATTN_CONFIG_SHAPES.items():
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            rows.append(attention_row(q, k, v, main_path=False,
                                      used_by=used_by))
        for name, shape, layout in ATTN_LAYOUT_CASES:
            q, k, v = attention_inputs(shape, layout, gen, dtype)
            rows.append(attention_row(q, k, v, main_path=False, edge=name,
                                      strides=list(q.stride())))
    max_err = max(r["max_abs_err"] for r in rows)
    # one forward_ego launches each main-path shape 4 times (4 GPT layers)
    per_forward = {}
    for dtype in ("bfloat16", "float32"):
        main = [r for r in rows if r["main_path"] and r["dtype"] == dtype]
        per_forward[dtype] = 4 * sum(r["device_ms"] for r in main)
        per_forward[f"sdpa_{dtype}"] = 4 * sum(r["library_device_ms"]
                                               for r in main)
    emit("kernels", kernels=["attention"], attention=rows,
         forward_ego_attention_device_ms=per_forward)
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


def top_scores(boxes, n_top=10):
    """The n_top highest box scores of sample 0, on the CPU."""
    return boxes[0, :, 7].float().cpu().sort(descending=True)[0][:n_top]


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


def synthetic_sensor_frames(cfg, n, seed=1, speed=3.0):
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
            "speed": (i, {"speed": speed}),
            "imu": (i, np.array([0, 0, 9.8, 0, 0, 0, 0.0])),
            "lidar": (i, pts),
        }


def flagship_member():
    """The flagship config and a seeded member's weights, for the agent
    phases run alone (``--only agent closed_loop``); the whole run passes
    phase_forward_ego's."""
    from transfuser_torch.config import GlobalConfig
    from transfuser_torch.models import LidarCenterNet

    cfg = GlobalConfig()
    model = LidarCenterNet(cfg, dtype=torch.float32, device="cpu", seed=0)
    return cfg, {k: v.detach() for k, v in model.state_dict().items()}


def with_mode(cfg, mode):
    """cfg with the agent's timing mode ("sync", "pipelined_fetch" or
    "async_inference") set in its controller."""
    import dataclasses

    flags = dict(pipelined_fetch=mode == "pipelined_fetch",
                 async_inference=mode == "async_inference")
    return cfg.replace(controller=dataclasses.replace(cfg.controller,
                                                      **flags))


AGENT_MODES = ("sync", "pipelined_fetch", "async_inference")
AGENT_TURNS = AGENT_MODES + AGENT_MODES[::-1]
HELD_CONTROL = [0.0, 0.0, 1.0]  # a fresh agent's control: full brake


def agent_run(cfg, state, mode, frames):
    """A fresh HybridAgent (one member from a config snapshot + .pth, its
    timing mode from the snapshot) over the frames. Launches are counted
    from frame 2 in the synchronous mode (frames 0-1 warm up) and from
    frame 0 in the lagged ones, whose first compute frame dispatches the
    priming forward (a worker thread may still run it at frame 2), up to
    destroy(), which drains the worker. run_step times from frame 2."""
    from transfuser_torch.agents.hybrid_agent import HybridAgent
    from transfuser_torch.ops import kernels

    with tempfile.TemporaryDirectory() as model_dir:
        with_mode(cfg, mode).save(os.path.join(model_dir, "config.json"))
        torch.save(state, os.path.join(model_dir, "model_0.pth"))
        t0 = time.perf_counter()
        agent = HybridAgent(model_dir)
        setup_s = time.perf_counter() - t0
    plan = [({"lat": x / 111324.60662786, "lon": 0.0}, 4)
            for x in range(0, 200, 10)]
    agent.set_global_plan(plan, [(float(x), 0.0) for x in range(0, 200, 10)])
    repeat = cfg.controller.action_repeat
    compute_ms, controls, wps = [], [], []
    torch.cuda.synchronize()
    kernels.reset_launches()           # the main path's run starts here
    for i, frame in enumerate(frames):
        if i == 2 and mode == "sync":
            torch.cuda.synchronize()
            kernels.reset_launches()   # ... after the warm-up frame
        t0 = time.perf_counter()
        control = agent.run_step(frame, 0.05 * i)
        wall = (time.perf_counter() - t0) * 1e3
        controls.append([control.steer, control.throttle, control.brake])
        if i % repeat == 0:
            wps.append(None if agent.pred_wp is None
                       else agent.pred_wp.copy())
            if i >= 2:
                compute_ms.append(wall)
    agent.destroy()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)  # ... and ends here
    if not np.isfinite(controls).all():
        raise AssertionError(f"{mode}: non-finite controls {controls}")
    dispatched = len(compute_ms) + (mode != "sync")
    expected = 16 * dispatched * agent.model_count
    if launches["attention"] != expected:
        raise AssertionError(
            f"{mode}: {launches['attention']} attention launches over "
            f"{dispatched} dispatched forwards, expected {expected}")
    return dict(setup_s=setup_s, controls=controls, wps=wps,
                compute_ms=compute_ms, launches=launches,
                dispatched=dispatched)


def phase_agent(cfg=None, state=None):
    """The flagship agent over 42 synthetic frames (21 compute frames) in
    each timing mode, a fresh agent from the same weights per run, the
    modes in turns (``AGENT_TURNS``) so that drift on the host falls on
    each. The frames' speed is 0: the GPS buffer rolls each fix forward
    through the bicycle model with the applied control times the speed,
    so at 0 the model inputs do not depend on the controls, and compute
    frame k of a lagged mode must drive with the synchronous run's
    waypoints of compute frame k - 1, bit for bit (the same kernels on the
    same inputs); the two synchronous runs must agree bit for bit too."""
    if cfg is None:
        cfg, state = flagship_member()
    frames = list(synthetic_sensor_frames(cfg, 42, speed=0.0))
    runs = [(mode, agent_run(cfg, state, mode, frames))
            for mode in AGENT_TURNS]
    sync_wps = runs[0][1]["wps"]
    lagged_controls = None
    for mode, run in runs:
        if mode == "sync":
            run["max_abs_err"] = max(float(np.abs(got - want).max())
                                     for got, want in zip(run["wps"],
                                                          sync_wps))
        else:
            if run["controls"][0] != HELD_CONTROL or \
                    run["wps"][0] is not None:
                raise AssertionError(f"{mode}: the priming frame returned "
                                     f"{run['controls'][0]}, not the held "
                                     "control")
            if lagged_controls is None:
                lagged_controls = run["controls"]
            elif run["controls"] != lagged_controls:
                raise AssertionError(f"{mode}: controls differ from the "
                                     "other lagged runs'")
            # compute frame k against the synchronous run's k - 1
            run["max_abs_err"] = max(float(np.abs(got - want).max())
                                     for got, want in zip(run["wps"][1:],
                                                          sync_wps[:-1]))
        if run["max_abs_err"] != 0.0:
            raise AssertionError(f"{mode}: waypoints differ from the "
                                 "synchronous run's (one compute frame "
                                 f"earlier when lagged) by "
                                 f"{run['max_abs_err']}")
    launches = dict.fromkeys(runs[0][1]["launches"], 0)
    fields = {}
    for mode in AGENT_MODES:
        mine = [run for m, run in runs if m == mode]
        pooled = [ms for run in mine for ms in run["compute_ms"]]
        per_run = {}
        for run in mine:
            for name, count in run["launches"].items():
                launches[name] += count
                per_run[name] = per_run.get(name, 0) + count
        fields[mode] = dict(
            runs=len(mine), setup_s=[run["setup_s"] for run in mine],
            compute_frames=[len(run["compute_ms"]) for run in mine],
            dispatched_forwards=[run["dispatched"] for run in mine],
            run_step_p50_ms=float(np.percentile(pooled, 50)),
            run_step_p90_ms=float(np.percentile(pooled, 90)),
            run_step_p50_ms_per_run=[
                float(np.percentile(run["compute_ms"], 50)) for run in mine],
            run_step_ms=[run["compute_ms"] for run in mine],
            launches=per_run,
            max_abs_err=max(run["max_abs_err"] for run in mine),
            # random weights predict near-zero waypoints: the agent
            # brakes, so steer and throttle are not exercised here
            non_brake_frames=[sum(c[2] < 0.5 for c in run["controls"])
                              for run in mine],
            last_control=mine[-1]["controls"][-1])
    emit("agent", turns=list(AGENT_TURNS), modes=fields, launches=launches,
         run_step_p50_ms={m: f["run_step_p50_ms"] for m, f in
                          fields.items()},
         pred_wp=sync_wps[-1].tolist())
    return launches


CLOSED_LOOP_ROUTE = """<?xml version='1.0' encoding='UTF-8'?>
<routes><route id="0" town="Town01">
  <waypoint x="0.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
  <waypoint x="60.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
</route></routes>"""


@contextlib.contextmanager
def closed_loop_probe():
    """Times the closed-loop runs of HybridAgent inside the block: run_step
    per compute frame and per repeat frame (the lazy camera and LiDAR
    synthesis it reads included), the sim's camera render and LiDAR
    synthesis, and the criteria; collects the agents that ran."""
    import collections

    from transfuser_torch.agents.hybrid_agent import HybridAgent
    from transfuser_torch.harness import route_scenario
    from transfuser_torch.sim import replay, sensors

    probe = types.SimpleNamespace(spent=collections.defaultdict(float),
                                  compute_ms=[], repeat_ms=[], agents=[])

    def timed(owner, name, key):
        orig = getattr(owner, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                probe.spent[key] += time.perf_counter() - t0
        setattr(owner, name, wrapper)
        return owner, name, orig

    run_step = HybridAgent.run_step

    def timed_run_step(self, input_data, timestamp):
        t0 = time.perf_counter()
        control = run_step(self, input_data, timestamp)
        ms = (time.perf_counter() - t0) * 1e3
        probe.spent["run_step"] += ms / 1e3
        if not any(a is self for a in probe.agents):
            probe.agents.append(self)
        if self.step % self.config.controller.action_repeat == 0:
            probe.compute_ms.append(ms)
        else:
            probe.repeat_ms.append(ms)
        return control

    patched = [timed(replay.ReplaySimulation, "render_camera", "render"),
               timed(sensors, "synth_lidar", "lidar"),
               timed(route_scenario.RouteScenario, "tick_criteria",
                     "criteria"),
               (HybridAgent, "run_step", run_step)]
    HybridAgent.run_step = timed_run_step
    try:
        yield probe
    finally:
        for owner, name, orig in patched:
            setattr(owner, name, orig)


def closed_loop_fields(probe, results: str, launches: dict) -> dict:
    """Checks one route's closed-loop run (no crashed status, at least 16
    attention launches per compute frame and member) and gives its
    numbers: route status, scores, infractions, run_step p50 / p90 per
    compute frame, and per tick the harness's own time (the scenario
    loop's wall minus run_step: sensor feed, criteria, sim step), the
    camera render, the LiDAR synthesis and the criteria."""
    with open(results) as f:
        (record,) = json.load(f)["_checkpoint"]["records"]
    status = record["status"]
    if "crashed" in status.lower():
        raise AssertionError(f"closed loop: route status {status!r}")
    (agent,) = probe.agents
    compute_ms, repeat_ms = probe.compute_ms, probe.repeat_ms
    expected = 16 * len(compute_ms) * agent.model_count
    if launches["attention"] < expected or not compute_ms:
        raise AssertionError(
            f"closed loop made {launches['attention']} attention launches "
            f"over {len(compute_ms)} compute frames, expected {expected}")
    n = len(compute_ms) + len(repeat_ms)
    loop_s = record["meta"]["duration_system"]  # the scenario loop's wall
    spent = probe.spent
    return dict(
        status=status, driving_score=record["scores"]["score_composed"],
        route_completion=record["scores"]["score_route"],
        infraction_penalty=record["scores"]["score_penalty"],
        infractions={k: len(v) for k, v in record["infractions"].items()
                     if v},
        duration_game=record["meta"]["duration_game"],
        ticks=n, compute_frames=len(compute_ms), members=agent.model_count,
        run_step_p50_ms=float(np.percentile(compute_ms, 50)),
        run_step_p90_ms=float(np.percentile(compute_ms, 90)),
        repeat_frame_p50_ms=float(np.percentile(repeat_ms, 50)),
        harness_ms_per_tick=(loop_s - spent["run_step"]) * 1e3 / n,
        render_ms_per_tick=spent["render"] * 1e3 / n,
        lidar_ms_per_tick=spent["lidar"] * 1e3 / n,
        criteria_ms_per_tick=spent["criteria"] * 1e3 / n,
        loop_s=loop_s, launches=launches)


def closed_loop_run(cfg, state, game_seconds, mode):
    """The port's evaluator drives HybridAgent (one flagship member, bf16,
    its timing mode from the config snapshot) over a map-less 60 m route
    for `game_seconds` of sim time, in process."""
    from transfuser_torch.agents.hybrid_agent import HybridAgent
    from transfuser_torch.harness.evaluator import Evaluator, EvaluatorArgs
    from transfuser_torch.ops import kernels

    with tempfile.TemporaryDirectory() as work, \
            closed_loop_probe() as probe:
        model_dir = os.path.join(work, "model")
        os.makedirs(model_dir)
        with_mode(cfg, mode).save(os.path.join(model_dir, "config.json"))
        torch.save(state, os.path.join(model_dir, "model_0.pth"))
        routes = os.path.join(work, "routes.xml")
        with open(routes, "w") as f:
            f.write(CLOSED_LOOP_ROUTE)
        results = os.path.join(work, "results.json")
        torch.cuda.synchronize()
        kernels.reset_launches()   # the main path's run starts here
        t0 = time.perf_counter()
        Evaluator(EvaluatorArgs(
            routes=routes, checkpoint=results,
            agent_factory=lambda c: HybridAgent(model_dir,
                                                route_index=c.index),
            max_game_seconds=game_seconds, timeout=600.0,
            print_route_table=False)).run()  # destroy() drains the worker
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(kernels.launches)  # ... and ends here
        fields = closed_loop_fields(probe, results, launches)
    emit("closed_loop", mode=mode, **fields, evaluator_s=wall)
    return launches


CLOSED_LOOP_TURNS = ("sync", "async_inference", "async_inference", "sync")


def phase_closed_loop(cfg=None, state=None, game_seconds=10.0):
    """The closed loop with the reference's timing and with
    async_inference (every compute frame, the priming one included,
    dispatches a forward on the worker), in turns (``CLOSED_LOOP_TURNS``)
    so that drift on the host falls on both."""
    if cfg is None:
        cfg, state = flagship_member()
    launches = {}
    for mode in CLOSED_LOOP_TURNS:
        for name, count in closed_loop_run(cfg, state, game_seconds,
                                           mode).items():
            launches[name] = launches.get(name, 0) + count
    return launches


def family_config(backbone, image, lidar):
    import dataclasses

    from transfuser_torch.config import GlobalConfig

    cfg = GlobalConfig()
    return cfg.replace(model=dataclasses.replace(
        cfg.model, backbone=backbone, image_architecture=image,
        lidar_architecture=lidar))


def synthetic_cloud(n, seed):
    """(n, 3) raw CARLA-frame points (x left, y forward, z up), most of
    them in front of the car and inside the 32 m BEV."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 35, n),
                     rng.uniform(-2.5, 1.0, n)], axis=-1)


def phase_family_forward_ego():
    """The other families and trunks at full width: bf16 latency and
    attention launches, fp32 card vs fp32 CPU."""
    from transfuser_torch.data.correspondences import \
        lidar_cam_correspondences
    from transfuser_torch.models import LidarCenterNet
    from transfuser_torch.ops import kernels

    total = dict.fromkeys(kernels.KERNELS, 0)
    keys = ("rgb", "lidar", "tp", "tpi", "vel")
    for name, backbone, image, lidar, want in FAMILY_CASES:
        cfg = family_config(backbone, image, lidar)
        x = flagship_inputs(cfg, seed=5)
        geo, corr_ms = {}, None
        if backbone == "geometric_fusion":
            cloud = synthetic_cloud(GEOMETRIC_CLOUD_POINTS, seed=6)
            t0 = time.perf_counter()
            bev, cam = lidar_cam_correspondences(cloud)
            corr_ms = (time.perf_counter() - t0) * 1e3
            geo = {"bev_points": bev[None], "cam_points": cam[None]}

        def inputs(dev):
            return ([torch.from_numpy(x[k]).to(dev) for k in keys],
                    {k: torch.from_numpy(v).to(dev) for k, v in geo.items()})

        torch.cuda.reset_peak_memory_stats()
        model = LidarCenterNet(cfg, dtype=torch.bfloat16, device="cuda",
                               seed=3)
        args, extra = inputs("cuda")
        for _ in range(2):
            model.forward_ego(*args, **extra)
        torch.cuda.synchronize()
        n = 50
        kernels.reset_launches()       # the main path's run starts here
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            wp_bf, boxes_bf, _ = model.forward_ego(*args, **extra)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(kernels.launches)  # ... and ends here
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per_forward = {k: v / n for k, v in launches.items()}
        if per_forward != {"attention": want, "scatter_max": 0,
                           "adamw": 0}:
            raise AssertionError(f"{name}: launches per forward_ego "
                                 f"{per_forward}, expected {want} attention")
        if not (torch.isfinite(wp_bf).all() and
                torch.isfinite(boxes_bf).all()):
            raise AssertionError(f"{name}: non-finite forward_ego outputs")

        model.dtype = torch.float32
        wp32, boxes32, _ = model.forward_ego(*args, **extra)
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        del model
        torch.cuda.empty_cache()
        cpu_model = LidarCenterNet(cfg, dtype=torch.float32, device="cpu")
        cpu_model.load_state_dict(state, strict=True)
        cpu_args, cpu_extra = inputs("cpu")
        t0 = time.perf_counter()
        wp_cpu, boxes_cpu, _ = cpu_model.forward_ego(*cpu_args, **cpu_extra)
        cpu_s = time.perf_counter() - t0
        del cpu_model
        checks = {
            "wp_fp32_card_vs_cpu": (float((wp32.cpu() - wp_cpu).abs().max()),
                                    1e-3),
            "scores_fp32_card_vs_cpu": (float((top_scores(boxes32) -
                                               top_scores(boxes_cpu))
                                              .abs().max()), 1e-4),
        }
        emit("family_forward_ego", config=name, backbone=backbone,
             image_architecture=image, lidar_architecture=lidar,
             launches_per_forward=per_forward, forwards=n,
             bf16_p50_ms=float(np.percentile(times, 50)),
             bf16_p90_ms=float(np.percentile(times, 90)),
             peak_memory_gb=peak_gb, cpu_fp32_s=cpu_s,
             correspondences_ms=corr_ms,
             pred_wp_bf16=wp_bf.float().cpu()[0].tolist(),
             checks={k: {"err": e, "tol": t} for k, (e, t) in
                     checks.items()})
        for check, (err, tol) in checks.items():
            if not err <= tol:
                raise AssertionError(f"{name} {check}: {err} > {tol}")
        for k, v in launches.items():
            total[k] += v
    return total


def config_case(gpt: dict, sensors: dict):
    """The flagship GlobalConfig() with the given GPT and sensor fields."""
    import dataclasses

    from transfuser_torch.config import GlobalConfig

    cfg = GlobalConfig()
    model = dataclasses.replace(
        cfg.model, gpt=dataclasses.replace(cfg.model.gpt, **gpt))
    return cfg.replace(model=model, sensors=dataclasses.replace(
        cfg.sensors, **sensors))


def phase_config_forward_ego(n=20):
    """The flagship at full width with other GPT head counts and token
    grids (CONFIG_CASES), through the key-tiled attention kernel: bf16
    p50 over n forwards, 16 attention launches each, the attention
    kernels' device time per forward, fp32 on the card vs
    fp32 on the CPU (1e-3 m / 1e-4, as the family phase) and bf16 vs
    fp32 waypoints within 5% of their scale (as the flagship phase)."""
    from transfuser_torch.models import LidarCenterNet
    from transfuser_torch.ops import kernels

    total = dict.fromkeys(kernels.KERNELS, 0)
    keys = ("rgb", "lidar", "tp", "tpi", "vel")
    for name, reaches, gpt, sensors in CONFIG_CASES:
        cfg = config_case(gpt, sensors)
        x = flagship_inputs(cfg, seed=7)
        args = [torch.from_numpy(x[k]).to("cuda") for k in keys]
        torch.cuda.reset_peak_memory_stats()
        model = LidarCenterNet(cfg, dtype=torch.bfloat16, device="cuda",
                               seed=4)
        for _ in range(2):
            model.forward_ego(*args)
        torch.cuda.synchronize()
        kernels.reset_launches()       # the main path's run starts here
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            wp_bf, boxes_bf, _ = model.forward_ego(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(kernels.launches)  # ... and ends here
        per_forward = {k: v / n for k, v in launches.items()}
        if per_forward != {"attention": 16, "scatter_max": 0,
                           "adamw": 0}:
            raise AssertionError(f"{name}: launches per forward_ego "
                                 f"{per_forward}, expected 16 attention")
        # the attention kernels' device time in one forward (its 16
        # launches), beside all of the forward's kernels
        prof = profile_calls(lambda: model.forward_ego(*args), 3)
        if not (torch.isfinite(wp_bf).all() and
                torch.isfinite(boxes_bf).all()):
            raise AssertionError(f"{name}: non-finite forward_ego outputs")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        model.dtype = torch.float32
        wp32, boxes32, _ = model.forward_ego(*args)
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        del model
        torch.cuda.empty_cache()
        cpu_model = LidarCenterNet(cfg, dtype=torch.float32, device="cpu")
        cpu_model.load_state_dict(state, strict=True)
        t0 = time.perf_counter()
        wp_cpu, boxes_cpu, _ = cpu_model.forward_ego(
            *[torch.from_numpy(x[k]) for k in keys])
        cpu_s = time.perf_counter() - t0
        del cpu_model
        wp32_c, wp_bf_c = wp32.cpu(), wp_bf.float().cpu()
        scale = max(1.0, float(wp32_c.abs().max()))
        checks = {
            "wp_fp32_card_vs_cpu": (float((wp32_c - wp_cpu).abs().max()),
                                    1e-3),
            "scores_fp32_card_vs_cpu": (float((top_scores(boxes32) -
                                               top_scores(boxes_cpu))
                                              .abs().max()), 1e-4),
            "wp_bf16_vs_fp32": (float((wp_bf_c - wp32_c).abs().max()),
                                0.05 * scale),
        }
        gpt_cfg = cfg.model.gpt
        emit("config_forward_ego", config=name, reaches=reaches,
             n_head=gpt_cfg.n_head,
             img_anchors=[gpt_cfg.img_vert_anchors, gpt_cfg.img_horz_anchors],
             lidar_anchors=[gpt_cfg.lidar_vert_anchors,
                            gpt_cfg.lidar_horz_anchors],
             img_resolution=list(cfg.sensors.img_resolution),
             launches_per_forward=per_forward, forwards=n,
             attention_device_ms_per_forward=prof[
                 "attention_device_ms_per_call"],
             device_kernel_ms_per_forward=prof["device_kernel_ms_per_call"],
             bf16_p50_ms=float(np.percentile(times, 50)),
             bf16_p90_ms=float(np.percentile(times, 90)),
             peak_memory_gb=peak_gb, cpu_fp32_s=cpu_s,
             scores_bf16_vs_fp32=float((top_scores(boxes_bf) -
                                        top_scores(boxes32)).abs().max()),
             pred_wp_bf16=wp_bf_c[0].tolist(),
             checks={k: {"err": e, "tol": t} for k, (e, t) in
                     checks.items()})
        for check, (err, tol) in checks.items():
            if not err <= tol:
                raise AssertionError(f"{name} {check}: {err} > {tol}")
        for k, v in launches.items():
            total[k] += v
    return total


def phase_family_agents():
    """HybridAgent for latentTF (no LiDAR sensor, frames without one) and
    geometric_fusion (per-frame correspondences on the host), each from a
    model dir with a config snapshot and a .pth."""
    from transfuser_torch.agents.hybrid_agent import HybridAgent
    from transfuser_torch.data.correspondences import \
        lidar_cam_correspondences
    from transfuser_torch.models import LidarCenterNet
    from transfuser_torch.ops import kernels

    total = dict.fromkeys(kernels.KERNELS, 0)
    for backbone, per_frame in (("latentTF", 16), ("geometric_fusion", 0)):
        cfg = family_config(backbone, "regnety_032", "regnety_032")
        model = LidarCenterNet(cfg, dtype=torch.float32, device="cpu",
                               seed=2)
        with tempfile.TemporaryDirectory() as model_dir:
            cfg.save(os.path.join(model_dir, "config.json"))
            torch.save({f"module.{k}": v
                        for k, v in model.state_dict().items()},
                       os.path.join(model_dir, "model_0.pth"))
            del model
            t0 = time.perf_counter()
            agent = HybridAgent(model_dir)
            setup_s = time.perf_counter() - t0
        sensors = [sen["id"] for sen in agent.sensors()]
        if ("lidar" in sensors) != (backbone != "latentTF"):
            raise AssertionError(f"{backbone}: sensors {sensors}")
        if (backbone == "geometric_fusion" and
                not agent.config.model.geometric_reference_view):
            raise AssertionError("a .pth member left the reference "
                                 "correspondence-grid view off")
        plan = [({"lat": x / 111324.60662786, "lon": 0.0}, 4)
                for x in range(0, 200, 10)]
        agent.set_global_plan(plan, [(float(x), 0.0)
                                     for x in range(0, 200, 10)])
        frames = list(synthetic_sensor_frames(cfg, 42, seed=4))
        if backbone == "latentTF":
            for frame in frames:
                del frame["lidar"]
        for i, frame in enumerate(frames[:2]):  # warm-up compute frame
            agent.run_step(frame, 0.05 * i)
        torch.cuda.synchronize()
        kernels.reset_launches()       # the main path's run starts here
        compute_ms, controls, corr_ms = [], [], []
        for i, frame in enumerate(frames[2:], start=2):
            compute = (agent.step + 1) % cfg.controller.action_repeat == 0
            t0 = time.perf_counter()
            control = agent.run_step(frame, 0.05 * i)
            wall = (time.perf_counter() - t0) * 1e3
            if compute:
                compute_ms.append(wall)
            controls.append([control.steer, control.throttle,
                             control.brake])
        launches = dict(kernels.launches)  # ... and ends here
        if backbone == "geometric_fusion":
            # the agent's host work per compute frame, timed on its own
            for frame in frames[2::2]:
                t0 = time.perf_counter()
                lidar_cam_correspondences(frame["lidar"][1][:, :3])
                corr_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(controls).all():
            raise AssertionError(f"{backbone}: non-finite controls")
        expected = {"attention": per_frame * len(compute_ms),
                    "scatter_max": 0, "adamw": 0}
        if launches != expected:
            raise AssertionError(f"{backbone} agent launches {launches}, "
                                 f"expected {expected}")
        emit("family_agent", backbone=backbone, setup_s=setup_s,
             sensors=sensors, compute_frames=len(compute_ms),
             run_step_p50_ms=float(np.percentile(compute_ms, 50)),
             run_step_ms=compute_ms, launches=launches,
             correspondences_p50_ms=(float(np.percentile(corr_ms, 50))
                                     if corr_ms else None),
             last_control=controls[-1], pred_wp=agent.pred_wp.tolist())
        del agent
        torch.cuda.empty_cache()
        for k, v in launches.items():
            total[k] += v
    return total


def phase_geometric_train(steps=3):
    from transfuser_torch.data.synthetic import synthetic_batch
    from transfuser_torch.ops import kernels
    from transfuser_torch.train.trainer import Trainer

    cfg = family_config("geometric_fusion", "regnety_032", "regnety_032")
    bsz = cfg.train.batch_size
    host = synthetic_batch(cfg, bsz, seed=0)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    batch = trainer.put_batch(host)
    torch.cuda.synchronize()
    kernels.reset_launches()           # the main path's run starts here
    totals, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        totals.append(float(metrics["loss_total"]))
    launches = dict(kernels.launches)  # ... and ends here
    want = {"attention": 0, "scatter_max": 0,
            "adamw": steps * adamw_launches(trainer.optimizer)}
    if launches != want:
        raise AssertionError(f"geometric train launches {launches}, "
                             f"expected {want}")
    if not np.isfinite(totals).all():
        raise AssertionError(f"non-finite geometric loss_total {totals}")
    emit("geometric_train", batch=bsz, steps=steps, step_ms=times,
         loss_total=totals, launches=launches,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del trainer, batch
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
    if per_forward != {"attention": 16, "scatter_max": 1, "adamw": 0}:
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
    adamw = adamw_launches(trainer.optimizer)
    if per_step != {"attention": 0, "scatter_max": 1, "adamw": adamw}:
        raise AssertionError(f"train launches per step {per_step}, expected "
                             "0 attention (dropout takes explicit probs), "
                             f"1 scatter_max and {adamw} adamw")
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
    if eval_launches != {"attention": 16, "scatter_max": 1, "adamw": 0}:
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


def adaptive_png(img: np.ndarray) -> tuple:
    """(H, W, 3) uint8 -> PNG bytes with a filter chosen per row as
    libpng's adaptive filtering chooses (the least sum of the filtered
    bytes read as signed), and the count of rows per filter type."""
    import struct
    import zlib

    from transfuser_torch.data import png

    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]                       # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                             # up
    cc = np.zeros_like(x)
    cc[1:, c:] = x[:-1, :-c]                   # up-left
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    rows = np.stack([(x - q) & 255 for q in preds])        # (5, H, W*C)
    cost = np.minimum(rows, 256 - rows).sum(axis=2)        # (5, H)
    kind = cost.argmin(axis=0)
    raw = np.concatenate([kind[:, None], rows[kind, np.arange(h)]], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    blob = (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", header) +
            png._chunk(b"IDAT", zlib.compress(raw.astype(np.uint8)
                                              .tobytes(), 6)) +
            png._chunk(b"IEND", b""))
    return blob, np.bincount(kind, minlength=5).tolist()


def interleaved_ms(fns: dict, rounds: int) -> dict:
    """Median wall ms per call of each function, called in turns (A, B,
    B, A, ...) so that drift on the host's clock falls on both."""
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            fns[name]()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def phase_native():
    """The port's native host library (transfuser_torch/native): built by
    g++ here, each entry point held to its numpy version exactly, the
    LiDAR histogram timed against numpy on a 40,000-point cloud (the
    agent's (N, 3) float32 view) and the PNG decode timed against the
    Python unfilter loop on a 160x960 strip with adaptive row filters."""
    from transfuser_torch import native
    from transfuser_torch.config import SEMANTIC_CONVERTER
    from transfuser_torch.data import decoders, lidar_np, png

    gxx = subprocess.run([native.compiler(), "--version"],
                         capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    cached = native.library_path().exists()
    native.build()
    build_s = time.perf_counter() - t0
    native.load()

    rng = np.random.default_rng(21)
    cloud = np.concatenate([
        rng.uniform(-30, 30, (40000, 2)), rng.uniform(-4, 1, (40000, 1)),
        rng.uniform(0, 1, (40000, 1))], axis=1).astype(np.float32)
    xyz = cloud[:, :3]
    strip = np.clip(128 + np.cumsum(rng.normal(0, 3, (160, 960, 3)),
                                    axis=1), 0, 255).astype(np.uint8)
    blob, filters = adaptive_png(strip)
    raw = rng.integers(0, 256, (160, 960, 3), dtype=np.uint8)
    seg = rng.integers(0, len(SEMANTIC_CONVERTER), (160, 960),
                       dtype=np.uint8)
    lut = np.asarray(SEMANTIC_CONVERTER, np.uint8)
    checks = {
        "lidar_histogram_xyzi": (native.lidar_histogram(cloud),
                                 lidar_np.lidar_to_histogram(
                                     cloud, use_native=False)),
        "lidar_histogram_xyz": (lidar_np.lidar_to_histogram(xyz),
                                lidar_np.lidar_to_histogram(
                                    xyz, use_native=False)),
        "decode_depth": (native.decode_depth(raw),
                         decoders.decode_depth(raw)),
        "semantic_convert": (native.semantic_convert(seg, lut),
                             decoders.convert_semantics(seg)),
        "decode_bev_roadlane": (native.decode_bev_roadlane(raw),
                                decoders.decode_bev_channels(raw)),
        "crop_to_float": (native.crop_to_float(raw, (160, 704), 50.0),
                          decoders.crop_image(raw, (160, 704), 50.0)
                          .astype(np.float32)),
        "png_unfilter": (png.decode(blob), strip),
        "png_python_loop": (png.decode(blob, use_native=False), strip),
    }
    errs = {}
    for name, (got, want) in checks.items():
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"native {name}: {got.shape} {got.dtype} "
                                 f"vs {want.shape} {want.dtype}")
        errs[name] = float(np.abs(got.astype(np.float64) -
                                  want.astype(np.float64)).max())
        if errs[name] != 0.0:
            raise AssertionError(f"native {name} differs from numpy by "
                                 f"{errs[name]}")
    hist = interleaved_ms({
        "native": lambda: lidar_np.lidar_to_histogram(xyz),
        "numpy": lambda: lidar_np.lidar_to_histogram(xyz, use_native=False),
    }, rounds=40)
    decode = interleaved_ms({
        "native": lambda: png.decode(blob),
        "python": lambda: png.decode(blob, use_native=False),
    }, rounds=6)
    emit("native", compiler=gxx.splitlines()[0] if gxx else None,
         build_s=build_s, was_built=cached, library=native.library_path().name,
         max_abs_err=errs, lidar_points=len(cloud),
         histogram_native_ms=hist["native"],
         histogram_numpy_ms=hist["numpy"],
         histogram_speedup=hist["numpy"] / hist["native"],
         png_shape=list(strip.shape), png_rows_per_filter=filters,
         png_native_ms=decode["native"], png_python_ms=decode["python"],
         png_speedup=decode["python"] / decode["native"])


def train_state_model(run_dir: str, epoch: int) -> dict:
    from transfuser_torch.train import checkpoint

    return torch.load(os.path.join(run_dir, str(epoch),
                                   checkpoint.TRAIN_STATE),
                      map_location="cpu", weights_only=True)["model"]


def check_export(run_dir: str, epoch: int) -> None:
    """model_<epoch>.msgpack holds, bit for bit, the model of the train
    state checkpointed at <epoch>."""
    from transfuser_torch.train import checkpoint
    from transfuser_torch.train.jax_import import state_dict_from_jax

    cfg = checkpoint.load_config_snapshot(run_dir)
    exported = state_dict_from_jax(checkpoint.load_inference_weights(
        os.path.join(run_dir, f"model_{epoch}.msgpack")), cfg)
    saved = train_state_model(run_dir, epoch)
    if exported.keys() != saved.keys():
        raise AssertionError(f"{run_dir}: export and checkpoint {epoch} "
                             "hold different tensors")
    for k, v in saved.items():
        if not torch.equal(exported[k], v):
            raise AssertionError(f"{run_dir}: model_{epoch}.msgpack {k} "
                                 f"differs from checkpoint {epoch}")


def check_history(run_dir: str, epochs: list) -> list:
    rows = json.load(open(os.path.join(run_dir, "history.json")))[
        "per_epoch"]
    if [r["epoch"] for r in rows] != epochs:
        raise AssertionError(f"{run_dir}: history epochs {rows}")
    for r in rows:
        if "val_ade" not in r or not np.isfinite(
                [v for k, v in r.items() if k != "epoch"]).all():
            raise AssertionError(f"{run_dir}: history row {r}")
    return rows


def count_step_launches(per_step: dict):
    """Wraps the trainer's step factories so that each train and eval step
    appends its kernel launches to per_step["train"] / per_step["eval"];
    returns the undo."""
    import transfuser_torch.train.trainer as trainer_mod
    from transfuser_torch.ops import kernels

    made = (trainer_mod.make_train_step, trainer_mod.make_eval_step)

    def counting(kind, make):
        def factory(*args, **kwargs):
            step = make(*args, **kwargs)

            def counted(batch):
                before = dict(kernels.launches)
                result = step(batch)
                per_step[kind].append({k: kernels.launches[k] - before[k]
                                       for k in before})
                return result
            return counted
        return factory

    trainer_mod.make_train_step = counting("train", made[0])
    trainer_mod.make_eval_step = counting("eval", made[1])

    def undo():
        trainer_mod.make_train_step, trainer_mod.make_eval_step = made
    return undo


def phase_cli():
    """The training CLI on a CARLA-layout dataset written at full size:
    two runs in process (the flagship through the echo cache, PointPillars
    through the device cache), a resume of the second in a fresh process
    on the plain loader, and the agent on the first run's export."""
    from transfuser_torch.agents.hybrid_agent import HybridAgent
    from transfuser_torch.config import GlobalConfig
    from transfuser_torch.data import png
    from transfuser_torch.data.dataset import CarlaDataset
    from transfuser_torch.data.loader import PrefetchLoader, pinned_put
    from transfuser_torch.data.synthetic import write_route
    from transfuser_torch.ops import kernels
    from transfuser_torch.train import cli

    t_phase = time.perf_counter()
    out = {}
    # launches per call of the trainer's train and eval steps
    per_step = {"train": [], "eval": []}
    undo = count_step_launches(per_step)
    launches = dict.fromkeys(kernels.KERNELS, 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        root, logs = os.path.join(tmp, "data"), os.path.join(tmp, "log")
        t0 = time.perf_counter()
        # 57 frames: 48 train samples (4 steps at batch 12); 21 frames:
        # 12 validation samples (Town02 is withheld)
        write_route(os.path.join(root, "Town01_Short", "Town01_route0"), 57,
                    seed=10)
        write_route(os.path.join(root, "Town01_Short", "Town02_route0"), 21,
                    seed=11)
        out["dataset_write_s"] = time.perf_counter() - t0
        common = ["--root_dir", root, "--logdir", logs, "--setting",
                  "02_05_withheld", "--batch_size", "12", "--val_every",
                  "1", "--num_workers", "4"]
        runs = {"a": ["--echo_window", "24"],
                "b": ["--use_point_pillars", "1", "--device_cache", "1"]}
        for name, extra in runs.items():
            pillars = name == "b"
            per_step["train"].clear()
            per_step["eval"].clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()   # the main path's run starts here
            t0 = time.perf_counter()
            summary = cli.main(common + ["--id", name, "--epochs", "2"] +
                               extra)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            for k, v in kernels.launches.items():  # ... and ends here
                launches[k] += v
            run_dir = os.path.join(logs, name)
            adamw = adamw_launches_for(
                pillar_config() if pillars else GlobalConfig())
            want = {"train": {"attention": 0, "scatter_max": int(pillars),
                              "adamw": adamw},
                    "eval": {"attention": 16, "scatter_max": int(pillars),
                             "adamw": 0}}
            counts = {"train": len(per_step["train"]),
                      "eval": len(per_step["eval"])}
            if counts != {"train": 8, "eval": 2}:
                raise AssertionError(f"run {name}: steps {counts}, expected "
                                     "8 train and 2 eval")
            for kind in ("train", "eval"):
                for got in per_step[kind]:
                    if got != want[kind]:
                        raise AssertionError(f"run {name}: {kind} step "
                                             f"launches {got} != "
                                             f"{want[kind]}")
            rows = check_history(run_dir, [0, 1])
            e = summary["export_epoch"]
            for path in ("1", "2", f"model_{e}.msgpack",
                         "best/model_best.msgpack", "best/EXPORT.json"):
                if not os.path.exists(os.path.join(run_dir, path)):
                    raise AssertionError(f"run {name}: no {path}")
            check_export(run_dir, e)
            out[name] = dict(
                argv=extra, seconds=seconds,
                samples_per_s=[r["samples_per_sec"] for r in rows],
                loss_total=[r["loss_total"] for r in rows],
                val_ade=[r["val_ade"] for r in rows],
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                export_epoch=e, launches=dict(kernels.launches),
                launches_per_train_step=want["train"],
                launches_per_eval_step=want["eval"],
                checkpoint_saves=summary["checkpoint_saves"],
                **{k: summary[k] for k in ("echo_factor", "device_cache")
                   if k in summary})
            if name == "a":  # the agent needs the export, not the states
                for path in ("1", "2"):
                    shutil.rmtree(os.path.join(run_dir, path))
            torch.cuda.empty_cache()
        dc = out["b"]["device_cache"]
        out["device_cache_upload_mb"] = dc["upload_bytes"] / 1e6
        out["device_cache_upload_s"] = dc["upload_s"]

        # resume run b in a fresh process, on the plain PrefetchLoader
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "transfuser_torch.train.cli", *common,
             "--id", "b", "--use_point_pillars", "1", "--load_epoch", "2",
             "--start_epoch", "2", "--epochs", "3"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"resume failed:\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        run_b = os.path.join(logs, "b")
        rows = check_history(run_b, [2])
        check_export(run_b, 3)
        step = torch.load(os.path.join(run_b, "3", "train_state.pt"),
                          map_location="cpu", weights_only=True)["step"]
        if step != 12:
            raise AssertionError(f"resumed run ended at step {step}, "
                                 "expected 8 + 4")
        out["resume"] = dict(seconds=time.perf_counter() - t0,
                             samples_per_s=rows[0]["samples_per_sec"],
                             loss_total=rows[0]["loss_total"],
                             val_ade=rows[0]["val_ade"], step=step)

        # the agent on run a's export: 4 compute frames
        cfg = GlobalConfig()
        t0 = time.perf_counter()
        agent = HybridAgent(os.path.join(logs, "a"), device="cuda")
        setup_s = time.perf_counter() - t0
        if agent.config.model.gpt.reference_view_unpack:
            raise AssertionError("a native export turned on the reference "
                                 "view-unpack quirk")
        plan = [({"lat": x / 111324.60662786, "lon": 0.0}, 4)
                for x in range(0, 200, 10)]
        agent.set_global_plan(plan, [(float(x), 0.0)
                                     for x in range(0, 200, 10)])
        frames = list(synthetic_sensor_frames(cfg, 8, seed=3))
        kernels.reset_launches()       # the main path's run starts here
        controls = [agent.run_step(f, 0.05 * i) for i, f in
                    enumerate(frames)]
        torch.cuda.synchronize()
        for k, v in kernels.launches.items():  # ... and ends here
            launches[k] += v
        controls = [[c.steer, c.throttle, c.brake] for c in controls]
        if not np.isfinite(controls).all():
            raise AssertionError(f"non-finite controls {controls}")
        if kernels.launches["attention"] != 16 * 4:
            raise AssertionError(f"agent on the export: "
                                 f"{kernels.launches} launches")
        out["agent"] = dict(setup_s=setup_s, compute_frames=4,
                            launches=dict(kernels.launches),
                            last_control=controls[-1])
        del agent

        # host decode: one epoch of the plain loader alone (flagship,
        # packed, augmented), 4 worker threads, and one sample at a time
        cfg = GlobalConfig(root_dir=root, setting="02_05_withheld")
        train_set = CarlaDataset(cfg.resolve_splits()[0], cfg, packed=True)
        loader = PrefetchLoader(train_set, 12, num_workers=4, seed=0,
                                device_put=pinned_put("cuda"))
        waits = []
        t0 = time.perf_counter()
        it = iter(loader)
        for _ in range(len(loader)):
            t1 = time.perf_counter()
            next(it)
            waits.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        for i in range(6):
            train_set[i]
        out["host_decode"] = dict(
            samples=len(train_set), workers=4, epoch_s=epoch_s,
            ms_per_sample=epoch_s * 1e3 / len(train_set),
            batch_wait=dict(
                batch_p50_ms=float(np.percentile(waits, 50)),
                batch_p95_ms=float(np.percentile(waits, 95)),
                batch_mean_ms=float(np.mean(waits))),
            serial_ms_per_sample=(time.perf_counter() - t1) * 1e3 / 6)

        # PNG decode of one 160x960 RGB strip with adaptive row filters
        rng = np.random.default_rng(12)
        strip = np.clip(128 + np.cumsum(rng.normal(0, 3, (160, 960, 3)),
                                        axis=1), 0, 255).astype(np.uint8)
        blob, filters = adaptive_png(strip)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = png.decode(blob)
            times.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(got, strip):
            raise AssertionError("adaptive-filter PNG decoded wrong")
        plain = png.encode(strip)
        t0 = time.perf_counter()
        png.decode(plain)
        out["png_decode"] = dict(
            shape=list(strip.shape), adaptive_ms=statistics.median(times),
            rows_per_filter=filters,
            filter_none_ms=(time.perf_counter() - t0) * 1e3)
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("cli", **out)
    return launches


LIFECYCLE_TOWN = "grid:2x80x2"
LIFECYCLE_BACKGROUND = 4
# Runs `python -m transfuser_torch.harness.cli` (argv after -c) and, at
# exit, reports the BEV rasteriser's calls and seconds and whether the
# process imported torch or initialised CUDA.
DATAGEN_CHILD = """
import atexit, json, runpy, sys, time
from transfuser_torch.data import bev_raster

bev = {"bev_frames": 0, "bev_s": 0.0}
render = bev_raster.BevRasterizer.render


def timed_render(self, *args, **kwargs):
    t0 = time.perf_counter()
    try:
        return render(self, *args, **kwargs)
    finally:
        bev["bev_frames"] += 1
        bev["bev_s"] += time.perf_counter() - t0


def report():
    torch = sys.modules.get("torch")
    print("DATAGEN_CHILD " + json.dumps(dict(
        bev, torch_imported=torch is not None,
        cuda_initialized=bool(torch is not None
                              and torch.cuda.is_initialized()))),
          flush=True)


bev_raster.BevRasterizer.render = timed_render
atexit.register(report)
runpy.run_module("transfuser_torch.harness.cli", run_name="__main__",
                 alter_sys=True)
"""


def lifecycle_routes(path: str, first: str) -> list:
    """Two generated routes of the grid town through its signalised
    junction (80, 80), straight on and left (route_gen's junction routes,
    thinned to keypoints as the expert benchmark thins them), into
    `path`; the first alone into `first`. -> the routes' lengths in m."""
    from transfuser_torch.harness.evaluator import build_town_map
    from transfuser_torch.tools.route_gen import (TownGraph,
                                                  junction_routes,
                                                  routes_to_xml)

    graph = TownGraph.from_town_map(build_town_map(LIFECYCLE_TOWN))
    routes = [next(r for r in junction_routes(graph, turn=turn)
                   if any(math.hypot(x - 80.0, y - 80.0) < 12.0
                          for x, y, _ in r))
              for turn in ("straight", "left")]
    routes_to_xml([r[::5] + [r[-1]] for r in routes], graph.name, path)
    routes_to_xml([routes[0][::5] + [routes[0][-1]]], graph.name, first)
    return [sum(math.hypot(b[0] - a[0], b[1] - a[1])
                for a, b in zip(r, r[1:])) for r in routes]


def route_records(results: str) -> list:
    """The records of a results JSON; raises on a crashed route."""
    with open(results) as f:
        records = json.load(f)["_checkpoint"]["records"]
    for r in records:
        if "crashed" in r["status"].lower():
            raise AssertionError(f"{results}: route status {r['status']!r}")
    return records


def phase_lifecycle(datagen_seconds=25.0, drive_seconds=10.0,
                    keep_data=None):
    """datagen -> train -> closed loop, and the expert benchmark, on the
    grid town with moving traffic: (a) ``python -m
    transfuser_torch.harness.cli datagen`` in a subprocess that must not
    initialise CUDA; (b) the flagship, bf16, trained through the training
    CLI in process for 2 epochs on that dataset; (c) its export driven by
    ``transfuser_torch.harness.cli evaluate`` in process; (d) the expert
    benchmark on 2 routes. ``keep_data``: a path that the dataset's route
    directories are moved to at the end (the bench phase reads them)."""
    from transfuser_torch.harness import cli as harness_cli
    from transfuser_torch.ops import kernels
    from transfuser_torch.tools.expert_benchmark import run_expert_benchmark
    from transfuser_torch.train import cli as train_cli

    t_phase = time.perf_counter()
    out = {}
    launches = dict.fromkeys(kernels.KERNELS, 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lifecycle_")
    try:
        routes = os.path.join(tmp, "routes.xml")
        first = os.path.join(tmp, "route0.xml")
        lengths = lifecycle_routes(routes, first)

        # (a) the expert writes the dataset, without CUDA
        save = os.path.join(tmp, "datagen")
        results = os.path.join(tmp, "datagen.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", DATAGEN_CHILD, "datagen", "--routes",
             routes, "--save-path", save, "--checkpoint", results,
             "--town-map", LIFECYCLE_TOWN, "--background-vehicles",
             str(LIFECYCLE_BACKGROUND), "--max-game-seconds",
             str(datagen_seconds)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"datagen failed:\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        (child,) = [json.loads(line.split(" ", 1)[1])
                    for line in proc.stdout.splitlines()
                    if line.startswith("DATAGEN_CHILD ")]
        if child["cuda_initialized"]:
            raise AssertionError("the datagen process initialised CUDA")
        records = route_records(results)
        frames = [len(os.listdir(os.path.join(save, f"route{i}",
                                              "measurements")))
                  for i in range(2)]
        if child["bev_frames"] != sum(frames) or min(frames) < 30:
            raise AssertionError(f"datagen saved {frames} frames, "
                                 f"{child['bev_frames']} BEV renders")
        game = sum(r["meta"]["duration_game"] for r in records)
        loop = sum(r["meta"]["duration_system"] for r in records)
        out["datagen"] = dict(
            route_lengths_m=lengths, frames=frames, wall_s=wall,
            game_s=game, loop_s=loop, game_s_per_wall_s=game / wall,
            game_s_per_loop_s=game / loop,
            bev_ms_per_saved_frame=child["bev_s"] * 1e3 / sum(frames),
            status=[r["status"] for r in records],
            driving_score=[r["scores"]["score_composed"] for r in records],
            torch_imported=child["torch_imported"],
            cuda_initialized=child["cuda_initialized"])
        # the training CLI's town layout: route 0 trains, route 1 is the
        # withheld Town02 validation
        root = os.path.join(tmp, "data")
        os.makedirs(os.path.join(root, "grid"))
        for i, name in enumerate(("Town01_route0", "Town02_route1")):
            os.rename(os.path.join(save, f"route{i}"),
                      os.path.join(root, "grid", name))

        # (b) the flagship, bf16, trained on the expert's data
        logs = os.path.join(tmp, "log")
        per_step = {"train": [], "eval": []}
        undo = count_step_launches(per_step)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()   # the main path's run starts here
            t0 = time.perf_counter()
            summary = train_cli.main([
                "--root_dir", root, "--logdir", logs, "--id", "expert",
                "--setting", "02_05_withheld", "--epochs", "2",
                "--batch_size", "12", "--val_every", "1",
                "--num_workers", "4"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            train_launches = dict(kernels.launches)  # ... and ends here
        finally:
            undo()
        for k, v in train_launches.items():
            launches[k] += v
        if not per_step["train"] or not per_step["eval"]:
            raise AssertionError(f"training ran {len(per_step['train'])} "
                                 f"train and {len(per_step['eval'])} eval "
                                 "steps")
        for kind, want in (("train", 0), ("eval", 16)):
            for got in per_step[kind]:
                if got["attention"] != want:
                    raise AssertionError(f"{kind} step launches {got}, "
                                         f"expected {want} attention")
        run_dir = os.path.join(logs, "expert")
        rows = check_history(run_dir, [0, 1])
        check_export(run_dir, summary["export_epoch"])
        for path in ("1", "2"):  # the agent needs the export only
            shutil.rmtree(os.path.join(run_dir, path))
        loss = [r["loss_total"] for r in rows]
        out["train"] = dict(
            seconds=seconds, train_steps=len(per_step["train"]),
            eval_steps=len(per_step["eval"]),
            samples_per_s=[r["samples_per_sec"] for r in rows],
            loss_first=loss[0], loss_last=loss[-1], loss_total=loss,
            val_ade=[r["val_ade"] for r in rows],
            eval_step_attention_launches=[
                got["attention"] for got in per_step["eval"]],
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=train_launches)
        torch.cuda.empty_cache()

        # (c) the trained agent on the grid town with traffic
        results = os.path.join(tmp, "drive.json")
        with closed_loop_probe() as probe:
            torch.cuda.synchronize()
            kernels.reset_launches()   # the main path's run starts here
            t0 = time.perf_counter()
            harness_cli.main([
                "evaluate", "--routes", first, "--agent", "hybrid",
                "--agent-config", run_dir, "--checkpoint", results,
                "--town-map", LIFECYCLE_TOWN, "--background-vehicles",
                str(LIFECYCLE_BACKGROUND), "--max-game-seconds",
                str(drive_seconds), "--timeout", "600"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            drive_launches = dict(kernels.launches)  # ... and ends here
            out["closed_loop"] = dict(
                closed_loop_fields(probe, results, drive_launches),
                evaluator_s=wall)
        for k, v in drive_launches.items():
            launches[k] += v

        # (d) the expert benchmark: 2 routes, the tool's town and traffic
        work = os.path.join(tmp, "expert")
        os.makedirs(work)
        t0 = time.perf_counter()
        scores = run_expert_benchmark(os.path.join(work, "expert.json"),
                                      n_routes=2, workdir=work)
        records = route_records(os.path.join(work, "expert.json"))
        out["expert_benchmark"] = dict(
            wall_s=time.perf_counter() - t0, n_routes=scores["n_routes"],
            background_vehicles=scores["background_vehicles"],
            driving_score=scores["score_composed"],
            route_completion=scores["score_route"],
            infraction_penalty=scores["score_penalty"],
            status=[r["status"] for r in records],
            game_s=sum(r["meta"]["duration_game"] for r in records))
        if keep_data is not None:
            shutil.move(os.path.join(root, "grid"), keep_data)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("lifecycle", **out)
    return launches


# ---------------------------------------------------------------- bench

# the bench's counts here, cut from its command line's 30 steps x 3 chains,
# 50 latency iterations and 32 chained forwards to hold the phase near 2
# minutes
BENCH_COUNTS = dict(n_steps=5, n_reps=2, iters=20, chain=8)


def bench_checks(name: str, res: dict, launches: dict, pillars: bool):
    """Finite losses, 0 < mfu <= 1, a positive FLOP count, 16 attention
    launches per forward, and a scatter-max launch under PointPillars."""
    if not (np.isfinite(res["loss_first"]) and np.isfinite(res["loss_last"])):
        raise AssertionError(f"bench {name}: non-finite loss {res}")
    if not 0.0 < res["mfu"] <= 1.0:
        raise AssertionError(f"bench {name}: mfu {res['mfu']}")
    if not res["train_step_tflop"] > 0:
        raise AssertionError(f"bench {name}: FLOP count "
                             f"{res['train_step_tflop']}")
    if res["attention_launches_per_forward"] != 16:
        raise AssertionError(f"bench {name}: "
                             f"{res['attention_launches_per_forward']} "
                             "attention launches per forward, expected 16")
    if pillars and launches["scatter_max"] < 1:
        raise AssertionError(f"bench {name}: no scatter-max launch")


def phase_bench(data_dir=None):
    """transfuser_torch.tools.bench's functions at BENCH_COUNTS on the
    flagship bf16 at batch 12 with its real-data modes on ``data_dir`` (the
    lifecycle phase's dataset; run alone, two written routes), the same
    with --pillars (no real data), then graft_entry.entry() once."""
    from transfuser_torch.data.synthetic import write_route
    from transfuser_torch.ops import kernels
    from transfuser_torch.tools import bench, graft_entry

    t_phase = time.perf_counter()
    launches = dict.fromkeys(kernels.KERNELS, 0)
    out = {}
    tmp = None
    if data_dir is None:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
        data_dir = tmp
        for i in range(2):
            write_route(os.path.join(tmp, f"route{i}"), 50, seed=i)
    try:
        for name, argv in (("flagship", [f"--real-data={data_dir}"]),
                           ("pillars", ["--pillars", "--no-real-data"])):
            opts = bench.parse_args(argv)
            torch.cuda.synchronize()
            kernels.reset_launches()   # the main path's run starts here
            t0 = time.perf_counter()
            res = bench.run(bench.bench_config(opts), opts,
                            torch.device("cuda", 0), **BENCH_COUNTS)
            seconds = time.perf_counter() - t0
            got = dict(kernels.launches)  # ... and ends here
            bench_checks(name, res, got, opts.pillars)
            for k, v in got.items():
                launches[k] += v
            out[name] = dict(res, seconds=seconds, launches=got)
            torch.cuda.empty_cache()

        forward, args = graft_entry.entry()
        torch.cuda.synchronize()
        kernels.reset_launches()       # the main path's run starts here
        with torch.no_grad():
            result = forward(*args)
        torch.cuda.synchronize()
        got = dict(kernels.launches)   # ... and ends here
        finite = [bool(torch.isfinite(t.float()).all()) for t in result]
        if got["attention"] != 16 or not all(finite):
            raise AssertionError(f"graft_entry: launches {got}, waypoints "
                                 f"/ boxes / labels finite {finite}")
        for k, v in got.items():
            launches[k] += v
        out["graft_entry"] = dict(shapes=[list(t.shape) for t in result],
                                  launches=got)
        del forward, args, result
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("bench", counts=BENCH_COUNTS, **out)
    return launches


# ---------------------------------------------------------------- parallel

PARALLEL_RANKS = 2
PARALLEL_BATCH = 4   # global batch of the fp32 checks: 2 rows per data rank
PARALLEL_TOL = dict(rtol=1e-3, atol=1e-4)  # the train phase's fp32 bound
PILLAR_ZERO_STEPS = 3


def parallel_config(**train):
    """The flagship with dropout off (fp32 checks) or as configured."""
    import dataclasses

    from transfuser_torch.config import GlobalConfig

    cfg = GlobalConfig()
    return cfg.replace(train=dataclasses.replace(cfg.train, **train))


def no_dropout(cfg):
    import dataclasses

    gpt = dataclasses.replace(cfg.model.gpt, embd_pdrop=0.0, attn_pdrop=0.0,
                              resid_pdrop=0.0)
    return cfg.replace(model=dataclasses.replace(cfg.model, gpt=gpt))


def parallel_batch(cfg, seed=5):
    """A global batch whose data halves differ: the second rank's rows
    hold no boxes (its own max(1, peaks) would be 1) and darker images
    (other BatchNorm statistics)."""
    from transfuser_torch.data.synthetic import synthetic_batch

    batch = synthetic_batch(cfg, PARALLEL_BATCH, seed=seed)
    half = PARALLEL_BATCH // 2
    batch["label"][half:] = 0.0
    batch["rgb"][half:] *= 0.25
    return batch


def dict_err(got: dict, want: dict) -> float:
    if set(got) != set(want):
        raise AssertionError(f"keys {sorted(got)} != {sorted(want)}")
    worst = 0.0
    for k, v in want.items():
        err = abs(got[k] - v)
        if not err <= PARALLEL_TOL["atol"] + PARALLEL_TOL["rtol"] * abs(v):
            raise AssertionError(f"{k}: {got[k]} vs {v} beyond rtol "
                                 f"{PARALLEL_TOL['rtol']} / atol "
                                 f"{PARALLEL_TOL['atol']}")
        worst = max(worst, err)
    return worst


def as_floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def parallel_rank(rank: int, job_path: str) -> None:
    """One gloo rank on cuda:0 (the card's GPUs are shared by the ranks):
    (i) data 2: the fp32 train-mode loss dict and eval dict of the global
    batch, then bf16 train steps with the default dropout and an eval
    step; (ii) model 2: the fp32 eval step, its attention shapes, an fp32
    train step with the default dropout, and a bf16 eval step; (iii)
    PointPillars data 2: 3 fp32 train steps with ZeRO-1 on, a ZeRO-1-off
    optimizer stepping beside it on the same gradients, then the ZeRO-1
    state saved and restored into a fresh trainer on the mesh. Writes its
    numbers and the launches of its Trainer steps (the main path) to
    <job out>.<rank>.json."""
    import dataclasses

    import transfuser_torch.models.gpt as gpt
    from transfuser_torch.data.pack import unpack_batch
    from transfuser_torch.data.synthetic import synthetic_batch
    from transfuser_torch.ops import kernels
    from transfuser_torch.parallel.sharding import (MeshSpec, batch_rows,
                                                    init_distributed,
                                                    make_mesh)
    from transfuser_torch.train.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    from transfuser_torch.train.losses import (compute_losses, global_losses,
                                               total_loss)
    from transfuser_torch.train.trainer import Trainer, _model_inputs

    job = json.load(open(job_path))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    init_distributed(device, backend="gloo",
                     init_method=f"tcp://127.0.0.1:{job['port']}",
                     world_size=PARALLEL_RANKS, rank=rank)
    dp = make_mesh(MeshSpec(data=PARALLEL_RANKS, model=1))
    tp = make_mesh(MeshSpec(data=1, model=PARALLEL_RANKS))
    out = {"rank": rank}
    launches = dict.fromkeys(kernels.KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
        return dict(counts)

    def sync():
        torch.cuda.synchronize()

    # (i) data 2, fp32, dropout off
    cfg0 = no_dropout(parallel_config())
    host = parallel_batch(cfg0)
    trainer = Trainer(cfg0, mesh=dp, dtype=torch.float32, device=device)
    batch = trainer.put_batch(batch_rows(host, dp))
    kernels.reset_launches()
    out["dp_eval_fp32"] = as_floats(trainer.eval_step(batch))
    sync()
    out["dp_eval_fp32_launches"] = add(kernels.launches)
    with torch.no_grad():  # train mode: global BatchNorm and normalisers
        trainer.model.train()
        b = unpack_batch(batch)
        args, extra = _model_inputs(b)
        o = trainer.model(*args, **extra, compute_aux=True)
        d = compute_losses(o, b, cfg0, dp.data_group)
        out["dp_train_fp32"] = as_floats(global_losses(
            {"loss_total": total_loss(d, cfg0), **d}, dp.data_group))
    del trainer, batch, o
    torch.cuda.empty_cache()

    # (i) data 2, bf16, the default dropout: the trainer's own steps
    cfg = parallel_config()
    trainer = Trainer(cfg, mesh=dp, dtype=torch.bfloat16, device=device)
    batch = trainer.put_batch(batch_rows(host, dp))
    sync()
    kernels.reset_launches()
    times, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        losses.append(as_floats(trainer.train_step(batch)))
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    out["dp_train_bf16_launches"] = add(kernels.launches)
    out["dp_train_bf16_adamw"] = 2 * adamw_launches(trainer.optimizer)
    out["dp_train_bf16_loss_total"] = [m["loss_total"] for m in losses]
    out["dp_train_bf16_step_ms"] = times
    kernels.reset_launches()
    out["dp_eval_bf16"] = as_floats(trainer.eval_step(batch))
    sync()
    out["dp_eval_bf16_launches"] = add(kernels.launches)
    del trainer, batch
    torch.cuda.empty_cache()

    # (ii) model 2, fp32: each rank's heads
    shapes = []
    attention = gpt.attention

    def recorded(q, k, v):
        shapes.append(list(q.shape))
        return attention(q, k, v)

    gpt.attention = recorded
    try:
        trainer = Trainer(cfg0, mesh=tp, dtype=torch.float32, device=device)
        batch = trainer.put_batch(batch_rows(host, tp))
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out["tp_eval_fp32"] = as_floats(trainer.eval_step(batch))
        sync()
        out["tp_eval_ms"] = (time.perf_counter() - t0) * 1e3
        out["tp_eval_launches"] = add(kernels.launches)
    finally:
        gpt.attention = attention
    out["tp_attention_shapes"] = shapes
    del trainer, batch
    # fp32 train step, the default dropout: the masks are one device's
    trainer = Trainer(cfg, mesh=tp, dtype=torch.float32, device=device)
    batch = trainer.put_batch(batch_rows(host, tp))
    sync()
    kernels.reset_launches()
    out["tp_train_fp32"] = as_floats(trainer.train_step(batch))
    sync()
    out["tp_train_fp32_launches"] = add(kernels.launches)
    out["tp_train_fp32_adamw"] = adamw_launches(trainer.optimizer)
    del trainer, batch
    # bf16: the 2-head shards' rows go through the wrapper's padded copy
    trainer = Trainer(cfg0, mesh=tp, dtype=torch.bfloat16, device=device)
    batch = trainer.put_batch(batch_rows(host, tp))
    sync()
    kernels.reset_launches()
    out["tp_eval_bf16"] = as_floats(trainer.eval_step(batch))
    sync()
    out["tp_eval_bf16_launches"] = add(kernels.launches)
    del trainer, batch
    torch.cuda.empty_cache()

    # (iii) PointPillars, data 2, fp32, the default dropout, ZeRO-1 on.
    # A ZeRO-1-off optimizer over a second copy of the model steps on the
    # same averaged gradients (the backward's atomics make two runs of
    # one step differ on the card, so equal gradients isolate ZeRO-1)
    pcfg = pillar_config()
    phost = synthetic_batch(pcfg, PARALLEL_BATCH, seed=0)
    on, off = (Trainer(pcfg.replace(train=dataclasses.replace(
        pcfg.train, zero_redundancy_optimizer=zero)), mesh=dp,
        dtype=torch.float32, device=device) for zero in (True, False))
    step_on = on.optimizer.step

    def both_steps():
        for p_off, p_on in zip(off.optimizer.params, on.optimizer.params):
            p_off.grad = p_on.grad.clone()
        off.optimizer.advance()
        off.optimizer.step()
        step_on()

    on.optimizer.step = both_steps
    batch = on.put_batch(batch_rows(phost, dp))
    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(PILLAR_ZERO_STEPS):
        loss = on.train_step(batch)["loss_total"]
    sync()
    out["pillar_ms_per_step"] = \
        (time.perf_counter() - t0) * 1e3 / PILLAR_ZERO_STEPS
    out["pillar_launches"] = add(kernels.launches)
    out["pillar_adamw"] = PILLAR_ZERO_STEPS * (
        adamw_launches(on.optimizer) + adamw_launches(off.optimizer))
    out["pillar_loss_total"] = float(loss)
    theirs = dict(off.model.named_parameters())
    diffs = {k: float((p.detach() - theirs[k].detach()).abs().max())
             for k, p in on.model.named_parameters()}
    out["zero_on_vs_off"] = max(diffs.values())
    out["zero_moments_kept"] = [len(on.optimizer.owned),
                                len(on.optimizer.params)]
    # the ZeRO-1 state written (rank 0) and restored on the mesh: rank 0
    # reads, broadcasts tensor by tensor, each rank keeps its moments
    ckpt = os.path.join(os.path.dirname(job["out"]), "pillar_ckpt")
    save_checkpoint(ckpt, on.model, on.optimizer, PILLAR_ZERO_STEPS)
    again = Trainer(on.config, mesh=dp, dtype=torch.float32, device=device)
    step = restore_checkpoint(ckpt, PILLAR_ZERO_STEPS, again.model,
                              again.optimizer)
    mine, theirs = on.optimizer.state_dict(), again.optimizer.state_dict()
    errs = [float((a - b).abs().max()) for a, b in zip(
        list(on.model.state_dict().values()) + mine["mu"] + mine["nu"],
        list(again.model.state_dict().values()) + theirs["mu"] +
        theirs["nu"]) if a.is_floating_point()]
    out["zero_restore"] = {"step": step, "max_abs_err": max(errs),
                           "tensors": len(errs)}
    del on, off, again, batch
    torch.cuda.empty_cache()
    out["launches"] = launches
    with open(f"{job['out']}.{rank}.json", "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def torchrun_cli(job_path: str) -> None:
    """A torchrun worker: the training CLI from ``env://`` (NCCL), its
    process group's backend and size, and its kernel launches."""
    from transfuser_torch.ops import kernels
    from transfuser_torch.train import cli

    job = json.load(open(job_path))
    seen = {}
    train = cli._train

    def recorded(args, device):
        seen.update(backend=torch.distributed.get_backend(),
                    world=torch.distributed.get_world_size(),
                    device=str(device))
        return train(args, device)

    cli._train = recorded
    kernels.reset_launches()
    summary = cli.main(job["argv"])
    with open(job["out"], "w") as f:
        json.dump(dict(seen, launches=dict(kernels.launches),
                       history=summary["history"]), f)


def phase_parallel():
    """Two gloo ranks sharing cuda:0 drive the trainer under a mesh:
    (i) the flagship at data 2, (ii) at model 2 (tensor parallel; an
    eval step and a train step with dropout against one process), (iii)
    PointPillars at data 2 with ZeRO-1, its state saved and restored on
    the mesh; then (iv) the training CLI under ``torchrun
    --nproc_per_node 1`` with NCCL at world size 1."""
    from transfuser_torch.data.pack import unpack_batch
    from transfuser_torch.data.synthetic import write_route
    from transfuser_torch.models import LidarCenterNet
    from transfuser_torch.ops import kernels
    from transfuser_torch.train.losses import compute_losses, total_loss
    from transfuser_torch.train.trainer import (Trainer, _model_inputs,
                                                make_eval_step)

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    # the single-process references: the same seeded weights, the whole
    # global batch (outside the launch count)
    cfg0 = no_dropout(parallel_config())
    model = LidarCenterNet(cfg0, dtype=torch.float32, device="cuda", seed=0)
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in parallel_batch(cfg0).items()}
    ref_eval = as_floats(make_eval_step(model, cfg0)(batch))
    with torch.no_grad():  # after the eval: it updates the running stats
        model.train()
        b = unpack_batch(batch)
        args, extra = _model_inputs(b)
        d = compute_losses(model(*args, **extra, compute_aux=True), b, cfg0)
        ref_train = as_floats({"loss_total": total_loss(d, cfg0), **d})
    # a train step with the default dropout, from the trainer's generator
    one = Trainer(parallel_config(), dtype=torch.float32, device="cuda")
    ref_dropout = as_floats(one.train_step(batch))
    del model, batch, one
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    out = {"backend": "gloo", "ranks": PARALLEL_RANKS, "device": "cuda:0",
           "global_batch": PARALLEL_BATCH, "tolerance": PARALLEL_TOL}
    launches = dict.fromkeys(kernels.KERNELS, 0)
    try:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump({"port": port, "out": os.path.join(tmp, "rank")}, f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             str(r), job], cwd=here, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(PARALLEL_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"parallel rank {r} exited "
                                     f"{p.returncode}:\n{log[-3000:]}")
        out["ranks_s"] = time.perf_counter() - t0
        ranks = [json.load(open(os.path.join(tmp, f"rank.{r}.json")))
                 for r in range(PARALLEL_RANKS)]
        per_rank = []
        for res in ranks:
            for key in ("dp_train_fp32", "dp_eval_fp32", "tp_eval_fp32",
                        "tp_train_fp32"):
                if res[key] != ranks[0][key]:
                    raise AssertionError(f"{key} differs between ranks")
            row = {"rank": res["rank"],
                   "dp_train_fp32_max_abs_err": dict_err(
                       res["dp_train_fp32"], ref_train),
                   "dp_eval_fp32_max_abs_err": dict_err(
                       res["dp_eval_fp32"], ref_eval),
                   "tp_eval_fp32_max_abs_err": dict_err(
                       res["tp_eval_fp32"], ref_eval),
                   "tp_train_dropout_fp32_max_abs_err": dict_err(
                       res["tp_train_fp32"], ref_dropout)}
            # a train step's AdamW launches: the rank's own launch plan
            # over the parameters it owns, as the rank counted them
            want = {"dp_eval_fp32_launches": {"attention": 16,
                                              "scatter_max": 0, "adamw": 0},
                    "dp_train_bf16_launches": {
                        "attention": 0, "scatter_max": 0,
                        "adamw": res["dp_train_bf16_adamw"]},
                    "dp_eval_bf16_launches": {"attention": 16,
                                              "scatter_max": 0, "adamw": 0},
                    "tp_eval_launches": {"attention": 16, "scatter_max": 0,
                                         "adamw": 0},
                    "tp_train_fp32_launches": {
                        "attention": 0, "scatter_max": 0,
                        "adamw": res["tp_train_fp32_adamw"]},
                    "tp_eval_bf16_launches": {"attention": 16,
                                              "scatter_max": 0, "adamw": 0}}
            want["pillar_launches"] = {"attention": 0,
                                       "scatter_max": PILLAR_ZERO_STEPS,
                                       "adamw": res["pillar_adamw"]}
            if min(res[k] for k in ("dp_train_bf16_adamw",
                                    "tp_train_fp32_adamw",
                                    "pillar_adamw")) < 1:
                raise AssertionError(f"rank {res['rank']}: a train step "
                                     "without an AdamW launch")
            for key, counts in want.items():
                if res[key] != counts:
                    raise AssertionError(f"rank {res['rank']} {key} "
                                         f"{res[key]}, expected {counts}")
            heads = {tuple(s[:3]) for s in res["tp_attention_shapes"]}
            if heads != {(PARALLEL_BATCH, 174, 2)}:
                raise AssertionError(f"tensor-parallel attention shapes "
                                     f"{res['tp_attention_shapes']}")
            if not np.isfinite(res["dp_train_bf16_loss_total"] +
                               list(res["dp_eval_bf16"].values()) +
                               list(res["tp_eval_bf16"].values())).all():
                raise AssertionError(f"non-finite bf16 losses {res}")
            kept, total = res["zero_moments_kept"]
            if not kept < total:
                raise AssertionError(f"ZeRO-1 kept {kept} of {total} "
                                     "parameters' moments")
            if res["zero_on_vs_off"] != 0.0:
                raise AssertionError(
                    f"ZeRO-1 on vs off: parameters differ by "
                    f"{res['zero_on_vs_off']} after {PILLAR_ZERO_STEPS} "
                    f"steps on the same gradients")
            restored = res["zero_restore"]
            if restored["step"] != PILLAR_ZERO_STEPS or \
                    restored["max_abs_err"] != 0.0:
                raise AssertionError(f"ZeRO-1 state restored on the mesh: "
                                     f"{restored}")
            row.update({k: res[k] for k in (
                "dp_train_bf16_loss_total", "dp_train_bf16_step_ms",
                "tp_eval_ms", "pillar_ms_per_step", "pillar_loss_total",
                "zero_on_vs_off", "zero_moments_kept", "zero_restore",
                "launches")})
            row["tp_attention_shapes"] = sorted(
                {tuple(s) for s in res["tp_attention_shapes"]})
            per_rank.append(row)
            for k, v in res["launches"].items():
                launches[k] += v
        out["per_rank"] = per_rank

        # (iv) torchrun, one process, NCCL, on a written dataset
        root, logdir = os.path.join(tmp, "data"), os.path.join(tmp, "log")
        write_route(os.path.join(root, "T", "Town01_route0"), 13, seed=20)
        write_route(os.path.join(root, "T", "Town02_route0"), 11, seed=21)
        cli_job = os.path.join(tmp, "cli.json")
        with open(cli_job, "w") as f:
            json.dump({"out": os.path.join(tmp, "cli_out.json"), "argv": [
                "--root_dir", root, "--logdir", logdir, "--setting",
                "02_05_withheld", "--epochs", "1", "--batch_size", "2",
                "--val_every", "1", "--num_workers", "2"]}, f)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", os.path.abspath(__file__),
             "--torchrun-cli", cli_job], cwd=here, capture_output=True,
            text=True, timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"torchrun CLI exited {run.returncode}:\n"
                                 f"{(run.stdout + run.stderr)[-3000:]}")
        res = json.load(open(os.path.join(tmp, "cli_out.json")))
        if (res["backend"], res["world"], res["device"]) != \
                ("nccl", 1, "cuda:0"):
            raise AssertionError(f"torchrun CLI ran on {res}")
        if res["launches"]["attention"] != 16 or \
                not np.isfinite(res["history"][0]["loss_total"]):
            raise AssertionError(f"torchrun CLI: {res}")
        out["torchrun_cli"] = dict(res, seconds=time.perf_counter() - t0)
        for k, v in res["launches"].items():
            launches[k] += v
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit("parallel", **out)
    return launches


def main() -> int:
    argv = sys.argv[1:]
    if "--parallel-rank" in argv:  # a rank of the parallel phase
        i = argv.index("--parallel-rank")
        parallel_rank(int(argv[i + 1]), argv[i + 2])
        return 0
    if "--torchrun-cli" in argv:  # the parallel phase's torchrun worker
        torchrun_cli(argv[argv.index("--torchrun-cli") + 1])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec("transfuser_torch") is None:
        print("chip_smoke: the transfuser_torch package is not beside this "
              "script; run it from a checkout of the repository",
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

    if "--only" in argv:  # development: just the named phases
        for name in argv[argv.index("--only") + 1:]:
            globals()[f"phase_{name}"]()
        print("chip_smoke: partial run (--only), no result", file=sys.stderr)
        return 0

    phase_native()
    floor_ms = phase_launch_floor()
    numbers = {"attention": phase_kernels()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    numbers["scatter_max"] = phase_scatter_max(gen)
    numbers["adamw"] = phase_adamw()
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
    bench_data = tempfile.mkdtemp(prefix="chip_smoke_bench_data_")
    expert_data = os.path.join(bench_data, "grid")
    try:
        for phase in (lambda: phase_agent(cfg, state),
                      lambda: phase_closed_loop(cfg, state),
                      phase_family_forward_ego, phase_config_forward_ego,
                      phase_family_agents,
                      phase_geometric_train,
                      lambda: phase_pillars_forward_ego(pillar_config()),
                      lambda: phase_train(pillar_config(), profile=profile),
                      phase_cli,
                      lambda: phase_lifecycle(keep_data=expert_data),
                      lambda: phase_bench(expert_data), phase_parallel):
            for name, count in phase().items():
                launches[name] += count
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(bench_data, ignore_errors=True)

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
