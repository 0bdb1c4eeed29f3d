"""A CPU-sized run of a cell: the cell's files with the configuration cut
to the port's test size (64x128 camera crop, 64x64 LiDAR grid, the
reference module's ``TINY_TRUNK`` for both trunks (micro RegNetY for
``model``), one GPT layer, a 2,000-point pillar cloud on an 8 m grid), so
that the harness's tests drive the whole path on the CPU."""

from __future__ import annotations

import copy
import time

import torch

from bench_port import harness


def tiny_config(config: dict) -> dict:
    trunk = harness.reference(config).TINY_TRUNK
    c = copy.deepcopy(config)
    g = c["config"]
    g["sensors"].update(img_resolution=[64, 128], lidar_resolution_width=64,
                        lidar_resolution_height=64)
    g["bev"].update(bev_resolution_width=40, bev_resolution_height=40)
    m = g["model"]
    m.update(image_architecture=trunk, lidar_architecture=trunk,
             perception_output_features=128, deconv_channel_num_1=32,
             deconv_channel_num_2=16, deconv_channel_num_3=8)
    m["gpt"]["n_layer"] = 1
    m["point_pillars"].update(max_lidar_points=2000, min_x=-4.0, max_x=4.0,
                              min_y=-8.0, max_y=0.0)
    return c


def tiny_run(workload: str, seed: int = 3, seconds: float = 1.0,
             trace: bool = False, **mix) -> harness.Run:
    run = harness.prepare(workload, seed, seconds, trace,
                          time.perf_counter())
    run.config = tiny_config(run.config)
    run.mix = dict(run.mix, **mix)
    if "valid_points" in run.mix:
        run.mix["valid_points"] = 2000
        run.mix["lidar_xy_m"] = 6.0
    if "batch" in run.mix:
        run.mix["batch"] = 2
    run.device = torch.device("cpu")
    run.card = "H100 80GB HBM3"  # the peak table's row for the readers
    return run
