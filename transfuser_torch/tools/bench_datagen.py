"""(Copy of transfuser_tpu/tools/bench_datagen.py without the device pin:
the DataAgent is numpy-only and never takes a device.)

Hermetic full-size datagen for the real-data benchmark.

Drives the DataAgent (expert + sensor/label writers, full datagen rig:
3x rgb/semantics/depth cams + lidar, reference data_agent.py:87-165) over
grid-town straight routes with the DEFAULT GlobalConfig, writing the
on-disk dataset layout `CarlaDataset` reads (rgb/ depth/ semantics/
lidar/ topdown/ label_raw/ measurements/).

An input-pipeline throughput number (reference surface: the 8-worker
pinned DataLoader, train.py:156-163) must be measured against real
decode work, not synthetic arrays already in memory.

Host-only (numpy + the hermetic sim).

Usage: python -m transfuser_torch.tools.bench_datagen <out_dir> \
           [--routes 4] [--ticks 600]
"""

from __future__ import annotations

import math
import os
import sys
from typing import List

# Written at the end of a successful generate(); consumers re-generate when
# the marker is absent (partial datasets are not silently measured).
COMPLETE_MARKER = ".bench_datagen_complete"


def generate(out_dir: str, n_routes: int = 4, ticks: int = 600) -> int:
    """Write `n_routes` route dirs under out_dir; returns total saved
    frames (DataAgent saves every save_freq'th tick, 0.5 s)."""
    import numpy as np

    from ..agents.data_agent import DataAgent
    from ..harness.evaluator import default_sensor_feeder
    from ..harness.route_parser import (downsample_route,
                                        interpolate_trajectory,
                                        location_route_to_gps)
    from ..sim.replay import ReplaySimulation
    from ..sim.types import Location, Rotation, Transform

    def straight(x0: float, y0: float, yaw: float,
                 length: float = 240.0) -> List[Transform]:
        c, s = math.cos(math.radians(yaw)), math.sin(math.radians(yaw))
        return [Transform(Location(x0 + c * d, y0 + s * d),
                          Rotation(yaw=yaw))
                for d in np.arange(0.0, length, 10.0)]

    # Both axes and directions so steering/speed supervision is varied.
    starts = [(12.0, -1.75, 0.0), (148.0, 1.75, 180.0),
              (1.75, 12.0, 90.0), (-1.75, 148.0, 270.0),
              (12.0, 78.25, 0.0), (148.0, 81.75, 180.0),
              (81.75, 12.0, 90.0), (78.25, 148.0, 270.0)]
    total = 0
    # The agent reads SAVE_PATH at construction; restore the caller's value
    # so an in-process call can't leak the bench dir into agents
    # constructed later.
    prev_save_path = os.environ.get("SAVE_PATH")
    os.environ["SAVE_PATH"] = out_dir  # agent writes out_dir/route{ri}
    try:
        for ri in range(n_routes):
            agent = DataAgent(route_index=ri)
            dense = interpolate_trajectory(
                straight(*starts[ri % len(starts)]))
            sparse = [dense[i] for i in downsample_route(dense, 50.0)]
            agent.set_global_plan(location_route_to_gps(sparse), sparse)
            for spec in agent.sensors():
                agent.sensor_interface.register_sensor(spec["id"],
                                                       spec["type"])
            sim = ReplaySimulation([t for t, _ in dense])
            agent.sim = sim
            for _ in range(ticks):
                default_sensor_feeder(sim, agent)
                sim.apply_control(agent(sim.game_time))
                sim.tick()
            n = len(os.listdir(agent.save_path / "measurements"))
            total += n
            print(f"[bench_datagen] route {ri}: {n} frames",
                  file=sys.stderr, flush=True)
    finally:
        if prev_save_path is None:
            os.environ.pop("SAVE_PATH", None)
        else:
            os.environ["SAVE_PATH"] = prev_save_path
    # Completion marker: a partial generation (crash mid-route) without it
    # would otherwise be silently measured as a complete dataset.
    with open(os.path.join(out_dir, COMPLETE_MARKER), "w") as f:
        f.write(f"{total}\n")
    return total


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    p.add_argument("--routes", type=int, default=4)
    p.add_argument("--ticks", type=int, default=600)
    args = p.parse_args(argv)
    n = generate(args.out_dir, args.routes, args.ticks)
    print(f"[bench_datagen] wrote {n} frames to {args.out_dir}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
