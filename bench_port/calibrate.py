"""The readings that the limits of ``correct`` are set from, for one cell,
in one process (the set-up is paid once per seed, the build once):

    python3 -m bench_port.calibrate --workload <name> --seeds 1,2,3 \
        [--seconds 4] [--control] [--fault <name>] [--out file.jsonl]

For each seed, one run of the cell by ``run.py``'s own path
(``harness.drive``, a window of ``--seconds``), then every number the
cell's driver compares: the program's and, with ``--control``, the
control's (the reference in the nearest lower precision, fp8, put in the
program's place). ``--fault`` plants one of ``faults.py``'s faults in the
program for every run. One JSON line per seed; the smallest and largest
reading of each number at the end. Not run by the benchmark's own runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from bench_port import faults, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    harness.cache_dirs()
    import torch

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.prepare(args.workload, seed, args.seconds, False,
                              time.perf_counter())
        device, why = harness.main_device(int(run.workload["chips"]))
        if device is None:
            harness.log(f"no result: {why}")
            return 2
        run.device = device
        run.card = torch.cuda.get_device_name(device)
        t0 = time.perf_counter()
        fault = faults.planted(args.fault) if args.fault else \
            contextlib.nullcontext()
        with fault:
            driver, outcome = harness.drive(run)
        row = dict(seed=seed, fault=args.fault, correct=run.correct(),
                   program=run.readings, e2e=run.e2e, setup_s=run.setup_s,
                   units=run.units, host=run.load)
        if args.control:
            row["control"] = driver.compare(run, outcome, control=True)
        del outcome
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    for who in ["program"] + (["control"] if args.control else []):
        keys = rows[0][who]
        span = {k: [min(r[who][k] for r in rows), max(r[who][k] for r in rows)]
                for k in keys}
        print(json.dumps({"who": who, "fault": args.fault, "min_max": span}),
              flush=True)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded {', '.join(bad)}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
