"""One run of one benchmark cell of the PyTorch port:

    python3 -m bench_port.run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of the repository. ``BENCHMARK.json`` names the cells; the
cell's configuration, traffic mix and limits are found by name under
``bench_port/``. The last line of standard output is the result (JSON);
the numbers that decide ``correct`` are the last lines of standard
error. Exits non-zero, with no result, where there is no CUDA card or
fewer than the cell asks for, and where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a file: bench_port/run.py
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from bench_port import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_dirs()
    run = harness.prepare(args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START)
    device, why = harness.main_device(int(run.workload["chips"]))
    if device is None:
        harness.log(f"no result: {why}")
        return 2
    import torch

    run.device = device
    run.card = torch.cuda.get_device_name(device)
    harness.drive(run)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"no result: loaded {', '.join(bad)}")
        return 3
    out = harness.result(run)
    harness.print_checks(run)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
