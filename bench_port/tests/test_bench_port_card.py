"""A short run of each cell on the card (skips without one):

    python -m pytest bench_port/tests/test_bench_port_card.py -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

from bench_port import harness

ROOT = os.path.dirname(harness.HERE)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.spec()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", workload,
         "--seed", "2147483999", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"] or trace
    assert list(res)[-1] == "checks"
