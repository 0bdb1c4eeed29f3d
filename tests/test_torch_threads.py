"""Torch's CPU thread pool in the port's test files.

The suite runs under pytest-xdist, several workers on one host's cores.
Torch's intra-op pool takes every core in each worker, and its threads
wait by spinning, so several full pools on one host slow each other down
many times over (a test of a few seconds alone took minutes beside five
others). Each port test file therefore takes this module's autouse
fixture: torch gets the worker's share of the cores (the cores over the
workers, at least 1; every core outside xdist) while the file runs, and
the subprocesses the file starts get the same through OMP_NUM_THREADS.
The files that pin a count of their own (test_torch_train.py,
test_torch_families.py, test_torch_lifecycle.py: 2 threads) keep it: a
train step's fp32 gradients depend on the summation order, and so on
the thread count.

    from test_torch_threads import torch_threads_per_worker  # noqa: F401
"""

import contextlib
import os
import subprocess
import sys

import pytest
import torch


def worker_share() -> int:
    """This process's share of the cores: all of them outside xdist,
    else the cores over the xdist workers, at least 1."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // max(1, workers))


@contextlib.contextmanager
def torch_threads(n: int):
    """torch.set_num_threads(n) and OMP_NUM_THREADS=n inside, both
    restored after."""
    before, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(n)
    os.environ["OMP_NUM_THREADS"] = str(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module", autouse=True)
def torch_threads_per_worker():
    with torch_threads(worker_share()):
        yield


@pytest.mark.parametrize("workers, cores, want", [
    (None, 8, 8), ("6", 8, 1), ("4", 8, 2), ("16", 8, 1), ("2", 7, 3)])
def test_worker_share_divides_the_cores(monkeypatch, workers, cores, want):
    if workers is None:
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    else:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: range(cores))
    assert worker_share() == want


def test_threads_reach_subprocesses_and_are_restored():
    before = torch.get_num_threads()
    with torch_threads(1):
        assert torch.get_num_threads() == 1
        out = subprocess.run(
            [sys.executable, "-c",
             "import torch; print(torch.get_num_threads())"],
            capture_output=True, text=True, check=True).stdout
        assert int(out) == 1
    assert torch.get_num_threads() == before
