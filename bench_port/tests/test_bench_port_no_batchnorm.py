"""The training comparison of a model with no BatchNorm: ``numbers``
leaves ``bn_stats_gap`` out where the reference has no running
statistics, and where it has them computes every number bit for bit as
before; a limit on the missing number fails the run."""

import math

import torch

from bench_port import harness
from bench_port.drivers import train

# ``numbers(*pair(stats=True))``, computed before a model could lack
# running statistics
PARENT = {
    "loss1_gap": 3.0769230769295705e-05,
    "loss_gap": 0.000382608695652209,
    "grad_gap": 0.008999999999999913,
    "grad_gap_p90": 0.00819999999999999,
    "grad_gap_median": 0.004999999999999825,
    "update_gap": 0.00999999999999994,
    "update_gap_p90": 0.009720000000000024,
    "update_gap_median": 0.007200000000000016,
    "bn_stats_gap": 0.0015090495974965637,
}


def pair(stats: bool):
    """A fixed (program, reference) pair of a training stretch's readings:
    three losses, nine leaves' gradient and change norms (the first leaf's
    reference gradient under ``UNMOVED`` of the median's) and, with
    ``stats``, four BatchNorm running statistics' changes."""
    names = [f"leaf{i}" for i in range(9)]
    grad = {n: 0.05 * (i + 1) ** 1.5 for i, n in enumerate(names)}
    grad["leaf0"] = 1e-7
    change = {n: 1e-3 * (9 - i) for i, n in enumerate(names)}

    def off(d, eps):
        return {n: v * (1 + eps * (-1) ** i * (i + 1))
                for i, (n, v) in enumerate(d.items())}

    want = dict(loss=[3.25, 3.0, 2.875], grad=grad, change=change, stats={})
    got = dict(loss=[3.2501, 2.9996, 2.8761], grad=off(grad, 1e-3),
               change=off(change, 2e-3), stats={})
    if stats:
        noise = torch.tensor([((7 * j) % 5 - 2) * 1e-4 for j in range(16)])
        for i in range(4):
            key = f"bn{i}." + ("running_mean", "running_var")[i % 2]
            v = (torch.arange(16, dtype=torch.float32) * 0.125 - 1.0) \
                * 2.0 ** -i
            want["stats"][key] = v
            got["stats"][key] = v + noise * (i + 1)
    return got, want


def test_numbers_with_running_statistics_are_unchanged():
    assert train.numbers(*pair(stats=True)) == PARENT


def test_numbers_without_running_statistics_leave_the_gap_out():
    out = train.numbers(*pair(stats=False))
    assert "bn_stats_gap" not in out
    assert out == {k: v for k, v in PARENT.items() if k != "bn_stats_gap"}


def _run(limits):
    return harness.Run(workload={"name": "x.train"}, config={}, mix={},
                       limits=limits, seed=0, seconds=1.0, trace=False,
                       t_start=0.0)


def test_a_limit_on_the_missing_gap_fails():
    limits = {"bn_stats_gap": {"limit": 0.006},
              "grad_gap_median": {"limit": 0.25}}
    with_stats = _run(limits)
    with_stats.judge(train.numbers(*pair(stats=True)))
    assert with_stats.correct(), with_stats.checks
    without = _run(limits)
    without.judge(train.numbers(*pair(stats=False)))
    assert not without.correct()
    assert without.checks["bn_stats_gap"][0] == math.inf
    assert without.checks["grad_gap_median"] == \
        with_stats.checks["grad_gap_median"]
