"""The card's idle time in the traced window that no ``agent.run_step``
span covers, as a share of the window: where the device waits on the
host outside the program (the cell's own loop, the profiler)."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "agent.run_step"):
        return None
    return spans.idle_outside_pct(t, "agent.run_step")
