"""CUDA kernels per training step, counted in the profiler's trace of the
traced steps (copies and memsets are not kernels)."""


def read(run):
    t = run.traced
    if t is None or not t.units:
        return None
    return t.kernel_count() / t.units
