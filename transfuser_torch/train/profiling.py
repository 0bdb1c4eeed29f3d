"""Tracing/profiling: per-stage step timing + torch.profiler traces
(counterpart of transfuser_tpu/train/profiling.py).

The reference has no profiler integration (SURVEY.md §5.1); here step
timing is a first-class metric and device traces come from torch.profiler
on demand.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np


class StepTimer:
    """Wall-clock stage timing with percentile summaries.

    Usage:
        timer = StepTimer()
        with timer.stage("data"):   batch = next(it)
        with timer.stage("step"):   metrics = train_step(batch)
        timer.summary() -> {"data_p50_ms": ..., "step_p50_ms": ...}

    A stage that launches device work measures its enqueue unless it ends
    in a synchronisation.
    """

    def __init__(self, window: int = 200):
        self.window = window
        self._samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            samples = self._samples[name]
            samples.append((time.perf_counter() - t0) * 1e3)
            if len(samples) > self.window:
                del samples[: len(samples) - self.window]

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, samples in self._samples.items():
            arr = np.asarray(samples)
            out[f"{name}_p50_ms"] = float(np.percentile(arr, 50))
            out[f"{name}_p95_ms"] = float(np.percentile(arr, 95))
            out[f"{name}_mean_ms"] = float(arr.mean())
        return out

    def throughput(self, stage: str, items_per_step: int) -> float:
        samples = self._samples.get(stage)
        if not samples:
            return 0.0
        return items_per_step / (np.mean(samples) / 1e3)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block (host and, with a card, CUDA
    activity), written as a Chrome trace ``trace.json`` under ``logdir``;
    a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
