"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
units of the cell's work, reduced to what the per-layer readers and the
result's ``device`` and ``breakdown`` need. Events are read from the
profiler's raw results (no per-event Python objects are built).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

WINDOW = "bench.window"
TOP = 10


@dataclass
class Trace:
    """Device events of the traced window (ns, the trace's clock)."""
    names: List[str]
    start: np.ndarray
    end: np.ndarray
    kernel: np.ndarray          # bool: a kernel (not a copy or a memset)
    window_start: int
    window_end: int
    units: int = 0              # compute frames or train steps traced
    host: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window_end - self.window_start) / 1e9

    def busy_intervals(self) -> np.ndarray:
        """Union of the device events' intervals inside the window."""
        s = np.clip(self.start, self.window_start, self.window_end)
        e = np.clip(self.end, self.window_start, self.window_end)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        merged = []
        cur_s = cur_e = None
        for a, b in zip(s.tolist(), e.tolist()):
            if cur_e is None or a > cur_e:
                if cur_e is not None:
                    merged.append((cur_s, cur_e))
                cur_s, cur_e = a, b
            elif b > cur_e:
                cur_e = b
        if cur_e is not None:
            merged.append((cur_s, cur_e))
        return np.array(merged, dtype=np.int64).reshape(-1, 2)

    @property
    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def kernel_count(self) -> int:
        return int(self.kernel.sum())

    def device_s_matching(self, patterns) -> float:
        """Summed device time of kernels whose name holds any pattern."""
        total = 0
        for n, s, e, k in zip(self.names, self.start, self.end, self.kernel):
            if k and any(p in n for p in patterns):
                total += int(e - s)
        return total / 1e9

    def device_ops(self):
        by = {}
        for n, s, e in zip(self.names, self.start.tolist(),
                           self.end.tolist()):
            by[n] = by.get(n, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], v / 1e9] for n, v in top]

    def idle_gaps(self):
        """Idle time between device work, summed by what the host was doing
        at each gap's middle: the innermost traced operation of any thread
        (the backward runs on autograd's own thread)."""
        iv = self.busy_intervals()
        edges = np.concatenate([[self.window_start], iv.reshape(-1),
                                [self.window_end]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        hs, he, hn = (self.host.get(k) for k in ("start", "end", "names"))
        by: Dict[str, float] = {}
        if hs is None or len(hs) == 0:
            return [["host", float((gaps[:, 1] - gaps[:, 0]).sum()) / 1e9]]
        longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:4000]
        for a, b in longest.tolist():
            mid = (a + b) // 2
            i = int(np.searchsorted(hs, mid, side="right"))
            lo = max(0, i - 20000)
            cover = np.nonzero(he[lo:i] > mid)[0]
            label = hn[lo + cover[-1]] if len(cover) else "untraced host"
            by[label] = by.get(label, 0.0) + (b - a) / 1e9
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:160], v] for n, v in top]


@contextlib.contextmanager
def traced(sync):
    """Profile the body; yields a dict that holds the ``Trace`` after the
    body returns. ``sync`` waits for the device before the window
    closes."""
    from torch.profiler import ProfilerActivity, profile

    holder: Dict[str, Trace] = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            yield holder
            sync()
    t0 = time.perf_counter()
    holder["trace"] = reduce(prof.profiler.kineto_results.events())
    holder["reduce_s"] = time.perf_counter() - t0


def reduce(events) -> Trace:
    """Device events, and the host's operations (not the CUDA runtime's
    calls or the profiler's own)."""
    from torch.autograd import DeviceType

    names, starts, ends = [], [], []
    hn, hs, he = [], [], []
    w0 = w1 = None
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():  # a host span mirrored on the card
                continue
            names.append(e.name())
            starts.append(e.start_ns())
            ends.append(e.end_ns())
            continue
        name = e.name()
        if name == WINDOW:
            w0, w1 = e.start_ns(), e.end_ns()
        elif not name.startswith(("cuda", "Activity Buffer")):
            hn.append(name)
            hs.append(e.start_ns())
            he.append(e.end_ns())
    if w0 is None:
        raise RuntimeError("the traced window's span is missing")
    kernel = np.array([not (n.startswith("Memcpy") or n.startswith("Memset"))
                       for n in names], dtype=bool)
    order = np.argsort(np.array(hs, dtype=np.int64), kind="stable")
    host = dict(start=np.array(hs, dtype=np.int64)[order],
                end=np.array(he, dtype=np.int64)[order],
                names=np.array(hn, dtype=object)[order])
    return Trace(names, np.array(starts, dtype=np.int64),
                 np.array(ends, dtype=np.int64), kernel, w0, w1, host=host)
