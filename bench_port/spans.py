"""The program's own spans in the traced units of a ``--trace 1`` run.

The port opens a ``torch.profiler.record_function`` range at each layer
boundary (``transfuser_torch/tracing.py``), named ``<layer>.<stage>``:
``agent.run_step``, ``model.fusion``, ``kernels.attention``,
``train.backward``, ... They are host events of the trace
(``Trace.host``), on the clock of its device events. The readers in
``metrics/`` that read them use what is here.

A span's self time is its duration less the time that the program's spans
nested inside it cover; it keeps the ATen work it makes itself. Where the
traced units hold no root span (a program that opens none) a reader
returns None; where the root is there and a stage's span is not (a stage
captured in a CUDA graph, say), the stage reads 0.0.
"""

from __future__ import annotations

import numpy as np

LAYERS = ("agent.", "model.", "kernels.", "train.")


def _named(t, pick) -> np.ndarray:
    """(n, 2) start and end (ns) of the host events whose name ``pick``
    accepts, in order of start."""
    hs, he, hn = (t.host.get(k) for k in ("start", "end", "names"))
    if hs is None or len(hs) == 0:
        return np.zeros((0, 2), np.int64)
    keep = np.fromiter((pick(n) for n in hn), bool, len(hn))
    return np.stack([hs[keep], he[keep]], axis=1).astype(np.int64)


def spans(t, name: str) -> np.ndarray:
    """The spans called ``name``."""
    return _named(t, lambda n: n == name)


def program_spans(t) -> np.ndarray:
    """Every span the program opened."""
    return _named(t, lambda n: n.startswith(LAYERS))


def holds(outer: np.ndarray, inner: np.ndarray) -> np.ndarray:
    """(len(outer), len(inner)): whether each interval of ``outer`` holds
    each of ``inner``."""
    return ((inner[None, :, 0] >= outer[:, None, 0])
            & (inner[None, :, 1] <= outer[:, None, 1]))


def inside(inner: np.ndarray, outer: np.ndarray) -> np.ndarray:
    """Which of ``inner`` lie within some interval of ``outer``."""
    return holds(outer, inner).any(axis=0)


def union(iv: np.ndarray) -> np.ndarray:
    """The intervals merged into disjoint ones, in order."""
    if len(iv) == 0:
        return np.zeros((0, 2), np.int64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:], len(iv)) - 1
    return np.stack([iv[first, 0], reach[last]], axis=1)


def covered(merged: np.ndarray, a, b) -> np.ndarray:
    """Time that the disjoint, ordered intervals ``merged`` cover inside
    each [a, b]."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    if len(merged) == 0:
        return np.zeros(np.broadcast(a, b).shape, np.int64)
    s, e = merged[:, 0], merged[:, 1]
    before = np.concatenate([[0], np.cumsum(e - s)])

    def upto(x):  # the covered time up to x
        i = np.searchsorted(s, x, side="right")
        j = np.maximum(i - 1, 0)
        part = np.clip(np.minimum(x, e[j]) - s[j], 0, None)
        return np.where(i > 0, before[j] + part, 0)

    return np.maximum(upto(b) - upto(a), 0)


def total_s(iv: np.ndarray) -> float:
    return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9


def self_s(t, name: str) -> float:
    """Summed self time of the spans called ``name``."""
    mine = spans(t, name)
    every = program_spans(t)
    total = 0
    for s, e in mine.tolist():
        within = every[(every[:, 0] >= s) & (every[:, 1] <= e)]
        # the span itself is among them, once
        own = np.nonzero((within[:, 0] == s) & (within[:, 1] == e))[0][:1]
        children = union(np.delete(within, own, axis=0))
        total += (e - s) - int((children[:, 1] - children[:, 0]).sum())
    return total / 1e9


def has_root(t, root: str) -> bool:
    return t is not None and t.units > 0 and len(spans(t, root)) > 0


def per_unit_ms(t, seconds: float) -> float:
    return 1e3 * seconds / t.units


def compute_frames(t) -> np.ndarray:
    """The ``agent.run_step`` spans that enclose a member's forward: the
    compute frames (action-repeat frames run none)."""
    steps = spans(t, "agent.run_step")
    return steps[holds(steps, spans(t, "model.forward_ego")).any(axis=1)]


def idle_outside_pct(t, root: str) -> float:
    """100 x the window's device-idle time that no ``root`` span covers,
    over the window."""
    w0, w1 = t.window_start, t.window_end
    busy = t.busy_intervals()
    roots = union(np.clip(spans(t, root), w0, w1))
    busy_s = int((busy[:, 1] - busy[:, 0]).sum())
    roots_s = int((roots[:, 1] - roots[:, 0]).sum())
    both = int(covered(busy, roots[:, 0], roots[:, 1]).sum())
    idle_outside = (w1 - w0) - busy_s - (roots_s - both)
    return 100.0 * idle_outside / (w1 - w0)
