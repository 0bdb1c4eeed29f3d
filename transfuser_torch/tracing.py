"""The port's named spans, on the PyTorch profiler's clock.

``span(name)`` marks one stage of the program: a ``<layer>.<stage>`` name
(``agent.run_step``, ``model.fusion``, ``train.backward``, ...). With a
profiler recording on this thread it is ``torch.profiler.record_function``,
so the span lands in the profiler's trace beside the ATen operations it
makes and the device work they launch, all on one clock. With none
recording it returns one shared no-op context after a single check: no
allocation, no clock read. A span never reads a tensor or waits for the
device, so a traced run computes what an untraced one does.

The profiler's trace is the one sink: run a block under
``profile_trace(logdir)`` (or any ``torch.profiler.profile``) and read the
spans in the Chrome trace it writes. A thread the program starts (the
agent's ``async_inference`` worker) is not traced by a profiler started
on another thread, and its spans are no-ops.
"""

from __future__ import annotations

import contextlib
import os
from typing import ContextManager, Iterator, Optional

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A named span over the ``with`` block: ``record_function(name)``
    while a profiler records, else the shared no-op."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]) -> Iterator[None]:
    """torch.profiler over the block (host and, with a card, CUDA
    activity), written as a Chrome trace ``trace.json`` under ``logdir``,
    the program's spans included; a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
