"""CUDA-graph replay of ``LidarCenterNet.forward_ego``, for callers whose
weights change only in place and whose input shapes repeat: the agent's
members, which ``LidarCenterNet.replay_forward_ego()`` opts in. Every other
caller stays eager.

Per input signature (each argument's shape, strides, dtype and device, or
None, and the model's compute dtype):

* the first call runs eagerly: it loads the kernels' libraries (``nvcc``
  may run) and lets cuDNN choose its algorithms;
* the second copies its inputs into static buffers, runs once on a side
  stream and then captures the call on that stream as one
  ``torch.cuda.CUDAGraph``. Not while a profiler records: such a call runs
  eagerly and the capture waits for a later one;
* every later call copies its inputs into the static buffers, replays the
  graph on the current stream and returns clones of the static outputs,
  so that what a caller holds is never overwritten by the next replay.
  The replay runs in the span ``model.replay``.

A call made while a FLOP counter (``ops/flops.py``) counts runs eagerly,
so the counter sees its operations. (Counting the captured call instead
would enter a ``TorchDispatchMode`` at capture, whose first use imports
``torch._dynamo`` and sympy: seconds of set-up for every process.)

At most ``MAX_GRAPHS`` signatures get a graph; others run eagerly. The
graph reads the parameters' storage and casts them in its own kernels, so
an in-place load (``load_state_dict``, ``copy_``) is seen by the next
replay; whatever gives a parameter new storage (a move, ``load_state_dict
(assign=True)``) must ``clear`` the graphs, as ``LidarCenterNet`` does.

The launch counters keep meaning "launches made": what the captured call
added to ``kernels.launches`` is added again at each replay.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops import flops, kernels
from ..tracing import span

MAX_GRAPHS = 2
MAX_SEEN = 8  # signatures remembered as having run once

_profiler_enabled = torch._C._autograd._profiler_enabled


def signature(args: Sequence[Optional[torch.Tensor]],
              dtype: torch.dtype) -> tuple:
    return (dtype,) + tuple(
        None if a is None else (a.shape, a.stride(), a.dtype, a.device)
        for a in args)


def on_card(args: Sequence[Optional[torch.Tensor]]) -> bool:
    return args[0].is_cuda


class Graph:
    """One captured call: the graph, its static inputs and outputs, the
    device it runs on (an index; -1 keeps the current one), and what the
    captured call added to the launch counters."""

    def __init__(self, graph, inputs: Sequence[Optional[torch.Tensor]],
                 outputs: Tuple[torch.Tensor, ...], device_index: int,
                 launches: Dict[str, int]):
        self.graph = graph
        self.inputs = tuple(inputs)
        self.outputs = outputs
        self.device_index = device_index
        self.launches = launches

    def __call__(self, args) -> Tuple[torch.Tensor, ...]:
        with span("model.replay"):
            for dst, src in zip(self.inputs, args):
                if dst is not None:
                    dst.copy_(src)
            with torch.cuda.device(self.device_index):
                self.graph.replay()
            out = tuple(o.clone() for o in self.outputs)
        for name, n in self.launches.items():
            kernels.launches[name] += n
        return out


class EgoGraphs:
    """The graphs of one model, by input signature (module docstring)."""

    def __init__(self):
        self.graphs: Dict[tuple, Graph] = {}
        self.seen: Dict[tuple, None] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    def clear(self) -> None:
        self.graphs.clear()
        self.seen.clear()

    def __call__(self, fn: Callable, args: Sequence[Optional[torch.Tensor]],
                 dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """``fn(*args)``, replayed from a graph where there is one."""
        if not on_card(args) or flops.counting():
            return fn(*args)
        sig = signature(args, dtype)
        graph = self.graphs.get(sig)
        if graph is None and sig in self.seen and self._may_capture():
            graph = self.graphs[sig] = self.capture(fn, args)
        if graph is not None:
            return graph(args)
        if len(self.graphs) < MAX_GRAPHS:
            self.seen[sig] = None
            if len(self.seen) > MAX_SEEN:
                del self.seen[next(iter(self.seen))]
        return fn(*args)

    def _may_capture(self) -> bool:
        return len(self.graphs) < MAX_GRAPHS and not _profiler_enabled()

    def capture(self, fn: Callable, args: Sequence[Optional[torch.Tensor]]
                ) -> Graph:
        """``fn`` on static copies of ``args``: once on the side stream (the
        stream's cuBLAS workspace and allocator blocks), then captured
        there. Neither run counts as a launch."""
        device = args[0].device
        static = [None if a is None else torch.empty_like(a) for a in args]
        for dst, src in zip(static, args):
            if dst is not None:
                dst.copy_(src)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        side = self._stream
        before = dict(kernels.launches)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*static)
        warm = dict(kernels.launches)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            outputs = tuple(fn(*static))
        torch.cuda.current_stream(device).wait_stream(side)
        launches = {name: kernels.launches[name] - warm[name]
                    for name in warm}
        kernels.launches.update(before)
        return Graph(graph, static, outputs, device.index,
                     {k: n for k, n in launches.items() if n})
