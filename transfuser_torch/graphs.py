"""CUDA-graph replay of a call whose input shapes repeat and whose owner's
weights change only in place: the agent's ``LidarCenterNet.forward_ego``
(``replay_forward_ego()`` opts a model in) and the trainer's training
step (``StepGraphs``). One ``Graphs`` cache serves one call.

A call is a host part, run first on every call (the step's re-seed and
``AdamW.advance``; the frame has none), then a device part. Per input
signature (each input's name, shape, strides, dtype and device, or None,
and the owner's compute dtype):

* the first call runs eagerly: it loads the kernels' libraries (``nvcc``
  may run) and lets cuDNN choose its algorithms;
* the second runs its device part eagerly on static copies of its inputs
  on a side stream (the stream's cuBLAS workspace and allocator blocks):
  that run is the call, counted and returned as clones. It then captures
  the device part there without running it; not while a profiler
  records, when the capture waits for a later call;
* every later call runs, in the span its user names (``model.replay``,
  ``train.replay``), its host part, copies its inputs into the static
  buffers, replays the graph and returns clones of the static outputs,
  so that what a caller holds outlives the next replay.

A call stays eager off the card, for a signature beyond the
``MAX_GRAPHS`` that get a graph, and while a FLOP counter
(``ops/flops.py``) counts, so that it sees the operations (a
``TorchDispatchMode`` entered at capture would import ``torch._dynamo``
and sympy: seconds of set-up for every process).

A graph reads the storage of the owner's parameters and buffers, and of
whatever else its call touches (AdamW's moments), so an in-place load is
seen by the next replay. Whatever gives them new storage (a move,
``load_state_dict(assign=True)``) moves the owner's ``storage_version``,
which the owner passes at each call: the cache drops every graph at the
first call that brings a new one. The cache holds no reference to its
owner, so the owner is freed when its last reference goes.

The launch counters keep meaning "launches made": what the captured call
added to ``kernels.launches`` is added again at each replay. The
CUDA-only work (the test for the card, the side stream, the capture)
sits behind one method, ``Graphs._card``; a replay's is the
``replay()`` of the graph that it made.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, ContextManager, Dict, Iterator, Optional, Tuple

import torch

from .ops import flops, kernels
from .tracing import span

MAX_GRAPHS = 2
MAX_SEEN = 8  # signatures remembered as having run once

_profiler_enabled = torch._C._autograd._profiler_enabled

Inputs = Dict[str, Optional[torch.Tensor]]
Record = Callable[[Callable[[], object]], Tuple[object, object]]
SideStream = Callable[[torch.device], ContextManager[Record]]


def signature(inputs: Inputs, dtype: Optional[torch.dtype]) -> tuple:
    return (dtype,) + tuple(
        (k, None) if v is None else (k, v.shape, v.stride(), v.dtype,
                                     v.device)
        for k, v in inputs.items())


def _clone(outputs):
    """Copies of a tuple or a dict of tensors."""
    if isinstance(outputs, dict):
        return {k: v.clone() for k, v in outputs.items()}
    return tuple(v.clone() for v in outputs)


@dataclasses.dataclass
class Graph:
    """One captured call: the graph, its static inputs and outputs, the
    device it runs on (an index; -1 keeps the current one), what the
    captured call added to the launch counters, and what its path kept of
    the capture (the step: the gradients its backward writes)."""
    graph: object
    inputs: Inputs
    outputs: object
    device_index: int
    launches: Dict[str, int]
    kept: object = None


class Graphs:
    """The graphs of one call, by input signature (module docstring).
    ``replay_span``: the name of a replay's span. The owner passes the
    device part ``fn(inputs)``, its ``storage_version`` and its compute
    dtype at each call. A path with more to do overrides ``host``,
    ``capture`` and ``replayed``, and sets ``generator`` to the generator
    its device part draws from."""

    generator: Optional[torch.Generator] = None  # registered with a graph

    def __init__(self, replay_span: str):
        self.replay_span = replay_span
        self.graphs: Dict[tuple, Graph] = {}
        self.seen: Dict[tuple, None] = {}
        self.version: Optional[int] = None
        self._stream: Optional[torch.cuda.Stream] = None

    def host(self) -> None:
        """The host part of a call, run before its device part."""

    def capture(self, record: Record, call: Callable[[], object]
                ) -> Tuple[object, object, object]:
        """The device part, ``call()``, captured by ``record``: (the
        graph, its outputs, what the path keeps in ``Graph.kept``)."""
        graph, outputs = record(call)
        return graph, outputs, None

    def replayed(self, graph: Graph) -> None:
        """The host state that an eager call leaves, put back after a
        replay of ``graph``."""

    def __call__(self, fn: Callable[[Inputs], object], inputs: Inputs,
                 version: int, dtype: Optional[torch.dtype]):
        """The call of ``fn`` on ``inputs``, replayed from a graph where
        there is one; ``version``: the owner's ``storage_version``."""
        if version != self.version:
            self.graphs.clear()
            self.seen.clear()
            self.version = version
        side_stream = self._card(inputs)
        if side_stream is None or flops.counting():
            return self._eager(fn, inputs)
        sig = signature(inputs, dtype)
        graph = self.graphs.get(sig)
        if graph is not None:
            return self._replay(graph, inputs)
        if sig in self.seen and len(self.graphs) < MAX_GRAPHS \
                and not _profiler_enabled():
            return self._capture(side_stream, fn, sig, inputs)
        if len(self.graphs) < MAX_GRAPHS:
            self.seen[sig] = None
            if len(self.seen) > MAX_SEEN:
                del self.seen[next(iter(self.seen))]
        return self._eager(fn, inputs)

    def _eager(self, fn: Callable[[Inputs], object], inputs: Inputs):
        self.host()
        return fn(inputs)

    def _replay(self, graph: Graph, inputs: Inputs):
        with span(self.replay_span):
            self.host()
            for k, v in inputs.items():
                if v is not None:
                    graph.inputs[k].copy_(v)
            with torch.cuda.device(graph.device_index):
                graph.graph.replay()
            out = _clone(graph.outputs)
        for name, n in graph.launches.items():
            kernels.launches[name] += n
        self.replayed(graph)
        return out

    def _capture(self, side_stream: SideStream,
                 fn: Callable[[Inputs], object], sig: tuple,
                 inputs: Inputs):
        """This call: its host part, then its device part run eagerly on
        static copies of its inputs on the side stream, then captured
        there without running. Returns that run's outputs, cloned."""
        device = next(v.device for v in inputs.values() if v is not None)
        static = {k: None if v is None else v.clone()
                  for k, v in inputs.items()}
        with side_stream(device) as record:
            out = self._eager(fn, static)
            ran = dict(kernels.launches)
            graph, outputs, kept = self.capture(record, lambda: fn(static))
        launches = {name: kernels.launches[name] - ran[name] for name in ran}
        kernels.launches.update(ran)
        self.graphs[sig] = Graph(
            graph, static, outputs,
            -1 if device.index is None else device.index,
            {k: n for k, n in launches.items() if n}, kept)
        self.seen.pop(sig, None)
        return _clone(out)

    def _card(self, inputs: Inputs) -> Optional[SideStream]:
        """The one CUDA seam. None unless every input is on a card; else
        ``side_stream``: ``with side_stream(device) as record`` is the
        block on this cache's side stream, which waits for the current
        stream first and is waited for after, and ``record(fn)`` captures
        ``fn()`` there as one CUDA graph, without running it: (the graph,
        ``fn()``'s outputs)."""
        if all(v.is_cuda for v in inputs.values() if v is not None):
            return self._side_stream
        return None

    @contextlib.contextmanager
    def _side_stream(self, device: torch.device) -> Iterator[Record]:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        side = self._stream
        current = torch.cuda.current_stream(device)

        def record(fn):
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                outputs = fn()
            return graph, outputs

        side.wait_stream(current)
        with torch.cuda.stream(side):
            yield record
        current.wait_stream(side)
