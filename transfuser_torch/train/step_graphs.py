"""CUDA-graph replay of the whole training step (``make_train_step``): the
batch's unpacking, the forward with the aux maps, the CenterNet targets,
the losses, the backward, the clipping and the AdamW update, captured as
one ``torch.cuda.CUDAGraph`` and replayed on every later step. A trainer
with no mesh on a card takes this path; every other caller stays eager:
any mesh (DDP, collectives, ZeRO-1), the CPU, and a call made while a
FLOP counter (``ops/flops.py``) counts.

A step has a host part and a device part. The host part re-seeds the
dropout generator from the count of updates done and runs
``AdamW.advance`` (count the update, write its learning rate and bias
corrections on the device by ``fill_``). The device part is
``step(batch)``, which a graph captures; inside it ``AdamW.step`` leaves
the host part out while its stream is being captured.

Per batch signature (each key's shape, strides, dtype and device, and the
model's compute dtype):

* the first call runs eagerly: it loads the kernels' libraries (``nvcc``
  may run) and lets cuDNN choose its algorithms;
* the second copies its batch into static buffers and runs its own step
  eagerly on a side stream (the stream's cuBLAS workspace and allocator
  blocks), then, with the gradients set to None so that the captured
  backward allocates them from the graph's pool and writes them on every
  replay, captures the step on that stream without running it. The
  capture advances no host state. Not while a profiler records: such a
  call runs eagerly and the capture waits for a later one;
* every later call runs the host part, copies its batch into the static
  buffers, replays the graph on the current stream and returns clones of
  the static losses, so that what a caller holds is never overwritten by
  the next replay. The replay runs in the span ``train.replay`` (inside
  ``train.step``); the phase spans are not opened.

So every call updates the parameters, the moments, the count and the
BatchNorm statistics once, whichever way it runs. The generator is
registered with the graph, and a replay reads its seed and offset as the
host left them, so a replayed step draws the dropout masks of an eager
one.

At most ``MAX_GRAPHS`` signatures get a graph; others run eagerly. The
graph reads the storage of the parameters, buffers and moments, so an
in-place load (``restore_checkpoint``, ``AdamW.load_state_dict``) is seen
by the next replay; whatever gives them new storage (a move,
``load_state_dict(assign=True)``: the model's ``storage_version``) drops
the graphs, and ``Trainer.init_state`` makes a new step with none.

The launch counters keep meaning "launches made": what the captured step
added to ``kernels.launches`` is added again at each replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ..ops import flops, kernels
from ..tracing import span
from .train_state import AdamW

Batch = Dict[str, torch.Tensor]

MAX_GRAPHS = 2
MAX_SEEN = 8  # signatures remembered as having run once

_profiler_enabled = torch._C._autograd._profiler_enabled


def signature(batch: Batch, dtype: torch.dtype) -> tuple:
    return (dtype,) + tuple((k, v.shape, v.stride(), v.dtype, v.device)
                            for k, v in batch.items())


def on_card(batch: Batch) -> bool:
    return all(v.is_cuda for v in batch.values())


@dataclasses.dataclass
class StepGraph:
    """One captured step: the graph, its static inputs and outputs, the
    gradients its backward writes, the device it runs on (an index; -1
    keeps the current one), and what the captured step added to the
    launch counters."""
    graph: object
    inputs: Batch
    outputs: Batch
    grads: List[Optional[torch.Tensor]]
    device_index: int
    launches: Dict[str, int]


class StepGraphs:
    """The graphs of one train step, by batch signature (module
    docstring). ``step``: the device part of a step; ``reseed``: the
    generator's seed from the count of updates done."""

    def __init__(self, step: Callable[[Batch], Batch],
                 reseed: Callable[[], None], gen: torch.Generator,
                 optimizer: AdamW, model: torch.nn.Module):
        self.step = step
        self.reseed = reseed
        self.gen = gen
        self.optimizer = optimizer
        self.model = model
        self.graphs: Dict[tuple, StepGraph] = {}
        self.seen: Dict[tuple, None] = {}
        self.version = self._version()
        self._stream: Optional[torch.cuda.Stream] = None

    def _version(self) -> int:
        return getattr(self.model, "storage_version", 0)

    def clear(self) -> None:
        self.graphs.clear()
        self.seen.clear()

    def eager(self, batch: Batch) -> Batch:
        self.reseed()
        return self.step(batch)

    def __call__(self, batch: Batch) -> Batch:
        """One training step, replayed from a graph where there is one."""
        if not on_card(batch) or flops.counting():
            return self.eager(batch)
        if self._version() != self.version:
            self.clear()
            self.version = self._version()
        sig = signature(batch, getattr(self.model, "dtype", None))
        graph = self.graphs.get(sig)
        if graph is not None:
            return self.replay(graph, batch)
        if sig in self.seen and self._may_capture():
            return self.capture(sig, batch)
        if len(self.graphs) < MAX_GRAPHS:
            self.seen[sig] = None
            if len(self.seen) > MAX_SEEN:
                del self.seen[next(iter(self.seen))]
        return self.eager(batch)

    def _may_capture(self) -> bool:
        return len(self.graphs) < MAX_GRAPHS and not _profiler_enabled()

    def replay(self, graph: StepGraph, batch: Batch) -> Batch:
        with span("train.replay"):
            self.reseed()
            self.optimizer.advance()
            for k, v in batch.items():
                graph.inputs[k].copy_(v)
            with torch.cuda.device(graph.device_index):
                graph.graph.replay()
            out = {k: v.clone() for k, v in graph.outputs.items()}
        for name, n in graph.launches.items():
            kernels.launches[name] += n
        # the host state an eager step leaves: training mode, and each
        # parameter's .grad the gradient of this step
        if not self.model.training:
            self.model.train()
        params = self.optimizer.params
        if params and params[0].grad is not graph.grads[0]:
            for p, g in zip(params, graph.grads):
                p.grad = g
        return out

    def record(self, static: Batch, stream) -> Tuple[object, Batch]:
        """The step on ``static`` captured on ``stream`` as one CUDA graph,
        without running it: (the graph, its static outputs)."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            outputs = self.step(static)
        return graph, outputs

    @contextlib.contextmanager
    def _side_stream(self, device: torch.device) -> Iterator[object]:
        """The block on this object's side stream, which waits for the
        current stream first and is waited for after."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            yield self._stream
        current.wait_stream(self._stream)

    def capture(self, sig: tuple, batch: Batch) -> Batch:
        """This call's own step, run eagerly on static copies of its
        batch on the side stream, then captured there without running.
        Returns that step's losses."""
        device = next(iter(batch.values())).device
        static = {k: v.clone() for k, v in batch.items()}
        params = self.optimizer.params
        with self._side_stream(device) as side:
            out = self.eager(static)
            warm = dict(kernels.launches)
            kept = [p.grad for p in params]
            self.optimizer.zero_grad()
            graph, outputs = self.record(static, side)
        launches = {name: kernels.launches[name] - warm[name]
                    for name in warm}
        kernels.launches.update(warm)
        grads = [p.grad for p in params]
        for p, g in zip(params, kept):  # this step's, until the next replay
            p.grad = g
        self.graphs[sig] = StepGraph(
            graph, static, outputs, grads,
            -1 if device.index is None else device.index,
            {k: n for k, n in launches.items() if n})
        self.seen.pop(sig, None)
        return {k: v.clone() for k, v in out.items()}
