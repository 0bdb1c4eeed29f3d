"""Floating-point operations of a stretch of PyTorch code, counted from
shapes, for the bench's model FLOP utilisation (``tools/bench.py``).

``FlopCounter`` is a ``TorchDispatchMode``: each ATen operation that runs
inside it is looked up in PyTorch's own table of formulas
(``torch.utils.flop_counter.flop_registry``, the one ``FlopCounterMode``
reads): matrix products, convolutions and their backward, SDPA. They count
2 operations per multiply-add and nothing for elementwise work,
normalisation, reductions, resizes or the optimizer. One formula is the
counter's own: PyTorch's for ``convolution_backward`` counts a grouped
convolution's weight gradient as if it had one group, ``groups`` times
its work (RegNetY's stages have 9-63 groups); here each gradient of a
convolution costs what its forward costs. Each operation runs as it would
outside the counter (none is decomposed), so the numbers it computes do
not change.

The hand-written kernels are ``ctypes`` calls that the dispatcher never
sees, so each wrapper reports its work by formula with ``count``, whether
it launches the kernel or runs the plain version; the plain version then
runs under ``uncounted``, so nothing is counted twice. (The backward of a
plain version, which autograd runs later, is counted as usual.) The
scatter-max counts 0: a max is no multiply-add.

Dispatch modes are per thread, and a counter counts the thread that
entered it.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import conv_flop_count, flop_registry

_active: List["FlopCounter"] = []


def _conv_backward_flops(grad_output, input, weight, bias_sizes, stride,
                         padding, dilation, transposed, output_padding,
                         groups, output_mask, out_val=None) -> int:
    """The input and weight gradients that ``output_mask`` asks for, each
    the forward's work (``conv_flop_count`` reads the group count from the
    weight's shape)."""
    forward = conv_flop_count(list(input.shape), list(weight.shape),
                              list(grad_output.shape), transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


FORMULAS = {**flop_registry,
            torch.ops.aten.convolution_backward: _conv_backward_flops}


class FlopCounter(TorchDispatchMode):
    """``with FlopCounter() as c: ...``; then ``c.counts``: operations by
    ATen operation name (``convolution``, ``convolution_backward``, ``mm``,
    ``addmm``, ``bmm``, ...) and by the name a kernel wrapper gave
    ``count`` (``attention``); ``c.total``: their sum."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = defaultdict(int)
        self._hidden = 0

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def __enter__(self):
        _active.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        out = func(*args, **kwargs)
        if packet in FORMULAS and not self._hidden:
            self.counts[packet.__name__] += int(
                FORMULAS[packet](*args, **kwargs, out_val=out))
        return out


def count(name: str, flops: int) -> None:
    """Add ``flops`` under ``name`` to the innermost active counter, if any
    (a kernel wrapper's work by formula)."""
    if _active:
        _active[-1].counts[name] += int(flops)


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Operations run here add nothing to the innermost active counter: a
    plain version whose work its wrapper counted by formula already."""
    if not _active:
        yield
        return
    counter = _active[-1]
    counter._hidden += 1
    try:
        yield
    finally:
        counter._hidden -= 1


def attention_flops(b: int, t: int, h: int, d: int) -> int:
    """softmax(q k^T / sqrt(D)) v over (B, T, H, D): two products of
    2 B H T^2 D operations each."""
    return 4 * b * h * t * t * d
