"""The host side of the AdamW kernel (``csrc/adamw.cu``, wrapped by
``train/train_state.py`` ``fused_update``), on the CPU:

* ``launch_plan`` splits a parameter list into launches that fit the
  kernel's parameter space, and the kernel's walk over those launches
  (its chunk numbering and binary search, emulated here) covers every
  element exactly once: at both benchmark configurations' full lists
  (924 and 932 tensors, built on the meta device), at edge sizes, and at
  more tensors than one launch holds;
* the wrapper refuses what the kernel does not take;
* off the card (the CPU, the meta device), ``AdamW.step`` runs the plain
  ``_foreach`` passes and launches nothing.

The card tests are ``tests/test_torch_adamw_cuda.py``.
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_torch.config import GlobalConfig
from transfuser_torch.models import LidarCenterNet
from transfuser_torch.ops import kernels
from transfuser_torch.train import train_state
from transfuser_torch.train.train_state import (AdamW, fused_update,
                                                launch_plan, plain_update)

SOURCE = Path(train_state.__file__).resolve().parent.parent / "csrc" / \
    "adamw.cu"
PARAM_SPACE = 32764  # bytes of kernel parameters on sm_90, CUDA >= 12.1
# (tensors, elements) of the configurations' trainable parameters
FULL = {"transfuser": (924, 168018327), "transfuser-pillars": (932, 168028471)}


class _Args(ctypes.Structure):
    """csrc/adamw.cu's AdamWArgs at MAX_TENSORS, with the host's C
    layout, which nvcc shares."""
    _fields_ = [("scalars", ctypes.c_void_p),
                ("consts", ctypes.c_float * 6),
                ("count", ctypes.c_int),
                ("chunk_start", ctypes.c_int * (train_state.MAX_TENSORS + 1)),
                ("numel", ctypes.c_int * train_state.MAX_TENSORS),
                ("ptrs", ctypes.c_void_p * (4 * train_state.MAX_TENSORS))]


def _sizes(name):
    cfg = GlobalConfig()
    if name == "transfuser-pillars":
        pp = dataclasses.replace(cfg.model.point_pillars,
                                 use_point_pillars=True)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    point_pillars=pp))
    model = LidarCenterNet(cfg, device="meta")
    return [p.numel() for p in model.parameters() if p.requires_grad]


def _walk(numels, plan):
    """The elements each launch's kernel visits, as the kernel finds them:
    chunk c of a launch is in its last tensor whose first chunk is <= c,
    at offset (c - that first chunk) * CHUNK, for up to CHUNK elements.
    Returns per tensor the count of visits of each element."""
    seen = [np.zeros(n, dtype=np.int64) for n in numels]
    for first, end, starts in plan:
        chunks = np.arange(starts[-1])
        local = np.searchsorted(np.asarray(starts[:-1]), chunks,
                                side="right") - 1
        for c, t in zip(chunks.tolist(), local.tolist()):
            n = numels[first + t]
            off = (c - starts[t]) * train_state.CHUNK
            assert 0 <= off < n
            seen[first + t][off:min(off + train_state.CHUNK, n)] += 1
    return seen


def test_layout_matches_the_kernel_source():
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxTensors"]) == train_state.MAX_TENSORS
    assert int(consts["kChunk"]) == train_state.CHUNK
    assert int(consts["kMaxParamBytes"]) == PARAM_SPACE
    assert ctypes.sizeof(_Args) <= PARAM_SPACE
    assert "__global__ void __launch_bounds__(kThreads)\ntf_adamw_step(" in src


@pytest.mark.parametrize("name", sorted(FULL))
def test_plan_covers_a_configurations_parameters(name):
    sizes = _sizes(name)
    assert (len(sizes), sum(sizes)) == FULL[name]
    plan = launch_plan(sizes)
    assert len(plan) == 2  # 924 and 932 tensors, at most 800 a launch
    assert [p[0] for p in plan] == [0, len(sizes) // 2]
    assert plan[-1][1] == len(sizes)
    assert all(end - first <= train_state.MAX_TENSORS
               for first, end, _ in plan)
    # the chunk numbering alone (the full walk is the edge cases' test)
    for first, end, starts in plan:
        want = [-(-n // train_state.CHUNK) for n in sizes[first:end]]
        assert np.diff(starts).tolist() == want


@pytest.mark.parametrize("sizes", [
    [0], [1], [3], [4 * 4096 + 1], [0, 1, 3, 4 * 4096 + 1, 0],
    [4096, 4095, 4097, 8192, 1, 0, 13],
    [(i * 37) % 5000 for i in range(2 * train_state.MAX_TENSORS + 3)],
    [0] * 900 + [5],
], ids=["0", "1", "3", "4k+1", "mixed", "chunk-edges", "1603-tensors",
        "empty-launch"])
def test_walk_visits_every_element_once(sizes):
    plan = launch_plan(sizes)
    assert all(0 < end - first <= train_state.MAX_TENSORS and starts[-1] > 0
               for first, end, starts in plan)
    assert len(plan) <= -(-len(sizes) // train_state.MAX_TENSORS)
    assert all(b[0] >= a[1] for a, b in zip(plan, plan[1:]))
    seen = _walk(sizes, plan)
    assert all((s == 1).all() for s in seen)
    if sum(sizes) == 0:
        assert plan == []


def test_plan_refuses_sizes_beyond_32_bits():
    with pytest.raises(ValueError, match="32-bit"):
        launch_plan([2 ** 31])


def _lists(n=3, size=10, dtype=torch.float32):
    make = [torch.randn(size, dtype=dtype) for _ in range(4 * n)]
    return make[:n], make[n:2 * n], make[2 * n:3 * n], make[3 * n:]


def _wrong(kind):
    p, g, m, v = _lists()
    scalars = torch.zeros(3)
    if kind == "non-contiguous":
        g[1] = torch.randn(20)[::2]
    elif kind == "bf16":
        m[2] = m[2].to(torch.bfloat16)
    elif kind == "mismatched":
        v[0] = torch.randn(2, 5)
    elif kind == "lengths":
        g = g[:2]
    elif kind == "scalars":
        scalars = torch.zeros(3, dtype=torch.float64)
    return p, g, m, v, scalars


@pytest.mark.parametrize("kind,error,match", [
    ("non-contiguous", ValueError, "contiguous"),
    ("bf16", TypeError, "float32"),
    ("mismatched", ValueError, "shape"),
    ("lengths", ValueError, "grads"),
    ("scalars", TypeError, "scalars"),
    ("cpu", ValueError, "runs on CUDA"),
])
def test_wrapper_refuses(kind, error, match):
    before = kernels.launches["adamw"]
    with pytest.raises(error, match=match):
        fused_update(*_wrong(kind), 0.9, 0.999, 1e-8, 0.01)
    assert kernels.launches["adamw"] == before


def _optimizer(weight_decay, agc_clip=0.0, grad_clip_norm=0.0):
    gen = torch.Generator().manual_seed(4)
    params = [torch.randn(s, generator=gen).requires_grad_()
              for s in ((7, 3), (5,), (4, 2, 3, 3), (0,), (9,))]
    opt = AdamW(params, lambda step: 1e-3 / (1 + step), weight_decay=
                weight_decay, agc_clip=agc_clip,
                grad_clip_norm=grad_clip_norm)
    return opt, gen


@pytest.mark.parametrize("weight_decay,agc_clip,grad_clip_norm", [
    (0.0, 0.0, 0.0), (0.01, 0.0, 0.0), (0.01, 0.5, 0.0), (0.01, 0.0, 1.0)])
def test_cpu_step_runs_the_plain_passes(monkeypatch, weight_decay, agc_clip,
                                        grad_clip_norm):
    def refuse(*args):
        raise AssertionError("the kernel's wrapper ran on the CPU")

    monkeypatch.setattr(train_state, "fused_update", refuse)
    opt, gen = _optimizer(weight_decay, agc_clip, grad_clip_norm)
    twin, _ = _optimizer(weight_decay, agc_clip, grad_clip_norm)
    before = dict(kernels.launches)
    for step in range(3):
        for i, (p, q) in enumerate(zip(opt.params, twin.params)):
            # the second parameter keeps no gradient: a zero one stands in
            p.grad = None if i == 1 else torch.randn(p.shape, generator=gen)
            q.grad = None if p.grad is None else p.grad.clone()
        opt.advance()
        opt.step()
        twin.advance()
        with torch.no_grad():
            plain_update(twin.params, twin.clipped_grads(), twin.mu, twin.nu,
                         twin.scalars, twin.b1, twin.b2, twin.eps,
                         twin.weight_decay)
        for a, b in zip(opt.params + opt.mu + opt.nu,
                        twin.params + twin.mu + twin.nu):
            assert torch.equal(a, b), step
    assert kernels.launches == before
    assert not torch.equal(opt.params[0], _optimizer(0.0)[0].params[0])


def test_step_off_the_card_launches_nothing(monkeypatch):
    """Any device but CUDA takes the plain passes (here the meta device,
    which computes shapes only)."""
    def refuse(*args):
        raise AssertionError("the kernel's wrapper ran off the card")

    monkeypatch.setattr(train_state, "fused_update", refuse)
    params = [torch.empty(4, device="meta", requires_grad=True)]
    opt = AdamW(params, lambda step: 1e-3, weight_decay=0.01)
    params[0].grad = torch.empty(4, device="meta")
    before = dict(kernels.launches)
    opt.advance()
    opt.step()
    assert kernels.launches == before
    assert opt.params[0].device.type == opt.mu[0].device.type == "meta"
