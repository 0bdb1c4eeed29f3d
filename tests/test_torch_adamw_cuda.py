"""The AdamW kernel (``csrc/adamw.cu``, ``train_state.fused_update``) on a
card, against the plain ``_foreach`` passes (``plain_update``) on the
same card, bit for bit (``torch.equal``) on the parameters and both
moments. Every test is marked ``cuda`` and skips without one; the file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_adamw_cuda.py -m cuda -q

Each benchmark configuration's full parameter list (924 and 932 fp32
tensors at their real shapes) takes ``STEPS`` updates with seeded
gradients and ``weight_decay`` 0.01: through ``AdamW.step`` eagerly, with
one parameter's gradient left None (the optimizer's zero gradient); over
a ZeRO-style owned subset; with both clippings on; and as one captured
``torch.cuda.CUDAGraph`` of ``AdamW.step`` replayed ``STEPS`` times with
new gradients and new ``advance`` scalars. Edge sizes (0, 1, 3, 4k + 1
elements, tensors one float into their buffers) take the kernel's 4-byte
path.
"""

import dataclasses
import functools

import pytest
import torch

from transfuser_torch.config import GlobalConfig
from transfuser_torch.models import LidarCenterNet
from transfuser_torch.ops import kernels
from transfuser_torch.train.train_state import MAX_TENSORS, AdamW, \
    fused_update, launch_plan, plain_update

STEPS = 3
NO_GRAD = 5  # the parameter whose gradient stays None
CONFIGS = ("transfuser", "transfuser-pillars")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the AdamW kernel is CUDA C++")


@functools.lru_cache(maxsize=None)
def _shapes(name):
    cfg = GlobalConfig()
    if name == "transfuser-pillars":
        pp = dataclasses.replace(cfg.model.point_pillars,
                                 use_point_pillars=True)
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    point_pillars=pp))
    model = LidarCenterNet(cfg, device="meta")
    return tuple(tuple(p.shape) for p in model.parameters()
                 if p.requires_grad)


def _schedule(step):
    return 1e-3 * 0.5 ** step  # a new learning rate at every update


def _pair(shapes, seed=0, **kwargs):
    """Two optimizers over equal fresh parameters on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    make = functools.partial(AdamW, weight_decay=0.01, **kwargs)
    return (make([p.clone().requires_grad_() for p in params], _schedule),
            make([p.clone().requires_grad_() for p in params], _schedule))


def _grads(opt, twin, gen, keep=None):
    """Seeded gradients, the same in both; ``keep``: write into the
    gradients already there (a captured graph reads those)."""
    for i, (p, q) in enumerate(zip(opt.params, twin.params)):
        if i == NO_GRAD:
            continue
        g = torch.randn(p.shape, generator=gen, device="cuda")
        if keep:
            p.grad.copy_(g)
        else:
            p.grad = g
        q.grad = g.clone()


def _plain_step(twin):
    twin.advance()
    own = twin.owned
    with torch.no_grad():
        grads = twin.clipped_grads()
        plain_update([twin.params[i] for i in own], [grads[i] for i in own],
                     [twin.mu[i] for i in own], [twin.nu[i] for i in own],
                     twin.scalars, twin.b1, twin.b2, twin.eps,
                     twin.weight_decay)


def _assert_equal(opt, twin, what):
    torch.cuda.synchronize()
    for name in ("params", "mu", "nu"):
        for i, (a, b) in enumerate(zip(getattr(opt, name),
                                       getattr(twin, name))):
            if a is None:
                assert b is None
                continue
            if not torch.equal(a, b):
                bad = int((a != b).sum())
                raise AssertionError(f"{what}: {name}[{i}] {tuple(a.shape)} "
                                     f"differs in {bad} elements, max "
                                     f"{float((a - b).abs().max())}")


def _own_a_subset(opt):
    """ZeRO-1's state on one rank: every third parameter belongs to
    another rank (no moments, not updated here)."""
    opt.owned = [i for i in range(len(opt.params)) if i % 3 != 1]
    for i in range(len(opt.params)):
        if i % 3 == 1:
            opt.mu[i] = opt.nu[i] = None


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["eager", "owned", "clipped"])
@pytest.mark.parametrize("name", CONFIGS)
def test_kernel_equals_the_plain_passes(name, mode):
    _needs_card()
    shapes = _shapes(name)
    clip = dict(agc_clip=0.01, grad_clip_norm=1.0) if mode == "clipped" \
        else {}
    opt, twin = _pair(shapes, **clip)
    if mode == "owned":
        _own_a_subset(opt)
        _own_a_subset(twin)
    sizes = [opt.params[i].numel() for i in opt.owned]
    per_step = len(launch_plan(sizes))  # 2 over all, 1 over the subset
    assert per_step == -(-len(sizes) // MAX_TENSORS)
    assert len(shapes) in (924, 932)
    gen = torch.Generator(device="cuda").manual_seed(1)
    start = [p.detach().clone() for p in opt.params]
    for step in range(STEPS):
        _grads(opt, twin, gen)
        before = kernels.launches["adamw"]
        opt.advance()
        opt.step()
        assert kernels.launches["adamw"] == before + per_step
        _plain_step(twin)
        _assert_equal(opt, twin, f"{name} {mode} step {step}")
    moved = [not torch.equal(p, s) for p, s in zip(opt.params, start)]
    assert all(m == (i in opt.owned) for i, m in enumerate(moved))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_replayed_graph_equals_the_plain_passes(name):
    _needs_card()
    opt, twin = _pair(_shapes(name), seed=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    # one eager update first: the kernel's library is loaded before capture
    _grads(opt, twin, gen)  # ... and these are the gradients the graph reads
    opt.advance()
    opt.step()
    _plain_step(twin)
    for p in opt.params:
        if p.grad is not None:
            p.grad.zero_()
    before = kernels.launches["adamw"]
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            opt.step()
    torch.cuda.current_stream().wait_stream(side)
    # the wrapper counted the captured launches; a replay runs no Python
    assert kernels.launches["adamw"] == before + 2
    for step in range(STEPS):
        _grads(opt, twin, gen, keep=True)
        opt.advance()
        graph.replay()
        _plain_step(twin)
        _assert_equal(opt, twin, f"{name} replay {step}")


@pytest.mark.cuda
def test_edge_sizes_take_the_scalar_path():
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    sizes = (0, 1, 3, 4, 4 * 4096 + 1, 4096, 4097, 12289, 5)

    def at(t, offset):
        """``t`` copied into a buffer ``offset`` floats in."""
        out = torch.empty(t.numel() + offset, device="cuda")[offset:]
        return out.copy_(t)

    def lists(offsets):
        """p, g, mu and nu, each ``offsets[k]`` floats into its buffer."""
        return [[at(t, off) for t in ts] for ts, off in zip(start, offsets)]

    start = [[torch.randn(n, generator=gen, device="cuda") for n in sizes]
             for _ in range(4)]
    start[3] = [t.abs() for t in start[3]]  # nu >= 0
    scalars = torch.tensor([1e-3, 0.1, 0.001], device="cuda")
    for offsets in ((0, 1, 0, 1), (1, 1, 1, 1), (0, 0, 0, 3)):
        got, want = lists(offsets), lists(offsets)
        for step in range(STEPS):
            scalars.mul_(torch.tensor([0.5, 1.0, 1.0], device="cuda"))
            fused_update(got[0], got[1], got[2], got[3], scalars, 0.9,
                         0.999, 1e-8, 0.01)
            plain_update(want[0], want[1], want[2], want[3], scalars, 0.9,
                         0.999, 1e-8, 0.01)
            torch.cuda.synchronize()
            for k in (0, 2, 3):
                for n, a, b in zip(sizes, got[k], want[k]):
                    assert torch.equal(a, b), (offsets, step, k, n)
