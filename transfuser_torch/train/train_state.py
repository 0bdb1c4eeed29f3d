"""Optimizer and LR schedule (counterpart of
transfuser_tpu/train/train_state.py; reference train.py:138-142, 194-199).

``make_optimizer`` gives what the JAX package's optax chain computes,
with optax's arithmetic:
  * ``agc_clip > 0``: unit-wise adaptive gradient clipping
    (``optax.adaptive_grad_clip``), then
  * ``grad_clip_norm > 0``: ``optax.clip_by_global_norm`` (no epsilon on
    the norm, unlike ``torch.nn.utils.clip_grad_norm_``), then
  * ``optax.adamw``: Adam moments with bias correction, plus
    ``weight_decay * param`` on every parameter (biases and norms
    included), times ``-lr(step)``.
The schedule is the JAX package's: ×``schedule_gamma`` drops at epochs
``schedule_reduce_epoch_01/02``, and with ``warmup_epochs > 0`` a linear
0 -> lr warmup joined by ``optax.join_schedules``, which also shifts the
drops by the warmup (train_state.py:39-45 there), reproduced here.

The update runs on the device over all parameters at once; the step
count lives on the host, so no step syncs. An update is ``advance()``
then ``step()``. ``advance`` is its host part: count it, and write its
learning rate and bias corrections into a small device tensor with
``fill_``, whose value travels as a launch argument. ``step`` is its
device part, which reads that tensor, so a CUDA graph of the training
step holds it and every replay follows the host part. On a card the
device part is one pass of the hand-written kernel ``csrc/adamw.cu``
(``fused_update``: p, g, mu and nu read once, p, mu and nu written once,
in ``launch_plan``'s few launches); on the CPU it is ``plain_update``,
16 ``torch._foreach_*`` passes. On a card the two are equal bit for bit
(``tests/test_torch_adamw_cuda.py``).

Under a mesh (``parallel/sharding.py``):
  * ZeRO-1 (``zero=True`` over a data group of more than one rank): whole
    parameters are partitioned over the data group (``zero_plan``; the
    leaves below JAX's size threshold stay replicated); a rank keeps
    ``mu`` / ``nu`` only for the parameters it owns, updates only those,
    and each owner broadcasts its updated parameters (one flattened
    broadcast per owner). Clipping acts on the full, already
    averaged gradients before that, and the update's arithmetic per
    element is unchanged, so ZeRO-1 on and off give equal parameters.
  * tensor parallel (``shard_dims``): a sharded parameter's squared sums
    are summed over the model group wherever a norm spans its sharded
    dimension (the global norm; AGC's unit norms of a sharded bias or of
    a row-parallel weight's rows).
``state_dict`` gathers the full moments (owner broadcasts, then the model
group's shards) on every rank; ``load_state_dict`` takes full moments
and keeps this rank's share.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..config import GlobalConfig
from ..ops import kernels
from ..parallel import comm
from ..parallel.sharding import (Mesh, TensorParallel, gather_tensor,
                                 shard_tensor, zero_plan)
from ..tracing import span

Schedule = Callable[[int], float]


def make_schedule(config: GlobalConfig,
                  steps_per_epoch: Optional[int] = None) -> Schedule:
    """step (0-based count of updates done) -> learning rate."""
    t = config.train
    if not steps_per_epoch:
        return lambda step: t.lr
    drops = (t.schedule_reduce_epoch_01 * steps_per_epoch,
             t.schedule_reduce_epoch_02 * steps_per_epoch)

    def piecewise(step: int) -> float:
        lr = t.lr
        for boundary in drops:
            if step >= boundary:
                lr *= t.schedule_gamma
        return lr

    if t.warmup_epochs <= 0:
        return piecewise
    warm = max(1, int(t.warmup_epochs * steps_per_epoch))

    def joined(step: int) -> float:
        if step < warm:  # optax.linear_schedule(0, lr, warm)
            frac = 1.0 - min(max(step, 0), warm) / warm
            return (0.0 - t.lr) * frac + t.lr
        return piecewise(step - warm)

    return joined


def unitwise_norm(x: torch.Tensor, shard_dim: Optional[int] = None,
                  group: comm.Group = None) -> torch.Tensor:
    """optax's unit-wise L2 norm, on the port's layouts: a vector (or a
    tensor that squeezes to one) whole; Linear / GRU weights (out, in) per
    output row; the GPT's (1, T, C) pos_emb over dim 0; conv weights
    (O, I, H, W) per output channel. These are the units optax takes on
    the JAX layouts (in, out), (1, T, C) and (H, W, I, O). ``x`` sharded
    along ``shard_dim`` over the model ``group``: a unit that spans that
    dimension sums its squares over the group."""
    sq = x * x
    if x.squeeze().dim() <= 1:
        dims = tuple(range(x.dim()))
    elif x.dim() == 2:
        dims = (1,)
    elif x.dim() == 3:
        dims = (0,)
    elif x.dim() == 4:
        dims = (1, 2, 3)
    else:
        raise ValueError(f"no unit-wise norm for shape {tuple(x.shape)}")
    n = sq.sum() if x.squeeze().dim() <= 1 else sq.sum(dims, keepdim=True)
    if shard_dim is not None and shard_dim in dims:
        n = comm.all_reduce_sum(n, group)
    return torch.sqrt(n).expand_as(x)


def adaptive_grad_clip(grads: List[torch.Tensor], params: List[torch.Tensor],
                       clipping: float, eps: float = 1e-3,
                       shard_dims: Optional[Sequence[Optional[int]]] = None,
                       group: comm.Group = None) -> List[torch.Tensor]:
    out = []
    dims = shard_dims or [None] * len(grads)
    for g, p, d in zip(grads, params, dims):
        g_norm = unitwise_norm(g, d, group)
        max_norm = clipping * torch.clamp(unitwise_norm(p, d, group),
                                          min=eps)
        clipped = g * (max_norm / torch.clamp(g_norm, min=1e-6))
        out.append(torch.where(g_norm < max_norm, g, clipped))
    return out


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        shard_dims: Optional[Sequence[Optional[int]]] = None,
                        group: comm.Group = None) -> List[torch.Tensor]:
    if not shard_dims or all(d is None for d in shard_dims):
        g_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    else:  # replicated leaves once, sharded ones summed over the group
        sq = [torch.linalg.vector_norm(g) ** 2 for g in grads]
        rep = torch.stack([s for s, d in zip(sq, shard_dims) if d is None]
                          or [torch.zeros_like(sq[0])]).sum()
        part = torch.stack([s for s, d in zip(sq, shard_dims)
                            if d is not None]).sum()
        g_norm = torch.sqrt(rep + comm.all_reduce_sum(part, group))
    scaled = [(g / g_norm) * max_norm for g in grads]
    return [torch.where(g_norm < max_norm, g, s)
            for g, s in zip(grads, scaled)]


# csrc/adamw.cu's layout: a launch takes at most MAX_TENSORS tensors, each
# cut into chunks of CHUNK elements, and counts both in 32-bit ints
MAX_TENSORS = 800
CHUNK = 4096
INT_MAX = 2 ** 31 - 1
_ARGTYPES = [ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
             ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
             ctypes.c_void_p] + [ctypes.c_float] * 6 + [ctypes.c_void_p]
Launch = Tuple[int, int, List[int]]


def launch_plan(numels: Sequence[int]) -> List[Launch]:
    """The kernel's launches over tensors of ``numels`` elements, in order:
    each ``(first, end, chunk_start)`` takes tensors ``first`` to
    ``end - 1``, and ``chunk_start[k]`` is the launch's first chunk of its
    k-th tensor, ``chunk_start[-1]`` its number of chunks. The tensors are
    split over as few launches as ``MAX_TENSORS`` allows, evenly; a launch
    whose tensors are all empty is left out."""
    n = len(numels)
    count = -(-n // MAX_TENSORS)
    plan = []
    for i in range(count):
        first, end = i * n // count, (i + 1) * n // count
        starts = [0]
        for size in numels[first:end]:
            if size > INT_MAX:
                raise ValueError(f"a tensor of {size} elements is beyond the "
                                 "AdamW kernel's 32-bit sizes")
            starts.append(starts[-1] + -(-size // CHUNK))
        if starts[-1] > INT_MAX:
            raise ValueError(f"{starts[-1]} chunks are beyond the AdamW "
                             "kernel's 32-bit chunk index")
        if starts[-1]:
            plan.append((first, end, starts))
    return plan


def plain_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 mu: List[torch.Tensor], nu: List[torch.Tensor],
                 scalars: torch.Tensor, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """AdamW in place, as 16 ``torch._foreach_*`` passes on any device;
    ``scalars``: the learning rate, 1 - b1^t and 1 - b2^t."""
    lr, bc1, bc2 = scalars.unbind()
    # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - b2))
    mu_hat = torch._foreach_div(mu, bc1)
    nu_hat = torch._foreach_div(nu, bc2)
    denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), eps)
    update = torch._foreach_div(mu_hat, denom)
    if weight_decay:
        torch._foreach_add_(update, torch._foreach_mul(params, weight_decay))
    torch._foreach_sub_(params, torch._foreach_mul(update, lr))


def _check_update(params, grads, mu, nu, scalars) -> None:
    """What the AdamW kernel takes: equal lists of float32, contiguous
    tensors, each of its param's shape, and 3 scalars, all on one CUDA
    device. Raises on anything else."""
    device = scalars.device
    if scalars.dtype != torch.float32 or scalars.shape != (3,) or \
            not scalars.is_contiguous():
        raise TypeError("the AdamW kernel takes 3 contiguous float32 "
                        f"scalars; got {scalars.dtype} {tuple(scalars.shape)}")
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError(f"{len(params)} params, {len(grads)} grads, "
                         f"{len(mu)} mu and {len(nu)} nu")
    for i, group in enumerate(zip(params, grads, mu, nu)):
        shape = group[0].shape
        for name, t in zip(("param", "grad", "mu", "nu"), group):
            if t.device != device:
                raise ValueError(f"{name} {i} is on {t.device}, the "
                                 f"scalars on {device}")
            if t.dtype != torch.float32:
                raise TypeError(f"the AdamW kernel takes float32; {name} "
                                f"{i} is {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"the AdamW kernel needs contiguous "
                                 f"tensors; {name} {i} has strides "
                                 f"{t.stride()}")
            if t.shape != shape:
                raise ValueError(f"{name} {i} has shape {tuple(t.shape)}, "
                                 f"its param {tuple(shape)}")
    if device.type != "cuda":
        raise ValueError(f"the AdamW kernel runs on CUDA, not {device}")


def fused_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                 mu: List[torch.Tensor], nu: List[torch.Tensor],
                 scalars: torch.Tensor, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """``plain_update`` on a card as the hand-written kernel
    ``csrc/adamw.cu``: one pass, in ``launch_plan``'s launches, each
    counted in ``kernels.launches["adamw"]``. The tensors' addresses travel
    as launch arguments, so a captured graph keeps them."""
    _check_update(params, grads, mu, nu, scalars)
    with span("kernels.adamw"):
        fn = kernels.function("adamw", "tf_adamw_step_launch", _ARGTYPES)
        consts = [ctypes.c_float(x) for x in
                  (b1, 1 - b1, b2, 1 - b2, eps, weight_decay)]
        numels = [p.numel() for p in params]
        for first, end, starts in launch_plan(numels):
            cut = slice(first, end)
            ptrs = [t.data_ptr() for four in zip(params[cut], grads[cut],
                                                   mu[cut], nu[cut])
                    for t in four]
            n = end - first
            err = kernels.call(
                fn, scalars.device, n, (ctypes.c_ulonglong * (4 * n))(*ptrs),
                (ctypes.c_int * n)(*numels[cut]),
                (ctypes.c_int * (n + 1))(*starts), scalars.data_ptr(),
                *consts)
            if err != 0:
                raise RuntimeError(f"AdamW kernel launch failed: CUDA error "
                                   f"{err} over tensors {first}-{end - 1}")
            kernels.count_launch("adamw")


class AdamW:
    """optax ``adamw`` (eps_root 0, no Nesterov) behind the JAX package's
    clipping chain, over ``params``' ``.grad``; ZeRO-1 over the mesh's
    data group with ``zero``, tensor-parallel norms with ``shard_dims``
    (one entry per parameter: its sharded dimension or None)."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, agc_clip: float = 0.0,
                 grad_clip_norm: float = 0.0, mesh: Optional[Mesh] = None,
                 shard_dims: Optional[Sequence[Optional[int]]] = None,
                 zero: bool = False):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.agc_clip = agc_clip
        self.grad_clip_norm = grad_clip_norm
        self.step_count = 0
        n = len(self.params)
        self.shard_dims = list(shard_dims) if shard_dims else [None] * n
        if len(self.shard_dims) != n:
            raise ValueError(f"{len(self.shard_dims)} shard dims for {n} "
                             "params")
        self.mesh = mesh
        self.tp = None if mesh is None or mesh.model == 1 else \
            TensorParallel(mesh.model_group, mesh.model, mesh.model_index,
                           {})
        self.zero = bool(zero) and mesh is not None and mesh.data > 1
        if self.zero:
            self.owner = zero_plan([p.shape for p in self.params], mesh.data)
            self.owned = [i for i in range(n)
                          if self.owner[i] in (-1, mesh.data_index)]
        else:
            self.owner, self.owned = [-1] * n, list(range(n))
        owned = set(self.owned)
        self.mu = [torch.zeros_like(p) if i in owned else None
                   for i, p in enumerate(self.params)]
        self.nu = [torch.zeros_like(p) if i in owned else None
                   for i, p in enumerate(self.params)]
        like = self.params[0] if self.params else torch.zeros(())
        # the update under way's learning rate, 1 - b1^t and 1 - b2^t
        self.scalars = torch.zeros(3, dtype=like.dtype, device=like.device)
        self._lr, self._bc1, self._bc2 = self.scalars.unbind()
        self._zeros = {}  # a zero gradient for each parameter that has none

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _broadcast_from_owners(self, tensors: List[torch.Tensor]) -> None:
        """Each owner's tensors to every rank of the data group, in place:
        one flattened broadcast per owner."""
        m = self.mesh
        for r in range(m.data):
            mine = [t for i, t in enumerate(tensors) if self.owner[i] == r]
            if not mine:
                continue
            flat = _flatten_dense_tensors(mine)
            dist.broadcast(flat, src=m.data_ranks[r], group=m.data_group)
            if r != m.data_index:
                for t, v in zip(mine, _unflatten_dense_tensors(flat, mine)):
                    t.copy_(v)

    def _full(self, moments: List[Optional[torch.Tensor]]
              ) -> List[torch.Tensor]:
        out = list(moments)
        if self.zero:
            out = [t if t is not None else torch.empty_like(p)
                   for t, p in zip(out, self.params)]
            # replicated moments are equal everywhere; the partitioned
            # ones come from their owners
            self._broadcast_from_owners(out)
        if self.tp is not None:
            out = [gather_tensor(t, d, self.tp) if d is not None else t
                   for t, d in zip(out, self.shard_dims)]
        return out

    def state_dict(self) -> dict:
        """The moments and the count of updates done, which is also the
        schedule's position: a restored optimizer continues the same
        schedule. Full, unsharded moments (collective under a mesh)."""
        return {"step_count": self.step_count, "mu": self._full(self.mu),
                "nu": self._full(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for name in ("mu", "nu"):
            src = state[name]
            if len(src) != len(self.params):
                raise ValueError(f"optimizer state has {len(src)} {name} "
                                 f"tensors for {len(self.params)} params")
            for i, (dst, v) in enumerate(zip(getattr(self, name), src)):
                if dst is None:
                    continue
                d = self.shard_dims[i]
                if self.tp is not None and d is not None:
                    v = shard_tensor(v, d, self.tp.size, self.tp.index)
                dst.copy_(v)
        self.step_count = int(state["step_count"])

    def _zero(self, i: int) -> torch.Tensor:
        z = self._zeros.get(i)
        if z is None:
            z = self._zeros[i] = torch.zeros_like(self.params[i])
        return z

    def clipped_grads(self) -> List[torch.Tensor]:
        with span("train.clip"):
            grads = [p.grad if p.grad is not None else self._zero(i)
                     for i, p in enumerate(self.params)]
            group = None if self.tp is None else self.tp.group
            dims = self.shard_dims if self.tp is not None else None
            if self.agc_clip > 0:
                grads = adaptive_grad_clip(grads, self.params, self.agc_clip,
                                           shard_dims=dims, group=group)
            if self.grad_clip_norm > 0:
                grads = clip_by_global_norm(grads, self.grad_clip_norm,
                                            shard_dims=dims, group=group)
        return grads

    def advance(self) -> None:
        """The host part of an update: count it, and write its learning
        rate and bias corrections on the device by ``fill_`` (a launch
        argument each, no host-to-device copy)."""
        lr = self.schedule(self.step_count)
        self.step_count += 1
        self._lr.fill_(lr)
        self._bc1.fill_(1 - self.b1 ** self.step_count)
        self._bc2.fill_(1 - self.b2 ** self.step_count)

    @torch.no_grad()
    def step(self) -> None:
        """The device part of an update: clipping and AdamW, with the
        scalars that ``advance``, run first, wrote."""
        grads = self.clipped_grads()
        with span("train.update"):
            own = self.owned
            if own:
                update = fused_update if self.scalars.is_cuda else \
                    plain_update
                update([self.params[i] for i in own], [grads[i] for i in own],
                       [self.mu[i] for i in own], [self.nu[i] for i in own],
                       self.scalars, self.b1, self.b2, self.eps,
                       self.weight_decay)
            if self.zero:
                self._broadcast_from_owners(self.params)


def make_optimizer(params: Iterable[torch.Tensor], config: GlobalConfig,
                   steps_per_epoch: Optional[int] = None,
                   mesh: Optional[Mesh] = None,
                   shard_dims: Optional[Sequence[Optional[int]]] = None
                   ) -> AdamW:
    """AdamW from the config; ZeRO-1 under a mesh when
    ``config.train.zero_redundancy_optimizer``."""
    t = config.train
    return AdamW(params, make_schedule(config, steps_per_epoch),
                 b1=t.adam_b1, b2=t.adam_b2, eps=t.adam_eps,
                 weight_decay=t.weight_decay,
                 agc_clip=t.agc_clip or 0.0,
                 grad_clip_norm=t.grad_clip_norm or 0.0, mesh=mesh,
                 shard_dims=shard_dims,
                 zero=bool(t.zero_redundancy_optimizer))
