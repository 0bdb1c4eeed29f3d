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

The update runs on the device with ``torch._foreach_*`` ops over all
parameters at once; the step count lives on the host, so no step syncs.
The host part of an update (``AdamW.advance``: count it, and write its
learning rate and bias corrections into a small device tensor with
``fill_``, whose value travels as a launch argument) is apart from the
device part, which reads that tensor: a captured step
(``train/step_graphs.py``) holds the device part, and each replay runs
the host part before it.

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

from typing import Callable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..config import GlobalConfig
from ..parallel import comm
from ..parallel.sharding import (Mesh, TensorParallel, gather_tensor,
                                 shard_tensor, zero_plan)
from ..tracing import span

Schedule = Callable[[int], float]


def capturing() -> bool:
    """Whether this thread's current CUDA stream is being captured into a
    graph."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


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
        """One update: ``advance``, then clipping and AdamW on the device.
        While a CUDA graph captures the step, the host part is left to
        the code that replays it, before each replay."""
        grads = self.clipped_grads()
        with span("train.update"):
            if not capturing():
                self.advance()
            b1, b2 = self.b1, self.b2
            own = self.owned
            params = [self.params[i] for i in own]
            grads = [grads[i] for i in own]
            mu = [self.mu[i] for i in own]
            nu = [self.nu[i] for i in own]
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            mu_hat = torch._foreach_div(mu, self._bc1)
            nu_hat = torch._foreach_div(nu, self._bc2)
            denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
            update = torch._foreach_div(mu_hat, denom)
            if self.weight_decay:
                torch._foreach_add_(update, torch._foreach_mul(
                    params, self.weight_decay))
            torch._foreach_sub_(params, torch._foreach_mul(update, self._lr))
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
