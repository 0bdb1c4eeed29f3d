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
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch

from ..config import GlobalConfig

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


def unitwise_norm(x: torch.Tensor) -> torch.Tensor:
    """optax's unit-wise L2 norm, on the port's layouts: a vector (or a
    tensor that squeezes to one) whole; Linear / GRU weights (out, in) per
    output row; the GPT's (1, T, C) pos_emb over dim 0; conv weights
    (O, I, H, W) per output channel. These are the units optax takes on
    the JAX layouts (in, out), (1, T, C) and (H, W, I, O)."""
    sq = x * x
    if x.squeeze().dim() <= 1:
        n = sq.sum()
    elif x.dim() == 2:
        n = sq.sum(1, keepdim=True)
    elif x.dim() == 3:
        n = sq.sum(0, keepdim=True)
    elif x.dim() == 4:
        n = sq.sum((1, 2, 3), keepdim=True)
    else:
        raise ValueError(f"no unit-wise norm for shape {tuple(x.shape)}")
    return torch.sqrt(n).expand_as(x)


def adaptive_grad_clip(grads: List[torch.Tensor], params: List[torch.Tensor],
                       clipping: float, eps: float = 1e-3) -> List[torch.Tensor]:
    out = []
    for g, p in zip(grads, params):
        g_norm = unitwise_norm(g)
        max_norm = clipping * torch.clamp(unitwise_norm(p), min=eps)
        clipped = g * (max_norm / torch.clamp(g_norm, min=1e-6))
        out.append(torch.where(g_norm < max_norm, g, clipped))
    return out


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    g_norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scaled = [(g / g_norm) * max_norm for g in grads]
    return [torch.where(g_norm < max_norm, g, s)
            for g, s in zip(grads, scaled)]


class AdamW:
    """optax ``adamw`` (eps_root 0, no Nesterov) behind the JAX package's
    clipping chain, over ``params``' ``.grad``."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, agc_clip: float = 0.0,
                 grad_clip_norm: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.agc_clip = agc_clip
        self.grad_clip_norm = grad_clip_norm
        self.step_count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """The moments and the count of updates done, which is also the
        schedule's position: a restored optimizer continues the same
        schedule."""
        return {"step_count": self.step_count, "mu": list(self.mu),
                "nu": list(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for name in ("mu", "nu"):
            src = state[name]
            if len(src) != len(self.params):
                raise ValueError(f"optimizer state has {len(src)} {name} "
                                 f"tensors for {len(self.params)} params")
            for dst, v in zip(getattr(self, name), src):
                dst.copy_(v)
        self.step_count = int(state["step_count"])

    def clipped_grads(self) -> List[torch.Tensor]:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.agc_clip > 0:
            grads = adaptive_grad_clip(grads, self.params, self.agc_clip)
        if self.grad_clip_norm > 0:
            grads = clip_by_global_norm(grads, self.grad_clip_norm)
        return grads

    @torch.no_grad()
    def step(self) -> None:
        grads = self.clipped_grads()
        lr = self.schedule(self.step_count)
        self.step_count += 1
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        mu_hat = torch._foreach_div(self.mu, 1 - b1 ** self.step_count)
        nu_hat = torch._foreach_div(self.nu, 1 - b2 ** self.step_count)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        update = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(
                self.params, self.weight_decay))
        torch._foreach_add_(self.params, torch._foreach_mul(update, -lr))


def make_optimizer(params: Iterable[torch.Tensor], config: GlobalConfig,
                   steps_per_epoch: Optional[int] = None) -> AdamW:
    t = config.train
    return AdamW(params, make_schedule(config, steps_per_epoch),
                 b1=t.adam_b1, b2=t.adam_b2, eps=t.adam_eps,
                 weight_decay=t.weight_decay,
                 agc_clip=t.agc_clip or 0.0,
                 grad_clip_norm=t.grad_clip_norm or 0.0)
