"""GPT-style fusion transformer over image + LiDAR anchor tokens
(counterpart of transfuser_tpu/models/gpt.py).

Reference: team_code_transfuser/transfuser.py:284-366 (GPT), 491-549
(SelfAttention/Block); parameter names are the reference's. Attention
goes through ``ops.attention.attention`` (the hand-written CUDA kernel on
the card) except in training with ``attn_pdrop > 0``, where it keeps
explicit probabilities for attention dropout, as the JAX package does
(gpt.py:56-64). Dropout sits where the JAX package puts it: on the
embeddings, on the attention probabilities, after the attention
projection and after the MLP; only in training mode.

Dropout masks come from the ``torch.Generator`` the caller passes (the
trainer seeds one per step from ``config.train.seed`` and the step), or
from torch's default generator. They cannot equal the JAX package's
``fold_in`` stream: the two frameworks draw different bits from one seed.

Tensor parallel (``Block.set_tensor_parallel``, called by
``parallel.sharding.shard_model`` once the linears hold their shards):
q/k/v and ``mlp.0`` hold a column shard, so each rank computes
``n_head / model`` heads and its slice of the MLP's hidden units; ``proj``
and ``mlp.2`` hold a row shard, their partial outputs are summed over the
model group and the bias is added once, after the sum (Megatron's
identity / all-reduce pair, ``parallel/comm.py``). The ranks of a model
group hold the same rows and draw the same dropout stream, so the
replicated activations stay equal on all of them; the attention
probabilities' mask is drawn for every head and each rank keeps its
heads' slice, so the masks are one device's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention
from ..ops.dtypes import acc_dtype
from ..parallel import comm
from .layers import LayerNorm, Linear

Generator = Optional[torch.Generator]


def dropout(x: torch.Tensor, rate: float, gen: Generator,
            heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate) in x's dtype. ``heads`` = (first, count):
    x holds heads first.. of ``count`` on dim 1; the mask is drawn for all
    of them and sliced, so it and the generator's stream are those of the
    unsharded x."""
    if rate == 0.0:
        return x
    shape = x.shape if heads is None else \
        (x.shape[0], heads[1]) + tuple(x.shape[2:])
    keep = torch.rand(shape, generator=gen, device=x.device) >= rate
    if heads is not None:
        keep = keep[:, heads[0]:heads[0] + x.shape[1]]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def row_parallel(linear: Linear, x: torch.Tensor,
                 group: comm.Group) -> torch.Tensor:
    """A row-parallel linear: this rank's partial product, summed over
    the model group, then the bias; the plain linear without a group."""
    if group is None:
        return linear(x)
    y = F.linear(x, linear.weight.to(x.dtype))
    return comm.reduce_from_group(y, group) + linear.bias.to(x.dtype)


class SelfAttention(nn.Module):
    def __init__(self, n_embd: int, n_head: int, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0):
        super().__init__()
        self.key = Linear(n_embd, n_embd)
        self.query = Linear(n_embd, n_embd)
        self.value = Linear(n_embd, n_embd)
        self.proj = Linear(n_embd, n_embd)
        self.n_head = n_head
        self.attn_pdrop = attn_pdrop
        self.resid_pdrop = resid_pdrop
        self.tp_group: comm.Group = None
        self.local_heads = n_head
        self.first_head = 0

    def forward(self, x: torch.Tensor, gen: Generator = None) -> torch.Tensor:
        b, t, c = x.shape
        hs = c // self.n_head
        x = comm.copy_to_group(x, self.tp_group)
        q = self.query(x).reshape(b, t, self.local_heads, hs)
        k = self.key(x).reshape(b, t, self.local_heads, hs)
        v = self.value(x).reshape(b, t, self.local_heads, hs)
        if self.training and self.attn_pdrop > 0.0:
            acc = acc_dtype(x.dtype)
            att = torch.einsum("bthd,bshd->bhts", q.to(acc), k.to(acc))
            att = torch.softmax(att * (1.0 / math.sqrt(hs)), dim=-1)
            att = dropout(att.to(x.dtype), self.attn_pdrop, gen,
                          (self.first_head, self.n_head))
            y = torch.einsum("bhts,bshd->bthd", att, v)
        else:
            y = attention(q, k, v)
        y = row_parallel(self.proj, y.reshape(b, t, self.local_heads * hs),
                         self.tp_group)
        return dropout(y, self.resid_pdrop, gen) if self.training else y


class Block(nn.Module):
    def __init__(self, n_embd: int, n_head: int, block_exp: int,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0):
        super().__init__()
        self.ln1 = LayerNorm(n_embd, eps=1e-5)
        self.ln2 = LayerNorm(n_embd, eps=1e-5)
        self.attn = SelfAttention(n_embd, n_head, attn_pdrop, resid_pdrop)
        self.mlp = nn.Sequential(
            Linear(n_embd, block_exp * n_embd), nn.ReLU(),
            Linear(block_exp * n_embd, n_embd))
        self.resid_pdrop = resid_pdrop
        self.tp_group: comm.Group = None

    def set_tensor_parallel(self, group: comm.Group, size: int,
                            index: int) -> None:
        """Run on this rank's shard (``index`` of ``size``) of the heads
        and MLP units (the linears already hold their shards)."""
        if self.attn.n_head % size:
            raise ValueError(f"{self.attn.n_head} heads do not divide over "
                             f"{size} model ranks")
        self.tp_group = self.attn.tp_group = group
        self.attn.local_heads = self.attn.n_head // size
        self.attn.first_head = index * self.attn.local_heads

    def forward(self, x: torch.Tensor, gen: Generator = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), gen)
        h = comm.copy_to_group(self.ln2(x), self.tp_group)
        h = row_parallel(self.mlp[2], self.mlp[1](self.mlp[0](h)),
                         self.tp_group)
        return x + (dropout(h, self.resid_pdrop, gen) if self.training
                    else h)


class GPTFusion(nn.Module):
    """Fuse pooled image tokens (B,Hi,Wi,C) with lidar tokens (B,Hl,Wl,C).

    NHWC in and out, like the JAX module; computes in the tokens' dtype.
    ``reference_view_unpack`` replicates the reference's token -> map
    unpacking quirk (transfuser.py:360): the (T, C) token block is
    reinterpreted as (C, H, W) with a raw view, a fixed scramble that
    reference-trained weights absorb.
    """

    def __init__(self, n_embd: int, n_head: int = 4, n_layer: int = 4,
                 block_exp: int = 4, img_anchors: Tuple[int, int] = (5, 22),
                 lidar_anchors: Tuple[int, int] = (8, 8),
                 embd_pdrop: float = 0.0, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, use_velocity: bool = True,
                 reference_view_unpack: bool = False):
        super().__init__()
        self.n_embd = n_embd
        self.img_anchors = tuple(img_anchors)
        self.lidar_anchors = tuple(lidar_anchors)
        self.reference_view_unpack = reference_view_unpack
        n_tok = (self.img_anchors[0] * self.img_anchors[1] +
                 self.lidar_anchors[0] * self.lidar_anchors[1])
        self.pos_emb = nn.Parameter(torch.zeros(1, n_tok, n_embd))
        self.vel_emb = Linear(1, n_embd) if use_velocity else None
        self.embd_pdrop = embd_pdrop
        self.blocks = nn.ModuleList(
            [Block(n_embd, n_head, block_exp, attn_pdrop, resid_pdrop)
             for _ in range(n_layer)])
        self.ln_f = LayerNorm(n_embd, eps=1e-5)

    def forward(self, image_tokens: torch.Tensor, lidar_tokens: torch.Tensor,
                velocity: Optional[torch.Tensor] = None,
                gen: Generator = None):
        b = image_tokens.shape[0]
        dt = image_tokens.dtype
        hi, wi = self.img_anchors
        hl, wl = self.lidar_anchors
        n_img = hi * wi
        x = torch.cat([image_tokens.reshape(b, n_img, self.n_embd),
                       lidar_tokens.reshape(b, hl * wl, self.n_embd)], dim=1)
        x = x + self.pos_emb.to(dt)
        if self.vel_emb is not None:
            if velocity is None:
                raise ValueError("GPTFusion with use_velocity needs velocity")
            x = x + self.vel_emb(velocity.reshape(b, 1).to(dt))[:, None, :]
        if self.training:
            x = dropout(x, self.embd_pdrop, gen)
        for block in self.blocks:
            x = block(x, gen)
        x = self.ln_f(x)
        if self.reference_view_unpack:
            image_out = x[:, :n_img].reshape(b, self.n_embd, hi, wi)
            lidar_out = x[:, n_img:].reshape(b, self.n_embd, hl, wl)
            return image_out.permute(0, 2, 3, 1), lidar_out.permute(0, 2, 3, 1)
        return (x[:, :n_img].reshape(b, hi, wi, self.n_embd),
                x[:, n_img:].reshape(b, hl, wl, self.n_embd))
