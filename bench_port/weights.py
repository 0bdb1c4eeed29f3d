"""Seeded weights, made on the device in a few large calls; the one state
dict that both the port and the reference load.

The families are those of the configuration's initialisation (the JAX
package's, which the port's ``init_like_flax`` follows): lecun-normal
convolution and dense kernels cut at two standard deviations, N(0, 0.02)
GPT linears, N(0, 0.001) for the CenterNet size and offset branches, the
heatmap's prior bias, zero biases, identity norms.

One departure: the heatmap branch's last convolution is drawn at N(0,
0.001) too. Under lecun-normal weights its logits spread so far that the
share of the 64x64 map above the agent's 0.3 confidence threshold swings
from none to all 100 decoded boxes with the seed, and the agent's
polygon NMS then costs from nothing to seconds a frame: the seed would
change the work. At 0.001 every score stays near the 0.1 prior, on every
seed, and no box passes the threshold.

Every float leaf has a rule: these, which hold for the layers of every
reference, merged with the run's reference module's ``seed_rules``
(its own leaves, such as the GPTs' position embeddings), whose rule
wins where both name a leaf. A leaf that no rule names is an error, not
a zero.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

TRUNC = 0.87962566103423978  # std of a unit normal cut at +-2


def _plan(ref, model: nn.Module):
    """key -> (kind, value) for the float leaves of the state dict: kind
    is "normal" (value: its standard deviation), "zero", "one" or
    "const"."""
    plan = {}
    c = model.cfg.model.centernet
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if ".transformer" in f".{name}":
                std = 0.02
            else:
                std = math.sqrt(1.0 / m.weight[0].numel()) / TRUNC
            plan[pre + "weight"] = ("normal", std)
            if m.bias is not None:
                plan[pre + "bias"] = ("zero", 0.0)
        elif isinstance(m, nn.GRUCell):
            for w in ("weight_ih", "weight_hh"):
                std = math.sqrt(1.0 / getattr(m, w)[0].numel()) / TRUNC
                plan[pre + w] = ("normal", std)
            plan[pre + "bias_ih"] = plan[pre + "bias_hh"] = ("zero", 0.0)
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
            plan[pre + "weight"] = ("one", 0.0)
            plan[pre + "bias"] = ("zero", 0.0)
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                plan[pre + "running_mean"] = ("zero", 0.0)
                plan[pre + "running_var"] = ("one", 0.0)
    for branch in ("wh", "offset"):
        for i in (0, 2):
            plan[f"head.{branch}_head.{i}.weight"] = (
                "normal", c.center_net_normal_init_std / TRUNC)
    plan["head.heatmap_head.2.weight"] = (
        "normal", c.center_net_normal_init_std / TRUNC)
    prior = c.center_net_bias_init_with_prob
    plan["head.heatmap_head.2.bias"] = ("const",
                                        -math.log((1 - prior) / prior))
    plan.update(ref.seed_rules(model))
    return plan


def seeded_state_dict(ref, cfg, seed: int, device
                      ) -> Dict[str, torch.Tensor]:
    """The state dict of the configuration's model as the reference
    module ``ref`` builds it, from ``seed``, on ``device``: one normal
    draw for every random leaf, one buffer for the rest."""
    model = ref.build(cfg, "meta")
    shapes = model.state_dict()
    plan = _plan(ref, model)
    floats = {k: v for k, v in shapes.items() if v.is_floating_point()}
    unnamed = [k for k in floats if k not in plan]
    if unnamed:
        raise ValueError(
            f"no seeding rule for {len(unnamed)} float leaves of "
            f"{ref.__name__}, first {unnamed[:5]}: give them one in its "
            "seed_rules")
    total = sum(v.numel() for v in floats.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.zeros(total, device=device)
    normal = [k for k in floats if plan[k][0] == "normal"]
    n_normal = sum(floats[k].numel() for k in normal)
    draw = torch.randn(n_normal, generator=gen, device=device).clamp_(-2, 2)
    out, at, taken = {}, 0, 0
    for k, v in floats.items():
        n = v.numel()
        view = flat[at:at + n]
        kind, value = plan[k]
        if kind == "normal":
            view.copy_(draw[taken:taken + n]).mul_(value)
            taken += n
        elif kind == "one":
            view.fill_(1.0)
        elif kind == "const":
            view.fill_(value)
        elif kind != "zero":
            raise ValueError(f"{k}: no seeding kind {kind!r}")
        out[k] = view.view(v.shape)
        at += n
    for k, v in shapes.items():
        if not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
    return {k: out[k] for k in shapes}
