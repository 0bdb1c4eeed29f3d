"""Plain fp32 training step of the reference model: CenterNet targets, the
11-term loss (reference model.py:733-805 and the mmdet head losses) and
AdamW (optax's arithmetic: bias-corrected moments, decoupled weight decay
on every parameter, constant learning rate). Imports nothing of the port.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .model import lowp

EPS = 1e-12
RUNNING = ("running_mean", "running_var")
DETAILED = ("loss_wp", "loss_bev", "loss_depth", "loss_semantic",
            "loss_center_heatmap", "loss_wh", "loss_offset",
            "loss_yaw_class", "loss_yaw_res", "loss_velocity", "loss_brake")


def gaussian_radius(h, w, min_overlap):
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt(torch.clamp(b1 * b1 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - torch.sqrt(torch.clamp(b2 * b2 - 16 * c2, min=0.0))) / 8
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))) \
        / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def targets(labels, feat_hw, image_hw, bins, min_overlap, min_radius):
    """Dense CenterNet targets of padded boxes (B, K, 7), the later box
    winning a shared pixel, as the reference's per-box loop."""
    bsz, k, _ = labels.shape
    fh, fw = feat_hw
    wr = fw / image_hw[1]
    hr = fh / image_hw[0]
    dev = labels.device
    valid = labels.abs().sum(-1) > 0.0
    ctx = labels[..., 0] * wr
    cty = labels[..., 1] * wr  # the reference scales both by the width
    cxi = torch.trunc(ctx).to(torch.int32)
    cyi = torch.trunc(cty).to(torch.int32)
    sw = labels[..., 2] * wr
    sh = labels[..., 3] * hr
    radius = torch.clamp(torch.trunc(gaussian_radius(sh, sw, min_overlap)),
                         min=float(min_radius))
    sigma = (2.0 * radius + 1.0) / 6.0
    dy = torch.arange(fh, device=dev, dtype=torch.float32)[None, None] \
        - cyi[..., None].float()
    dx = torch.arange(fw, device=dev, dtype=torch.float32)[None, None] \
        - cxi[..., None].float()
    g = torch.exp(-(dy[..., :, None] ** 2 + dx[..., None, :] ** 2)
                  / (2.0 * sigma[..., None, None] ** 2))
    window = (dy.abs()[..., :, None] <= radius[..., None, None]) & \
        (dx.abs()[..., None, :] <= radius[..., None, None])
    g = torch.where(window & valid[..., None, None], g, torch.zeros_like(g))
    heatmap = g.amax(dim=1)[..., None]
    pix = cyi.clamp(0, fh - 1).long() * fw + cxi.clamp(0, fw - 1).long()
    later = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
    wins = valid & ~((pix[:, :, None] == pix[:, None, :])
                     & valid[:, None, :] & later).any(-1)
    two_pi = 2.0 * math.pi
    per = two_pi / bins
    shifted = torch.remainder(torch.remainder(labels[..., 4], two_pi)
                              + per / 2.0, two_pi)
    ycls = torch.trunc(shifted / per).to(torch.int32)
    yres = shifted - (ycls.float() * per + per / 2.0)
    vals = torch.stack([sw, sh, ctx - cxi.float(), cty - cyi.float(),
                        ycls.float(), yres, labels[..., 5],
                        labels[..., 6].to(torch.int32).float(),
                        torch.ones_like(sw)], -1)
    n = bsz * fh * fw
    flat = pix + torch.arange(bsz, device=dev)[:, None] * (fh * fw)
    flat = torch.where(wins, flat, torch.full_like(flat, n))
    dense = torch.zeros(n + 1, vals.shape[-1], device=dev)
    dense.scatter_(0, flat.reshape(-1, 1).expand(-1, vals.shape[-1]),
                   vals.reshape(-1, vals.shape[-1]))
    t = dense[:n].reshape(bsz, fh, fw, -1)
    avg = torch.clamp((heatmap == 1.0).sum().float(), min=1.0)
    return heatmap, t, avg


def _nll(logits, labels):
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def losses(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
           cfg) -> Dict[str, torch.Tensor]:
    """The detailed loss dict, unweighted, in the reference's order."""
    c = cfg.model.centernet
    res: Dict[str, torch.Tensor] = {}
    res["loss_wp"] = (out["pred_wp"] - batch["ego_waypoint"]).abs().mean()
    bw = torch.tensor(cfg.loss.bev_class_weights,
                      device=out["pred_bev"].device)[batch["bev"].long()]
    res["loss_bev"] = (_nll(out["pred_bev"], batch["bev"]) * bw).sum() \
        / bw.sum()
    heat, t, af = targets(batch["label"], tuple(out["head_heatmap"].shape[1:3]),
                          (cfg.sensors.lidar_resolution_height,
                           cfg.sensors.lidar_resolution_width),
                          c.num_dir_bins, c.gaussian_min_overlap,
                          c.gaussian_min_radius)
    w = t[..., 8]
    w2 = w[..., None].expand(-1, -1, -1, 2)
    p = out["head_heatmap"]
    pos = -torch.log(p + EPS) * torch.pow(1.0 - p, 2.0) * (heat == 1.0).float()
    neg = -torch.log(1.0 - p + EPS) * torch.pow(p, 2.0) \
        * torch.pow(1.0 - heat, 4.0)
    res["loss_center_heatmap"] = (pos + neg).sum() / af
    res["loss_wh"] = c.loss_wh_weight * ((out["head_wh"] - t[..., 0:2]).abs()
                                         * w2).sum() / (af * 2.0)
    res["loss_offset"] = ((out["head_offset"] - t[..., 2:4]).abs()
                          * w2).sum() / (af * 2.0)

    def ce(logits, labels):
        nll = _nll(logits, labels)
        if cfg.loss.reference_ce_batch_broadcast:
            return (nll.sum(0) * w.sum(0)).sum() / af
        return (nll * w).sum() / af

    res["loss_yaw_class"] = ce(out["head_yaw_class"], t[..., 4].long())
    d = (out["head_yaw_res"][..., 0] - t[..., 5]).abs()
    res["loss_yaw_res"] = (torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
                           * w).sum() / af
    res["loss_velocity"] = ((out["head_velocity"][..., 0] - t[..., 6]).abs()
                            * w).sum() / af
    res["loss_brake"] = ce(out["head_brake"], t[..., 7].long())
    if cfg.model.multitask:
        res["loss_semantic"] = cfg.loss.ls_seg * _nll(
            out["pred_semantic"], batch["semantic"]).mean()
        res["loss_depth"] = cfg.loss.ls_depth * (
            out["pred_depth"] - batch["depth"]).abs().mean()
    else:
        res["loss_semantic"] = res["loss_depth"] = \
            torch.zeros_like(res["loss_wp"])
    return {k: res[k] for k in DETAILED}


def total(detailed, cfg):
    return sum(wt * detailed[k] for k, wt in
               zip(DETAILED, cfg.loss.detailed_losses_weights))


def model_inputs(batch):
    pillars = "lidar_raw" in batch
    return dict(rgb=batch["rgb"],
                lidar=batch["lidar_raw"] if pillars else batch["lidar"],
                target_point=batch["target_point"],
                target_point_image=batch["target_point_image"],
                velocity=batch["speed"],
                num_points=batch["num_points"] if pillars else None)


def dropout_generator(cfg, step, device):
    """The per-step dropout stream of the configuration: seeded from the
    training seed and the step count."""
    return torch.Generator(device=device).manual_seed(
        int(cfg.train.seed) * 2 ** 32 + step)


def train(model, cfg, batches: List[Dict[str, torch.Tensor]],
          mode: str = "fp32", moments=None, count: int = 0
          ) -> Dict[str, object]:
    """AdamW steps of ``model`` over ``batches``, in ``mode`` ("fp32" or
    the control's "fp8"), from the moments ``moments`` = (mu, nu), each a
    tensor per trainable parameter by name (zeros where None), after
    ``count`` updates (the bias correction's and the dropout stream's
    position). Returns each step's total loss, every parameter's gradient
    norm at step 1 and change norm after the last step, and every
    BatchNorm running statistic's change in step 1, by name."""
    t = cfg.train
    b1, b2 = t.adam_b1, t.adam_b2
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in model.named_parameters() if p.requires_grad]
    start = [p.detach().clone() for p in params]
    running = {k: v for k, v in model.state_dict().items()
               if k.endswith(RUNNING)}
    stats0 = {k: v.clone() for k, v in running.items()}
    stats = None
    if moments is None:
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
    else:
        mu = [moments[0][n].to(p.device, torch.float32).clone()
              for n, p in zip(names, params)]
        nu = [moments[1][n].to(p.device, torch.float32).clone()
              for n, p in zip(names, params)]
    loss_steps, grad_norms = [], None
    device = params[0].device
    with lowp(mode):
        for step, batch in enumerate(batches):
            model.train()
            for p in params:
                p.grad = None
            out = model(**model_inputs(batch), compute_aux=True,
                        gen=dropout_generator(cfg, count + step, device))
            loss = total(losses(out, batch, cfg), cfg)
            loss.backward()
            loss_steps.append(float(loss.detach()))
            if stats is None:
                stats = {k: running[k] - stats0[k] for k in running}
            with torch.no_grad():
                grads = [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in params]
                if grad_norms is None:
                    grad_norms = [float(torch.linalg.vector_norm(g))
                                  for g in grads]
                k = count + step + 1
                for p, g, m, v in zip(params, grads, mu, nu):
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).add_(g * g, alpha=1 - b2)
                    upd = (m / (1 - b1 ** k)) / (
                        torch.sqrt(v / (1 - b2 ** k)) + t.adam_eps)
                    p.add_(upd + t.weight_decay * p, alpha=-t.lr)
    change = [float(torch.linalg.vector_norm(p.detach() - s))
              for p, s in zip(params, start)]
    return dict(loss=loss_steps, grad=dict(zip(names, grad_norms)),
                change=dict(zip(names, change)), stats=stats)


def loss_at(model, cfg, batch, state, count: int, mode: str = "fp32"
            ) -> float:
    """The total loss of one training forward of ``model`` with the
    weights and statistics ``state``, on ``batch``, with the dropout
    stream of the step after ``count`` updates."""
    model.load_state_dict(state)
    model.train()
    with torch.no_grad(), lowp(mode):
        out = model(**model_inputs(batch), compute_aux=True,
                    gen=dropout_generator(cfg, count, batch["rgb"].device))
        return float(total(losses(out, batch, cfg), cfg))
