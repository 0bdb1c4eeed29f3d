"""CenterNet math (counterpart of transfuser_tpu/ops/centernet.py): box
decode, in-graph target generation and the mmdet-style head losses.
NHWC in, like the JAX package.

Top-k takes a stable descending sort, so equal scores (the zeros left by
the local-maximum filter, above all) come back lowest index first, as
``jax.lax.top_k`` returns them.

``build_targets`` replaces the JAX package's 20-step ``fori_loop`` of
scalar scatters (later boxes overwrite earlier ones, as the reference's
per-sample loop, model.py:285-374) with one scatter: a box writes its
pixel only if no later valid box of its sample hits the same pixel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import comm


def class_to_angle(cls: torch.Tensor, res: torch.Tensor, num_dir_bins: int,
                   limit_period: bool = True) -> torch.Tensor:
    per = 2.0 * math.pi / num_dir_bins
    angle = cls.to(res.dtype) * per + res
    if limit_period:
        angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    return angle


def local_maximum(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """NHWC: keep only pixels that are the max of their kernel x kernel
    window (-inf padding)."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, 1, pad)
    hmax = hmax.permute(0, 2, 3, 1)
    return torch.where(hmax == heat, heat, torch.zeros_like(heat))


class DecodedBoxes(NamedTuple):
    boxes: torch.Tensor   # (B, k, 8): x, y, w, h, yaw, velocity, brake, score
    labels: torch.Tensor  # (B, k) int32 class ids


def decode_heatmap(heatmap: torch.Tensor, wh: torch.Tensor,
                   offset: torch.Tensor, yaw_class: torch.Tensor,
                   yaw_res: torch.Tensor, velocity: torch.Tensor,
                   brake: torch.Tensor, k: int = 100, kernel: int = 3,
                   num_dir_bins: int = 12,
                   ratio: float = 4.0) -> DecodedBoxes:
    """Top-k box decode. All inputs NHWC; returns image-space (x256) boxes."""
    bsz, h, w, _ = heatmap.shape
    heat = local_maximum(heatmap, kernel)
    # flatten class x spatial in CHW order, like get_topk_from_heatmap
    flat = heat.permute(0, 3, 1, 2).reshape(bsz, -1)
    scores, order = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, inds = scores[:, :k], order[:, :k]
    topk_classes = torch.div(inds, h * w, rounding_mode="floor")
    pix = inds % (h * w)
    ys = torch.div(pix, w, rounding_mode="floor").to(torch.float32)
    xs = (pix % w).to(torch.float32)

    def gather(feat: torch.Tensor) -> torch.Tensor:
        flat_feat = feat.reshape(bsz, h * w, -1)
        idx = pix[..., None].expand(-1, -1, flat_feat.shape[-1])
        return torch.gather(flat_feat, 1, idx)

    wh_g = gather(wh)
    off_g = gather(offset)
    yaw_cls = torch.argmax(gather(yaw_class), dim=-1)
    yaw_res_g = gather(yaw_res)[..., 0]
    vel_g = gather(velocity)[..., 0]
    brake_g = torch.argmax(gather(brake), dim=-1)

    yaw = class_to_angle(yaw_cls, yaw_res_g, num_dir_bins)
    xs = xs + off_g[..., 0]
    ys = ys + off_g[..., 1]

    boxes = torch.stack([
        xs * ratio, ys * ratio, wh_g[..., 0] * ratio, wh_g[..., 1] * ratio,
        yaw, vel_g, brake_g.to(torch.float32), scores,
    ], dim=-1)
    return DecodedBoxes(boxes=boxes, labels=topk_classes.to(torch.int32))


EPS = 1e-12


# ------------------------------------------------------------------ targets

def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_overlap: float) -> torch.Tensor:
    """mmdet gaussian_target.gaussian_radius (min_overlap form)."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt(torch.clamp(b1 * b1 - 4 * c1, min=0.0))) / 2

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 - torch.sqrt(torch.clamp(b2 * b2 - 16 * c2, min=0.0))) / 8

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))) \
        / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def angle_to_class(angle: torch.Tensor, num_dir_bins: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference model.py:250-283: angle -> (bin, residual)."""
    two_pi = 2.0 * math.pi
    angle = torch.remainder(angle, two_pi)
    per = two_pi / num_dir_bins
    shifted = torch.remainder(angle + per / 2.0, two_pi)
    cls = torch.trunc(shifted / per).to(torch.int32)
    res = shifted - (cls.to(angle.dtype) * per + per / 2.0)
    return cls, res


class CenterNetTargets(NamedTuple):
    heatmap: torch.Tensor      # (B, H, W, num_classes)
    wh: torch.Tensor           # (B, H, W, 2)
    offset: torch.Tensor       # (B, H, W, 2)
    yaw_class: torch.Tensor    # (B, H, W) int64
    yaw_res: torch.Tensor      # (B, H, W)
    velocity: torch.Tensor     # (B, H, W)
    brake: torch.Tensor        # (B, H, W) int64
    weight: torch.Tensor       # (B, H, W) point-target weight
    avg_factor: torch.Tensor   # scalar, number of heatmap peaks (>= 1)


def build_targets(labels: torch.Tensor, valid: torch.Tensor,
                  feat_hw: Tuple[int, int], image_hw: Tuple[int, int],
                  num_dir_bins: int, min_overlap: float = 0.1,
                  min_radius: int = 2,
                  group: comm.Group = None) -> CenterNetTargets:
    """Dense CenterNet targets from padded box labels.

    labels (B, K, 7) [cx, cy, w, h, yaw, speed, brake] in image pixels;
    valid (B, K) bool (False rows are the zero padding, model.py:774).
    ``avg_factor`` is the number of heatmap peaks in the batch, clamped at
    1; with a data-parallel ``group``, the peaks of the global batch,
    clamped at 1, then shared evenly among the group's ranks (each rank's
    sum over its rows divided by it is its share of the global loss,
    times the group's size, which the gradient average takes back).
    """
    bsz, k, _ = labels.shape
    feat_h, feat_w = feat_hw
    img_h, img_w = image_hw
    width_ratio = feat_w / img_w
    height_ratio = feat_h / img_h
    fdt = torch.promote_types(labels.dtype, torch.float32)
    dev = labels.device

    # the reference scales BOTH center coordinates by width_ratio
    # (model.py:330-331); kept for parity
    ctx = labels[..., 0] * width_ratio
    cty = labels[..., 1] * width_ratio
    ctx_int = torch.trunc(ctx).to(torch.int32)
    cty_int = torch.trunc(cty).to(torch.int32)
    scale_w = labels[..., 2] * width_ratio
    scale_h = labels[..., 3] * height_ratio

    radius = gaussian_radius(scale_h, scale_w, min_overlap)
    radius = torch.clamp(torch.trunc(radius), min=float(min_radius)).to(fdt)
    sigma = (2.0 * radius + 1.0) / 6.0

    # heatmap: max over the per-box gaussians inside their (2r+1) window
    ys = torch.arange(feat_h, dtype=fdt, device=dev)
    xs = torch.arange(feat_w, dtype=fdt, device=dev)
    dy = ys[None, None, :] - cty_int[..., None].to(fdt)       # (B,K,H)
    dx = xs[None, None, :] - ctx_int[..., None].to(fdt)       # (B,K,W)
    g = torch.exp(-(dy[..., :, None] ** 2 + dx[..., None, :] ** 2)
                  / (2.0 * sigma[..., None, None] ** 2))      # (B,K,H,W)
    window = (dy.abs()[..., :, None] <= radius[..., None, None]) & \
             (dx.abs()[..., None, :] <= radius[..., None, None])
    g = torch.where(window & valid[..., None, None], g, torch.zeros_like(g))
    heatmap = g.amax(dim=1)[..., None]                         # (B,H,W,1)

    # point targets: the last valid box at a pixel wins
    yj = cty_int.clamp(0, feat_h - 1).long()
    xj = ctx_int.clamp(0, feat_w - 1).long()
    pix = yj * feat_w + xj                                     # (B,K)
    later = torch.ones(k, k, dtype=torch.bool, device=dev).triu(1)
    overwritten = ((pix[:, :, None] == pix[:, None, :]) & valid[:, None, :]
                   & later).any(-1)
    wins = valid & ~overwritten
    yaw_cls, yaw_res = angle_to_class(labels[..., 4], num_dir_bins)
    values = torch.stack([
        scale_w, scale_h, ctx - ctx_int.to(fdt), cty - cty_int.to(fdt),
        yaw_cls.to(fdt), yaw_res, labels[..., 5],
        labels[..., 6].to(torch.int32).to(fdt), torch.ones_like(scale_w),
    ], dim=-1).to(fdt)                                         # (B,K,9)
    n_pix = bsz * feat_h * feat_w
    flat = pix + torch.arange(bsz, device=dev)[:, None] * (feat_h * feat_w)
    flat = torch.where(wins, flat, torch.full_like(flat, n_pix))  # losers
    dense = torch.zeros(n_pix + 1, values.shape[-1], dtype=fdt, device=dev)
    dense.scatter_(0, flat.reshape(-1, 1).expand(-1, values.shape[-1]),
                   values.reshape(-1, values.shape[-1]))
    t = dense[:n_pix].reshape(bsz, feat_h, feat_w, -1)

    peaks = comm.all_reduce_sum((heatmap == 1.0).sum().to(fdt), group)
    avg_factor = torch.clamp(peaks, min=1.0) / comm.group_size(group)
    return CenterNetTargets(
        heatmap=heatmap, wh=t[..., 0:2], offset=t[..., 2:4],
        yaw_class=t[..., 4].long(), yaw_res=t[..., 5], velocity=t[..., 6],
        brake=t[..., 7].long(), weight=t[..., 8], avg_factor=avg_factor)


# ------------------------------------------------------------------- losses
# mmdet semantics: sum / avg_factor with elementwise weights


def gaussian_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                        avg_factor: torch.Tensor, alpha: float = 2.0,
                        gamma: float = 4.0) -> torch.Tensor:
    pos_w = (target == 1.0).to(pred.dtype)
    neg_w = torch.pow(1.0 - target, gamma)
    pos = -torch.log(pred + EPS) * torch.pow(1.0 - pred, alpha) * pos_w
    neg = -torch.log(1.0 - pred + EPS) * torch.pow(pred, alpha) * neg_w
    return (pos + neg).sum() / avg_factor


def weighted_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                     weight: torch.Tensor, avg_factor: torch.Tensor,
                     loss_weight: float = 1.0) -> torch.Tensor:
    return loss_weight * ((pred - target).abs() * weight).sum() / avg_factor


def weighted_smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                            weight: torch.Tensor, avg_factor: torch.Tensor,
                            beta: float = 1.0) -> torch.Tensor:
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return (loss * weight).sum() / avg_factor


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lg = logits.to(torch.promote_types(logits.dtype, torch.float32))
    picked = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(lg, dim=-1) - picked


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     weight: torch.Tensor, avg_factor: torch.Tensor,
                     batch_broadcast: bool = False,
                     group: comm.Group = None) -> torch.Tensor:
    """logits (B, H, W, C), integer labels (B, H, W), weight (B, H, W).

    ``batch_broadcast`` reproduces the reference's yaw-class/brake CE:
    mmdet multiplies the (B,H,W) loss map by the (B,1,H,W) weight, which
    broadcasts to (B,B,H,W), so every sample's loss map is weighted by
    every sample's center mask before the sum. Under a data-parallel
    ``group`` "every sample" is the global batch's: the center masks are
    summed over the group."""
    nll = _nll(logits, labels)
    if batch_broadcast:
        masks = comm.all_reduce_sum(weight.sum(0), group)
        return (nll.sum(0) * masks).sum() / avg_factor
    return (nll * weight).sum() / avg_factor


def cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None,
                       group: comm.Group = None) -> torch.Tensor:
    """F.cross_entropy(reduction='mean') over NHWC logits, with its
    weighted-mean rule sum(w_y * nll) / sum(w_y). Under a data-parallel
    ``group`` the denominator is the group's mean of sum(w_y), so the
    group's mean of this loss is the global batch's weighted mean (an
    unweighted mean needs nothing: the shards are of one size)."""
    nll = _nll(logits, labels)
    if class_weights is None:
        return nll.mean()
    w = class_weights.to(nll.dtype)[labels.long()]
    return (nll * w).sum() / comm.all_reduce_mean(w.sum(), group)
