"""Evaluation metrics beyond the training losses (counterpart of
transfuser_tpu/train/metrics.py): waypoint ADE/FDE, the accuracy
acceptance metrics, and the CenterNet head's agreement with the labels.

Under a data-parallel ``group`` the means (ADE, FDE) stay this rank's,
whose group mean is the global batch's; the IoU's counts are summed over
the group, so it is the global batch's on every rank.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..parallel import comm


def waypoint_ade(pred_wp: torch.Tensor, gt_wp: torch.Tensor) -> torch.Tensor:
    """Average displacement error: mean L2 over all waypoints (B, T, 2)."""
    return torch.linalg.norm(pred_wp - gt_wp, dim=-1).mean()


def waypoint_fde(pred_wp: torch.Tensor, gt_wp: torch.Tensor) -> torch.Tensor:
    """Final displacement error: L2 at the last waypoint."""
    return torch.linalg.norm(pred_wp[:, -1] - gt_wp[:, -1], dim=-1).mean()


def heatmap_peak_agreement(pred_heatmap: torch.Tensor,
                           target_heatmap: torch.Tensor,
                           threshold: float = 0.3) -> torch.Tensor:
    """Fraction of GT peaks with a confident prediction at the same cell."""
    peaks = target_heatmap >= 1.0
    hits = (pred_heatmap >= threshold) & peaks
    return hits.sum() / peaks.sum().clamp(min=1)


def class_iou(pred: torch.Tensor, target: torch.Tensor,
              cls: int, group: comm.Group = None) -> torch.Tensor:
    p = pred == cls
    t = target == cls
    counts = comm.all_reduce_sum(torch.stack([(p & t).sum(), (p | t).sum()]),
                                 group)
    return counts[0] / counts[1].clamp(min=1)


def eval_metrics(outputs: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor],
                 group: comm.Group = None) -> Dict[str, torch.Tensor]:
    out = {"ade": waypoint_ade(outputs["pred_wp"], batch["ego_waypoint"]),
           "fde": waypoint_fde(outputs["pred_wp"], batch["ego_waypoint"])}
    if "pred_bev" in outputs and "bev" in batch:
        pred = torch.argmax(outputs["pred_bev"], dim=-1)
        out["bev_iou_road"] = class_iou(pred, batch["bev"], 1, group)
    return out
