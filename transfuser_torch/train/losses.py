"""The 11-term training loss (counterpart of transfuser_tpu/train/losses.py;
reference model.py:733-805 and the mmdet head loss, model.py:150-248),
CenterNet target generation included, all on the device.

Batch layout (NHWC, fp32 unless noted): rgb (B,H,W,3) in [0,255]; lidar
(B,256,256,2) histogram, or lidar_raw (B,N,4) + num_points (B,) under
PointPillars; target_point (B,2); target_point_image (B,256,256,1);
ego_waypoint (B,4,2); label (B,20,7) padded boxes [cx,cy,w,h,yaw,speed,
brake]; bev (B,160,160) int in {0,1,2}; depth (B,H,W); semantic (B,H,W)
int in [0,7); speed (B,).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import GlobalConfig
from ..ops import centernet as cn
from ..parallel import comm


def compute_losses(outputs: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor],
                   config: GlobalConfig,
                   group: comm.Group = None) -> Dict[str, torch.Tensor]:
    """The detailed (unweighted) loss dict, in the reference's
    ``detailed_losses`` order; needs the ``compute_aux`` maps.

    Under a data-parallel ``group`` (this rank holding its share of the
    global batch) each term is this rank's share such that the group's
    mean of a term is the global batch's term, and the group's mean of
    the gradients is the global batch's gradient (what DDP's averaging
    needs): the mean terms stay local means, and the sums are divided by
    the group's mean normaliser (``avg_factor``, the BEV class weights):
    the global normaliser over the group's size. ``global_losses`` takes
    the mean."""
    cfg = config
    losses: Dict[str, torch.Tensor] = {}
    # waypoints: plain L1 (model.py:765)
    losses["loss_wp"] = (outputs["pred_wp"] - batch["ego_waypoint"]).abs() \
        .mean()
    # BEV segmentation: class-weighted CE (model.py:762-763)
    bev_w = torch.tensor(cfg.loss.bev_class_weights, dtype=torch.float32,
                         device=outputs["pred_bev"].device)
    losses["loss_bev"] = cn.cross_entropy_mean(outputs["pred_bev"],
                                               batch["bev"], bev_w, group)

    labels = batch["label"]
    valid = labels.abs().sum(-1) > 0.0  # model.py:774
    cnc = cfg.model.centernet
    t = cn.build_targets(
        labels, valid, tuple(outputs["head_heatmap"].shape[1:3]),
        (cfg.sensors.lidar_resolution_height,
         cfg.sensors.lidar_resolution_width),
        num_dir_bins=cnc.num_dir_bins, min_overlap=cnc.gaussian_min_overlap,
        min_radius=cnc.gaussian_min_radius, group=group)
    af = t.avg_factor
    w2 = t.weight[..., None].expand(-1, -1, -1, 2)
    losses["loss_center_heatmap"] = cn.gaussian_focal_loss(
        outputs["head_heatmap"], t.heatmap, af)
    losses["loss_wh"] = cn.weighted_l1_loss(
        outputs["head_wh"], t.wh, w2, af * 2.0, loss_weight=cnc.loss_wh_weight)
    losses["loss_offset"] = cn.weighted_l1_loss(
        outputs["head_offset"], t.offset, w2, af * 2.0)
    ce_bb = cfg.loss.reference_ce_batch_broadcast
    losses["loss_yaw_class"] = cn.weighted_ce_loss(
        outputs["head_yaw_class"], t.yaw_class, t.weight, af,
        batch_broadcast=ce_bb, group=group)
    losses["loss_yaw_res"] = cn.weighted_smooth_l1_loss(
        outputs["head_yaw_res"][..., 0], t.yaw_res, t.weight, af)
    losses["loss_velocity"] = cn.weighted_l1_loss(
        outputs["head_velocity"][..., 0], t.velocity, t.weight, af)
    losses["loss_brake"] = cn.weighted_ce_loss(
        outputs["head_brake"], t.brake, t.weight, af, batch_broadcast=ce_bb,
        group=group)

    # multitask aux losses (model.py:780-793)
    if cfg.model.multitask:
        losses["loss_semantic"] = cfg.loss.ls_seg * cn.cross_entropy_mean(
            outputs["pred_semantic"], batch["semantic"])
        pd = outputs["pred_depth"]
        losses["loss_depth"] = cfg.loss.ls_depth * (
            pd.to(torch.promote_types(pd.dtype, torch.float32))
            - batch["depth"]).abs().mean()
    else:
        zero = torch.zeros_like(losses["loss_wp"])
        losses["loss_semantic"] = zero
        losses["loss_depth"] = zero
    return {name: losses[name] for name in cfg.loss.detailed_losses}


def global_losses(detailed: Dict[str, torch.Tensor],
                  group: comm.Group = None) -> Dict[str, torch.Tensor]:
    """The data group's mean of each (detached) term: the global batch's
    loss dict, equal on every rank. One all-reduce of the stacked terms."""
    if comm.group_size(group) == 1:
        return {k: v.detach() for k, v in detailed.items()}
    dtype = torch.float32
    for v in detailed.values():
        dtype = torch.promote_types(dtype, v.dtype)
    mean = comm.all_reduce_mean(torch.stack(
        [v.detach().to(dtype) for v in detailed.values()]), group)
    return dict(zip(detailed, mean.unbind()))


def total_loss(detailed: Dict[str, torch.Tensor],
               config: GlobalConfig) -> torch.Tensor:
    """Weighted sum in the reference's detailed_losses order
    (train.py:309-311, config.py:134-136)."""
    total = torch.zeros((), dtype=torch.float32,
                        device=detailed["loss_wp"].device)
    for name, weight in zip(config.loss.detailed_losses,
                            config.loss.detailed_losses_weights):
        total = total + weight * detailed[name]
    return total
