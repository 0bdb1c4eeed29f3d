"""Top-level perception + planning model, all four backbone families
(counterpart of transfuser_tpu/models/lidar_centernet.py; reference
team_code_transfuser/model.py:538-805).

Parameters follow the reference checkpoint's names (``_model.*``,
``head.*_head.{0,2}``, ``join.{0,2,4}``, ``decoder.*``, ``output.*``,
``pred_bev.{0,2}``, ``seg_decoder.*``, ``depth_decoder.*``), so a
reference ``model_*.pth`` loads with ``load_state_dict(strict=True)``
(see ``train.jax_import.load_reference_checkpoint`` for its alias keys).
Parameters stay fp32 and the model computes in ``self.dtype`` (bf16 by
default), with the JAX package's fp32 islands. Public inputs and outputs
are NHWC.

``config.model.backbone`` picks the family: transFuser (the BEV histogram
or, under ``use_point_pillars``, the raw point cloud as LiDAR input),
late_fusion, latentTF (camera only: a positional grid replaces the
histogram) or geometric_fusion (which also takes the per-frame
``bev_points`` / ``cam_points`` correspondences); the trunks are RegNetY,
ResNet or ConvNeXt. Training mode (``.train()``) is the JAX package's
``train=True``: BatchNorm on batch statistics, GPT dropout.
``compute_aux=True`` adds the training-only maps ``pred_bev``,
``pred_semantic`` and ``pred_depth``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..config import GlobalConfig
from ..graphs import Graphs
from ..ops import centernet as cn
from ..ops.image_ops import resize_bilinear, to_nchw, to_nhwc
from ..tracing import span
from .decoders import DepthDecoder, SegDecoder
from .encoders import ConvNeXtBlock
from .geometric_fusion import GeometricFusionBackbone
from .heads import LidarCenterNetHead, bias_init_with_prob
from .late_fusion import LateFusionBackbone
from .latent_tf import LatentTFBackbone
from .layers import BatchNorm1d, BatchNorm2d, Conv2d, LayerNorm, Linear
from .point_pillar import PointPillarNet
from .transfuser import TransfuserBackbone
from .waypoint_gru import make_join, waypoint_rollout

BACKBONES = {
    "transFuser": TransfuserBackbone,
    "late_fusion": LateFusionBackbone,
    "geometric_fusion": GeometricFusionBackbone,
    "latentTF": LatentTFBackbone,
}


class LidarCenterNet(nn.Module):
    def __init__(self, config: GlobalConfig, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", seed: int = 0):
        super().__init__()
        mcfg = config.model
        if mcfg.backbone not in BACKBONES:
            raise ValueError(f"unknown backbone '{mcfg.backbone}'; options: "
                             f"{', '.join(BACKBONES)}")
        self.config = config
        self.dtype = dtype
        self.graphs: Optional[Graphs] = None
        # counts what gives the parameters or buffers new storage, which a
        # CUDA graph (graphs.py) cannot follow
        self.storage_version = 0
        pp = mcfg.point_pillars
        lidar_ch = (pp.num_features[-1] if pp.use_point_pillars
                    else 2 * mcfg.lidar_seq_len)
        lidar_ch += int(mcfg.use_target_point_image)
        self._model = BACKBONES[mcfg.backbone](config, lidar_ch)
        feats = mcfg.perception_output_features
        if mcfg.multitask:
            deconv = (mcfg.deconv_channel_num_1, mcfg.deconv_channel_num_2,
                      mcfg.deconv_channel_num_3)
            scales = (mcfg.deconv_scale_factor_1, mcfg.deconv_scale_factor_2)
            self.seg_decoder = SegDecoder(feats, *deconv, mcfg.num_class,
                                          *scales)
            self.depth_decoder = DepthDecoder(feats, *deconv, *scales)
        ch = mcfg.centernet.channel
        bev_ch = config.bev.bev_features_channels
        self.pred_bev = nn.Sequential(
            Conv2d(bev_ch, ch, 3, 1, 1), nn.ReLU(),
            Conv2d(ch, config.bev.bev_num_classes, 1))
        self.head = LidarCenterNetHead(bev_ch, ch, mcfg.centernet.num_classes,
                                       mcfg.centernet.num_dir_bins)
        self.join = make_join(feats, mcfg.gru_hidden_size)
        self.decoder = nn.GRUCell(4 if mcfg.gru_concat_target_point else 2,
                                  mcfg.gru_hidden_size)
        self.output = Linear(mcfg.gru_hidden_size, 3)
        if pp.use_point_pillars:
            self.point_pillar_net = PointPillarNet(pp)
        gen = torch.Generator().manual_seed(seed)
        init_like_flax(self, gen)
        self.eval()
        self.to(device)

    def forward(self, rgb: torch.Tensor, lidar_bev: torch.Tensor,
                target_point: torch.Tensor,
                target_point_image: Optional[torch.Tensor] = None,
                velocity: Optional[torch.Tensor] = None,
                bev_points: Optional[torch.Tensor] = None,
                cam_points: Optional[torch.Tensor] = None,
                num_points: Optional[torch.Tensor] = None,
                compute_aux: bool = False,
                gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """rgb (B,H,W,3) in [0,255]; lidar_bev (B,H,W,2) histogram, or
        under PointPillars the padded raw cloud (B,N,4) with its counts
        ``num_points`` (B,); target_point (B,2); target_point_image
        (B,H,W,1); velocity (B,); under geometric_fusion bev_points
        (B,8,8,5,2) and cam_points (B,5,22,5,2) integer cell indices (the
        anchor grids' sizes). Returns pred_wp (B,pred_len,2) and the
        seven NHWC head maps (``head_*``), all at-least-fp32; with
        ``compute_aux`` also pred_bev (B,bev_h,bev_w,classes),
        pred_semantic (B,H,W,num_class) and pred_depth (B,H,W), in the
        compute dtype. ``gen`` draws the GPT's dropout masks in training."""
        cfg = self.config
        dt = self.dtype
        if cfg.model.point_pillars.use_point_pillars:
            if num_points is None:
                raise ValueError("PointPillars needs num_points")
            with span("model.pillars"):
                canvas = self.point_pillar_net(lidar_bev, num_points, dt)
                # rot90(k=-1) over H, W: the voxelization's orientation
                # (model.py:690)
                lidar = to_nchw(torch.rot90(canvas, k=-1, dims=(1, 2)))
        else:
            lidar = to_nchw(lidar_bev).to(dt)
        if cfg.model.use_target_point_image:
            if target_point_image is None:
                raise ValueError("config uses the target-point image")
            lidar = torch.cat([lidar, to_nchw(target_point_image).to(dt)], 1)
        if cfg.model.backbone == "geometric_fusion":
            pyramid, image_grid, fused = self._model(
                to_nchw(rgb).to(dt), lidar, velocity, bev_points, cam_points)
        else:
            pyramid, image_grid, fused = self._model(
                to_nchw(rgb).to(dt), lidar, velocity, gen)
        with span("model.outputs"):
            pred_wp = waypoint_rollout(
                self.join, self.decoder, self.output, fused, target_point,
                cfg.model.pred_len, cfg.model.gru_concat_target_point,
                cfg.sensors.lidar_pos[0])
            out = {"pred_wp": pred_wp}
            for name, v in self.head(pyramid[0]).items():
                out[f"head_{name}"] = to_nhwc(v)
            if compute_aux:
                # model.py:760 resizes with align_corners=True
                out["pred_bev"] = resize_bilinear(
                    to_nhwc(self.pred_bev(pyramid[0])),
                    (cfg.bev.bev_resolution_height,
                     cfg.bev.bev_resolution_width), align_corners=True)
                if cfg.model.multitask:
                    out["pred_semantic"] = to_nhwc(
                        self.seg_decoder(image_grid))
                    out["pred_depth"] = self.depth_decoder(image_grid)
        return out

    @torch.no_grad()
    def forward_ego(self, rgb: torch.Tensor, lidar_bev: torch.Tensor,
                    target_point: torch.Tensor,
                    target_point_image: Optional[torch.Tensor] = None,
                    velocity: Optional[torch.Tensor] = None,
                    bev_points: Optional[torch.Tensor] = None,
                    cam_points: Optional[torch.Tensor] = None,
                    num_points: Optional[torch.Tensor] = None):
        """Inference path (model.py:685-731): waypoints + decoded top-k
        boxes, in eval mode whatever the module's mode. Returns (pred_wp
        (B,4,2), boxes (B,k,8), labels (B,k)); confidence filtering is
        left to the host-side agent. After ``replay_forward_ego()``, CUDA
        inputs run through a CUDA graph from their second call on, whose
        replay skips the mode walks; the outputs are the caller's."""
        inputs = dict(rgb=rgb, lidar_bev=lidar_bev, target_point=target_point,
                      target_point_image=target_point_image,
                      velocity=velocity, bev_points=bev_points,
                      cam_points=cam_points, num_points=num_points)
        with span("model.forward_ego"):
            if self.graphs is not None:
                return self.graphs(self._forward_ego_eval, inputs,
                                   self.storage_version, self.dtype)
            return self._forward_ego_eval(inputs)

    def _forward_ego_eval(self, inputs):
        was_training = self.training
        self.eval()
        try:
            out = self(**inputs)
        finally:
            self.train(was_training)
        cnc = self.config.model.centernet
        with span("model.decode"):
            decoded = cn.decode_heatmap(
                out["head_heatmap"], out["head_wh"], out["head_offset"],
                out["head_yaw_class"], out["head_yaw_res"],
                out["head_velocity"], out["head_brake"],
                k=cnc.top_k_center_keypoints,
                kernel=cnc.center_net_max_pooling_kernel,
                num_dir_bins=cnc.num_dir_bins)
        return out["pred_wp"], decoded.boxes, decoded.labels

    def replay_forward_ego(self) -> None:
        """Opt in to replaying ``forward_ego`` from CUDA graphs
        (``graphs.py``), for a caller whose weights change only in place:
        a graph would ignore weights passed in for one call, as
        ``torch.func.functional_call`` passes them. Does nothing to CPU
        inputs. Idempotent."""
        if self.graphs is None:
            self.graphs = Graphs("model.replay")

    def _apply(self, fn, recurse=True):
        # a move gives the parameters new storage: the graphs read the old
        self.storage_version += 1
        return super()._apply(fn, recurse)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        # assign=True swaps the parameters; an in-place load needs nothing
        if assign:
            self.storage_version += 1
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)


@torch.no_grad()
def init_like_flax(model: LidarCenterNet, gen: torch.Generator) -> None:
    """Seeded random init with the JAX package's initializer families:
    lecun-normal (truncated) conv and dense kernels, zero biases, N(0,
    0.02) GPT linears, N(0, 0.001) CenterNet wh/offset branches, the
    heatmap prior bias, identity BatchNorm and LayerNorm, ConvNeXt layer
    scales of 1e-6."""

    def lecun(w):
        fan_in = w[0].numel()
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)

    for name, m in model.named_modules():
        if isinstance(m, (Conv2d, Linear)):
            if ".transformer" in f".{name}":
                nn.init.normal_(m.weight, 0.0, 0.02, generator=gen)
            else:
                lecun(m.weight)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.GRUCell):
            lecun(m.weight_ih)
            lecun(m.weight_hh)
            nn.init.zeros_(m.bias_ih)
            nn.init.zeros_(m.bias_hh)
        elif isinstance(m, (BatchNorm1d, BatchNorm2d, LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, ConvNeXtBlock):
            m.gamma.fill_(1e-6)
    for branch in ("wh", "offset"):
        for conv in getattr(model.head, f"{branch}_head")[::2]:
            nn.init.normal_(conv.weight, 0.0,
                            model.config.model.centernet
                            .center_net_normal_init_std, generator=gen)
    model.head.heatmap_head[2].bias.fill_(bias_init_with_prob(
        model.config.model.centernet.center_net_bias_init_with_prob))
