"""Training and eval steps and the epoch engine, on one device
(counterpart of transfuser_tpu/train/trainer.py; reference Engine,
train.py:213-379).

A train step is: widen the batch on the device, forward in training mode
with the aux maps, the in-graph CenterNet targets and the 11-term loss,
backward, clip, AdamW. It returns the loss terms as tensors on the
device; the host reads nothing, so steps queue without a sync.

Dropout masks are drawn from a ``torch.Generator`` on the model's device,
seeded per step from ``config.train.seed`` and the step, so a run
repeats; they cannot equal the JAX package's ``fold_in`` stream. The mesh
/ DDP story of the JAX trainer is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..config import GlobalConfig
from ..data.pack import unpack_batch
from ..models import LidarCenterNet
from .losses import compute_losses, total_loss
from .metrics import eval_metrics
from .train_state import AdamW, make_optimizer

Batch = Dict[str, torch.Tensor]


def _model_inputs(batch: Batch):
    """(positional args, keyword args) of LidarCenterNet from a batch: the
    padded raw cloud and its counts under PointPillars, else the
    histogram; geometric_fusion's correspondences where the batch has
    them (trainer.py:34-52 there)."""
    extra = {}
    if "bev_points" in batch:
        extra = dict(bev_points=batch["bev_points"],
                     cam_points=batch["cam_points"])
    if "lidar_raw" in batch:
        lidar = batch["lidar_raw"]
        extra["num_points"] = batch["num_points"]
    else:
        lidar = batch["lidar"]
    args = (batch["rgb"], lidar, batch["target_point"],
            batch.get("target_point_image"), batch.get("speed"))
    return args, extra


def make_train_step(model: LidarCenterNet, config: GlobalConfig,
                    optimizer: AdamW) -> Callable[[Batch], Batch]:
    device = next(model.parameters()).device
    seed = int(config.train.seed)

    def train_step(batch: Batch) -> Batch:
        batch = unpack_batch(batch)
        model.train()
        gen = torch.Generator(device=device).manual_seed(
            seed * 2 ** 32 + optimizer.step_count)
        args, extra = _model_inputs(batch)
        out = model(*args, **extra, compute_aux=True, gen=gen)
        detailed = compute_losses(out, batch, config)
        loss = total_loss(detailed, config)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return {"loss_total": loss.detach(),
                **{k: v.detach() for k, v in detailed.items()}}

    return train_step


def make_eval_step(model: LidarCenterNet,
                   config: GlobalConfig) -> Callable[[Batch], Batch]:
    @torch.no_grad()
    def eval_step(batch: Batch) -> Batch:
        batch = unpack_batch(batch)
        model.eval()
        args, extra = _model_inputs(batch)
        out = model(*args, **extra, compute_aux=True)
        detailed = compute_losses(out, batch, config)
        return {"loss_total": total_loss(detailed, config), **detailed,
                **eval_metrics(out, batch)}

    return eval_step


class Trainer:
    """Epoch engine on one device: init, train and validate loops."""

    def __init__(self, config: GlobalConfig,
                 steps_per_epoch: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 seed: int = 0):
        self.config = config
        self.steps_per_epoch = steps_per_epoch
        self.device = torch.device(device)
        if dtype is None:
            dtype = torch.bfloat16 \
                if config.train.compute_dtype == "bfloat16" else torch.float32
        self.dtype = dtype
        self.init_state(seed=seed)
        self.epoch = 0

    def init_state(self, seed: int = 0) -> LidarCenterNet:
        """A model with seeded weights and a fresh optimizer (the port's
        modules know their shapes without an example batch)."""
        self.model = LidarCenterNet(self.config, dtype=self.dtype,
                                    device=self.device, seed=seed)
        self.optimizer = make_optimizer(self.model.parameters(), self.config,
                                        self.steps_per_epoch)
        self.train_step = make_train_step(self.model, self.config,
                                          self.optimizer)
        self.eval_step = make_eval_step(self.model, self.config)
        return self.model

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Batch:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _mean(self, step, batches) -> Dict[str, float]:
        """Mean of every step's metrics, summed on the device and read
        once at the end (no sync per step)."""
        sums: Batch = {}
        n = 0
        for batch in batches:
            for k, v in step(self.put_batch(batch)).items():
                sums[k] = sums[k] + v if k in sums else v
            n += 1
        return {k: float(v) / max(n, 1) for k, v in sums.items()}

    def train_epoch(self, batches: Iterable[Dict[str, np.ndarray]],
                    fetch_metrics: bool = True) -> Dict[str, float]:
        """fetch_metrics=True: the mean of every step's metrics (summed on
        the device, read once). False: the last step's metrics, as the JAX
        trainer returns them then (its CLI's default)."""
        if fetch_metrics:
            out = self._mean(self.train_step, batches)
        else:
            metrics: Batch = {}
            for batch in batches:
                metrics = self.train_step(self.put_batch(batch))
            out = {k: float(v) for k, v in metrics.items()}
        self.epoch += 1
        return out

    def validate(self, batches: Iterable[Dict[str, np.ndarray]]
                 ) -> Dict[str, float]:
        return {"val_" + k: v for k, v in
                self._mean(self.eval_step, batches).items()}
