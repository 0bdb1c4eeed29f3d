"""Training and eval steps and the epoch engine, on one device or a
(data x model) mesh of processes (counterpart of
transfuser_tpu/train/trainer.py; reference Engine, train.py:213-379).

A train step is: widen the batch on the device, forward in training mode
with the aux maps, the in-graph CenterNet targets and the 11-term loss,
backward, clip, AdamW. It returns the loss terms as tensors on the
device; the host reads nothing, so steps queue without a sync.

Dropout masks are drawn from the step's ``torch.Generator`` on the
model's device, seeded before every step from ``config.train.seed``, the
count of updates done and the rank's data index, so a run repeats and
the data ranks draw different masks for their different rows; they
cannot equal the JAX package's ``fold_in`` stream.

A step has a host part, run first whichever way the step runs:
re-seed the generator from the count of updates done, then
``AdamW.advance`` (count the update, write its learning rate and bias
corrections on the device). The rest is the device part. With no mesh,
on a card, the step is replayed as one CUDA graph from its third call
with a batch signature on (``StepGraphs``, ``graphs.py``); a trainer
under a mesh, on the CPU, or a call under a FLOP counter runs eagerly.

Under a mesh (``parallel/sharding.py``) a step computes what one device
computes on the global batch, as the JAX trainer's GSPMD mesh does:
  * the model is wrapped in ``DistributedDataParallel`` over the data
    group. ``broadcast_buffers=False``: the BatchNorm statistics are the
    global batch's (``models/layers.py``), so the running statistics are
    already equal on every rank. ``find_unused_parameters=False``: every
    parameter of every family gets a gradient in a training step (the
    aux heads exist only with ``multitask``, whose losses use them);
  * the loss terms are each rank's share (``train/losses.py``), so DDP's
    average of the gradients is the global batch's gradient, and a step
    returns the data group's mean of the terms: the global loss dict,
    equal on every rank, as ``validate`` and ``train_epoch`` then sum it;
  * the GPT blocks run tensor parallel over the model group, whose ranks
    get the same rows; ZeRO-1 over the data group when
    ``config.train.zero_redundancy_optimizer``;
  * the batches given are this rank's rows (one process per device: the
    CLI's loader shards by data index; ``parallel.sharding.batch_rows``
    cuts them from a global batch), as the JAX trainer takes them when
    it runs in more than one process.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..config import GlobalConfig
from ..data.pack import unpack_batch
from ..graphs import Graph, Graphs
from ..models import LidarCenterNet
from ..parallel.sharding import Mesh, shard_model
from ..tracing import span
from .losses import compute_losses, global_losses, total_loss
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


class StepGraphs(Graphs):
    """The training step's graphs. ``host``: the step's host part. The
    generator is registered with each graph, and a replay reads its seed
    and offset as the host part left them, so a replayed step draws the
    dropout masks of an eager one. The gradients are None at capture, so
    that the captured backward allocates them from the graph's pool and
    writes them on every replay; after a replay the model is in training
    mode and each parameter's ``.grad`` is this step's gradient, as an
    eager step leaves them."""

    def __init__(self, model: LidarCenterNet, host: Callable[[], None],
                 gen: torch.Generator, optimizer: AdamW):
        super().__init__("train.replay")
        self.model, self.host = model, host
        self.generator, self.optimizer = gen, optimizer

    def capture(self, record, call):
        params = self.optimizer.params
        kept = [p.grad for p in params]
        self.optimizer.zero_grad()
        graph, outputs, _ = super().capture(record, call)
        grads = [p.grad for p in params]
        for p, g in zip(params, kept):  # this step's, until the next replay
            p.grad = g
        return graph, outputs, grads

    def replayed(self, graph: Graph) -> None:
        if not self.model.training:
            self.model.train()
        params = self.optimizer.params
        if params and params[0].grad is not graph.kept[0]:
            for p, g in zip(params, graph.kept):
                p.grad = g


def make_train_step(model: torch.nn.Module, config: GlobalConfig,
                    optimizer: AdamW, mesh: Optional[Mesh] = None
                    ) -> Callable[[Batch], Batch]:
    """``model``: the LidarCenterNet, or its DDP wrapper under a mesh. The
    step returned carries its ``StepGraphs`` as ``.graphs`` (None under a
    mesh)."""
    device = next(model.parameters()).device
    seed = int(config.train.seed)
    group = None if mesh is None else mesh.data_group
    stream = 0 if mesh is None else mesh.data_index << 48
    gen = torch.Generator(device=device)

    def host() -> None:
        """The host part of a step: re-seed, then count the update."""
        gen.manual_seed(seed * 2 ** 32 + optimizer.step_count + stream)
        optimizer.advance()

    def step(batch: Batch) -> Batch:
        """The device part of a step: what a CUDA graph captures."""
        with span("train.forward"):
            batch = unpack_batch(batch)
            model.train()
            args, extra = _model_inputs(batch)
            out = model(*args, **extra, compute_aux=True, gen=gen)
        with span("train.losses"):
            detailed = compute_losses(out, batch, config, group)
            loss = total_loss(detailed, config)
        with span("train.backward"):
            optimizer.zero_grad()
            loss.backward()
        optimizer.step()
        return global_losses({"loss_total": loss, **detailed}, group)

    graphs = None if mesh is not None else StepGraphs(model, host, gen,
                                                      optimizer)

    def train_step(batch: Batch) -> Batch:
        with span("train.step"):
            if graphs is not None:
                return graphs(step, batch, model.storage_version,
                              model.dtype)
            host()
            return step(batch)

    train_step.graphs = graphs
    return train_step


def make_eval_step(model: LidarCenterNet, config: GlobalConfig,
                   mesh: Optional[Mesh] = None) -> Callable[[Batch], Batch]:
    group = None if mesh is None else mesh.data_group

    @torch.no_grad()
    def eval_step(batch: Batch) -> Batch:
        batch = unpack_batch(batch)
        model.eval()
        args, extra = _model_inputs(batch)
        out = model(*args, **extra, compute_aux=True)
        detailed = compute_losses(out, batch, config, group)
        return global_losses(
            {"loss_total": total_loss(detailed, config), **detailed,
             **eval_metrics(out, batch, group)}, group)

    return eval_step


class Trainer:
    """Epoch engine on one device or one rank of a mesh: init, train and
    validate loops. Under a mesh the batches given are this rank's rows."""

    def __init__(self, config: GlobalConfig, mesh: Optional[Mesh] = None,
                 steps_per_epoch: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 seed: int = 0):
        self.config = config
        self.mesh = mesh
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
        modules know their shapes without an example batch). Under a mesh
        every rank builds the same full model from the seed, then keeps
        its tensor-parallel shards."""
        model = LidarCenterNet(self.config, dtype=self.dtype,
                               device=self.device, seed=seed)
        mesh, shard_dims, forward = self.mesh, None, model
        if mesh is not None:
            if mesh.model > 1:
                shard_model(model, mesh)
                dims = model.tensor_parallel.dims
                shard_dims = [dims.get(n) for n, p in model.named_parameters()
                              if p.requires_grad]
            for m in model.modules():
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.process_group = mesh.data_group
            if mesh.data > 1:
                forward = torch.nn.parallel.DistributedDataParallel(
                    model, device_ids=[self.device.index]
                    if self.device.type == "cuda" else None,
                    process_group=mesh.ddp_group, broadcast_buffers=False,
                    find_unused_parameters=False)
        self.model = model
        self.optimizer = make_optimizer(model.parameters(), self.config,
                                        self.steps_per_epoch, mesh,
                                        shard_dims)
        self.train_step = make_train_step(forward, self.config,
                                          self.optimizer, mesh)
        self.eval_step = make_eval_step(model, self.config, mesh)
        return model

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Batch:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _mean(self, step, batches) -> Dict[str, float]:
        """Mean of every step's metrics, summed on the device and read
        once at the end (no sync per step). Each step's metrics are the
        global batch's already, so these are the global means."""
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
