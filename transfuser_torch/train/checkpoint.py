"""Checkpointing: per-epoch train state, config snapshot, inference weights
(counterpart of transfuser_tpu/train/checkpoint.py; reference per-epoch
torch.save of model/optimizer state, train.py:381-384, and the args.txt
round trip, train.py:174-175 -> submission_agent.py:41-74).

Two formats:
  * train state, for resume: ``torch.save`` of the model's state dict, the
    AdamW state (moments, count of updates) and the step, in
    ``<logdir>/<epoch>/train_state.pt``: one directory per epoch, as the
    JAX package's orbax checkpoints are laid out. It is never named
    ``model_*``, so ``list_ensemble_weights`` does not take it for an
    ensemble member.
  * inference weights, one ensemble member: ``model_*.msgpack`` in the JAX
    package's format (flax's msgpack of ``{'params', 'batch_stats'}``),
    read and written by ``flax_msgpack``. A port-trained member loads in
    the JAX agent and a JAX-trained one in the port's.

Every run directory carries a config.json that the agents use to rebuild
the exact architecture.

Under a mesh (``parallel/sharding.py``) the files are the same as on one
device: ``snapshot`` gathers the full model (tensor-parallel shards) and
the full optimizer state (ZeRO-1 moments, shards) on every rank, and only
rank 0 writes. ``restore_checkpoint`` reads on rank 0 and broadcasts the
state tensor by tensor on the model's device; every rank keeps its
share, so a checkpoint written at one mesh resumes at another.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..config import GlobalConfig
from ..parallel.sharding import full_state_dict, is_chief, \
    load_full_state_dict
from . import flax_msgpack

CONFIG_SNAPSHOT = "config.json"
TRAIN_STATE = "train_state.pt"


def save_config_snapshot(logdir: str, config: GlobalConfig) -> None:
    os.makedirs(logdir, exist_ok=True)
    config.save(os.path.join(logdir, CONFIG_SNAPSHOT))


def load_config_snapshot(logdir: str) -> GlobalConfig:
    return GlobalConfig.load(os.path.join(logdir, CONFIG_SNAPSHOT))


# ------------------------------------------------------------- train state

def snapshot(model: torch.nn.Module, optimizer) -> Dict[str, Any]:
    """The full train state as CPU tensors (collective under a mesh). The
    optimizer updates parameters in place, so the copy must be finished
    before the next step runs: the copies are queued, then waited for
    once."""
    def host(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", non_blocking=True, copy=True)

    opt = optimizer.state_dict()
    state = {"model": {k: host(v) for k, v in full_state_dict(model).items()},
             "optimizer": {"step_count": opt["step_count"],
                           "mu": [host(v) for v in opt["mu"]],
                           "nu": [host(v) for v in opt["nu"]]},
             "step": opt["step_count"]}
    if any(p.is_cuda for p in model.parameters()):
        torch.cuda.synchronize()
    return state


def write_state(logdir: str, epoch: int, state: Dict[str, Any]) -> str:
    """Write into a temporary directory, then rename it to ``<epoch>``: a
    reader never sees a half-written checkpoint."""
    path = os.path.join(logdir, str(epoch))
    tmp = f"{path}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, TRAIN_STATE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def save_checkpoint(logdir: str, model: torch.nn.Module, optimizer,
                    epoch: int) -> str:
    """Save model + optimizer state for `epoch` (rank 0 writes); returns
    its directory."""
    state = snapshot(model, optimizer)
    path = os.path.join(logdir, str(epoch))
    return write_state(logdir, epoch, state) if is_chief() else path


def broadcast_state(state: Optional[Dict[str, Any]],
                    device: torch.device) -> Dict[str, Any]:
    """Rank 0's train state on every rank: its layout (names, shapes,
    dtypes, step) as one small object, then each tensor by a broadcast on
    ``device`` (NCCL broadcasts the card's tensors), one at a time so a
    rank holds one full copy of the state and no staging buffer."""
    head = [None]
    if state is not None:
        opt = state["optimizer"]
        head[0] = {"step": state["step"], "step_count": opt["step_count"],
                   "model": [(k, v.shape, v.dtype)
                             for k, v in state["model"].items()],
                   "mu": [(i, v.shape, v.dtype)
                          for i, v in enumerate(opt["mu"])],
                   "nu": [(i, v.shape, v.dtype)
                          for i, v in enumerate(opt["nu"])]}
    dist.broadcast_object_list(head, src=0)
    head = head[0]

    def tensors(layout, src):
        out = []
        for key, shape, dtype in layout:
            t = src[key].to(device) if src is not None else \
                torch.empty(shape, dtype=dtype, device=device)
            dist.broadcast(t, src=0)
            out.append((key, t))
        return out

    opt = None if state is None else state["optimizer"]
    return {"model": dict(tensors(head["model"],
                                  None if state is None else state["model"])),
            "optimizer": {"step_count": head["step_count"],
                          **{m: [t for _, t in tensors(
                              head[m], None if opt is None else opt[m])]
                             for m in ("mu", "nu")}},
            "step": head["step"]}


def restore_checkpoint(logdir: str, epoch: int, model: torch.nn.Module,
                       optimizer) -> int:
    """Load `epoch`'s state into model and optimizer in place; returns the
    step. Under a process group rank 0 reads and broadcasts it."""
    state = None
    if is_chief():
        state = torch.load(os.path.join(logdir, str(epoch), TRAIN_STATE),
                           map_location="cpu", weights_only=True)
    if dist.is_initialized() and dist.get_world_size() > 1:
        state = broadcast_state(state, next(model.parameters()).device)
    load_full_state_dict(model, state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


class AsyncCheckpointWriter:
    """Epoch-loop checkpointing that overlaps the write with training.

    ``save`` copies the state to the host (one synchronisation) and returns;
    a thread writes the file while the next epoch trains. ``restore``,
    ``wait`` and ``close`` wait for the write in flight. ``saves`` records,
    per save, the seconds ``save`` took to return and the seconds until
    the file was written.
    """

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves: List[Dict[str, float]] = []

    def save(self, epoch: int, model: torch.nn.Module, optimizer) -> None:
        self.wait()
        t0 = time.perf_counter()
        state = snapshot(model, optimizer)
        record = {"epoch": epoch, "return_s": time.perf_counter() - t0}
        self.saves.append(record)
        if not is_chief():
            return

        def write():
            try:
                write_state(self.logdir, epoch, state)
                record["done_s"] = time.perf_counter() - t0
            except BaseException as exc:  # surfaced by wait()
                self._error = exc

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def restore(self, epoch: int, model: torch.nn.Module, optimizer) -> int:
        self.wait()
        return restore_checkpoint(self.logdir, epoch, model, optimizer)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -------------------------------------------------------- inference weights

def save_inference_weights(path: str, variables: Dict[str, Any]) -> None:
    """Standalone inference weights (one ensemble member): model_*.msgpack,
    ``variables`` being ``{'params', 'batch_stats'}`` with numpy leaves
    (``jax_import.variables_from_state_dict``)."""
    blob = flax_msgpack.encode(variables)
    with open(path, "wb") as f:
        f.write(blob)


def load_inference_weights(path: str) -> Dict[str, Any]:
    """A model_*.msgpack -> ``{'params', 'batch_stats'}`` with numpy leaves
    (``jax_import.state_dict_from_jax`` takes it to the port's names)."""
    with open(path, "rb") as f:
        return flax_msgpack.decode(f.read())


def list_ensemble_weights(model_dir: str) -> List[str]:
    """Every model_*.msgpack (native) or model_*.pth (reference torch
    checkpoint, converted on load) in the directory is an ensemble member
    (reference loads every *.pth, submission_agent.py:84-99)."""
    return [os.path.join(model_dir, f) for f in sorted(os.listdir(model_dir))
            if f.startswith("model_") and f.endswith((".msgpack", ".pth"))]
