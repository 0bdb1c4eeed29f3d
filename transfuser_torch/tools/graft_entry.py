"""Entry check of the port: the flagship forward on the card, and a
multi-rank dry run of one training step on the CPU (counterpart of the JAX
package's ``__graft_entry__.py``).

    python -m transfuser_torch.tools.graft_entry [--device=cpu]
    python -m transfuser_torch.tools.graft_entry dryrun [N]

``entry()`` returns ``(forward, example_args)``: ``forward(state_dict,
rgb, lidar, target_point, target_point_image, speed)`` runs the flagship
``GlobalConfig()`` ``LidarCenterNet.forward_ego`` in bf16 through
``torch.func.functional_call``, so the weights are an argument, as the
JAX entry's variables are; ``example_args`` holds the seeded model's state
dict and a ``data.synthetic.synthetic_batch(cfg, 1)`` on the device. The
command builds the kernels (on the card), runs the forward once under
``torch.no_grad()`` and prints the output shapes.

``dryrun N`` (default 8) runs ONE full training step (all 11 losses, the
in-graph CenterNet targets, AdamW, ZeRO-1 and the tensor-parallel GPT)
over N gloo ranks on the CPU, each a subprocess of this module, on a
(data x model) mesh with model = 2 when N is even, at the JAX dry run's
tiny config: ``resnet_micro`` trunks, 64x128 image, 64x64 LiDAR, 40x40
BEV, 2 GPT layers with the flagship's 5x22 / 8x8 anchors (the 2x4 image
features pool up to 5x22 and are resized back down), fp32, a synthetic
batch of max(2 x data, 2). The ranks meet through a file in a temporary
directory (no port to race for). Rank 0 prints ``dryrun_multichip ok:
mesh=(D x M), step=1, loss_total=...``; a non-finite loss, a failed rank
or a run past ``timeout_s`` (default 900 s) exits non-zero. The JAX
entry's re-exec into a scrubbed CPU process (its caller may have claimed
the TPU already) is not carried over: the ranks here are always fresh
processes, pinned to the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import GlobalConfig
from ..data.synthetic import synthetic_batch
from ..models import LidarCenterNet

INPUT_KEYS = ("rgb", "lidar", "target_point", "target_point_image", "speed")
_REPO = Path(__file__).resolve().parents[2]
DRYRUN_TIMEOUT_S = 900.0


class _ForwardEgo(torch.nn.Module):
    """``forward`` = the wrapped model's ``forward_ego``, so that
    ``functional_call`` can run it."""

    def __init__(self, model: LidarCenterNet):
        super().__init__()
        self.model = model

    def forward(self, *inputs):
        return self.model.forward_ego(*inputs)


def entry(device: str = "cuda") -> Tuple[Callable, tuple]:
    """(forward, example_args) of the flagship bf16 ``forward_ego``
    (module docstring); on the card unless ``device`` says otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("graft_entry: no CUDA device (pass device='cpu' "
                           "to run on the CPU)")
    cfg = GlobalConfig()
    model = LidarCenterNet(cfg, dtype=torch.bfloat16, device=device, seed=0)
    module = _ForwardEgo(model)

    def forward(state_dict: Dict[str, torch.Tensor], rgb, lidar,
                target_point, target_point_image, speed):
        weights = {"model." + k: v for k, v in state_dict.items()}
        return torch.func.functional_call(
            module, weights, (rgb, lidar, target_point, target_point_image,
                              speed))

    batch = synthetic_batch(cfg, 1)
    example_args = (model.state_dict(),) + tuple(
        torch.from_numpy(batch[k]).to(device) for k in INPUT_KEYS)
    return forward, example_args


# ---------------------------------------------------------------- dryrun

def dryrun_config() -> GlobalConfig:
    """The JAX dry run's tiny config (__graft_entry__.py)."""
    cfg = GlobalConfig()
    sensors = dataclasses.replace(cfg.sensors, img_resolution=(64, 128),
                                  lidar_resolution_width=64,
                                  lidar_resolution_height=64)
    bev = dataclasses.replace(cfg.bev, bev_resolution_width=40,
                              bev_resolution_height=40)
    gpt = dataclasses.replace(cfg.model.gpt, n_layer=2)
    model = dataclasses.replace(cfg.model, image_architecture="resnet_micro",
                                lidar_architecture="resnet_micro", gpt=gpt)
    return cfg.replace(sensors=sensors, bev=bev, model=model)


def mesh_shape(n_ranks: int) -> Tuple[int, int]:
    """(data, model): model 2 when it divides the ranks."""
    model = 2 if n_ranks % 2 == 0 else 1
    return n_ranks // model, model


def dryrun_batch(cfg: GlobalConfig, data: int) -> Dict[str, np.ndarray]:
    return synthetic_batch(cfg, max(2 * data, 2))


def _rank(rank: int, job_path: str) -> None:
    """One rank of the dry run: join the gloo group, take this rank's
    rows of the global batch, one train step; rank 0 prints the line."""
    from ..parallel.sharding import (MeshSpec, batch_rows, init_distributed,
                                     make_mesh)
    from ..train.trainer import Trainer

    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"), backend="gloo",
                     init_method=job["init_method"],
                     world_size=job["world"], rank=rank)
    try:
        cfg = GlobalConfig.from_json(job["config"])
        data, model = job["mesh"]
        mesh = make_mesh(MeshSpec(data=data, model=model))
        trainer = Trainer(cfg, mesh=mesh, dtype=torch.float32, device="cpu",
                          seed=0)
        batch = trainer.put_batch(dryrun_batch(cfg, data))
        metrics = trainer.train_step(batch_rows(batch, mesh))
        loss = float(metrics["loss_total"])
        if not math.isfinite(loss):
            raise RuntimeError(f"rank {rank}: non-finite loss {loss}")
        if rank == 0:
            print(f"dryrun_multichip ok: mesh=({data}x{model}), step=1, "
                  f"loss_total={loss!r}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def dryrun(n_ranks: int = 8, config: Optional[GlobalConfig] = None,
           timeout_s: float = DRYRUN_TIMEOUT_S) -> float:
    """One training step over ``n_ranks`` gloo ranks on the CPU (module
    docstring); ``config`` defaults to ``dryrun_config()``. Prints rank
    0's line and returns its loss_total; raises if a rank fails or the
    ranks are not done within ``timeout_s``."""
    cfg = config or dryrun_config()
    data, model = mesh_shape(n_ranks)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
    env["CUDA_VISIBLE_DEVICES"] = ""   # the ranks never touch a card
    with tempfile.TemporaryDirectory(prefix="graft_dryrun_") as tmp:
        job_path = os.path.join(tmp, "job.json")
        with open(job_path, "w") as f:
            json.dump(dict(config=cfg.to_json(), mesh=[data, model],
                           world=n_ranks, init_method="file://" +
                           os.path.join(tmp, "rendezvous")), f)
        logs = [(open(os.path.join(tmp, f"{r}.out"), "w+"),
                 open(os.path.join(tmp, f"{r}.err"), "w+"))
                for r in range(n_ranks)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "transfuser_torch.tools.graft_entry",
             "--rank", str(r), job_path], env=env, cwd=str(_REPO),
            stdout=out, stderr=err, text=True)
            for r, (out, err) in enumerate(logs)]
        # a rank that fails leaves the others waiting in a collective:
        # stop them all at the first failure or at the time limit
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outputs = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            outputs.append((out.read(), err.read()))
            out.close()
            err.close()
    failed = [(r, p.returncode, err) for r, (p, (_, err)) in
              enumerate(zip(procs, outputs)) if p.returncode != 0]
    if failed:
        r, rc, err = failed[0]
        raise RuntimeError(f"dryrun: {len(failed)} of {n_ranks} ranks "
                           f"failed or were stopped; rank {r} (rc {rc}):\n"
                           f"{err[-4000:]}")
    line = outputs[0][0].strip().splitlines()[-1]
    print(line)
    return float(line.rsplit("loss_total=", 1)[1])


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--rank"]:
        _rank(int(argv[1]), argv[2])
        return 0
    if argv[:1] == ["dryrun"]:
        dryrun(int(argv[1]) if len(argv) > 1 else 8)
        return 0
    device = "cpu" if "--device=cpu" in argv else "cuda"
    if device == "cuda":
        if not torch.cuda.is_available():
            print("graft_entry: no CUDA device (pass --device=cpu to run on "
                  "the CPU)", file=sys.stderr)
            return 2
        from ..ops import kernels
        kernels.build(kernels.KERNELS)
    forward, args = entry(device)
    with torch.no_grad():
        out = forward(*args)
    print([tuple(t.shape) for t in out])
    return 0


if __name__ == "__main__":
    sys.exit(main())
