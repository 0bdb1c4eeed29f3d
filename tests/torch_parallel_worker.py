"""One rank of a multi-process run of the PyTorch port on the CPU, for
tests/test_torch_parallel.py. Imports torch and the port only (no jax).

    python torch_parallel_worker.py step <job.json> <rank>
    python torch_parallel_worker.py resume <job.json> <rank>
    python torch_parallel_worker.py cli <job.json> [<rank>]

``step``: joins a gloo group of ``job["world"]`` ranks through
``job["init_method"]`` (a ``file://`` rendezvous), builds the port's
Trainer on a ``job["mesh"]`` = (data, model) mesh from ``job["config"]``
(a port config JSON) in fp64 (the parameters too), loads the full weights of
``job["weights"]`` into it, and for each
setting of ZeRO-1 in ``job["zero"]`` runs ``job["steps"]`` train steps on
the global batch ``job["batch"]`` (an .npz; each rank takes its rows),
after one eval step on the loaded weights. It records the eval dict,
after the first step the loss dict, the full gradients (DDP's average,
tensor-parallel shards gathered) and the BatchNorm running statistics,
and after the last the full parameters. Writes
``<job["out"]>.<rank>.pt``.

``resume``: as ``step``, for each (data, model) mesh of ``job["meshes"]``
with ZeRO-1 on, restores the train state of ``job["ckpt"]`` / epoch
``job["epoch"]`` (written by one process) through
``checkpoint.restore_checkpoint``, records the full parameters, the full
(gathered) moments and the step count, then takes one train step on the
global batch and records its loss dict and the parameters after it.

``cli``: records which train-set samples this process decodes, runs
``transfuser_torch.train.cli.main(job["argv"])`` (with ``--multihost 1
--coordinator_address 127.0.0.1:<job["port"]> --process_id <rank>`` when
a rank is given, else under torchrun's ``env://``) and writes the indices
and the run's summary to ``<job["out"]>.<rank>.json``.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch


def _join(job: dict, rank: int):
    """Join the gloo group; the job's config. The trainer's models are
    built in fp64 (the parameters too)."""
    from transfuser_torch.config import GlobalConfig
    from transfuser_torch.parallel.sharding import init_distributed
    from transfuser_torch.train import trainer as module

    torch.set_num_threads(1)
    build = module.LidarCenterNet
    module.LidarCenterNet = lambda *a, **kw: build(*a, **kw).double()
    init_distributed(torch.device("cpu"), init_method=job["init_method"],
                     world_size=job["world"], rank=rank)
    return GlobalConfig.from_json(open(job["config"]).read())


def _step(job: dict, rank: int) -> None:
    import torch.distributed as dist

    from transfuser_torch.parallel.sharding import (MeshSpec, batch_rows,
                                                    full_state_dict,
                                                    gather_tensor,
                                                    load_full_state_dict,
                                                    make_mesh)
    from transfuser_torch.train.trainer import Trainer

    cfg = _join(job, rank)
    weights = torch.load(job["weights"], weights_only=True)
    batch = dict(np.load(job["batch"]))
    out = {"rank": rank}
    for zero in job["zero"]:
        train = dataclasses.replace(cfg.train,
                                    zero_redundancy_optimizer=zero)
        mesh = make_mesh(MeshSpec(*job["mesh"]))
        trainer = Trainer(cfg.replace(train=train), mesh=mesh,
                          dtype=torch.float64, device="cpu")
        load_full_state_dict(trainer.model, weights)
        rows = trainer.put_batch(batch_rows(batch, mesh))
        run = {"eval": {k: float(v) for k, v in
                        trainer.eval_step(rows).items()}}
        for step in range(job["steps"]):
            metrics = trainer.train_step(rows)
            if step == 0:
                tp = getattr(trainer.model, "tensor_parallel", None)
                grads = {}
                for name, p in trainer.model.named_parameters():
                    g = p.grad.detach()
                    if tp is not None and name in tp.dims:
                        g = gather_tensor(g, tp.dims[name], tp)
                    grads[name] = g.clone()
                run["loss"] = {k: float(v) for k, v in metrics.items()}
                run["grads"] = grads
                run["stats"] = {k: v.clone() for k, v in
                                full_state_dict(trainer.model).items()
                                if k.endswith(("running_mean",
                                               "running_var"))}
        run["params"] = {k: v.clone() for k, v in
                         full_state_dict(trainer.model).items()}
        run["zero_owned"] = len(trainer.optimizer.owned)
        out[f"zero{int(zero)}"] = run
    torch.save(out, f"{job['out']}.{rank}.pt")
    dist.destroy_process_group()


def _resume(job: dict, rank: int) -> None:
    import torch.distributed as dist

    from transfuser_torch.parallel.sharding import (MeshSpec, batch_rows,
                                                    full_state_dict,
                                                    make_mesh)
    from transfuser_torch.train.checkpoint import restore_checkpoint
    from transfuser_torch.train.trainer import Trainer

    cfg = _join(job, rank)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, zero_redundancy_optimizer=True))
    batch = dict(np.load(job["batch"]))
    out = {"rank": rank}
    for data, model in job["meshes"]:
        mesh = make_mesh(MeshSpec(data, model))
        trainer = Trainer(cfg, mesh=mesh, dtype=torch.float64, device="cpu")
        step = restore_checkpoint(job["ckpt"], job["epoch"], trainer.model,
                                  trainer.optimizer)
        opt = trainer.optimizer.state_dict()
        run = {"step": step, "step_count": opt["step_count"],
               "mu": [t.clone() for t in opt["mu"]],
               "nu": [t.clone() for t in opt["nu"]],
               "zero_owned": len(trainer.optimizer.owned),
               "restored": {k: v.clone() for k, v in
                            full_state_dict(trainer.model).items()}}
        metrics = trainer.train_step(
            trainer.put_batch(batch_rows(batch, mesh)))
        run["loss"] = {k: float(v) for k, v in metrics.items()}
        run["params"] = {k: v.clone() for k, v in
                         full_state_dict(trainer.model).items()}
        out[f"{data}x{model}"] = run
    torch.save(out, f"{job['out']}.{rank}.pt")
    dist.destroy_process_group()


def _cli(job: dict, rank) -> None:
    from transfuser_torch.data import dataset
    from transfuser_torch.train import cli

    torch.set_num_threads(1)
    seen = []
    made = []

    class Recording(dataset.CarlaDataset):
        """The CLI builds its train set first: record that one's reads."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def __getitem__(self, i):
            if self is made[0]:
                seen.append(int(i))
            return super().__getitem__(i)

    dataset.CarlaDataset = Recording
    argv = list(job["argv"])
    if rank is not None:
        argv += ["--multihost", "1", "--coordinator_address",
                 f"127.0.0.1:{job['port']}", "--num_processes",
                 str(job["world"]), "--process_id", str(rank)]
    else:
        rank = int(os.environ["RANK"])
    summary = cli.main(argv)
    with open(f"{job['out']}.{rank}.json", "w") as f:
        json.dump({"rank": rank, "indices": sorted(set(seen)),
                   "history": summary["history"]}, f)


def main() -> None:
    mode, job = sys.argv[1], json.load(open(sys.argv[2]))
    rank = int(sys.argv[3]) if len(sys.argv) > 3 else None
    {"step": _step, "resume": _resume, "cli": _cli}[mode](job, rank)


if __name__ == "__main__":
    main()
