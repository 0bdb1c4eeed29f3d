"""Training CLI (counterpart of transfuser_tpu/train/cli.py; the reference
train.py:30-211 surface) on one device or a (data x model) mesh of
processes, one device each.

    python -m transfuser_torch.train.cli --root_dir <dataset> [flags]
    torchrun --nproc_per_node N -m transfuser_torch.train.cli ...
    python -m transfuser_torch.train.cli --multihost 1 \
        --coordinator_address host:port --num_processes N --process_id i ...

Every flag of the JAX CLI, with its default, plus ``--device`` (``cuda``
unless the caller asks for ``cpu``; a process takes ``cuda:LOCAL_RANK``
unless ``--device`` names an index). Under torchrun the process group
comes from the ``env://`` variables; ``--multihost 1`` starts it from the
coordinator's address, as ``jax.distributed.initialize`` there. NCCL for
CUDA, gloo for the CPU. The mesh is ``--mesh_data`` (0: the world over
``--mesh_model``) x ``--mesh_model`` and must cover the world;
``--batch_size`` is per data rank, so the global batch is
``batch_size * n_data``, and each process loads its data index's shard.
Rank 0 alone writes the config snapshot, args.txt, TensorBoard, history,
checkpoints and exports. ``--sync_batch_norm`` changes nothing: the
BatchNorm statistics are always the global batch's, as in the JAX
package. ``--zero_redundancy_optimizer`` shards the Adam moments over the
data ranks. ``--group_lowering`` and ``--remat`` are TPU knobs, kept in
the config snapshot and read by nothing in the port. The device-cache
tiers are single-process, as there.

A run writes into ``<logdir>/<id>/``: config.json and args.txt, one
train-state checkpoint directory per epoch (``<epoch>/``), history.json,
the best-validation export ``best/`` (config.json, model_best.msgpack,
EXPORT.json) and, at the end, ``model_<epoch>.msgpack`` of the best
validation epoch: the inference weights both packages' agents load. The
files do not depend on the mesh: a checkpoint resumes at any mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.sharding import (MeshSpec, full_state_dict, init_distributed,
                                 is_chief, local_device, make_mesh)
from .elastic import record


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train TransFuser (PyTorch port)")
    p.add_argument("--id", type=str, default="transfuser",
                   help="Unique experiment identifier.")
    p.add_argument("--epochs", type=int, default=41)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=12,
                   help="Per-device batch size; global = batch_size * "
                        "n_data")
    p.add_argument("--logdir", type=str, default="log")
    p.add_argument("--load_epoch", type=int, default=None,
                   help="Checkpoint epoch to resume from.")
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--setting", type=str, default="all",
                   choices=["all", "02_05_withheld"])
    p.add_argument("--root_dir", type=str, required=True)
    p.add_argument("--schedule", type=int, default=1)
    p.add_argument("--schedule_reduce_epoch_01", type=int, default=30)
    p.add_argument("--schedule_reduce_epoch_02", type=int, default=40)
    p.add_argument("--backbone", type=str, default="transFuser",
                   choices=["transFuser", "late_fusion", "geometric_fusion",
                            "latentTF"])
    p.add_argument("--image_architecture", type=str, default="regnety_032")
    p.add_argument("--lidar_architecture", type=str, default="regnety_032")
    p.add_argument("--use_velocity", type=int, default=0)
    p.add_argument("--n_layer", type=int, default=4)
    p.add_argument("--wp_only", type=int, default=0)
    p.add_argument("--use_target_point_image", type=int, default=1)
    p.add_argument("--use_point_pillars", type=int, default=0)
    p.add_argument("--val_every", type=int, default=5)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="Global-norm gradient clipping; 0 disables (the "
                        "reference trains unclipped, and clip 1.0 diverged "
                        "the flagship in the JAX package's A/B).")
    p.add_argument("--agc_clip", type=float, default=0.0,
                   help="NFNet-style adaptive (per-unit, weight-relative) "
                        "gradient clipping; 0 disables.")
    p.add_argument("--warmup_epochs", type=float, default=0.0,
                   help="Linear LR warmup in epochs; 0 disables.")
    p.add_argument("--no_bev_loss", type=int, default=0)
    p.add_argument("--sync_batch_norm", type=int, default=1,
                   help="Kept for the reference's surface; changes "
                        "nothing: BatchNorm statistics are always the "
                        "global batch's, as in the JAX package.")
    p.add_argument("--zero_redundancy_optimizer", type=int, default=1,
                   help="ZeRO-1: partition the Adam moments over the data "
                        "ranks; one device holds them whole.")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="Data-parallel axis size; 0 = the processes over "
                        "--mesh_model.")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="Tensor-parallel axis size for the fusion GPT.")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_restarts", type=int, default=3,
                   help="In-job elastic retries: failed epochs reload the "
                        "last checkpoint and continue.")
    p.add_argument("--group_lowering", type=str, default="auto",
                   choices=["native", "dense", "chunked", "im2col",
                            "auto"],
                   help="The JAX package's grouped-conv lowering on the "
                        "TPU; recorded in the config, unused by the port.")
    p.add_argument("--remat", type=str, default="early",
                   choices=["none", "early", "all"],
                   help="The JAX package's backward-pass "
                        "rematerialization; recorded in the config, unused "
                        "by the port.")
    p.add_argument("--multihost", type=int, default=0,
                   help="Start the process group from --coordinator_address"
                        ", --num_processes and --process_id (tcp://), as "
                        "the JAX CLI's jax.distributed.initialize; without "
                        "it a torchrun launch is read from env://.")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (multihost only).")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--per_step_metrics", type=int, default=0,
                   help="Per-epoch means of every step's metrics (summed "
                        "on the device); default: the last step's.")
    p.add_argument("--wire", type=str, default="packed",
                   choices=("packed", "f32"),
                   help="Batch wire format: 'packed' ships uint8/uint16 "
                        "and widens on the device (data/pack.py), 'f32' "
                        "ships the float arrays.")
    p.add_argument("--device_cache", type=int, default=0,
                   help="Hold the whole (packed) train set resident in "
                        "device memory and gather batches there "
                        "(data/device_cache.py). Requires the set to fit "
                        "in 8 GB and FORCES augment=False (augmentation is "
                        "sampled at decode time).")
    p.add_argument("--echo_window", type=int, default=0,
                   help="Rotating-window device cache WITH live "
                        "augmentation (data/echo_cache.py): N samples "
                        "stay resident, a background thread re-decodes "
                        "freshly augmented ones and chunks swap in between "
                        "steps (data echoing). 0 = off. Mutually exclusive "
                        "with --device_cache.")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device to train on: 'cuda' (default) or "
                        "'cpu'.")
    return p


def config_from_args(args: argparse.Namespace):
    from ..config import GlobalConfig

    cfg = GlobalConfig(root_dir=args.root_dir, setting=args.setting)
    gpt = dataclasses.replace(cfg.model.gpt, n_layer=args.n_layer)
    model = dataclasses.replace(
        cfg.model, backbone=args.backbone,
        image_architecture=args.image_architecture,
        lidar_architecture=args.lidar_architecture,
        use_velocity=bool(args.use_velocity),
        use_target_point_image=bool(args.use_target_point_image),
        point_pillars=dataclasses.replace(
            cfg.model.point_pillars,
            use_point_pillars=bool(args.use_point_pillars)),
        group_lowering=args.group_lowering,
        remat=args.remat if args.remat != "none" else False,
        gpt=gpt)
    weights = list(cfg.loss.detailed_losses_weights)
    if args.wp_only:
        weights = [1.0] + [0.0] * (len(weights) - 1)
    if args.no_bev_loss:
        weights[cfg.loss.detailed_losses.index("loss_bev")] = 0.0
    loss = dataclasses.replace(
        cfg.loss, detailed_losses_weights=tuple(weights))
    train = dataclasses.replace(
        cfg.train, lr=args.lr, epochs=args.epochs,
        batch_size=args.batch_size,
        schedule_reduce_epoch_01=args.schedule_reduce_epoch_01
        if args.schedule else 10 ** 9,
        schedule_reduce_epoch_02=args.schedule_reduce_epoch_02
        if args.schedule else 10 ** 9,
        val_every=args.val_every,
        grad_clip_norm=args.grad_clip,
        agc_clip=args.agc_clip,
        warmup_epochs=args.warmup_epochs,
        zero_redundancy_optimizer=bool(args.zero_redundancy_optimizer),
        seed=args.seed)
    return cfg.replace(model=model, loss=loss, train=train)


def _start(args: argparse.Namespace) -> Tuple[torch.device, bool]:
    """This process's device, and whether this call started the process
    group (``--multihost 1``, or torchrun's ``env://`` variables)."""
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here; pass "
                         "--device cpu to train on the CPU")
    device = local_device(args.device)
    if args.multihost:
        if not args.coordinator_address or args.num_processes is None \
                or args.process_id is None:
            raise SystemExit("--multihost 1 needs --coordinator_address, "
                             "--num_processes and --process_id")
        init_distributed(device,
                         init_method=f"tcp://{args.coordinator_address}",
                         world_size=args.num_processes, rank=args.process_id)
        return device, True
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        init_distributed(device)
        return device, True
    return device, False


def _mesh_shape(args: argparse.Namespace, world: int) -> Tuple[int, int]:
    model = max(args.mesh_model, 1)
    n_data = args.mesh_data or max(world // model, 1)
    if n_data * model != world:
        raise SystemExit(f"mesh {n_data}x{model} needs {n_data * model} "
                         f"processes; this run has {world}")
    return n_data, model


def _steps(loader, world: int):
    """Under more than one process, ``len(loader)`` batches: the same count
    on every data rank. The loader's shards are the JAX loader's, so where
    the data ranks do not divide the set, the first shards hold one
    sample more, and a rank with one batch more would wait for the others
    in its collectives."""
    if world == 1:
        return iter(loader)
    return itertools.islice(iter(loader), len(loader))


def _export(path: str, trainer) -> None:
    """Collective under tensor parallelism; rank 0 writes."""
    from .checkpoint import save_inference_weights
    from .jax_import import variables_from_state_dict

    state = full_state_dict(trainer.model)
    if is_chief():
        save_inference_weights(path, variables_from_state_dict(
            state, trainer.config))


@record
def main(argv: Optional[list] = None) -> dict:
    """Train; returns a summary of the run (history, checkpoint save
    times, loader figures) for callers that drive it in process."""
    args = build_argparser().parse_args(argv)
    device, started = _start(args)
    try:
        return _train(args, device)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args: argparse.Namespace, device: torch.device) -> dict:
    from ..data.dataset import CarlaDataset
    from ..data.loader import PrefetchLoader, pinned_put
    from .checkpoint import AsyncCheckpointWriter, save_config_snapshot
    from .trainer import Trainer

    world = dist.get_world_size() if dist.is_initialized() else 1
    n_data, n_model = _mesh_shape(args, world)
    chief = is_chief()
    if (args.device_cache or args.echo_window) and world > 1:
        raise SystemExit("device cache tiers are single-process only")

    cfg = config_from_args(args)
    logdir = os.path.join(args.logdir, args.id)
    writer = None
    if chief:
        os.makedirs(logdir, exist_ok=True)
        save_config_snapshot(logdir, cfg)
        with open(os.path.join(logdir, "args.txt"), "w") as f:
            json.dump(vars(args), f, indent=2)
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(logdir)
        except Exception:
            writer = None
    mesh = make_mesh(MeshSpec(n_data, n_model)) if world > 1 else None
    shard_rank = 0 if mesh is None else mesh.data_index
    log = print if chief else (lambda *a, **k: None)
    log(f"device={device} processes={world} mesh=({n_data}x{n_model})")

    train_dirs, val_dirs = cfg.resolve_splits()
    packed = args.wire == "packed"
    use_device_cache = bool(args.device_cache)
    use_echo = bool(args.echo_window)
    if use_device_cache and use_echo:
        raise SystemExit("--device_cache and --echo_window are mutually "
                         "exclusive cache tiers")
    train_set = CarlaDataset(train_dirs, cfg, packed=packed,
                             augment=False if use_device_cache else None)
    val_set = CarlaDataset(val_dirs, cfg, augment=False, packed=packed)
    global_batch = args.batch_size * n_data
    batch = global_batch // n_data
    log(f"train samples={len(train_set)} val={len(val_set)} "
        f"global_batch={global_batch} local_batch={batch}")

    steps_per_epoch = max(1, len(train_set) // global_batch)
    trainer = Trainer(cfg, mesh=mesh, steps_per_epoch=steps_per_epoch,
                      device=device, seed=args.seed)

    # workers pin and copy their batches, so copies overlap both decode
    # and compute
    put = pinned_put(device)
    summary: dict = {}
    if use_device_cache:
        from ..data.device_cache import DeviceCacheLoader, fits
        if not fits(train_set, 8 << 30):
            raise SystemExit("--device_cache: train set exceeds the 8 GB "
                             "device budget; use the packed PrefetchLoader")
        print("[device_cache] uploading train set to the device "
              "(augment forced off)")
        train_loader = DeviceCacheLoader(
            train_set, batch, shuffle=True, seed=args.seed, device=device,
            log=lambda m: print(f"[device_cache] {m}"))
        summary["device_cache"] = {"upload_bytes": train_loader.upload_bytes,
                                   "upload_s": train_loader.upload_s}
    elif use_echo:
        from ..data.echo_cache import EchoCacheLoader
        train_loader = EchoCacheLoader(
            train_set, batch, window=args.echo_window, seed=args.seed,
            device=device, log=lambda m: print(f"[echo_cache] {m}"))
    else:
        train_loader = PrefetchLoader(train_set, batch, shuffle=True,
                                      num_workers=args.num_workers,
                                      seed=args.seed, device_put=put,
                                      shard_rank=shard_rank,
                                      shard_count=n_data)
    val_loader = PrefetchLoader(val_set, batch, shuffle=False,
                                num_workers=args.num_workers,
                                device_put=put, shard_rank=shard_rank,
                                shard_count=n_data)

    # the JAX CLI draws an example batch here to shape its init; the
    # port's modules know their shapes, so the trainer already holds the
    # seeded model
    ckpt = AsyncCheckpointWriter(logdir)
    try:
        if args.load_epoch is not None:
            ckpt.restore(args.load_epoch, trainer.model, trainer.optimizer)
            log(f"resumed from epoch {args.load_epoch}")

        # In-job elastic recovery (torchelastic restart semantics): a
        # failed epoch writes the structured error file, reloads the last
        # good checkpoint, and retries, up to --max_restarts times.
        epoch = args.start_epoch
        restarts = 0
        last_saved = args.load_epoch
        history = []
        best_val_ade, best_epoch = None, None
        while epoch < args.epochs:
            try:
                train_loader.set_epoch(epoch)
                t0 = time.time()
                metrics = trainer.train_epoch(
                    _steps(train_loader, world),
                    fetch_metrics=bool(args.per_step_metrics))
                dt = time.time() - t0
                sps = len(train_set) / max(dt, 1e-9)
                log(f"epoch {epoch}: "
                    f"loss={metrics.get('loss_total', 0):.4f} "
                    f"({sps:.1f} samples/s)")
                if writer:
                    for k, v in metrics.items():
                        writer.add_scalar(k, v, epoch + 1)
                    writer.add_scalar("samples_per_sec", sps, epoch + 1)
                epoch_row = {"epoch": epoch,
                             "samples_per_sec": round(sps, 4),
                             **{k: round(float(v), 4)
                                for k, v in metrics.items()}}

                # validate on the cadence AND at the last epoch: the
                # exported checkpoint must carry a validation pass
                last = epoch == args.epochs - 1
                if args.setting != "all" and len(val_set) > 0 and \
                        (epoch % args.val_every == 0 or last):
                    val_metrics = trainer.validate(_steps(val_loader, world))
                    log(f"epoch {epoch}: val_loss="
                        f"{val_metrics.get('val_loss_total', 0):.4f} "
                        f"val_ade={val_metrics.get('val_ade', 0):.3f} "
                        f"val_fde={val_metrics.get('val_fde', 0):.3f}")
                    if writer:
                        for k, v in val_metrics.items():
                            writer.add_scalar(k, v, epoch + 1)
                    epoch_row.update({k: round(float(v), 4)
                                      for k, v in val_metrics.items()})
                    ade = val_metrics.get("val_ade")
                    if ade is not None and (best_val_ade is None
                                            or ade < best_val_ade):
                        best_val_ade, best_epoch = float(ade), epoch + 1
                        # Eager best-val inference export into its own
                        # model dir: a usable eval ensemble survives even if
                        # a later epoch or checkpoint write fails. A subdir
                        # keeps the final model_*.msgpack export from
                        # turning into a 2-member ensemble.
                        best_dir = os.path.join(logdir, "best")
                        if chief:
                            os.makedirs(best_dir, exist_ok=True)
                            save_config_snapshot(best_dir, cfg)
                        _export(os.path.join(best_dir,
                                             "model_best.msgpack"), trainer)
                        if chief:
                            with open(os.path.join(best_dir, "EXPORT.json"),
                                      "w") as f:
                                json.dump({"epoch": epoch + 1,
                                           "val_ade": best_val_ade,
                                           "val_fde": float(val_metrics.get(
                                               "val_fde", 0.0)),
                                           }, f, indent=1)

                # the state is copied to the host here; the file is
                # written while the next epoch trains
                # (AsyncCheckpointWriter)
                ckpt.save(epoch + 1, trainer.model, trainer.optimizer)
                last_saved = epoch + 1
                history.append(epoch_row)
                if chief:
                    with open(os.path.join(logdir, "history.json"),
                              "w") as f:
                        json.dump({"best_val_ade": best_val_ade,
                                   "best_epoch": best_epoch,
                                   "per_epoch": history}, f, indent=1)
                epoch += 1
            except Exception as exc:
                from .elastic import write_error_file
                err_path = write_error_file(exc)
                restarts += 1
                if restarts > args.max_restarts:
                    print(f"[elastic] epoch {epoch} failed; restart budget "
                          f"exhausted ({args.max_restarts}); error file at "
                          f"{err_path}")
                    raise
                print(f"[elastic] epoch {epoch} failed "
                      f"({type(exc).__name__}: {exc}); restart "
                      f"{restarts}/{args.max_restarts}, error file "
                      f"{err_path}")
                if last_saved is not None:
                    ckpt.restore(last_saved, trainer.model,
                                 trainer.optimizer)
                    print(f"[elastic] restored checkpoint epoch "
                          f"{last_saved}")
        if use_echo:
            print(f"[echo_cache] echo factor "
                  f"{train_loader.echo_factor:.2f} (consumed/refreshed)")
            summary["echo_factor"] = train_loader.echo_factor
        # Export the weights in the inference format the agents load,
        # selected by best validation ADE when validation ran (the reference
        # keeps every epoch and evaluates several, README.md:113-172; here
        # one file, so the model dir stays a single-member ensemble).
        export_epoch = epoch
        if best_epoch is not None and best_epoch != epoch:
            ckpt.restore(best_epoch, trainer.model, trainer.optimizer)
            export_epoch = best_epoch
            log(f"exporting best-val_ade checkpoint: epoch "
                f"{best_epoch} (val_ade {best_val_ade:.3f})")
        _export(os.path.join(logdir, f"model_{export_epoch}.msgpack"),
                trainer)
    finally:
        if use_echo:  # stops the refresh thread
            train_loader.close()
        ckpt.close()  # drains any write in flight
    summary.update(history=history, best_epoch=best_epoch,
                   export_epoch=export_epoch, checkpoint_saves=ckpt.saves)
    return summary


if __name__ == "__main__":
    main()
