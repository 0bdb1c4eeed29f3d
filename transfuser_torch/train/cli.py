"""Training CLI (counterpart of transfuser_tpu/train/cli.py; the reference
train.py:30-211 surface) on one device.

    python -m transfuser_torch.train.cli --root_dir <dataset> [flags]

Every flag of the JAX CLI, with its default, plus ``--device`` (``cuda``
unless the caller asks for ``cpu``). The JAX CLI's mesh flags name what is
not ported yet (ROADMAP.md Queue 1 item 13): ``--mesh_data`` above 1,
``--mesh_model`` above 1 and ``--multihost 1`` exit with that message;
``--mesh_data 0`` means this one device. ``--sync_batch_norm`` and
``--zero_redundancy_optimizer`` change nothing on one device, as in the
JAX CLI without a mesh; ``--group_lowering`` and ``--remat`` are TPU
knobs, kept in the config snapshot and read by nothing in the port.

A run writes into ``<logdir>/<id>/``: config.json and args.txt, one
train-state checkpoint directory per epoch (``<epoch>/``), history.json,
the best-validation export ``best/`` (config.json, model_best.msgpack,
EXPORT.json) and, at the end, ``model_<epoch>.msgpack`` of the best
validation epoch: the inference weights both packages' agents load.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import torch

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
                   help="Global batch-norm statistics across data-parallel "
                        "replicas; nothing to synchronise on one device.")
    p.add_argument("--zero_redundancy_optimizer", type=int, default=1,
                   help="Shard the optimizer state across data-parallel "
                        "replicas; one device holds it whole.")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="Data-parallel axis size; 0 = this one device "
                        "(more is not ported yet).")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="Tensor-parallel axis size for the fusion GPT "
                        "(more than 1 is not ported yet).")
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
                   help="Multi-host training (not ported yet).")
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


def _refuse_unported(args: argparse.Namespace) -> None:
    for flag, value in (("--mesh_data", args.mesh_data),
                        ("--mesh_model", args.mesh_model)):
        if value > 1:
            raise SystemExit(
                f"{flag} {value}: training on more than one device is not "
                "ported yet (ROADMAP.md Queue 1 item 13)")
    if args.multihost:
        raise SystemExit("--multihost 1: multi-host training is not ported "
                         "yet (ROADMAP.md Queue 1 item 13)")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here; pass "
                         "--device cpu to train on the CPU")


def _export(path: str, trainer) -> None:
    from .checkpoint import save_inference_weights
    from .jax_import import variables_from_state_dict

    save_inference_weights(path, variables_from_state_dict(
        trainer.model.state_dict(), trainer.config))


@record
def main(argv: Optional[list] = None) -> dict:
    """Train; returns a summary of the run (history, checkpoint save
    times, loader figures) for callers that drive it in process."""
    from ..data.dataset import CarlaDataset
    from ..data.loader import PrefetchLoader, pinned_put
    from .checkpoint import AsyncCheckpointWriter, save_config_snapshot
    from .trainer import Trainer

    args = build_argparser().parse_args(argv)
    _refuse_unported(args)
    device = torch.device(args.device)

    cfg = config_from_args(args)
    logdir = os.path.join(args.logdir, args.id)
    os.makedirs(logdir, exist_ok=True)
    save_config_snapshot(logdir, cfg)
    with open(os.path.join(logdir, "args.txt"), "w") as f:
        json.dump(vars(args), f, indent=2)

    writer = None
    try:
        from tensorboardX import SummaryWriter
        writer = SummaryWriter(logdir)
    except Exception:
        writer = None

    print(f"device={device} processes=1 mesh=(1x1)")

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
    batch = args.batch_size
    print(f"train samples={len(train_set)} val={len(val_set)} "
          f"global_batch={batch} local_batch={batch}")

    steps_per_epoch = max(1, len(train_set) // batch)
    trainer = Trainer(cfg, steps_per_epoch=steps_per_epoch, device=device,
                      seed=args.seed)

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
                                      seed=args.seed, device_put=put)
    val_loader = PrefetchLoader(val_set, batch, shuffle=False,
                                num_workers=args.num_workers,
                                device_put=put)

    # the JAX CLI draws an example batch here to shape its init; the
    # port's modules know their shapes, so the trainer already holds the
    # seeded model
    ckpt = AsyncCheckpointWriter(logdir)
    try:
        if args.load_epoch is not None:
            ckpt.restore(args.load_epoch, trainer.model, trainer.optimizer)
            print(f"resumed from epoch {args.load_epoch}")

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
                    iter(train_loader),
                    fetch_metrics=bool(args.per_step_metrics))
                dt = time.time() - t0
                sps = len(train_set) / max(dt, 1e-9)
                print(f"epoch {epoch}: "
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
                    val_metrics = trainer.validate(iter(val_loader))
                    print(f"epoch {epoch}: val_loss="
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
                        os.makedirs(best_dir, exist_ok=True)
                        save_config_snapshot(best_dir, cfg)
                        _export(os.path.join(best_dir,
                                             "model_best.msgpack"), trainer)
                        with open(os.path.join(best_dir, "EXPORT.json"),
                                  "w") as f:
                            json.dump({"epoch": epoch + 1,
                                       "val_ade": best_val_ade,
                                       "val_fde": float(
                                           val_metrics.get("val_fde", 0.0)),
                                       }, f, indent=1)

                # the state is copied to the host here; the file is
                # written while the next epoch trains
                # (AsyncCheckpointWriter)
                ckpt.save(epoch + 1, trainer.model, trainer.optimizer)
                last_saved = epoch + 1
                history.append(epoch_row)
                with open(os.path.join(logdir, "history.json"), "w") as f:
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
            print(f"exporting best-val_ade checkpoint: epoch "
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
