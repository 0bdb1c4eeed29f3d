"""The port's training CLI at 2 processes on the CPU (gloo ranks in
subprocesses of tests/torch_parallel_worker.py), started with ``--multihost
1`` and with torchrun's ``env://``, on a written dataset: disjoint shards
covering the train set, equal losses on both ranks, one set of
checkpoints, and a resume at 1 process. The multihost ranks meet at the
CLI's coordinator port (the JAX CLI's flags), started again on a new port
if it was taken meanwhile; torchrun's standalone rendezvous binds a port
of its own. Each launch has 180 s in all (tests/test_torch_parallel.py's
``_launch``).
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import WORKER, PortTaken, _free_port, _launch
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_torch.data.synthetic import write_route
from transfuser_torch.train import checkpoint, cli
from transfuser_torch.train.trainer import Trainer


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The CLI at 2 processes, started both ways, 1 epoch each: 4 train
    samples (2 per rank at batch 1), 2 withheld ones."""
    root = tmp_path_factory.mktemp("carla")
    write_route(str(root / "T" / "Town01_route0"), 13, seed=0, n_points=4000)
    write_route(str(root / "T" / "Town02_route0"), 11, seed=1, n_points=4000)
    d = tmp_path_factory.mktemp("cli")
    runs = {}
    for how in ("multihost", "torchrun"):
        argv = ["--root_dir", str(root), "--logdir", str(d), "--id", how,
                "--setting", "02_05_withheld", "--epochs", "1",
                "--batch_size", "1", "--val_every", "1", "--num_workers",
                "1", "--device", "cpu", "--per_step_metrics", "1",
                "--image_architecture", "regnety_micro",
                "--lidar_architecture", "regnety_micro"]
        job = dict(argv=argv, world=2, out=str(d / f"{how}_rank"))
        path = d / f"{how}.json"
        if how == "multihost":
            # the CLI's coordinator address takes a port (the JAX CLI's
            # flags): started again on a new one if a rank finds it taken
            for attempt in range(3):
                job["port"] = _free_port()
                path.write_text(json.dumps(job))
                try:
                    _launch([[sys.executable, WORKER, "cli", str(path),
                              str(r)] for r in range(2)])
                    break
                except PortTaken:
                    shutil.rmtree(d / how, ignore_errors=True)
                    if attempt == 2:
                        raise
        else:
            # torchrun's standalone rendezvous binds a port of its own
            path.write_text(json.dumps(job))
            _launch([[sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", "2", WORKER, "cli",
                      str(path)]])
        runs[how] = [json.loads(Path(f"{job['out']}.{r}.json").read_text())
                     for r in range(2)]
    return root, d, runs


@pytest.mark.parametrize("how", ["multihost", "torchrun"])
def test_cli_two_processes(cli_runs, how):
    _, d, runs = cli_runs
    r0, r1 = runs[how]
    i0, i1 = set(r0["indices"]), set(r1["indices"])
    assert i0.isdisjoint(i1) and i0 | i1 == {0, 1, 2, 3}
    for row in r0["history"] + r1["history"]:
        row.pop("samples_per_sec")  # each rank's own clock
    assert r0["history"] == r1["history"]  # the global losses
    assert np.isfinite(r0["history"][0]["loss_total"])
    assert "val_ade" in r0["history"][0]
    run = d / how
    for name in ("config.json", "args.txt", "1", "history.json",
                 "model_1.msgpack", "best/model_best.msgpack"):
        assert (run / name).exists(), name
    assert checkpoint.list_ensemble_weights(str(run)) == \
        [str(run / "model_1.msgpack")]


def test_cli_resumes_a_two_process_checkpoint_at_one(cli_runs):
    root, d, _ = cli_runs
    saved = torch.load(d / "multihost" / "1" / checkpoint.TRAIN_STATE,
                       weights_only=True)
    resumed = {}
    real_train_epoch = Trainer.train_epoch

    def spy(self, batches, fetch_metrics=True):
        if not resumed:
            resumed.update({k: v.clone() for k, v in
                            self.model.state_dict().items()})
            resumed["step_count"] = self.optimizer.step_count
        return real_train_epoch(self, batches, fetch_metrics)

    Trainer.train_epoch = spy
    try:
        summary = cli.main([
            "--root_dir", str(root), "--logdir", str(d), "--id",
            "multihost", "--setting", "02_05_withheld", "--epochs", "2",
            "--batch_size", "2", "--val_every", "1", "--num_workers", "1",
            "--device", "cpu", "--load_epoch", "1", "--start_epoch", "1",
            "--image_architecture", "regnety_micro",
            "--lidar_architecture", "regnety_micro"])
    finally:
        Trainer.train_epoch = real_train_epoch
    assert resumed.pop("step_count") == saved["step"] == 2
    for k, v in saved["model"].items():
        assert torch.equal(resumed[k], v), k
    assert [r["epoch"] for r in summary["history"]] == [1]
    assert (d / "multihost" / "2").exists()
