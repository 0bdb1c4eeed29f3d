"""The port's training CLI against the JAX package's: flags and the config
they build, the refusal of meshes the world cannot hold, the elastic
restart, and a
real run on the CPU over a written dataset whose export the port's agent
then drives with (the port's counterpart of tests/test_lifecycle.py; its
closed-loop half, an export driven through the port's harness CLI, is in
tests/test_torch_closed_loop.py)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_agent import _frames, _plan
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.train import cli as jax_cli
from transfuser_torch.agents.hybrid_agent import HybridAgent
from transfuser_torch.data.synthetic import write_route
from transfuser_torch.train import checkpoint
from transfuser_torch.train import cli
from transfuser_torch.train.jax_import import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent

ARGVS = [
    [],
    ["--use_point_pillars", "1", "--n_layer", "2", "--wp_only", "1"],
    ["--schedule", "0", "--no_bev_loss", "1", "--lr", "3e-4",
     "--batch_size", "6", "--epochs", "7", "--val_every", "2"],
    ["--backbone", "late_fusion", "--image_architecture", "resnet34",
     "--use_velocity", "1", "--use_target_point_image", "0",
     "--remat", "none", "--group_lowering", "native"],
    ["--grad_clip", "1.0", "--agc_clip", "0.01", "--warmup_epochs", "0.5",
     "--zero_redundancy_optimizer", "0", "--seed", "7",
     "--setting", "02_05_withheld"],
]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default)
            for a in parser._actions if a.dest != "help"}


def test_flags_are_the_jax_clis_plus_device():
    ours, theirs = _options(cli.build_argparser()), \
        _options(jax_cli.build_argparser())
    assert ours.pop("device") == (("--device",), "cuda")
    assert ours == theirs
    help_text = subprocess.run(
        [sys.executable, "-m", "transfuser_torch.train.cli", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        check=True).stdout
    for flags, _ in theirs.values():
        assert flags[0] in help_text
    assert "--device" in help_text


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_config_from_args_equals_jax(argv):
    argv = ["--root_dir", "/data"] + argv
    ours = cli.config_from_args(cli.build_argparser().parse_args(argv))
    theirs = jax_cli.config_from_args(jax_cli.build_argparser()
                                      .parse_args(argv))
    assert json.loads(ours.to_json()) == json.loads(theirs.to_json())


@pytest.mark.parametrize("argv,match", [
    (["--mesh_data", "2"], "mesh 2x1 needs 2 processes; this run has 1"),
    (["--mesh_model", "2"], "mesh 1x2 needs 2 processes; this run has 1"),
    (["--multihost", "1"], "needs --coordinator_address")],
    ids=["mesh_data", "mesh_model", "multihost"])
def test_multi_device_flags_are_refused(tmp_path, argv, match):
    """The mesh flags run (tests/test_torch_parallel.py); one process
    refuses a mesh larger than its world, and --multihost 1 without its
    coordinator, before it writes anything."""
    with pytest.raises(SystemExit, match=match):
        cli.main(["--root_dir", str(tmp_path), "--logdir", str(tmp_path),
                  "--device", "cpu"] + argv)
    assert not (tmp_path / "transfuser").exists()


def test_cuda_without_a_card_is_refused(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["--root_dir", str(tmp_path), "--logdir", str(tmp_path)])


def test_train_cli_elastic_restart(tmp_path, monkeypatch):
    """A failing epoch writes the error file, restores the last
    checkpoint, and retries (in-job elastic recovery)."""
    calls = {"epochs": [], "restores": 0, "saves": [], "exports": []}

    class StubTrainer:
        def __init__(self, config, **kw):
            self.config = config
            self.model = self.optimizer = None

        def train_epoch(self, it, fetch_metrics=True):
            calls["fetch_metrics"] = fetch_metrics
            epoch_idx = len(calls["epochs"])
            calls["epochs"].append(epoch_idx)
            if epoch_idx == 1:  # the second attempt overall fails once
                raise RuntimeError("simulated device OOM")
            return {"loss_total": 1.0}

        def validate(self, it):
            return {}

    class StubLoader:
        def __init__(self, dataset, *a, **kw):
            self.dataset = dataset

        def set_epoch(self, e):
            pass

        def __iter__(self):
            return iter([{"x": np.zeros(1)}])

    class StubWriter:
        def __init__(self, logdir):
            self.saves = []

        def save(self, epoch, model, optimizer):
            calls["saves"].append(epoch)

        def restore(self, epoch, model, optimizer):
            calls["restores"] += 1

        def close(self):
            calls["closed"] = True

    monkeypatch.setattr("transfuser_torch.train.trainer.Trainer", StubTrainer)
    monkeypatch.setattr("transfuser_torch.data.dataset.CarlaDataset",
                        lambda dirs, cfg, **kw: [1, 2, 3])
    monkeypatch.setattr("transfuser_torch.data.loader.PrefetchLoader",
                        StubLoader)
    monkeypatch.setattr(
        "transfuser_torch.train.checkpoint.AsyncCheckpointWriter", StubWriter)
    monkeypatch.setattr(cli, "_export",
                        lambda path, trainer: calls["exports"].append(path))
    monkeypatch.setenv("TPU_ELASTIC_ERROR_FILE", str(tmp_path / "err.json"))

    cli.main(["--root_dir", str(tmp_path), "--logdir", str(tmp_path),
              "--id", "t", "--epochs", "2", "--max_restarts", "2",
              "--num_workers", "0", "--device", "cpu"])
    # epoch0 ok, epoch1 (first try) fails, restore, epoch1 retry ok
    assert calls["saves"] == [1, 2]
    assert calls["restores"] == 1
    assert calls.get("closed")
    assert calls["fetch_metrics"] is False  # the last step's metrics
    assert calls["exports"] == [str(tmp_path / "t" / "model_2.msgpack")]
    err = json.loads((tmp_path / "err.json").read_text())
    assert "simulated device OOM" in err["message"]["message"]
    assert err["rank"] == 0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of the real CLI on the CPU over a written dataset (3
    train, 2 validation samples), micro trunks, at the full frame size."""
    root = tmp_path_factory.mktemp("carla")
    write_route(str(root / "T" / "Town01_route0"), 12, seed=0, n_points=4000)
    write_route(str(root / "T" / "Town02_route0"), 11, seed=1, n_points=4000)
    logdir = tmp_path_factory.mktemp("log")
    torch.manual_seed(0)
    summary = cli.main([
        "--root_dir", str(root), "--logdir", str(logdir), "--id", "run",
        "--setting", "02_05_withheld", "--epochs", "2", "--batch_size", "2",
        "--val_every", "1", "--num_workers", "2", "--device", "cpu",
        "--image_architecture", "regnety_micro",
        "--lidar_architecture", "regnety_micro"])
    return logdir / "run", summary


def test_cli_trains_checkpoints_and_exports(trained):
    run, summary = trained
    history = json.loads((run / "history.json").read_text())
    rows = history["per_epoch"]
    assert [r["epoch"] for r in rows] == [0, 1]
    for r in rows:
        assert np.isfinite([v for k, v in r.items() if k != "epoch"]).all()
        assert "val_ade" in r and "loss_total" in r
    e = history["best_epoch"]
    assert summary["export_epoch"] == e
    for name in ("config.json", "args.txt", "1", "2", f"model_{e}.msgpack",
                 "best/model_best.msgpack", "best/EXPORT.json",
                 "best/config.json"):
        assert (run / name).exists(), name
    assert checkpoint.list_ensemble_weights(str(run)) == \
        [str(run / f"model_{e}.msgpack")]
    assert json.loads((run / "best" / "EXPORT.json").read_text())[
        "epoch"] == e
    # the exported weights are the train state of the epoch they name
    cfg = checkpoint.load_config_snapshot(str(run))
    exported = state_dict_from_jax(checkpoint.load_inference_weights(
        str(run / f"model_{e}.msgpack")), cfg)
    saved = torch.load(run / str(e) / checkpoint.TRAIN_STATE,
                       weights_only=True)["model"]
    assert exported.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(exported[k], v), k
    saves = summary["checkpoint_saves"]
    assert [s["epoch"] for s in saves] == [1, 2]
    assert all(s["done_s"] >= s["return_s"] for s in saves)


def test_port_agent_drives_with_the_cli_export(trained):
    run, _ = trained
    agent = HybridAgent(str(run), device="cpu")
    assert agent.model_count == 1
    assert not agent.config.model.gpt.reference_view_unpack
    plan, world = _plan()
    agent.set_global_plan(plan, world)
    for i, frame in enumerate(_frames(agent.config, 4)):
        c = agent.run_step(frame, 0.05 * i)
        assert np.isfinite([c.steer, c.throttle, c.brake]).all()
    assert np.isfinite(agent.pred_wp).all()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """The operator's exporter: the program's spans are in ``trace.json``,
    each around the ATen work it made."""
    from transfuser_torch.tracing import profile_trace, span

    with profile_trace(str(tmp_path)):
        for _ in range(3):
            with span("train.step"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    steps = [e for e in events if e.get("name") == "train.step"]
    assert len(steps) == 3
    for s in steps:
        inside = [e for e in events if e.get("name") == "aten::matmul"
                  and s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]
        assert len(inside) == 1
    with profile_trace(None):  # off: no trace, no error
        pass
