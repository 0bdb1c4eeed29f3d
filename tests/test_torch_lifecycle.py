"""The whole lifecycle in the port alone (the counterpart of
tests/test_lifecycle.py): the port's datagen writes a dataset, the port's
CarlaDataset reads it at the tiny test shapes, the port's Trainer fits it
(the loss falls over 12 fp32 steps), the run is exported as the training
CLI exports it (config snapshot plus flax-format msgpack weights), and
``python -m transfuser_torch.harness.cli evaluate`` drives the trained
agent in the closed loop. This is the contract a reference user runs
across datagen.sh, train.py and local_evaluation.sh."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from transfuser_torch.config import GlobalConfig
from transfuser_torch.data.dataset import CarlaDataset, collate
from transfuser_torch.harness import cli
from transfuser_torch.sim import sensors as port_sensors
from transfuser_torch.train.checkpoint import (save_config_snapshot,
                                               save_inference_weights)
from transfuser_torch.train.jax_import import variables_from_state_dict
from transfuser_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent

ROUTE_XML = """<?xml version='1.0' encoding='UTF-8'?>
<routes><route id="0" town="Town01">
  <waypoint x="0.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
  <waypoint x="{end}" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
</route></routes>"""


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers: torch's CPU pool at its default
    size oversubscribes the cores, 2 threads here (and in the CLI's
    process)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tiny_config() -> GlobalConfig:
    """tests/helpers.tiny_config's shapes in the port's config (64x128
    image, 64x64 LiDAR, 40x40 BEV, one GPT layer), on micro RegNetY
    trunks with anchors that every pool divides."""
    cfg = GlobalConfig()
    sensors = dataclasses.replace(
        cfg.sensors, img_resolution=(64, 128),
        lidar_resolution_width=64, lidar_resolution_height=64)
    bev = dataclasses.replace(
        cfg.bev, bev_resolution_width=40, bev_resolution_height=40)
    gpt = dataclasses.replace(
        cfg.model.gpt, n_layer=1, img_vert_anchors=2, img_horz_anchors=4,
        lidar_vert_anchors=2, lidar_horz_anchors=2)
    model = dataclasses.replace(
        cfg.model, image_architecture="regnety_micro",
        lidar_architecture="regnety_micro", gpt=gpt,
        perception_output_features=128, deconv_channel_num_1=32,
        deconv_channel_num_2=16, deconv_channel_num_3=8)
    train = dataclasses.replace(cfg.train, batch_size=2,
                                compute_dtype="float32")
    return cfg.replace(sensors=sensors, bev=bev, model=model, train=train)


def test_datagen_train_eval_lifecycle(tmp_path, monkeypatch):
    # ---- 1. the expert collects a dataset through the port's CLI
    monkeypatch.setattr(port_sensors, "_NOISE_POOLS", {})
    monkeypatch.delenv("SAVE_PATH", raising=False)
    routes = tmp_path / "datagen.xml"
    routes.write_text(ROUTE_XML.format(end=200.0))
    assert cli.main(["datagen", "--routes", str(routes), "--save-path",
                     str(tmp_path / "data"), "--checkpoint",
                     str(tmp_path / "datagen.json"),
                     "--max-game-seconds", "12"]) == 0
    sp = tmp_path / "data" / "route0"
    assert len(os.listdir(sp / "measurements")) >= 20

    # ---- 2. the port's reader at the tiny config's shapes
    cfg = _tiny_config()
    ds = CarlaDataset([str(sp)], cfg, augment=False)
    assert len(ds) >= 8
    batch = collate([ds[i] for i in range(4)])
    assert batch["rgb"].shape == (4, 64, 128, 3)
    assert batch["lidar"].shape == (4, 64, 64, 2)

    # ---- 3. train on it: the loss falls on expert-collected samples
    torch.manual_seed(0)
    trainer = Trainer(cfg, dtype=torch.float32, device="cpu", seed=0)
    on_device = trainer.put_batch(batch)
    losses = [float(trainer.train_step(on_device)["loss_total"])
              for _ in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses

    # ---- 4. export as the training CLI does
    model_dir = tmp_path / "model_ckpt"
    model_dir.mkdir()
    save_config_snapshot(str(model_dir), cfg)
    save_inference_weights(
        str(model_dir / "model_0.msgpack"),
        variables_from_state_dict(trainer.model.state_dict(), cfg))

    # ---- 5. the trained agent drives the port's closed loop
    routes = tmp_path / "eval.xml"
    routes.write_text(ROUTE_XML.format(end=40.0))
    results = tmp_path / "results.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("ROUTES", "TEAM_CONFIG", "CHECKPOINT_ENDPOINT",
                        "SAVE_PATH")}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-m", "transfuser_torch.harness.cli", "evaluate",
         "--routes", str(routes), "--agent", "hybrid",
         "--agent-config", str(model_dir), "--checkpoint", str(results),
         "--max-game-seconds", "4", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (record,) = json.loads(results.read_text())["_checkpoint"]["records"]
    assert "crashed" not in record["status"].lower(), record["status"]
    assert record["meta"]["duration_game"] > 4.0 - 0.1
