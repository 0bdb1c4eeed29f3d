"""The port's host side of the other backbone families vs the JAX
package: the latentTF and geometric_fusion agents on the same weights and
frames, the copied correspondence sampler and box safety check, the
CarlaDataset's geometric sample, and the training CLI on geometric fusion.

The agents compute in bf16 (the JAX agent always does), so waypoints
agree to the bound tests/test_torch_agent.py holds transFuser's to.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_agent import WP_ATOL, WP_RTOL, _frames, _plan
from test_torch_families import _config, _numpy_variables
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu import native as jax_native
from transfuser_tpu.agents.hybrid_agent import HybridAgent as JaxAgent
from transfuser_tpu.config import GlobalConfig as JaxConfig
from transfuser_tpu.control import safety as jsafety
from transfuser_tpu.data import correspondences as jcorr
from transfuser_tpu.data.dataset import CarlaDataset as JaxDataset
from transfuser_tpu.data.synthetic import synthetic_batch
from transfuser_tpu.models.lidar_centernet import LidarCenterNet as JaxModel
from transfuser_tpu.train.checkpoint import save_config_snapshot
from transfuser_tpu.train.trainer import _model_inputs as jax_inputs
from transfuser_torch.agents.hybrid_agent import HybridAgent
from transfuser_torch.config import GlobalConfig
from transfuser_torch.control import safety
from transfuser_torch.data import correspondences
from transfuser_torch.data.dataset import CarlaDataset
from transfuser_torch.data.synthetic import write_route
from transfuser_torch.train import checkpoint, cli
from transfuser_torch.train.jax_import import state_dict_from_jax


# ------------------------------------------------------------ host copies

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_correspondences_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = 20000
    world = np.concatenate([rng.uniform(-25, 25, (n, 1)),
                            rng.uniform(-5, 40, (n, 1)),
                            rng.uniform(-3, 2, (n, 1))], axis=1)
    for got, want in zip(correspondences.project_correspondence_pairs(world),
                         jcorr.project_correspondence_pairs(world)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            correspondences.lidar_cam_correspondences(world, seed=seed),
            jcorr.lidar_cam_correspondences(world, seed=seed)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_box_safety_check_equals_jax():
    """latentTF's predicted-box check on random fused boxes (corner
    layout of the agent's _metric_boxes) at random ego speeds."""
    rng = np.random.default_rng(4)
    ctrl = GlobalConfig().controller
    hits = 0
    for _ in range(300):
        boxes = []
        for _ in range(int(rng.integers(0, 4))):
            c = rng.uniform([-2, -4], [8, 4])
            h, w, yaw = rng.uniform(0.5, 3), rng.uniform(0.5, 2), \
                rng.uniform(-np.pi, np.pi)
            local = np.array([[-h, -w], [-h, w], [h, w], [h, -w],
                              [0.0, 0.0], [0.0, h]])
            rot = np.array([[np.cos(yaw), -np.sin(yaw)],
                            [np.sin(yaw), np.cos(yaw)]])
            boxes.append(local @ rot.T + c)
            assert safety.bb_yaw(boxes[-1]) == jsafety.bb_yaw(boxes[-1])
        speed = float(rng.uniform(0, 12))
        got = safety.bb_detected_in_front_of_vehicle(boxes, speed, ctrl)
        assert got == jsafety.bb_detected_in_front_of_vehicle(boxes, speed,
                                                              ctrl)
        hits += got
    assert 0 < hits < 300


# ----------------------------------------------------------------- agents

def _model_dir(tmp_path, cfg):
    """A model dir with a config snapshot and one .pth in the reference's
    names, seeded numpy weights in the JAX model's tree."""
    jm = JaxModel(cfg, dtype=jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(cfg, 1).items()}
    args, extra = jax_inputs(batch)
    variables = _numpy_variables(jax.eval_shape(
        lambda k: jm.init(k, *args, train=False, **extra),
        jax.random.PRNGKey(0)), seed=6)
    # waypoint steps of a few decimetres, as at the JAX package's init:
    # the bf16 bound below is in metres
    variables["params"]["wp_gru"]["output"]["kernel"] *= 0.1
    model_dir = str(tmp_path / "model")
    save_config_snapshot(model_dir, cfg)
    torch.save({f"module.{k}": v
                for k, v in state_dict_from_jax(variables, cfg).items()},
               os.path.join(model_dir, "model_0.pth"))
    return model_dir


def _drive_both(cfg, ours, ref, frames):
    plan, world = _plan()
    for agent in (ours, ref):
        agent.set_global_plan(plan, world)
    compared = 0
    for i, frame in enumerate(frames):
        c_ours = ours.run_step(frame, 0.05 * i)
        c_ref = ref.run_step(frame, 0.05 * i)
        for c in (c_ours, c_ref):
            assert np.isfinite([c.steer, c.throttle, c.brake]).all()
        if i % 2:
            continue  # action-repeat frame: both reuse their last control
        np.testing.assert_allclose(ours.pred_wp, ref.pred_wp, rtol=WP_RTOL,
                                   atol=WP_ATOL, err_msg=f"frame {i}")
        if c_ours.brake == c_ref.brake:
            np.testing.assert_allclose(
                [c_ours.steer, c_ours.throttle],
                [c_ref.steer, c_ref.throttle], atol=WP_ATOL,
                err_msg=f"frame {i}")
            compared += 1
    assert compared >= 1


def test_latent_tf_agent_matches_jax_agent(tmp_path):
    """Camera only: neither agent lists a LiDAR sensor, and the frames
    carry none."""
    cfg = _config("latentTF")
    model_dir = _model_dir(tmp_path, cfg)
    ours = HybridAgent(model_dir, device="cpu")
    ref = JaxAgent(model_dir)
    for agent in (ours, ref):
        assert "lidar" not in [s["id"] for s in agent.sensors()]
    assert ours.config.model.gpt.reference_view_unpack
    frames = []
    for frame in _frames(cfg, 4):
        del frame["lidar"]
        frames.append(frame)
    _drive_both(cfg, ours, ref, frames)


def test_geometric_agent_matches_jax_agent(tmp_path):
    """Per-frame correspondences from each frame's cloud, at the full
    sensor size (the sampler's grids are the full-size anchor grids); a
    .pth member turns on the reference's grid view in both agents."""
    full = JaxConfig()
    gpt = dataclasses.replace(full.model.gpt, n_layer=1, n_embd=32)
    cfg = full.replace(model=dataclasses.replace(
        full.model, backbone="geometric_fusion",
        image_architecture="resnet_micro", lidar_architecture="resnet_micro",
        gpt=gpt, use_velocity=True, perception_output_features=128,
        deconv_channel_num_1=32, deconv_channel_num_2=16,
        deconv_channel_num_3=8))
    model_dir = _model_dir(tmp_path, cfg)
    ours = HybridAgent(model_dir, device="cpu")
    ref = JaxAgent(model_dir)
    for agent in (ours, ref):
        assert agent.config.model.geometric_reference_view
        assert "lidar" in [s["id"] for s in agent.sensors()]
    _drive_both(cfg, ours, ref, list(_frames(cfg, 4)))


# ---------------------------------------------------------- data and CLI

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("carla")
    write_route(str(root / "T" / "Town01_route0"), 12, seed=0,
                n_points=3000)
    write_route(str(root / "T" / "Town02_route0"), 11, seed=1, n_points=3000)
    return str(root)


def test_geometric_dataset_sample_equals_jax_reader(data_root, monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)
    jcfg = JaxConfig(root_dir=data_root, setting="02_05_withheld")
    jcfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, backbone="geometric_fusion"))
    cfg = GlobalConfig.from_json(jcfg.to_json())
    train, val = cfg.resolve_splits()
    ours = CarlaDataset(train + val, cfg, augment=False, packed=True)
    ref = JaxDataset(train + val, jcfg, augment=False, packed=True)
    for i in (0, 4):
        got, want = ours[i], ref[i]
        assert got.keys() == want.keys()
        assert "bev_points" in got and "cam_points" in got
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cli_trains_geometric_fusion(data_root, tmp_path):
    """One epoch of the real CLI on the CPU, geometric fusion on the micro
    ResNet trunks at the full frame size; the export drives the agent."""
    torch.manual_seed(0)
    summary = cli.main([
        "--root_dir", data_root, "--logdir", str(tmp_path), "--id", "geo",
        "--setting", "02_05_withheld", "--epochs", "1", "--batch_size", "2",
        "--val_every", "1", "--num_workers", "2", "--device", "cpu",
        "--backbone", "geometric_fusion",
        "--image_architecture", "resnet_micro",
        "--lidar_architecture", "resnet_micro"])
    run = tmp_path / "geo"
    rows = json.loads((run / "history.json").read_text())["per_epoch"]
    assert len(rows) == 1 and "val_ade" in rows[0]
    assert np.isfinite([v for v in rows[0].values()]).all()
    e = summary["export_epoch"]
    cfg = checkpoint.load_config_snapshot(str(run))
    assert (cfg.model.backbone, cfg.model.image_architecture) == \
        ("geometric_fusion", "resnet_micro")
    exported = state_dict_from_jax(checkpoint.load_inference_weights(
        str(run / f"model_{e}.msgpack")), cfg)
    assert "_model.image_projection4.4.weight" in exported
    agent = HybridAgent(str(run), device="cpu")
    assert not agent.config.model.geometric_reference_view
    plan, world = _plan()
    agent.set_global_plan(plan, world)
    for i, frame in enumerate(_frames(agent.config, 2)):
        c = agent.run_step(frame, 0.05 * i)
        assert np.isfinite([c.steer, c.throttle, c.brake]).all()
