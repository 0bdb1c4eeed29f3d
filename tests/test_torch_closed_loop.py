"""The port's HybridAgent in the closed loop, and the port's harness CLI.

Lockstep: the port's harness drives the port's agent (on the CPU) over a
40 m route, and on every tick the JAX package's agent receives the same
sensor dict; their waypoints agree within the bf16 bound of
tests/test_torch_agent.py on every compute frame. The port agent's
recorded controls, replayed through the JAX harness, then give the same
results JSON: the harnesses agree exactly, the agents within bf16
rounding, and the two trajectories cannot drift apart.

CLI: the flags of ``python -m transfuser_torch.harness.cli`` are the JAX
CLI's plus ``--device``; it refuses a missing card; ``datagen`` and the
expert and data agents give the JAX CLI's results JSON; and it drives the
export of the port's training CLI to a results JSON (the closed-loop half
of tests/test_lifecycle.py).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from test_torch_agent import WP_ATOL, WP_RTOL
from test_torch_harness import strip_wall_clock
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.agents import base as jax_base
from transfuser_tpu.agents.hybrid_agent import HybridAgent as JaxAgent
from transfuser_tpu.data.synthetic import synthetic_batch
from transfuser_tpu.harness import cli as jax_cli
from transfuser_tpu.harness import evaluator as jax_evaluator
from transfuser_tpu.models import LidarCenterNet as JaxModel
from transfuser_tpu.sim import sensors as jax_sensors
from transfuser_tpu.sim.types import VehicleControl as JaxControl
from transfuser_tpu.train.checkpoint import (save_config_snapshot,
                                             save_inference_weights)
from transfuser_torch.agents import base as port_base
from transfuser_torch.agents.hybrid_agent import HybridAgent
from transfuser_torch.data.synthetic import write_route
from transfuser_torch.harness import cli
from transfuser_torch.harness import evaluator as port_evaluator
from transfuser_torch.sim import sensors as port_sensors
from transfuser_torch.train import cli as train_cli

REPO = Path(__file__).resolve().parent.parent

ROUTE_XML = """<?xml version='1.0' encoding='UTF-8'?>
<routes><route id="0" town="Town01">
  <waypoint x="0.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
  <waypoint x="40.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
</route></routes>"""

# the y = 80 road of the grid town, into its signalised junction
GRID_ROUTE_XML = """<?xml version='1.0' encoding='UTF-8'?>
<routes><route id="0" town="Town01">
  <waypoint x="60.0" y="78.25" z="0.0" pitch="0" roll="0" yaw="0"/>
  <waypoint x="110.0" y="78.25" z="0.0" pitch="0" roll="0" yaw="0"/>
</route></routes>"""


def _model_dir(tmp_path):
    """One JAX-initialised member of the flagship family at the CPU test
    size (micro RegNetY trunks, 64x128 image, 64x64 LiDAR, anchors that
    every pool divides), saved as the training CLI exports it."""
    cfg = tiny_config()
    gpt = dataclasses.replace(
        cfg.model.gpt, img_vert_anchors=2, img_horz_anchors=4,
        lidar_vert_anchors=2, lidar_horz_anchors=2)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, image_architecture="regnety_micro",
        lidar_architecture="regnety_micro", gpt=gpt))
    model_dir = str(tmp_path / "model")
    save_config_snapshot(model_dir, cfg)
    b = synthetic_batch(cfg, 1, img_hw=(64, 128), lidar_hw=(64, 64),
                        bev_hw=(40, 40))
    variables = jax.jit(lambda rngs: JaxModel(cfg, dtype=jnp.float32).init(
        rngs, b["rgb"], b["lidar"], b["target_point"],
        b["target_point_image"], b["speed"], train=False))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)})
    save_inference_weights(os.path.join(model_dir, "model_0.msgpack"),
                           jax.device_get(variables))
    return model_dir


class Lockstep(port_base.AutonomousAgent):
    """The port's agent drives; the JAX agent sees every tick's sensor dict
    and its waypoints are held to the port's on every compute frame."""

    def setup(self, path_to_conf_file, route_index=None):
        self.ours = HybridAgent(path_to_conf_file, device="cpu")
        self.ref = JaxAgent(path_to_conf_file)
        self.controls = []
        self.compute_frames = 0
        self.controls_compared = 0

    def sensors(self):
        return self.ours.sensors()

    def set_global_plan(self, gps, world):
        super().set_global_plan(gps, world)
        self.ours.set_global_plan(gps, world)
        self.ref.set_global_plan(gps, world)

    def run_step(self, input_data, timestamp):
        data = input_data.copy()  # evaluates the lazy camera/lidar reads
        c_ours = self.ours.run_step(dict(data), timestamp)
        c_ref = self.ref.run_step(dict(data), timestamp)
        for c in (c_ours, c_ref):
            assert np.isfinite([c.steer, c.throttle, c.brake]).all()
        if self.ours.step % 2 == 0:  # a compute frame of both agents
            self.compute_frames += 1
            np.testing.assert_allclose(
                self.ours.pred_wp, self.ref.pred_wp, rtol=WP_RTOL,
                atol=WP_ATOL, err_msg=f"compute frame {self.compute_frames}")
            if c_ours.brake == c_ref.brake:
                np.testing.assert_allclose(
                    [c_ours.steer, c_ours.throttle],
                    [c_ref.steer, c_ref.throttle], atol=WP_ATOL)
                self.controls_compared += 1
        self.controls.append((c_ours.steer, c_ours.throttle, c_ours.brake))
        return c_ours


def test_port_agent_in_lockstep_with_jax_agent(tmp_path, monkeypatch):
    model_dir = _model_dir(tmp_path)
    routes = tmp_path / "routes.xml"
    routes.write_text(ROUTE_XML)

    monkeypatch.setattr(port_sensors, "_NOISE_POOLS", {})
    agents = []

    def lockstep(route_config):
        agents.append(Lockstep(model_dir))
        return agents[-1]

    port_evaluator.Evaluator(port_evaluator.EvaluatorArgs(
        routes=str(routes), agent_factory=lockstep,
        checkpoint=str(tmp_path / "port.json"), max_game_seconds=2.0,
        timeout=600.0, print_route_table=False)).run()
    ours = json.loads((tmp_path / "port.json").read_text())
    record = ours["_checkpoint"]["records"][0]
    assert "crashed" not in record["status"].lower(), record["status"]
    (agent,) = agents
    assert agent.compute_frames >= 20
    assert agent.controls_compared >= 1

    # the same controls, tick by tick, through the JAX harness
    specs = agent.ours.sensors()

    class Replay(jax_base.AutonomousAgent):
        def setup(self, path_to_conf_file, route_index=None):
            self.controls = iter(agent.controls)

        def sensors(self):
            return specs

        def run_step(self, input_data, timestamp):
            input_data.copy()  # the same lazy reads, in the same order
            steer, throttle, brake = next(self.controls)
            return JaxControl(steer=steer, throttle=throttle, brake=brake)

    monkeypatch.setattr(jax_sensors, "_NOISE_POOLS", {})
    jax_evaluator.Evaluator(jax_evaluator.EvaluatorArgs(
        routes=str(routes), agent_factory=lambda c: Replay(),
        checkpoint=str(tmp_path / "jax.json"), max_game_seconds=2.0,
        timeout=600.0, print_route_table=False)).run()
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert strip_wall_clock(ours) == strip_wall_clock(ref)


def _options(parser, command):
    sub = next(a for a in parser._actions if a.dest == "command")
    return {a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices or ()))
            for a in sub.choices[command]._actions if a.dest != "help"}


@pytest.mark.parametrize("command", ["evaluate", "datagen"])
def test_flags_are_the_jax_clis_plus_device(command, monkeypatch):
    for var, value in [("ROUTES", "r.xml"), ("SCENARIOS", "s.json"),
                       ("CHECKPOINT_ENDPOINT", "c.json"),
                       ("TEAM_CONFIG", "model"), ("RESUME", "1"),
                       ("REPETITIONS", "3"), ("TOWN_MAP", "grid:3"),
                       ("SAVE_PATH", "out")]:
        monkeypatch.setenv(var, value)
    ours = _options(cli.build_parser(), command)
    theirs = _options(jax_cli.build_parser(), command)
    assert ours.pop("device") == (("--device",), "cuda", ())
    assert ours == theirs
    assert theirs["repetitions"][1] == 3 and theirs["resume"][1] is True


def test_help_runs_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "transfuser_torch.harness.cli", "evaluate",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=120,
        check=True).stdout
    assert "--device" in out and "--town-map" in out


def test_cuda_without_a_card_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    routes = tmp_path / "routes.xml"
    routes.write_text(ROUTE_XML)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["evaluate", "--routes", str(routes), "--agent", "hybrid",
                  "--checkpoint", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


@pytest.mark.parametrize("argv", [
    ["datagen"], ["evaluate", "--agent", "autopilot"],
    ["evaluate", "--agent", "data"]], ids=["datagen", "autopilot", "data"])
def test_expert_commands_equal_jax_cli(tmp_path, monkeypatch, argv):
    """``datagen`` and the expert / data agents through each package's CLI
    on a short grid-town route with traffic: equal results JSON, and
    datagen writes the same dataset files."""
    routes = tmp_path / "routes.xml"
    routes.write_text(GRID_ROUTE_XML)
    results, saved = {}, {}
    for name, module, sensors in (("jax", jax_cli, jax_sensors),
                                  ("port", cli, port_sensors)):
        monkeypatch.setattr(sensors, "_NOISE_POOLS", {})
        monkeypatch.setenv("SAVE_PATH", "")
        out = tmp_path / name
        extra = ["--device", "cpu"] if name == "port" else []
        assert module.main(argv + [
            "--routes", str(routes), "--checkpoint", str(out) + ".json",
            "--save-path", str(out), "--max-game-seconds", "3",
            "--town-map", "grid", "--background-vehicles", "1"] + extra) == 0
        results[name] = json.loads((tmp_path / f"{name}.json").read_text())
        saved[name] = sorted(str(p.relative_to(out)) for p in out.rglob("*")
                             if p.is_file())
    assert strip_wall_clock(results["port"]) == \
        strip_wall_clock(results["jax"])
    (record,) = results["port"]["_checkpoint"]["records"]
    assert "crashed" not in record["status"].lower(), record["status"]
    assert saved["port"] == saved["jax"]
    # only the datagen command writes a dataset (SAVE_PATH from --save-path)
    assert bool(saved["port"]) == (argv[0] == "datagen")


def test_cli_drives_a_training_cli_export(tmp_path):
    """Train one epoch with the port's CLI on a written dataset, then drive
    its export through ``python -m transfuser_torch.harness.cli``."""
    root = tmp_path / "carla"
    write_route(str(root / "T" / "Town01_route0"), 4, seed=0, n_points=2000)
    write_route(str(root / "T" / "Town02_route0"), 3, seed=1, n_points=2000)
    torch.manual_seed(0)
    train_cli.main([
        "--root_dir", str(root), "--logdir", str(tmp_path / "log"),
        "--id", "run", "--setting", "02_05_withheld", "--epochs", "1",
        "--batch_size", "2", "--val_every", "1", "--num_workers", "0",
        "--device", "cpu", "--image_architecture", "regnety_micro",
        "--lidar_architecture", "regnety_micro"])
    run = tmp_path / "log" / "run"
    assert list(run.glob("model_*.msgpack"))

    routes = tmp_path / "routes.xml"
    routes.write_text(ROUTE_XML)
    results = tmp_path / "results.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("ROUTES", "TEAM_CONFIG", "CHECKPOINT_ENDPOINT")}
    proc = subprocess.run(
        [sys.executable, "-m", "transfuser_torch.harness.cli", "evaluate",
         "--routes", str(routes), "--agent", "hybrid",
         "--agent-config", str(run), "--checkpoint", str(results),
         "--max-game-seconds", "1", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    data = json.loads(results.read_text())
    (record,) = data["_checkpoint"]["records"]
    assert "crashed" not in record["status"].lower(), record["status"]
    assert record["meta"]["duration_game"] > 1.0
    assert data["labels"][0] == "Avg. driving score"
    assert json.loads(proc.stdout[proc.stdout.index("{"):])[
        "score_composed"] >= 0.0
