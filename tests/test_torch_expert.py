"""The port's privileged expert against the JAX package's.

Lockstep: each package's AutoPilot drives its own hermetic sim through the
scenarios of tests/test_autopilot.py (straight route, blocking vehicle,
crossing walker, red light, stop trigger, a short route to its goal). Both
sides are numpy, so the controls are equal on every tick, exactly, and so
are the ego poses; each scenario's own assertion is checked on the port.

The expert benchmark (``run_expert_benchmark``: generated grid-town
routes, scenario triggers, moving traffic) of both packages writes the
same results JSON, its wall-clock ``duration_system`` aside.
"""

import json
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_harness import strip_wall_clock
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.agents.autopilot import AutoPilot as JaxAutoPilot
from transfuser_tpu.harness import criteria as jax_criteria
from transfuser_tpu.harness import evaluator as jax_evaluator
from transfuser_tpu.harness import route_parser as jax_route_parser
from transfuser_tpu.sim import replay as jax_replay
from transfuser_tpu.sim import sensors as jax_sensors
from transfuser_tpu.sim import types as jax_types
from transfuser_tpu.tools import expert_benchmark as jax_benchmark
from transfuser_torch.agents.autopilot import AutoPilot
from transfuser_torch.harness import criteria as port_criteria
from transfuser_torch.harness import evaluator as port_evaluator
from transfuser_torch.harness import route_parser as port_route_parser
from transfuser_torch.sim import replay as port_replay
from transfuser_torch.sim import sensors as port_sensors
from transfuser_torch.sim import types as port_types
from transfuser_torch.tools import expert_benchmark as port_benchmark

PACKAGES = {
    "jax": SimpleNamespace(agent=JaxAutoPilot, evaluator=jax_evaluator,
                           route=jax_route_parser, replay=jax_replay,
                           types=jax_types, criteria=jax_criteria),
    "port": SimpleNamespace(agent=AutoPilot, evaluator=port_evaluator,
                            route=port_route_parser, replay=port_replay,
                            types=port_types, criteria=port_criteria),
}


def _route(pkg, xs):
    t = pkg.types
    return [t.Transform(t.Location(float(x), 0.0), t.Rotation(yaw=0.0))
            for x in xs]


def _actors(pkg, scenario):
    """The actors of test_autopilot.py's scenario, in ``pkg``'s types."""
    t, Actor = pkg.types, pkg.replay.Actor
    if scenario == "blocker":
        return [Actor(actor_id=42, type_id="vehicle.blocker",
                      transform=t.Transform(t.Location(12.0, 0.0),
                                            t.Rotation(yaw=0.0)),
                      speed=0.0)]
    if scenario == "walker":
        return [Actor(actor_id=7, type_id="walker.pedestrian",
                      transform=t.Transform(t.Location(8.0, -2.0),
                                            t.Rotation(yaw=90.0)),
                      extent=t.Location(0.4, 0.4, 1.0), speed=0.2,
                      direction=(0.0, 1.0, 0.0))]
    if scenario == "red_light":
        return [Actor(actor_id=9, type_id="traffic_light",
                      transform=t.Transform(t.Location(20.0, 0.0),
                                            t.Rotation(yaw=0.0)),
                      state="Red",
                      trigger_location=t.Location(0.0, 0.0, 0.0),
                      trigger_box=t.Location(3.0, 4.0, 2.0))]
    if scenario == "stop":
        return [Actor(actor_id=77, type_id="static.prop.stop",
                      transform=t.Transform(t.Location(25.0, 4.0),
                                            t.Rotation(yaw=0.0)),
                      extent=t.Location(0.3, 0.3, 2.0),
                      trigger_location=t.Location(-2.5, -4.0, 0.0),
                      trigger_box=t.Location(2.5, 3.0, 2.0))]
    return []


# scenario -> (route x positions, ticks)
SCENARIOS = {
    "straight": (np.arange(0.0, 130.0, 10.0), 300),
    "blocker": (np.arange(0.0, 130.0, 10.0), 200),
    "walker": (np.arange(0.0, 130.0, 10.0), 200),
    "red_light": (np.arange(0.0, 130.0, 10.0), 400),
    "stop": (np.arange(0.0, 130.0, 10.0), 600),
    "short_route": (np.arange(0.0, 60.0, 1.0), 500),
}


def _wire(pkg, scenario):
    """test_autopilot._wire_agent in ``pkg``: the agent's plan, sensors
    and a sim it has privileged access to."""
    xs, _ = SCENARIOS[scenario]
    agent = pkg.agent()
    dense = pkg.route.interpolate_trajectory(_route(pkg, xs))
    ids = pkg.route.downsample_route(dense, 50.0)
    sparse = [dense[i] for i in ids]
    agent.set_global_plan(pkg.route.location_route_to_gps(sparse), sparse)
    for spec in agent.sensors():
        agent.sensor_interface.register_sensor(spec["id"], spec["type"])
    sim = pkg.replay.ReplaySimulation([t for t, _ in dense], fps=20,
                                      actors=_actors(pkg, scenario))
    agent.sim = sim
    completion = pkg.criteria.RouteCompletionTest([t for t, _ in dense])
    return agent, sim, completion


def _pose(sim):
    tf = sim.ego_transform
    return (tf.location.x, tf.location.y, tf.rotation.yaw, sim.ego_speed)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_autopilot_lockstep_with_jax(scenario):
    runs = {name: _wire(pkg, scenario) for name, pkg in PACKAGES.items()}
    feeders = {name: pkg.evaluator.default_sensor_feeder
               for name, pkg in PACKAGES.items()}
    controls = []
    inside_stop = False
    for tick in range(SCENARIOS[scenario][1]):
        step = {}
        for name, (agent, sim, completion) in runs.items():
            feeders[name](sim, agent)
            c = agent(sim.game_time)
            step[name] = (c.steer, c.throttle, c.brake)
            sim.apply_control(c)
            sim.tick()
            completion.update(sim)
        assert step["port"] == step["jax"], (tick, step)
        assert _pose(runs["port"][1]) == _pose(runs["jax"][1]), tick
        controls.append(step["port"])
        x = runs["port"][1].ego_transform.location.x
        if 20.0 <= x <= 25.0 and runs["port"][1].ego_speed < \
                port_criteria.RunningStopTest.SPEED_THRESHOLD:
            inside_stop = True

    agent, sim, completion = runs["port"]
    jax_completion = runs["jax"][2]
    assert completion.percentage == jax_completion.percentage
    assert completion._done == jax_completion._done
    x, y = sim.ego_transform.location.x, sim.ego_transform.location.y
    braked = any(b > 0.5 for _, _, b in controls)
    if scenario == "straight":
        assert x > 30.0 and abs(y) < 2.0 and 0.0 < sim.ego_speed <= 5.0
    elif scenario == "blocker":
        assert x < 12.0 - 2.0 and not sim.collision_events
    elif scenario == "walker":
        assert braked and not sim.collision_events
    elif scenario == "red_light":
        assert braked and x < 30.0
    elif scenario == "stop":
        assert agent.ignore_stop_signs is False
        assert inside_stop and x > 30.0
    else:  # short route: the expert stops ~5 m short, which is arrival
        assert completion._done and completion.percentage == 100.0


def test_expert_benchmark_equals_jax(tmp_path, monkeypatch):
    results = {}
    for name, module, sensors in (("jax", jax_benchmark, jax_sensors),
                                  ("port", port_benchmark, port_sensors)):
        monkeypatch.setattr(sensors, "_NOISE_POOLS", {})
        work = tmp_path / name
        work.mkdir()
        out = work / "expert.json"
        scores = module.run_expert_benchmark(
            str(out), n_routes=2, town_spec="grid:2x80x2",
            background_vehicles=4, max_game_seconds=15.0,
            workdir=str(work))
        results[name] = (scores, json.loads(out.read_text()),
                         (work / "routes.xml").read_text(),
                         (work / "scenarios.json").read_text())
    ours, theirs = results["port"], results["jax"]
    assert ours[2:] == theirs[2:]  # the generated routes and scenarios
    assert ours[0] == theirs[0]
    assert strip_wall_clock(ours[1]) == strip_wall_clock(theirs[1])
    assert ours[0]["n_routes"] == 2
    assert len(ours[1]["_checkpoint"]["records"]) == 2
    assert ours[1]["labels"][0] == "Avg. driving score"


def test_expert_benchmark_cli(tmp_path, monkeypatch, capsys):
    """``python -m transfuser_torch.tools.expert_benchmark`` flags: the JAX
    tool's, and the scores on its standard output."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # its workdir
    out = tmp_path / "cli.json"
    port_benchmark.main(["--out", str(out), "--routes", "1",
                         "--background", "0", "--max_game_seconds", "3"])
    data = json.loads(out.read_text())
    assert len(data["_checkpoint"]["records"]) == 1
    assert data["labels"][0] == "Avg. driving score"
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["n_routes"] == 1 and printed["background_vehicles"] == 0


@pytest.mark.parametrize("case", [
    "valid", "duplicate_id", "map_only_sensor", "map_track", "too_far",
    "too_many_cameras", "datagen_extras"])
def test_sensor_validation_rules(case):
    """tests/test_aux_modules.py's sensor-rig rules on the port's copy of
    harness/agent_wrapper.py."""
    from transfuser_torch.agents.base import Track
    from transfuser_torch.harness.agent_wrapper import (
        SensorConfigurationInvalid, validate_sensor_configuration)
    good = [{"type": "sensor.camera.rgb", "id": "rgb", "x": 1.3, "y": 0,
             "z": 2.3}, {"type": "sensor.other.gnss", "id": "gps"}]
    hd_map = [{"type": "sensor.opendrive_map", "id": "hd"}]
    cases = {
        "valid": (good, Track.SENSORS, False, False),
        "duplicate_id": (good + [good[0]], Track.SENSORS, False, True),
        "map_only_sensor": (hd_map, Track.SENSORS, False, True),
        "map_track": (hd_map, Track.MAP, False, False),
        "too_far": ([{"type": "sensor.camera.rgb", "id": "far",
                      "x": 20.0}], Track.MAP, False, True),
        "too_many_cameras": ([{"type": "sensor.camera.rgb", "id": f"c{i}"}
                              for i in range(5)], Track.SENSORS, False,
                             True),
        "datagen_extras": ([{"type": "sensor.camera.depth", "id": "d"}],
                           Track.MAP, True, False),
    }
    sensors, track, datagen, refused = cases[case]
    if refused:
        with pytest.raises(SensorConfigurationInvalid):
            validate_sensor_configuration(sensors, track, datagen=datagen)
    else:
        validate_sensor_configuration(sensors, track, datagen=datagen)
    if case == "datagen_extras":  # refused outside the datagen profile
        with pytest.raises(SensorConfigurationInvalid):
            validate_sensor_configuration(sensors, track)


def test_datagen_profile_pins_the_lidar():
    """The datagen route scenario's LiDAR has no dropoff (the evaluation
    profile's 0.45), as the JAX package's does."""
    from transfuser_torch.harness.agent_wrapper import pinned_lidar_attributes
    from transfuser_torch.harness.game_time import GameTime
    from transfuser_torch.harness.route_scenario import RouteScenario
    assert pinned_lidar_attributes(True)["points_per_second"] == 1200000
    assert pinned_lidar_attributes(False)["rotation_frequency"] == 10.0
    dropoff = {}
    for datagen in (False, True):
        config = port_route_parser.RouteConfig(
            name="0", town="Town01", index=0,
            trajectory=_route(PACKAGES["port"], (0.0, 50.0)))
        dropoff[datagen] = RouteScenario(config, datagen=datagen) \
            .sim._lidar_dropoff
    assert dropoff == {False: 0.45, True: 0.0}
    # the simulation clock of the live adapter's harness
    GameTime.restart()
    GameTime.on_carla_tick(frame=5, elapsed_seconds=0.25)
    GameTime.on_carla_tick(frame=4, elapsed_seconds=0.1)  # stale frame
    assert (GameTime.get_time(), GameTime.get_frame()) == (0.25, 5)
    GameTime.restart()
    assert GameTime.get_frame() == 0
