"""The port's closed-loop harness (transfuser_torch/harness, transfuser_torch/sim)
against the JAX package's: the same routes and Scenario3 trigger, driven by
the same deterministic agents, give equal results JSON (the wall-clock
``duration_system`` aside), map-less and on the procedural grid town with
moving background traffic. The oracle agent also reads an rgb camera, so
equal camera frames (palette, noise pool, road mask, actor boxes) are part
of the comparison."""

import json
import math
import zlib

import numpy as np
import pytest

from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.agents import base as jax_base
from transfuser_tpu.agents import demo_agents as jax_demo
from transfuser_tpu.control import pid as jax_pid
from transfuser_tpu.control import route_planner as jax_planner
from transfuser_tpu.harness import evaluator as jax_evaluator
from transfuser_tpu.sim import sensors as jax_sensors
from transfuser_tpu.sim import types as jax_types
from transfuser_torch.agents import base as port_base
from transfuser_torch.agents import demo_agents as port_demo
from transfuser_torch.control import pid as port_pid
from transfuser_torch.control import route_planner as port_planner
from transfuser_torch.harness import evaluator as port_evaluator
from transfuser_torch.sim import sensors as port_sensors
from transfuser_torch.sim import types as port_types

ROUTES_XML = """<?xml version='1.0' encoding='UTF-8'?>
<routes>
  <route id="0" town="Town01">
    <waypoint x="0.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
    <waypoint x="80.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
    <waypoint x="160.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
  </route>
  <route id="1" town="Town01">
    <waypoint x="0.0" y="10.0" z="0.0" pitch="0" roll="0" yaw="0"/>
    <waypoint x="100.0" y="10.0" z="0.0" pitch="0" roll="0" yaw="0"/>
  </route>
</routes>
"""

SCENARIOS_JSON = {
    "available_scenarios": [{
        "Town01": [{
            "scenario_type": "Scenario3",
            "available_event_configurations": [
                {"transform": {"x": 40.0, "y": 0.0, "z": 0.0, "yaw": 0.0,
                               "pitch": 0.0}},
            ],
        }],
    }]
}

# The grid town's roads lie on multiples of its 80 m blocks; this route
# follows the y = 0 road and turns onto x = 80.
GRID_ROUTES_XML = """<?xml version='1.0' encoding='UTF-8'?>
<routes>
  <route id="0" town="Town01">
    <waypoint x="0.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
    <waypoint x="80.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
    <waypoint x="80.0" y="80.0" z="0.0" pitch="0" roll="0" yaw="90"/>
  </route>
</routes>
"""

PACKAGES = {
    "jax": (jax_base, jax_demo, jax_pid, jax_planner, jax_evaluator,
            jax_sensors, jax_types),
    "port": (port_base, port_demo, port_pid, port_planner, port_evaluator,
             port_sensors, port_types),
}


def oracle_agent(package):
    """The P-controller oracle of tests/test_harness.py on the package's own
    base class, PID and planner, plus a small rgb camera whose frames it
    digests."""
    base, _, pid, planner, _, _, types = PACKAGES[package]

    class OracleAgent(base.AutonomousAgent):
        def setup(self, path_to_conf_file, route_index=None):
            self._planner = planner.RoutePlanner(min_distance=7.5,
                                                 max_distance=50.0)
            self._turn = pid.PIDController(k_p=2.0, k_i=0.0, k_d=0.2, n=20)
            self._initialized = False
            self.digests = []

        def sensors(self):
            return [
                {"type": "sensor.camera.rgb", "x": 1.3, "y": 0.0, "z": 2.3,
                 "yaw": 0.0, "width": 96, "height": 48, "fov": 100,
                 "id": "rgb_front"},
                {"type": "sensor.other.gnss", "id": "gps"},
                {"type": "sensor.other.imu", "id": "imu"},
                {"type": "sensor.speedometer", "id": "speed"},
            ]

        def run_step(self, input_data, timestamp):
            if not self._initialized:
                self._planner.set_route(self._global_plan, gps=True)
                self._initialized = True
            rgb = np.ascontiguousarray(input_data["rgb_front"][1])
            self.digests.append((rgb.shape, zlib.crc32(rgb.tobytes())))
            pos = np.array(input_data["gps"][1][:2]) * \
                planner.GPS_CARLA_SCALE
            compass = input_data["imu"][1][-1]
            speed = input_data["speed"][1]["speed"]
            route = self._planner.run_step(pos)
            target = route[1][0] if len(route) > 1 else route[0][0]
            delta = target - pos
            heading = math.atan2(delta[1], delta[0]) - compass
            heading = (heading + math.pi) % (2 * math.pi) - math.pi
            steer = float(np.clip(self._turn.step(heading / math.pi), -1, 1))
            throttle = 0.6 if speed < 5.0 else 0.0
            return types.VehicleControl(steer=steer, throttle=throttle,
                                        brake=0.0)

    return OracleAgent


def crashing_agent(package):
    base, demo = PACKAGES[package][:2]

    class CrashingAgent(demo.NpcAgent):
        def run_step(self, input_data, timestamp):
            if timestamp > 1.0:
                raise RuntimeError("kernel launch failed")
            return super().run_step(input_data, timestamp)

    return CrashingAgent


AGENTS = {
    "dummy": lambda package: PACKAGES[package][1].DummyAgent,
    "npc": lambda package: PACKAGES[package][1].NpcAgent,
    "oracle": oracle_agent,
    "crash": crashing_agent,
}


def strip_wall_clock(x):
    """The results JSON without its wall-clock field."""
    if isinstance(x, dict):
        return {k: strip_wall_clock(v) for k, v in x.items()
                if k != "duration_system"}
    if isinstance(x, list):
        return [strip_wall_clock(v) for v in x]
    return x


def run_evaluator(package, tmp_path, monkeypatch, agent, town_map=None,
                  background_vehicles=0, max_game_seconds=12.0):
    """One evaluation by ``package``'s Evaluator in a fresh camera-noise
    pool. -> (results JSON, the agents it built)."""
    evaluator, sensors = PACKAGES[package][4:6]
    monkeypatch.setattr(sensors, "_NOISE_POOLS", {})
    routes = tmp_path / "routes.xml"
    routes.write_text(GRID_ROUTES_XML if town_map else ROUTES_XML)
    scenarios = tmp_path / "scenarios.json"
    scenarios.write_text(json.dumps(SCENARIOS_JSON))
    ckpt = tmp_path / f"{package}_results.json"
    agent_cls = AGENTS[agent](package)
    built = []

    def factory(route_config):
        built.append(agent_cls(""))
        return built[-1]

    evaluator.Evaluator(evaluator.EvaluatorArgs(
        routes=str(routes), scenarios=str(scenarios), agent_factory=factory,
        checkpoint=str(ckpt), max_game_seconds=max_game_seconds,
        town_map=town_map, background_vehicles=background_vehicles,
        print_route_table=False)).run()
    return json.loads(ckpt.read_text()), built


@pytest.mark.parametrize("setup", ["mapless", "grid"])
@pytest.mark.parametrize("agent", ["dummy", "npc", "oracle"])
def test_evaluator_matches_jax(tmp_path, monkeypatch, agent, setup):
    kw = dict(town_map="grid", background_vehicles=2) if setup == "grid" \
        else {}
    ref, ref_agents = run_evaluator("jax", tmp_path, monkeypatch, agent, **kw)
    ours, our_agents = run_evaluator("port", tmp_path, monkeypatch, agent,
                                     **kw)
    assert strip_wall_clock(ours) == strip_wall_clock(ref)
    records = ours["_checkpoint"]["records"]
    assert len(records) == (1 if setup == "grid" else 2)
    assert all("crashed" not in r["status"].lower() for r in records)
    if agent == "oracle":
        # the camera frames themselves agree, frame by frame
        assert [a.digests for a in our_agents] == \
            [a.digests for a in ref_agents]
        assert all(len(a.digests) > 100 for a in our_agents)
    if agent != "dummy":
        assert float(ours["values"][1]) > 0.0  # some route completion


def test_agent_crash_is_recorded_as_in_jax(tmp_path, monkeypatch):
    """An agent exception inside run_step (a kernel that fails to launch,
    say) is an "Agent crashed" record and the evaluation goes on, in both
    packages alike."""
    ref, _ = run_evaluator("jax", tmp_path, monkeypatch, "crash")
    ours, _ = run_evaluator("port", tmp_path, monkeypatch, "crash")
    assert strip_wall_clock(ours) == strip_wall_clock(ref)
    statuses = [r["status"] for r in ours["_checkpoint"]["records"]]
    assert statuses == ["Failed - Agent crashed"] * 2


def test_render_matches_jax(monkeypatch):
    """Camera renders of one grid-town scene with traffic: semantic ids,
    depth and the noisy rgb palette, port against JAX."""
    from transfuser_tpu.harness.evaluator import build_town_map as jax_map
    from transfuser_tpu.harness.route_parser import RouteConfig as JaxRoute
    from transfuser_tpu.harness.route_scenario import \
        RouteScenario as JaxScenario
    from transfuser_torch.harness.evaluator import build_town_map as port_map
    from transfuser_torch.harness.route_parser import \
        RouteConfig as PortRoute
    from transfuser_torch.harness.route_scenario import \
        RouteScenario as PortScenario

    def scene(package, route_cls, scenario_cls, town):
        types, sensors = PACKAGES[package][6], PACKAGES[package][5]
        monkeypatch.setattr(sensors, "_NOISE_POOLS", {})
        traj = [types.Transform(types.Location(x, 0.0)) for x in (0., 80.)]
        scenario = scenario_cls(
            route_cls(name="r", index=0, town="Town01", trajectory=traj),
            background_vehicles=6, town_map=town("grid"))
        sim = scenario.sim
        out = []
        spec = {"id": "rgb_front", "x": 1.3, "y": 0.0, "z": 2.3, "yaw": 0.0,
                "width": 160, "height": 80, "fov": 90}
        for step in range(30):
            sim.apply_control(types.VehicleControl(throttle=0.7,
                                                   steer=0.02))
            sim.tick()
            if step % 10 == 9:
                out += [sim.render_camera(spec, k)
                        for k in ("semantic", "depth", "rgb")]
        return out

    ref = scene("jax", JaxRoute, JaxScenario, jax_map)
    ours = scene("port", PortRoute, PortScenario, port_map)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    # the scene has roads, actors and sky in view
    sem = ours[-3][..., 0]
    assert {port_sensors.ROAD, port_sensors.SKY} <= set(np.unique(sem))
    assert (sem == port_sensors.VEHICLE).any()


def test_replay_recorded_frames_and_junction_hook_match_jax():
    """ReplaySimulation(recorded_frames=...) replays the recorded sensor
    dicts frame by frame and holds the last one; ``junction_fn`` answers
    ``is_junction`` on a map-less sim; both as in the JAX package."""
    from transfuser_tpu.sim.replay import ReplaySimulation as JaxSim
    from transfuser_torch.sim.replay import ReplaySimulation as PortSim

    recorded = [{"speed": {"speed": float(i)}, "tag": i} for i in range(3)]
    seen = {}
    for name, sim_cls, types in (("jax", JaxSim, jax_types),
                                 ("port", PortSim, port_types)):
        traj = [types.Transform(types.Location(x, 0.0))
                for x in (0.0, 50.0)]
        sim = sim_cls(traj, fps=20, recorded_frames=recorded,
                      junction_fn=lambda loc: 10.0 <= loc.x <= 20.0)
        frames, junctions = [], []
        for x in (0.0, 15.0, 30.0, 12.0, 40.0):
            frames.append(sim.sensor_frame())
            junctions.append(sim.is_junction(types.Location(x, 0.0)))
            sim.apply_control(types.VehicleControl(throttle=1.0))
            sim.tick()
        loc = sim.ego_location()
        seen[name] = ([f["tag"] for f in frames], junctions,
                      (loc.x, loc.y), sim.frame)
        assert all(f is recorded[min(i, 2)] for i, f in enumerate(frames))
        plain = sim_cls(traj, fps=20)  # no hook, no map: never a junction
        assert not plain.is_junction(types.Location(15.0, 0.0))
    assert seen["port"] == seen["jax"]
    assert seen["port"][:2] == ([0, 1, 2, 2, 2],
                                [False, True, False, True, False])


def test_base_reader_feeds_a_sensor_interface():
    """The pseudo-sensor thread delivers readings at its period through
    the interface's barrier, numbered by frame, until stopped."""
    from transfuser_torch.harness.sensor_interface import (BaseReader,
                                                           SensorInterface)

    interface = SensorInterface(timeout=5.0)
    interface.register_sensor("speed", "sensor.speedometer")
    count = iter(range(10 ** 6))
    reader = BaseReader("speed", interface,
                        lambda: {"speed": float(next(count))}, period=0.002)
    assert reader.daemon
    reader.start()
    try:
        got = [interface.get_data()["speed"] for _ in range(3)]
    finally:
        reader.stop()
        reader.join(timeout=5.0)
    assert not reader.is_alive()
    assert [frame for frame, _ in got] == [0, 1, 2]
    assert [data["speed"] for _, data in got] == [0.0, 1.0, 2.0]
