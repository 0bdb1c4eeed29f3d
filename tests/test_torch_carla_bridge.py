"""The port's live-CARLA adapter and ROS-style bridge agent under the JAX
package's contract tests.

tests/test_carla_adapter.py pins the client API sequence against a fake
``carla`` egg; each of its cases runs here unchanged with the port's
``sim.carla_adapter`` and ``sim.types`` in the place of the JAX package's
(the cases import both inside their bodies). tests/test_bridge_agent.py's
external stack and local bus then drive the port's BridgeAgent through the
port's evaluator, and its stepping mode refuses a step with no control.
"""

import sys

import numpy as np
import pytest

import test_bridge_agent as jax_bridge_cases
import test_carla_adapter as carla_cases
from test_bridge_agent import routes  # noqa: F401  (fixture)
from test_carla_adapter import fake_carla  # noqa: F401  (fixture)
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_torch.agents.bridge_agent import (CONTROL_TOPIC,
                                                  BridgeAgent, LocalBus)
from transfuser_torch.harness.evaluator import Evaluator, EvaluatorArgs
from transfuser_torch.sim import carla_adapter as port_adapter
from transfuser_torch.sim import types as port_types

ADAPTER_CASES = ["test_client_setup_contract",
                 "test_ego_spawn_and_control_roundtrip",
                 "test_sensor_attach_pins_leaderboard_attributes",
                 "test_sensor_attach_datagen_profile",
                 "test_actor_wrapping_and_cleanup",
                 "test_junction_query"]


@pytest.mark.parametrize("case", ADAPTER_CASES)
def test_carla_adapter_contract(case, fake_carla, monkeypatch):  # noqa: F811
    monkeypatch.setitem(sys.modules, "transfuser_tpu.sim.carla_adapter",
                        port_adapter)
    monkeypatch.setitem(sys.modules, "transfuser_tpu.sim.types", port_types)
    assert carla_cases._make_sim().__class__ is port_adapter.CarlaSimulation
    getattr(carla_cases, case)(fake_carla)


class _PortBridgeAgent(BridgeAgent):
    bus_instance = None

    def make_bus(self, path_to_conf_file):
        return type(self).bus_instance


def test_bridge_agent_closed_loop(tmp_path, routes):  # noqa: F811
    xml, scen = routes
    bus = LocalBus()
    stack = jax_bridge_cases._EchoStack(bus)
    _PortBridgeAgent.bus_instance = bus
    result = Evaluator(EvaluatorArgs(
        routes=xml, scenarios=scen,
        agent_factory=lambda cfg: _PortBridgeAgent(),
        checkpoint=str(tmp_path / "results.json"),
        max_game_seconds=20.0, town_map="grid",
        print_route_table=False)).run()
    scores = result.get("scores", result)
    assert stack.frames > 10
    assert stack.clocks and stack.clocks == sorted(stack.clocks)
    assert stack.plan and len(stack.plan) >= 2
    assert scores["score_route"] > 20.0


def test_bridge_stepping_mode_requires_control():
    bus = LocalBus()
    _PortBridgeAgent.bus_instance = bus
    agent = _PortBridgeAgent()
    agent.stepping = True
    agent._step_mode_possible = True
    agent.control_timeout = 0.05
    with pytest.raises(RuntimeError, match="no control"):
        agent.run_step({"rgb": (0, np.zeros((4, 4, 3)))}, 0.05)
    bus.subscribe("/carla/ego_vehicle/camera/rgb/rgb/image",
                  lambda m: bus.publish(CONTROL_TOPIC,
                                        {"throttle": 0.3, "steer": 0.1}))
    ctrl = agent.run_step({"rgb": (1, np.zeros((4, 4, 3)))}, 0.1)
    assert ctrl.throttle == pytest.approx(0.3)
    assert ctrl.steer == pytest.approx(0.1)
