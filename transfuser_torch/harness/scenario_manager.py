"""(Copy of transfuser_tpu/harness/scenario_manager.py.)

Scenario execution loop with sim + agent watchdogs.

Behavioral spec: leaderboard/scenario_manager_local.py:30-230 — per tick:
agent() -> apply_control -> criteria tick -> world tick; dual watchdogs;
duration bookkeeping; timeout accounting.
"""

from __future__ import annotations

import math
import time
from typing import Optional

from ..agents.base import AutonomousAgent
from .route_scenario import RouteScenario
from .watchdog import Watchdog


class AgentError(Exception):
    """Agent failures crash the route, not the evaluation
    (leaderboard_evaluator_local.py:353-373)."""


class ScenarioManager:
    def __init__(self, timeout: float = 60.0, debug: bool = False,
                 max_game_seconds: Optional[float] = None):
        self._timeout = timeout
        self._debug = debug
        self._max_game_seconds = max_game_seconds
        self._watchdog: Optional[Watchdog] = None
        self._agent_watchdog: Optional[Watchdog] = None
        self.scenario: Optional[RouteScenario] = None
        self.agent: Optional[AutonomousAgent] = None
        self._running = False
        self.duration_system = 0.0
        self.duration_game = 0.0
        self.timed_out = False

    def load_scenario(self, scenario: RouteScenario,
                      agent: AutonomousAgent,
                      sensor_feeder) -> None:
        """sensor_feeder(sim, agent) pushes the current frame's sensor data
        into the agent's SensorInterface (the AgentWrapper role,
        agent_wrapper_local.py:86-193)."""
        self.scenario = scenario
        self.agent = agent
        self._sensor_feeder = sensor_feeder
        agent.set_global_plan(scenario.global_plan_gps,
                              scenario.global_plan_world)

    def run_scenario(self) -> None:
        assert self.scenario is not None and self.agent is not None
        self._watchdog = Watchdog(self._timeout)
        self._agent_watchdog = Watchdog(self._timeout)
        self._watchdog.start()
        self._running = True
        start_system = time.time()
        sim = self.scenario.sim
        start_game = sim.game_time

        max_game = self._max_game_seconds
        try:
            while self._running:
                self._watchdog.update()
                self._sensor_feeder(sim, self.agent)
                self._agent_watchdog.start()
                try:
                    control = self.agent(sim.game_time)
                except Exception as e:  # noqa: BLE001
                    raise AgentError(str(e)) from e
                finally:
                    self._agent_watchdog.stop()
                sim.apply_control(control)
                self.scenario.tick_criteria()
                sim.tick()
                if self.scenario.should_terminate():
                    self._running = False
                if max_game is not None and \
                        sim.game_time - start_game > max_game:
                    self.timed_out = True
                    self._running = False
        finally:
            self._watchdog.stop()
            self.duration_system = time.time() - start_system
            self.duration_game = sim.game_time - start_game

    def stop_scenario(self) -> None:
        self._running = False
