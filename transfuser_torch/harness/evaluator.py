"""(Copy of transfuser_tpu/harness/evaluator.py without OpenCV.)

Top-level route evaluator: index -> run -> score -> checkpoint.

Behavioral spec: leaderboard_evaluator_local.py:246-476 — per-route
agent setup under watchdog, scenario build, run, statistics registration,
cleanup; crash taxonomy (agent crash recorded + continue; simulation crash
aborts); --resume via the results-JSON checkpoint.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from ..agents.base import AutonomousAgent
from .route_parser import RouteConfig, RouteIndexer
from .route_scenario import RouteScenario
from .scenario_manager import AgentError, ScenarioManager
from .statistics import StatisticsEngine


def _resize_image(data: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-resize an HxWxC frame to the agent's declared camera shape.

    (np.resize tiles/truncates raw bytes — it is not an image resize; a
    mismatched sensor declaration must still deliver real pixels.) The
    reference takes OpenCV's bilinear resize where OpenCV is installed
    and this nearest sampling otherwise; the port always samples. Only a
    backend that cannot render cameras reaches it.
    """
    ys = np.clip((np.arange(h) + 0.5) * data.shape[0] / h, 0,
                 data.shape[0] - 1).astype(np.int64)
    xs = np.clip((np.arange(w) + 0.5) * data.shape[1] / w, 0,
                 data.shape[1] - 1).astype(np.int64)
    return data[ys][:, xs]


def default_sensor_feeder(sim, agent: AutonomousAgent) -> None:
    """Push the backend's frame into the agent's sensor queue, tagged by the
    agent's declared sensor ids.

    Camera and lidar payloads are delivered LAZILY (SensorInterface
    update_sensor(lazy=True)): synthesizing a 60k-point lidar sweep and
    nine camera renders per tick for an agent that persists them at 2 Hz
    (the DataAgent) made datagen ~10x slower than the driving itself.
    Thunks evaluate inside the agent's run_step, the same tick they were
    queued, so the sim state they read is the state they were fed from."""
    frame = sim.sensor_frame()
    can_render = hasattr(sim, "render_camera")
    for spec in agent.sensors():
        tag = spec["id"]
        stype = spec["type"]
        lazy = True
        if stype == "sensor.camera.rgb":
            if can_render:
                # map-aware palette render (sensors.semantic_to_rgb), not
                # the legacy noise frame: trained models consume this.
                data = (lambda s=spec: sim.render_camera(s, "rgb"))
            else:
                key = {"rgb": "rgb", "rgb_left": "rgb_left",
                       "rgb_right": "rgb_right", "rgb_back": "rgb",
                       "rgb_front": "rgb"}.get(tag, "rgb")

                def data(k=key, h=spec.get("height"),
                         w=spec.get("width")):
                    img = frame[k]
                    if h and img.shape[:2] != (h, w):
                        img = _resize_image(img, h, w)
                    return img
        elif stype in ("sensor.camera.semantic_segmentation",
                       "sensor.camera.depth"):
            kind = "semantic" if stype.endswith("segmentation") else "depth"
            if can_render:
                data = (lambda s=spec, k=kind: sim.render_camera(s, k))
            else:
                h, w = spec.get("height", 160), spec.get("width", 320)
                data = (lambda h=h, w=w, k=kind: np.zeros(
                    (h, w, 1 if k == "semantic" else 3), np.uint8))
        elif stype == "sensor.lidar.ray_cast":
            data = (lambda f=frame: f["lidar"])
        elif stype == "sensor.other.gnss":
            data, lazy = frame["gps"], False
        elif stype == "sensor.other.imu":
            data, lazy = frame["imu"], False
        elif stype == "sensor.speedometer":
            data, lazy = frame["speed"], False
        elif stype == "sensor.opendrive_map":
            continue
        else:
            continue
        if lazy:
            # The thunks close over the LIVE sim: a deferred read after
            # sim.tick() would silently return sensor data rendered from
            # advanced sim state. Fail loudly instead (the lazy contract
            # is same-tick evaluation; see the docstring above).
            def data(fn=data, fed=sim.frame, tag=tag):
                cur = sim.frame
                if cur != fed:
                    raise RuntimeError(
                        f"lazy sensor '{tag}' evaluated at sim frame "
                        f"{cur} but was fed at frame {fed}: sensor "
                        "payloads must be read the same tick they were "
                        "queued")
                return fn()
        agent.sensor_interface.update_sensor(tag, data, sim.frame, lazy=lazy)


@dataclass
class EvaluatorArgs:
    routes: str
    scenarios: Optional[str] = None
    agent_factory: Optional[Callable[[RouteConfig], AutonomousAgent]] = None
    checkpoint: str = "results.json"
    resume: bool = False
    repetitions: int = 1
    timeout: float = 60.0
    fps: int = 20
    # None = per-route budget 0.8 s/m + 5 s (route_scenario_local.py:52-53);
    # a number forces a flat cap (tests).
    max_game_seconds: Optional[float] = None
    background_vehicles: int = 0
    # "grid", "grid:<blocks>", "grid:<blocks>x<block_size>", or
    # "grid:<blocks>x<block_size>x<lanes_per_dir>": procedural road
    # network (sim/town_map.py) enabling moving traffic + map-true
    # criteria; None keeps the map-less legacy backend.
    town_map: Optional[str] = None
    datagen: bool = False
    # print the per-route ANSI criteria table (result_writer.py:19-116)
    print_route_table: bool = True
    # comma-separated route ids/names to run (None = all)
    route_subset: Optional[str] = None


def build_town_map(spec: Optional[str]):
    """Resolve an EvaluatorArgs.town_map spec string to a TownMap."""
    if not spec:
        return None
    from ..sim.town_map import grid_town
    if spec.startswith("grid"):
        blocks, block_size, lanes_per_dir = 2, 80.0, 1
        rest = spec[4:].lstrip(":")
        if rest:
            parts = rest.split("x")
            blocks = int(parts[0])
            if len(parts) > 1:
                block_size = float(parts[1])
            if len(parts) > 2:
                lanes_per_dir = int(parts[2])
        # lights at interior intersections, stop signs at edge midpoints
        interior = [(i, j) for i in range(1, blocks)
                    for j in range(1, blocks)]
        edge = [(i, 0) for i in range(1, blocks)] + \
               [(0, j) for j in range(1, blocks)]
        return grid_town(blocks=blocks, block_size=block_size,
                         lights_at=interior or [(0, 0)], stops_at=edge,
                         lanes_per_dir=lanes_per_dir)
    raise ValueError(f"unknown town map spec: {spec!r}")


class Evaluator:
    def __init__(self, args: EvaluatorArgs):
        self.args = args
        self.statistics = StatisticsEngine()
        self.indexer = RouteIndexer(args.routes, args.scenarios,
                                    args.repetitions,
                                    route_subset=args.route_subset)
        if args.resume:
            self.indexer.resume(args.checkpoint)
            self.statistics.resume(args.checkpoint)

    def run(self) -> Dict:
        args = self.args
        crashed = False
        while self.indexer.peek() and not crashed:
            config = self.indexer.next()
            crashed = self._run_route(config)
            self.indexer.save_state(args.checkpoint)
        if not crashed:
            global_record = self.statistics.compute_global_statistics(
                self.indexer.total)
            self.statistics.save_global_record(
                global_record, [], self.indexer.total, args.checkpoint)
            return global_record.to_dict()
        return {"status": "crashed"}

    def _run_route(self, config: RouteConfig) -> bool:
        """Returns True on a fatal (simulation-level) crash."""
        args = self.args
        self.statistics.set_route(config.route_id, config.index)
        agent = None
        try:
            scenario = RouteScenario(
                config, fps=args.fps,
                background_vehicles=args.background_vehicles,
                town_map=build_town_map(args.town_map),
                datagen=args.datagen)
            agent = args.agent_factory(config)
            if hasattr(agent, "sim"):
                # privileged agents (expert/datagen) get world access
                agent.sim = scenario.sim
            for spec in agent.sensors():
                agent.sensor_interface.register_sensor(
                    spec["id"], spec["type"])
            route_budget = (args.max_game_seconds
                            if args.max_game_seconds is not None
                            else scenario.timeout)
            manager = ScenarioManager(
                timeout=args.timeout,
                max_game_seconds=route_budget)
            manager.load_scenario(scenario, agent, default_sensor_feeder)
            start_system = time.time()
            manager.run_scenario()
            # collect_events() runs the criteria finalize() pass
            # (route-completion %, outside-lanes infraction) — it must
            # precede the table so the printout matches the JSON record.
            events = scenario.collect_events()
            if self.args.print_route_table:
                from .result_writer import ResultOutputProvider
                failed = any(c.test_status == "FAILURE"
                             for c in scenario.criteria)
                ResultOutputProvider(
                    f"RouteScenario_{config.route_id}",
                    "FAILURE" if failed else "SUCCESS",
                    manager.duration_system, manager.duration_game,
                    scenario.criteria,
                    timeout=route_budget,
                    start_system_time=start_system,
                    repetition=getattr(config, "repetition_index", 0))
            record = self.statistics.compute_route_statistics(
                config.index, events,
                config.trajectory, manager.duration_system,
                manager.duration_game, timed_out=manager.timed_out)
            self.statistics.save_record(record, config.index,
                                        args.checkpoint)
            return False
        except AgentError:
            traceback.print_exc()
            record = self.statistics.compute_route_statistics(
                config.index, [], config.trajectory,
                failure="Agent crashed")
            self.statistics.save_record(record, config.index,
                                        args.checkpoint)
            return False
        except Exception:
            traceback.print_exc()
            record = self.statistics.compute_route_statistics(
                config.index, [], config.trajectory,
                failure="Simulation crashed")
            self.statistics.save_record(record, config.index,
                                        args.checkpoint)
            self.statistics.save_entry_status("Crashed", False,
                                              args.checkpoint)
            return True
        finally:
            if agent is not None:
                try:
                    agent.destroy()
                except Exception:
                    pass
