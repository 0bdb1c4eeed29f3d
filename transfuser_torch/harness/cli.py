"""Evaluation + data-generation CLIs (counterpart of
transfuser_tpu/harness/cli.py).

Replaces the reference driver scripts (leaderboard/scripts/
local_evaluation.sh, datagen.sh and leaderboard_evaluator_local.py:421-476):
the same env vars are honored (ROUTES, SCENARIOS, CHECKPOINT_ENDPOINT,
TEAM_CONFIG, SAVE_PATH, RESUME, REPETITIONS, TOWN_MAP) with argparse
overrides on top.

    python -m transfuser_torch.harness.cli evaluate --routes longest6.xml \
        --agent hybrid --agent-config log/transfuser
    python -m transfuser_torch.harness.cli datagen --routes routes.xml \
        --save-path data/

Every flag of the JAX CLI, with its default, plus ``--device`` (``cuda``
unless the caller asks for ``cpu``). Only the ``hybrid`` agent receives
the device; the expert (``autopilot``), the data agent (``data``), ``npc``
and ``dummy`` are numpy-only and never touch CUDA. ``--device cuda`` with
the hybrid agent and no CUDA device exits with an error rather than
running on the CPU. ``datagen`` runs the evaluator with the datagen sensor
profile (no LiDAR dropoff, the extra cameras allowed) and the data agent
writing ``SAVE_PATH/route<i>``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional


def _agent_factory(kind: str, conf: str, device: str):
    def factory(route_config):
        if kind == "hybrid":
            from ..agents.hybrid_agent import HybridAgent
            return HybridAgent(conf, route_index=route_config.index,
                               device=device)
        if kind == "autopilot":
            from ..agents.autopilot import AutoPilot
            return AutoPilot(conf, route_index=route_config.index)
        if kind == "data":
            from ..agents.data_agent import DataAgent
            return DataAgent(conf, route_index=route_config.index)
        if kind == "npc":
            from ..agents.demo_agents import NpcAgent
            return NpcAgent(conf)
        if kind == "dummy":
            from ..agents.demo_agents import DummyAgent
            return DummyAgent(conf)
        raise ValueError(f"unknown agent kind: {kind}")
    return factory


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="transfuser_torch.harness.cli")
    sub = p.add_subparsers(dest="command", required=True)

    for name in ("evaluate", "datagen"):
        sp = sub.add_parser(name)
        sp.add_argument("--routes", default=os.environ.get("ROUTES"))
        sp.add_argument("--scenarios", default=os.environ.get("SCENARIOS"))
        sp.add_argument("--checkpoint",
                        default=os.environ.get("CHECKPOINT_ENDPOINT",
                                               "results.json"))
        sp.add_argument("--agent",
                        default="data" if name == "datagen" else "hybrid",
                        choices=["hybrid", "autopilot", "data", "npc",
                                 "dummy"])
        sp.add_argument("--agent-config",
                        default=os.environ.get("TEAM_CONFIG", ""))
        sp.add_argument("--resume", action="store_true",
                        default=bool(int(os.environ.get("RESUME", "0"))))
        sp.add_argument("--repetitions",
                        default=int(os.environ.get("REPETITIONS", "1")),
                        type=int)
        sp.add_argument("--timeout", default=60.0, type=float)
        sp.add_argument("--max-game-seconds", default=None, type=float,
                        help="flat per-route cap; default scales "
                             "0.8 s/m + 5 s with route length "
                             "(route_scenario_local.py:52-53)")
        sp.add_argument("--background-vehicles", default=0, type=int)
        sp.add_argument("--town-map", default=os.environ.get("TOWN_MAP"),
                        help="procedural road network, e.g. 'grid', "
                             "'grid:3', 'grid:3x100' (moving traffic + "
                             "map-true criteria); default: map-less")
        sp.add_argument("--save-path",
                        default=os.environ.get("SAVE_PATH"))
        sp.add_argument("--device", default="cuda",
                        help="torch device of the hybrid agent: 'cuda' "
                             "(default) or 'cpu'; other agents use none")
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.routes:
        print("--routes (or env ROUTES) is required", file=sys.stderr)
        return 2
    if args.agent == "hybrid":
        import torch
        if torch.device(args.device).type == "cuda" and \
                not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device here; pass "
                             "--device cpu to drive on the CPU")
    if args.command == "datagen" and args.save_path:
        os.environ["SAVE_PATH"] = args.save_path

    from .evaluator import Evaluator, EvaluatorArgs
    ev = Evaluator(EvaluatorArgs(
        routes=args.routes, scenarios=args.scenarios,
        agent_factory=_agent_factory(args.agent, args.agent_config,
                                     args.device),
        checkpoint=args.checkpoint, resume=args.resume,
        repetitions=args.repetitions, timeout=args.timeout,
        max_game_seconds=args.max_game_seconds,
        background_vehicles=args.background_vehicles,
        town_map=args.town_map,
        datagen=(args.command == "datagen")))
    result = ev.run()
    print(json.dumps(result.get("scores", result), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
