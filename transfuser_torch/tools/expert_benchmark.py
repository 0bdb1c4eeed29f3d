"""(Copy of transfuser_tpu/tools/expert_benchmark.py without the device
pin: the expert is numpy-only and never takes a device, and a caller that
passes ``agent_factory`` chooses its agent's device itself.)

Hermetic expert benchmark — the repo's `autopilot_longest6` artifact.

The reference ships the privileged expert's Longest6 closed-loop result
(`results/autopilot_longest6.json`, driving score 74.487 over 36 routes
with dense traffic; labels at statistics_manager_local.py:278-290).
This produces the equivalent scored artifact for the hermetic backend:
routes generated from the multi-lane grid town's topology (junction
crossings + lane changes + straights), signalized intersections, moving
background traffic and scenario triggers, driven by the AutoPilot and
scored by the same statistics engine / JSON schema.

CLI:  python -m transfuser_torch.tools.expert_benchmark \
          --out results/autopilot_hermetic_torch.json [--routes 12]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import xml.etree.ElementTree as ET
from typing import Optional


def _write_benchmark_routes(graph, path: str, n_routes: int) -> int:
    """Route XML mixing junction crossings, lane changes and straights —
    categories are interleaved round-robin so truncation to n_routes
    keeps the mix instead of dropping whole categories."""
    from .route_gen import (junction_routes, lane_change_routes,
                            routes_to_xml, topology_walks)
    lc = lane_change_routes(graph)
    pools = [junction_routes(graph, turn="straight")[:: 7],
             junction_routes(graph, turn="left")[:: 7],
             junction_routes(graph, turn="right")[:: 7],
             lc["lr"][:: 9] + lc["rl"][:: 9],
             topology_walks(graph)[:: 5]]
    pool = []
    i = 0
    while any(pools) and len(pool) < n_routes * 2:
        if pools[i % len(pools)]:
            pool.append(pools[i % len(pools)].pop(0))
        i += 1
    pool = [r[:: 5] + [r[-1]] if len(r) > 3 else r for r in pool]
    routes = [r for r in pool if len(r) >= 2][:n_routes]
    routes_to_xml(routes, graph.name, path)
    return len(routes)


def _write_longest6_routes(graph, path: str, n_routes: int,
                           target_len: float, seed: int) -> tuple:
    """Longest6-shaped route XML: long multi-junction random walks
    (~`target_len` m each; leaderboard/data/longest6 = 36 routes at
    ~1.5 km average under max-density traffic)."""
    from .route_gen import long_routes, routes_to_xml
    routes = long_routes(graph, n=n_routes, target_len=target_len,
                         seed=seed)
    routes_to_xml(routes, graph.name, path)
    import math
    lengths = [sum(math.hypot(b[0] - a[0], b[1] - a[1])
                   for a, b in zip(r, r[1:])) for r in routes]
    return len(routes), (sum(lengths) / max(len(lengths), 1))


def _write_benchmark_scenarios(graph, path: str,
                               stride: int = 4) -> int:
    """Scenario JSON combining trigger types along the routes (deduped
    like route_gen.generate_scenarios). `stride` subsamples the trigger
    pool; 1 = every candidate (Longest6-style saturation)."""
    from .route_gen import _scenario_triggers
    by_type = {}
    total = 0
    for stype in ("Scenario1", "Scenario3", "Scenario4",
                  "Scenario7", "Scenario8", "Scenario9"):
        triggers = sorted({(round(x, 1), round(y, 1), round(yaw, 0))
                           for x, y, yaw in
                           _scenario_triggers(graph, stype)[:: stride]})
        by_type[stype] = [{"transform": {"x": x, "y": y, "z": 0.0,
                                         "yaw": yaw, "pitch": 0.0},
                           "other_actors": {}}
                          for x, y, yaw in triggers]
        total += len(triggers)
    data = {"available_scenarios": [{graph.name: [
        {"available_event_configurations": evs, "scenario_type": st}
        for st, evs in by_type.items()]}]}
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    return total


def run_expert_benchmark(out_json: str, n_routes: int = 12,
                         town_spec: str = "grid:2x80x2",
                         background_vehicles: int = 20,
                         max_game_seconds: Optional[float] = None,
                         workdir: Optional[str] = None,
                         print_route_table: bool = False,
                         longest6: bool = False,
                         target_len: float = 1200.0,
                         agent_factory=None,
                         resume: bool = False,
                         route_subset: Optional[str] = None) -> dict:
    from ..agents.autopilot import AutoPilot
    from .route_gen import TownGraph
    from ..harness.evaluator import (Evaluator, EvaluatorArgs,
                                     build_town_map)

    workdir = workdir or tempfile.mkdtemp(prefix="expert_bench_")
    town = build_town_map(town_spec)
    graph = TownGraph.from_town_map(town)
    routes_xml = os.path.join(workdir, "routes.xml")
    scen_json = os.path.join(workdir, "scenarios.json")
    mean_len = None
    if longest6:
        n, mean_len = _write_longest6_routes(graph, routes_xml, n_routes,
                                             target_len, seed=1)
        _write_benchmark_scenarios(graph, scen_json, stride=1)
    else:
        n = _write_benchmark_routes(graph, routes_xml, n_routes)
        _write_benchmark_scenarios(graph, scen_json)

    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    result = Evaluator(EvaluatorArgs(
        routes=routes_xml, scenarios=scen_json,
        agent_factory=agent_factory or (lambda cfg: AutoPilot()),
        checkpoint=out_json,
        town_map=town_spec,
        background_vehicles=background_vehicles,
        max_game_seconds=max_game_seconds,
        resume=resume,
        route_subset=route_subset,
        print_route_table=print_route_table)).run()
    scores = result.get("scores", result)
    scores["n_routes"] = n
    if mean_len is not None:
        scores["mean_route_length_m"] = round(mean_len, 1)
    scores["background_vehicles"] = background_vehicles
    return scores


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="results/autopilot_hermetic_torch.json",
                   help="results JSON (default: beside the JAX package's "
                        "results/autopilot_hermetic.json, not over it)")
    p.add_argument("--routes", type=int, default=None)
    p.add_argument("--town", default=None)
    p.add_argument("--background", type=int, default=None)
    p.add_argument("--longest6", action="store_true",
                   help="Longest6-shaped benchmark: 36 long multi-junction "
                        "routes (~1.2 km), max-density traffic, scenario "
                        "triggers saturated (leaderboard/data/longest6)")
    p.add_argument("--target-len", type=float, default=1200.0)
    p.add_argument("--max_game_seconds", type=float, default=None,
                   help="flat cap; default scales 0.8 s/m + 5 s per route")
    p.add_argument("--resume", action="store_true",
                   help="skip routes already completed in --out")
    p.add_argument("--routes-subset", default=None,
                   help="comma-separated route ids/names to run "
                        "(e.g. '8,25,35')")
    p.add_argument("--table", action="store_true",
                   help="print the per-route ANSI criteria tables")
    args = p.parse_args(argv)
    if args.longest6:
        defaults = dict(routes=36, town="grid:4x100x2", background=200)
    else:
        defaults = dict(routes=12, town="grid:2x80x2", background=20)
    scores = run_expert_benchmark(
        args.out,
        n_routes=args.routes if args.routes is not None
        else defaults["routes"],
        town_spec=args.town or defaults["town"],
        background_vehicles=args.background if args.background is not None
        else defaults["background"],
        max_game_seconds=args.max_game_seconds,
        print_route_table=args.table,
        longest6=args.longest6, target_len=args.target_len,
        resume=args.resume, route_subset=args.routes_subset)
    print(json.dumps(scores))


if __name__ == "__main__":
    main()
