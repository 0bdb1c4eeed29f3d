"""What every cell shares: the benchmark's description, the files found by
name (configuration, traffic mix, limits, driver, per-layer readers),
the card checks, the result line.

Layout, all under ``bench_port/``:

* ``configs/<config>.json``: the configuration as run (``config``, the
  port's ``GlobalConfig`` tree), with ``source``, ``reduced`` and
  ``assumed``, and optionally ``reference``;
* ``reference/<name>.py``: the plain fp32 reference model that a
  configuration names by ``"reference": "<name>"`` (``model`` where it
  names none); ``reference/train.py`` and ``reference/agent.py``, the
  training step and the agent's host loop, read only the configuration
  and serve every reference model;
* ``traffic/<mix>.json``: the mix's parameters; its ``driver`` names
  ``drivers/<driver>.py``, which runs the cell;
* ``limits/<workload>.json``: the limit of each number that decides
  ``correct`` (the readings each was set from are in PERF.md);
* ``metrics/<metric>.py``: one per-layer metric each, ``read(run)``
  returning a number or None.

A new configuration, mix, cell or metric is a new file and a new entry in
``BENCHMARK.json``; no existing file changes. A configuration whose
trunks or backbone family ``reference/model.py`` lacks brings them in a
new ``reference/<name>.py``, as ``reference/model.py``'s docstring
says.

The contract of a reference module: ``reference(config)`` imports it
once per run (``Run.ref``), and the drivers, ``flops.py`` and
``weights.py`` call it, none through an import of their own:

* ``namespace(dict)``: the configuration as attributes;
* ``build(cfg, device)``: the model, weights empty (``"meta"`` for
  shapes and FLOPs);
* ``plain_fp32()``: a context with TF32 off;
* ``lowp(mode)``: a context in which the model rounds to ``mode``
  (``"fp8"``: the control of ``correct``); ``reference/train.py`` enters
  ``model.lowp``, so a module's layers round under that one;
* ``_resizing``: a one-element list, above 0 while the model resizes
  (the FLOP count leaves resizes out);
* ``seed_rules(model)``: key -> (kind, value) for the leaves its own
  classes add, merged into ``weights.py``'s rules; every float leaf
  needs one;
* ``TINY_TRUNK``: the trunk of the CPU-size runs of the tests.

``namespace``, ``plain_fp32``, ``lowp`` and ``_resizing`` are
``model.py``'s own, imported from it.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import resource
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "transfuser_tpu")
CONTRACT = ("namespace", "build", "plain_fp32", "lowp", "_resizing",
            "seed_rules", "TINY_TRUNK")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def spec() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_module(kind: str, name: str):
    """``bench_port/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = f"bench_port.{kind}." + name.replace(".", "_").replace("-", "_")
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    sys.modules[mod_name] = mod  # dataclasses look their module up there
    s.loader.exec_module(mod)
    return mod


def reference(config: Dict):
    """The reference module that a configuration file names (its
    ``reference`` key, ``model`` where it has none), imported once: the
    same module object serves the build, the FLOP count and the
    weights."""
    name = config.get("reference", "model")
    if not (isinstance(name, str) and name.isidentifier()):
        raise ValueError(f"reference {name!r} is not a module name")
    mod = importlib.import_module(f"bench_port.reference.{name}")
    missing = [a for a in CONTRACT if not hasattr(mod, a)]
    if missing:
        raise ValueError(f"reference {name!r} lacks {missing}")
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``transfuser_torch`` is not ``transfuser_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Run:
    """One run of one cell: its inputs, and what the driver measured."""
    workload: Dict
    config: Dict                # the configuration file
    mix: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    t_start: float              # perf_counter at process start
    spec: Dict = field(default_factory=dict)
    ref: object = None          # the reference module (``reference``)
    device: object = None
    card: str = ""
    # filled by the driver
    cfg: object = None          # the configuration as attributes
    setup_s: float = math.nan
    e2e: Dict[str, float] = field(default_factory=dict)
    units: int = 0              # compute frames or train steps timed
    window_s: float = math.nan
    host: Dict[str, float] = field(default_factory=dict)
    load: Dict[str, float] = field(default_factory=dict)  # host_load
    traced: object = None       # trace.Trace of the traced units
    flops_per_unit: float = math.nan
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    readings: Dict[str, float] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]

    def correct(self) -> bool:
        return bool(self.checks) and all(
            v <= lim for v, lim in self.checks.values())

    def judge(self, readings: Dict[str, float]) -> None:
        """Hold the numbers that the cell's limits name to their limits; a
        number not read, NaN or infinite fails."""
        self.readings = dict(readings)
        for k, spec in self.limits.items():
            v = float(readings.get(k, math.inf))
            self.checks[k] = (v if math.isfinite(v) else math.inf,
                              float(spec["limit"]))


def prepare(workload: str, seed: int, seconds: float, trace: bool,
            t_start: float) -> Run:
    sp = spec()
    cells = {w["name"]: w for w in sp["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    config = load_json(os.path.join(ROOT, next(
        c["file"] for c in sp["configs"] if c["name"] == w["config"])))
    mix = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "limits", f"{workload}.json"))
    return Run(w, config, mix, limits, seed, seconds, trace, t_start, sp,
               reference(config))


def metrics_of(run: Run, kind: str) -> List[Dict]:
    """The cell's end-to-end or per-layer metrics: those that list it, or
    that list no cells and move (or are) a metric the cell reports."""
    e2e_here = [m["name"] for m in run.spec["end_to_end"]
                if run.name in m.get("workloads", [run.name])]
    out = []
    for m in run.spec[kind]:
        cells = m.get("workloads")
        if cells is not None:
            if run.name in cells:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e_here:
            out.append(m)
    return out


def result(run: Run) -> Dict:
    metrics = {}
    if run.trace:
        for m in metrics_of(run, "per_layer"):
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in metrics_of(run, "end_to_end"):
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.card,
              "count": int(run.workload["chips"]),
              "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": run.correct(), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.traced is not None:
        t = run.traced
        device.update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {"device_ops": t.device_ops(),
                            "idle_gaps": t.idle_gaps()}
    out["host"] = dict(run.load)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def drive(run: Run):
    """One run of the cell as ``run.py`` makes it: the cell's driver sets
    up, times the window and frees the program; its comparison with the
    reference then decides ``correct``. Returns the driver and what the
    window left, for a second comparison (the control's)."""
    driver = load_module("drivers", run.mix["driver"])
    outcome = driver.run(run)
    run.judge(driver.compare(run, outcome))
    log("host in the window: " + json.dumps(run.load))
    return driver, outcome


def _steal_s() -> float:
    """CPU time the hypervisor gave to others, all cores, since boot."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return float(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return math.nan


@contextlib.contextmanager
def host_load(run: Run):
    """The host's side of the timed window, into ``run.load``: the
    process's CPU seconds (all threads) and the main thread's against the
    wall's, its voluntary and involuntary context switches, the CPU time
    stolen from the machine and its load average at the close."""
    def now():
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return (time.perf_counter(), time.process_time(), time.thread_time(),
                ru.ru_nvcsw, ru.ru_nivcsw, _steal_s())
    a = now()
    yield
    b = now()
    run.load = {"wall_s": b[0] - a[0], "cpu_s": b[1] - a[1],
                "main_thread_cpu_s": b[2] - a[2],
                "voluntary_switches": b[3] - a[3],
                "involuntary_switches": b[4] - a[4],
                "steal_s": b[5] - a[5], "loadavg_1m": os.getloadavg()[0],
                "cpus": len(os.sched_getaffinity(0))}


def print_checks(run: Run) -> None:
    for k, (v, lim) in run.checks.items():
        verdict = "ok" if v <= lim else "FAIL"
        print(f"check {k} = {v!r} limit {lim!r} {verdict}", file=sys.stderr,
              flush=True)


def log(msg: str) -> None:
    print(f"[bench_port] {msg}", file=sys.stderr, flush=True)


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout. The port builds
    its CUDA sources into ``transfuser_torch/_build/`` (fixed in its
    code); Triton, which the port does not use, is pointed there too."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "transfuser_torch", "_build",
                                       "triton"))


def member_seed(seed: int, i: int) -> int:
    """The weight seed of ensemble member i of a run seeded ``seed``."""
    import numpy as np

    return int(np.random.SeedSequence([int(seed), i]).generate_state(
        1, np.uint64)[0] >> 1)


def main_device(chips: int):
    """The card, or None where the run may not go on: no CUDA, or fewer
    cards than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        return None, "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return None, (f"{torch.cuda.device_count()} CUDA devices, the cell "
                      f"needs {chips}")
    return torch.device("cuda", 0), ""

