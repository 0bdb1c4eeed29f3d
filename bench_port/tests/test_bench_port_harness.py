"""The harness on the CPU: what it imports, how it finds its files, and
that it refuses to run without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_port import harness

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _py_files(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in ("transfuser_torch", "transfuser_torch.ops", "jaxtyping",
                 "flaxen", "transfuser_tpux"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "transfuser_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert harness.forbidden_modules() == ["jaxlib", "transfuser_tpu"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _py_files(PKG):
        for mod in _imports(path):
            top = mod.split(".", 1)[0]
            assert top not in harness.FORBIDDEN, (path, mod)
            assert top != "bench", (path, mod)  # the old root bench.py


def test_the_reference_imports_nothing_of_the_port():
    for path in _py_files(os.path.join(PKG, "reference")):
        for mod in _imports(path):
            assert mod.split(".", 1)[0] not in (
                "transfuser_torch", "bench_port"), (path, mod)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, torch; sys.path.insert(0, 'bench_port/tests');"
        "torch.set_num_threads(2);"
        "from tiny import tiny_run; from bench_port import harness;"
        "r = tiny_run('transfuser.frame', seconds=0.5,"
        " sample_compute_frames=2, warmup_frames=2);"
        "harness.drive(r);"
        "r = tiny_run('transfuser-pillars.train', seconds=0.3);"
        "harness.drive(r);"
        "print('FORBIDDEN', harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload",
         "transfuser.frame", "--seed", "2147483700", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload",
         "transfuser.train", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a cell's limits and a per-layer metric added
    as files and entries only: the harness finds each by its name."""
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    shutil.copytree(PKG, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = tmp_path / "bench_port"
    cfg = json.load(open(os.path.join(PKG, "configs", "transfuser.json")))
    cfg["config"]["model"]["gpt"]["n_head"] = 8
    json.dump(cfg, open(new / "configs" / "transfuser-h8.json", "w"))
    mix = json.load(open(os.path.join(PKG, "traffic", "frame.json")))
    mix["members"] = 3
    json.dump(mix, open(new / "traffic" / "frame.ensemble3.json", "w"))
    json.dump({"wp_gap_m": {"limit": 1.0}},
              open(new / "limits" / "transfuser-h8.frame.ensemble3.json",
                   "w"))
    (new / "metrics" / "probe.count.frame.py").write_text(
        "def read(run):\n    return 7.0\n")
    spec["configs"].append(dict(spec["configs"][0], name="transfuser-h8",
                                file="bench_port/configs/transfuser-h8.json"))
    spec["workloads"].append(dict(
        spec["workloads"][0], name="transfuser-h8.frame.ensemble3",
        config="transfuser-h8", traffic="frame.ensemble3"))
    spec["per_layer"].append(dict(
        spec["per_layer"][0], name="probe.count.frame",
        workloads=["transfuser-h8.frame.ensemble3"]))
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    code = (
        "import time; from bench_port import harness as h;"
        "r = h.prepare('transfuser-h8.frame.ensemble3', 1, 1.0, True,"
        " time.perf_counter());"
        "print(r.config['config']['model']['gpt']['n_head'],"
        " r.mix['members'], r.limits['wp_gap_m']['limit'],"
        " [m['name'] for m in h.metrics_of(r, 'per_layer')],"
        " h.load_module('metrics', 'probe.count.frame').read(r),"
        " h.load_module('drivers', r.mix['driver']).__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [
        "8", "3", "1.0", "['probe.count.frame']", "7.0", "bench_port.drivers.frame"]


def test_benchmark_json_names_files_that_exist():
    spec = harness.spec()
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in spec["workloads"]:
        assert os.path.isfile(os.path.join(PKG, "traffic",
                                           f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(PKG, "limits",
                                           f"{w['name']}.json"))
    for m in spec["per_layer"]:
        assert os.path.isfile(os.path.join(PKG, "metrics",
                                           f"{m['name']}.py"))


@pytest.mark.parametrize("name", ["transfuser", "transfuser-pillars"])
def test_config_file_loads_in_the_port(name):
    from transfuser_torch.config import GlobalConfig

    raw = json.load(open(os.path.join(PKG, "configs", f"{name}.json")))
    cfg = GlobalConfig.from_json(json.dumps(raw["config"]))
    assert json.loads(cfg.to_json()) == raw["config"]
