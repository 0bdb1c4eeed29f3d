"""The port's offline tools (transfuser_torch/tools/result_parser.py,
package_submission.py, visualize.py) against the JAX package's: the data
functions on the same results JSON (a committed JAX evaluation), the
town overlay pixel for pixel, the staged submission's layout; and the
renderers that replace the matplotlib figures, which import neither
matplotlib, OpenCV nor torch."""

import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.harness import evaluator as jax_evaluator
from transfuser_tpu.tools import package_submission as jax_package
from transfuser_tpu.tools import result_parser as jax_parser
from transfuser_tpu.tools import visualize as jax_visualize
from transfuser_torch.data import png
from transfuser_torch.harness import evaluator as port_evaluator
from transfuser_torch.tools import package_submission, result_parser
from transfuser_torch.tools import visualize

REPO = Path(__file__).resolve().parent.parent
RESULTS = [str(REPO / "results" / name) for name in (
    "trained_longest6_hermetic.json", "autopilot_longest6_hermetic.json")]


@pytest.fixture(scope="module")
def results():
    ours = result_parser.load_results(RESULTS)
    assert ours == jax_parser.load_results(RESULTS)
    return ours


def test_result_parser_data_functions_match_jax(results, tmp_path):
    rows = result_parser.per_route_rows(results)
    assert len(rows) == 54
    assert rows == jax_parser.per_route_rows(results)
    assert result_parser.aggregate(results) == jax_parser.aggregate(results)
    locations = result_parser.infraction_locations(results)
    assert locations and locations == jax_parser.infraction_locations(results)
    for msg in ("at (x=281.166, y=-5.250, z=0.000)", "at (x=-3, y=4.5)",
                "Agent ran a stop sign map_stop_6"):
        assert result_parser.extract_infraction_coords(msg) == \
            jax_parser.extract_infraction_coords(msg)
    result_parser.write_csv(rows, str(tmp_path / "ours.csv"))
    jax_parser.write_csv(rows, str(tmp_path / "ref.csv"))
    assert (tmp_path / "ours.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()
    for town in result_parser.TOWN_SCALE:
        for loc in locations[:10]:
            xy = (loc["x"], loc["y"])
            assert result_parser.world_to_pixel(xy, town) == \
                jax_parser.world_to_pixel(xy, town)
    ids = np.arange(-2, 10).reshape(3, 4)
    np.testing.assert_array_equal(visualize.semantic_to_rgb(ids),
                                  jax_visualize.semantic_to_rgb(ids))


def test_town_overlays_equal_jax(results, tmp_path):
    locations = result_parser.infraction_locations(results)
    ours, ref = tmp_path / "ours.png", tmp_path / "ref.png"
    # on a hermetic grid town
    town = "grid:4x80"
    img, _, _ = result_parser.render_town_base_image(
        port_evaluator.build_town_map(town))
    want, _, _ = jax_parser.render_town_base_image(
        jax_evaluator.build_town_map(town))
    np.testing.assert_array_equal(img, want)
    result_parser.render_town_overlay(
        locations, "Town01", str(ours),
        town_map=port_evaluator.build_town_map(town))
    jax_parser.render_town_overlay(
        locations, "Town01", str(ref),
        town_map=jax_evaluator.build_town_map(town))
    got = png.read(str(ours))
    np.testing.assert_array_equal(
        got, cv2.cvtColor(cv2.imread(str(ref)), cv2.COLOR_BGR2RGB))
    assert (got != want).any()  # some crosses landed on the map
    # on a calibrated town image
    base = tmp_path / "Town01.png"
    cv2.imwrite(str(base), np.random.default_rng(0).integers(
        0, 256, (700, 800, 3), dtype=np.uint8))
    result_parser.render_town_overlay(locations, "Town01", str(ours),
                                      town_img_path=str(base))
    jax_parser.render_town_overlay(locations, "Town01", str(ref),
                                   town_img_path=str(base))
    np.testing.assert_array_equal(
        png.read(str(ours)),
        cv2.cvtColor(cv2.imread(str(ref)), cv2.COLOR_BGR2RGB))


def test_renderers_draw_without_matplotlib(results, tmp_path):
    locations = result_parser.infraction_locations(results)
    out = str(tmp_path / "map.png")
    result_parser.render_infraction_map(locations, out)
    img = png.read(out)
    xs = [loc["x"] for loc in locations]
    assert img.shape[1] == int((max(xs) - min(xs) + 20) * 2) + 1
    red = np.all(img == result_parser.INFRACTION_COLORS["route_dev"], -1)
    assert red.any()

    rng = np.random.default_rng(1)
    lidar = rng.uniform(0, 1, (256, 256, 2))
    wp = np.array([[2.0, 0.0], [4.0, 0.5], [6.0, 1.0], [8.0, 1.5]])
    path = visualize.render_model_io(
        str(tmp_path / "io"), 7, rng.uniform(0, 255, (160, 704, 3)), lidar,
        np.array([20.0, 2.0]), wp, pred_semantic=rng.uniform(
            0, 1, (160, 704, 7)), pred_depth=rng.uniform(0, 1, (160, 704)),
        boxes=np.array([[128.0, 100.0, 6.0, 12.0, 0.3]]), gt_wp=wp + 0.5)
    assert path.endswith("00007.png")
    panel = png.read(path)
    # rows: camera | BEV, depth | semantics, 8 px apart
    assert panel.shape == (256 + 8 + 160, 704 + 8 + 704, 3)
    bev = panel[:256, 712:968]
    for color in ((255, 0, 0), (0, 160, 0), (0, 0, 255), (255, 255, 0)):
        assert np.all(bev == color, -1).any(), color

    routes = tmp_path / "routes.xml"
    routes.write_text("""<?xml version='1.0' encoding='UTF-8'?>
<routes><route id="0" town="Town01">
  <waypoint x="0.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
  <waypoint x="80.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
</route><route id="1" town="Town01">
  <waypoint x="80.0" y="0.0" z="0.0" pitch="0" roll="0" yaw="0"/>
  <waypoint x="80.0" y="80.0" z="0.0" pitch="0" roll="0" yaw="0"/>
</route></routes>""")
    scenarios = tmp_path / "scenarios.json"
    scenarios.write_text(json.dumps({"available_scenarios": [{"Town01": [{
        "scenario_type": "Scenario3", "available_event_configurations": [
            {"transform": {"x": 40.0, "y": 0.0, "z": 0.0, "yaw": 0.0,
                           "pitch": 0.0}}]}]}]}))
    out = visualize.render_routes_map(
        str(routes), str(scenarios), str(tmp_path / "routes.png"),
        town_map=port_evaluator.build_town_map("grid:2x80"))
    img = png.read(out)
    for color in visualize.TAB10[:2] + [(0, 0, 0), (204, 204, 204)]:
        assert np.all(img == color, -1).any(), color

    code = ("import sys; import transfuser_torch.tools.result_parser, "
            "transfuser_torch.tools.visualize, "
            "transfuser_torch.tools.package_submission; "
            "print(sorted({'matplotlib', 'cv2', 'torch', 'jax'} & "
            "set(sys.modules)))")
    done = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, check=True)
    assert done.stdout.strip() == "[]"


def _layout(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if "__pycache__" not in p.parts)


def test_package_submission_stages_the_port_as_jax_stages_itself(tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "config.json").write_text("{}")
    (ckpt / "model_0.msgpack").write_bytes(b"\x00" * 16)
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    package_submission.stage(str(REPO), str(ckpt), str(ours))
    jax_package.stage(str(REPO), str(ckpt), str(ref))
    top = sorted(os.listdir(ours))
    assert top == sorted(p.replace("transfuser_tpu", "transfuser_torch")
                         for p in os.listdir(ref))
    assert _layout(ours / "model_ckpt") == _layout(ref / "model_ckpt")
    assert _layout(ours / "transfuser_torch") == [
        p for p in _layout(REPO / "transfuser_torch")
        if not p.startswith("_build") and not p.endswith((".so", ".o"))]
    assert os.access(ours / "run_docker.sh", os.X_OK)
    dockerfile = (ours / "Dockerfile").read_text()
    assert "transfuser_torch.harness.cli" in dockerfile
    assert "torch" in dockerfile and "jax" not in dockerfile
    assert "--gpus all" in (ours / "run_docker.sh").read_text()
    for env in ("TEAM_AGENT", "TEAM_CONFIG", "CHALLENGE_TRACK_CODENAME",
                "ROUTES", "SCENARIOS", "REPETITIONS", "CHECKPOINT_ENDPOINT",
                "RESUME"):
        assert f"ENV {env} " in dockerfile
