"""The port's HybridAgent vs the JAX package's, on the same reference-style
``.pth`` and config snapshot, fed the same synthetic sensor frames; and a
scan that keeps JAX out of the port."""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_full_import import _parity_config
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.agents.hybrid_agent import HybridAgent as JaxAgent
from transfuser_tpu.models.lidar_centernet import LidarCenterNet as JaxModel
from transfuser_tpu.train.checkpoint import (save_config_snapshot,
                                             save_inference_weights)
from transfuser_torch.agents.hybrid_agent import HybridAgent
from transfuser_torch.models import LidarCenterNet
from transfuser_torch.train import checkpoint
from transfuser_torch.train.jax_import import (state_dict_from_jax,
                                               variables_from_state_dict)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "transfuser_tpu",
             "msgpack", "cv2", "PIL")

# Both agents compute the model in bf16 (the JAX agent always does,
# hybrid_agent.py:163), rounding at different places: waypoints (metres)
# agree to a few centimetres on these random weights.
WP_ATOL, WP_RTOL = 5e-2, 5e-2


def _model_dir(tmp_path):
    cfg = _parity_config()
    rng = np.random.default_rng(0)
    jm = JaxModel(cfg, dtype=jnp.float32)
    x = [jnp.asarray(a) for a in (
        rng.uniform(0, 255, (1, 64, 128, 3)), rng.uniform(0, 1, (1, 64, 64, 2)),
        rng.uniform(-20, 20, (1, 2)), np.zeros((1, 64, 64, 1)),
        rng.uniform(0, 10, (1,)))]
    variables = jax.device_get(jax.jit(
        lambda key: jm.init(key, *x, train=False))(jax.random.PRNGKey(1)))
    variables = {k: dict(v) for k, v in variables.items()}
    state = state_dict_from_jax(variables, cfg)
    model_dir = str(tmp_path / "model")
    save_config_snapshot(model_dir, cfg)
    torch.save({f"module.{k}": v for k, v in state.items()},
               os.path.join(model_dir, "model_0.pth"))
    return cfg, model_dir


def _plan():
    # straight road north of the start, as GPS fixes (route_planner scale)
    pts = [(float(x), 0.0) for x in range(0, 120, 10)]
    gps = [({"lat": x / 111324.60662786, "lon": y / 111319.490945}, 4)
           for x, y in pts]
    return gps, pts


def _frames(cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    h = cfg.sensors.img_resolution[0]
    w = cfg.sensors.img_width
    for i in range(n):
        pts = np.concatenate([
            rng.uniform(-20, 20, (3000, 2)), rng.uniform(-4, 0, (3000, 1)),
            rng.uniform(0, 1, (3000, 1))], axis=1).astype(np.float32)
        x = 0.4 * i
        yield {
            "rgb_front": (i, rng.integers(0, 256, (h, w, 4), np.uint8)),
            "rgb_left": (i, rng.integers(0, 256, (h, w, 4), np.uint8)),
            "rgb_right": (i, rng.integers(0, 256, (h, w, 4), np.uint8)),
            "gps": (i, np.array([x / 111324.60662786, 0.3 / 111319.490945,
                                 0.0])),
            "speed": (i, {"speed": 2.0 + 0.1 * i}),
            "imu": (i, np.array([0, 0, 9.8, 0, 0, 0, 0.05 * i])),
            "lidar": (i, pts),
        }


def test_port_agent_matches_jax_agent(tmp_path):
    cfg, model_dir = _model_dir(tmp_path)
    ours = HybridAgent(model_dir, device="cpu")
    ref = JaxAgent(model_dir)
    assert ours.model_count == ref.model_count == 1
    assert ours.config.model.gpt.reference_view_unpack
    _drive_both(cfg, ours, ref)


def _drive_both(cfg, ours, ref):
    plan, world = _plan()
    for agent in (ours, ref):
        agent.set_global_plan(plan, world)
    compared = 0
    for i, frame in enumerate(_frames(cfg, 6)):
        c_ours = ours.run_step(frame, 0.05 * i)
        c_ref = ref.run_step(frame, 0.05 * i)
        for c in (c_ours, c_ref):
            assert np.isfinite([c.steer, c.throttle, c.brake]).all()
        if i % 2:
            continue  # action-repeat frame: both reuse their last control
        np.testing.assert_allclose(ours.pred_wp, ref.pred_wp, rtol=WP_RTOL,
                                   atol=WP_ATOL, err_msg=f"frame {i}")
        if c_ours.brake == c_ref.brake:
            np.testing.assert_allclose(
                [c_ours.steer, c_ours.throttle],
                [c_ref.steer, c_ref.throttle], atol=WP_ATOL,
                err_msg=f"frame {i}")
            compared += 1
    assert compared >= 1


def _native_config():
    import dataclasses

    cfg = _parity_config()
    gpt = dataclasses.replace(cfg.model.gpt, reference_view_unpack=False)
    return cfg.replace(model=dataclasses.replace(cfg.model, gpt=gpt))


def _native_member_dir(tmp_path, write):
    """A model dir with natively trained weights (a port model at seeded
    init) written by ``write`` (either package's save_inference_weights)."""
    cfg = _native_config()
    model_dir = str(tmp_path / "model")
    save_config_snapshot(model_dir, cfg)
    tm = LidarCenterNet(cfg, dtype=torch.float32, device="cpu", seed=2)
    write(os.path.join(model_dir, "model_3.msgpack"),
          variables_from_state_dict(tm.state_dict(), cfg))
    return cfg, model_dir, tm


def test_agent_loads_a_jax_written_member(tmp_path):
    """A model_*.msgpack written by the JAX package loads bit for bit, and
    the reference view-unpack quirk stays off for it."""
    _, model_dir, tm = _native_member_dir(tmp_path, save_inference_weights)
    ours = HybridAgent(model_dir, device="cpu")
    assert ours.model_count == 1
    assert not ours.config.model.gpt.reference_view_unpack
    got = ours.members[0].state_dict()
    for k, v in tm.state_dict().items():
        assert torch.equal(got[k], v), k


def test_jax_agent_drives_like_the_port_on_a_port_export(tmp_path):
    """The JAX agent loads a member the port wrote, and both agents drive
    alike on it."""
    cfg, model_dir, _ = _native_member_dir(
        tmp_path, checkpoint.save_inference_weights)
    ours = HybridAgent(model_dir, device="cpu")
    ref = JaxAgent(model_dir)
    assert ours.model_count == ref.model_count == 1
    assert not ours.config.model.gpt.reference_view_unpack
    assert not ref.config.model.gpt.reference_view_unpack
    _drive_both(cfg, ours, ref)


def test_agent_refuses_what_is_not_ported(tmp_path):
    import dataclasses

    cfg = _native_config()
    model_dir = str(tmp_path / "model")
    save_config_snapshot(model_dir, cfg)
    tm = LidarCenterNet(cfg, device="cpu")
    torch.save(tm.state_dict(), os.path.join(model_dir, "model_0.pth"))
    checkpoint.save_inference_weights(
        os.path.join(model_dir, "model_1.msgpack"),
        variables_from_state_dict(tm.state_dict(), cfg))
    # a reference .pth needs the view-unpack quirk, a native member must
    # not have it: one ensemble cannot hold both (the JAX agent's rule)
    with pytest.raises(ValueError, match="mixes reference .pth"):
        HybridAgent(model_dir, device="cpu")
    os.remove(os.path.join(model_dir, "model_1.msgpack"))
    # a config snapshot with a lag mode on is accepted (the JAX package's
    # trained evaluations turn async_inference on); the worker starts at
    # the first compute frame and destroy() closes it
    ctrl = dataclasses.replace(cfg.controller, async_inference=True)
    save_config_snapshot(model_dir, cfg.replace(controller=ctrl))
    agent = HybridAgent(model_dir, device="cpu")
    assert agent.config.controller.async_inference
    assert agent._worker is None
    agent.destroy()
    assert agent._worker is None


def _port_files():
    return sorted((REPO / "transfuser_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call) and
              getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args and
              isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"
