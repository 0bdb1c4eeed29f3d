"""PyTorch port vs the JAX package: the whole transFuser model at a tiny
size, in fp32 on the CPU, with the same weights on both sides.

Weights: JAX init -> ``state_dict_from_jax`` -> the port's
``load_state_dict(strict=True)``. Tolerance rtol 1e-3 / atol 1e-4, the
bound tests/test_full_import.py holds the JAX model to against its torch
replica (summation order differs between XLA:CPU and torch's CPU
kernels).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_full_import import TorchLidarCenterNet, _parity_config
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.models.lidar_centernet import LidarCenterNet as JaxModel
from transfuser_tpu.train.torch_import import (
    _flat_leaves, convert_lidar_centernet_statedict)
from transfuser_torch.models import LidarCenterNet
from transfuser_torch.train.jax_import import (canonical_reference_state,
                                               load_reference_checkpoint,
                                               state_dict_from_jax)

RTOL, ATOL = 1e-3, 1e-4


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    return dict(
        rgb=rng.uniform(0, 255, (2, 64, 128, 3)).astype(np.float32),
        lidar=rng.uniform(0, 1, (2, 64, 64, 2)).astype(np.float32),
        tp=rng.uniform(-20, 20, (2, 2)).astype(np.float32),
        tpi=(rng.uniform(0, 1, (2, 64, 64, 1)) > 0.99).astype(np.float32),
        vel=rng.uniform(0, 10, (2,)).astype(np.float32))


def _randomize_stats(variables, seed=3):
    """Non-identity BatchNorm stats and non-zero pos_emb, so the BN fold and
    the reference view-unpack quirk are exercised."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "mean":
                v = rng.uniform(-0.3, 0.3, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "pos_emb" or (k in ("scale", "bias") and
                                    "BatchNorm_0" in path):
                v = rng.uniform(-0.1, 0.1, v.shape) + (k == "scale")
            out[k] = v.astype(np.float32)
        return out

    return walk(variables)


@pytest.fixture(scope="module")
def models():
    cfg = _parity_config()
    x = _inputs()
    jm = JaxModel(cfg, dtype=jnp.float32)
    variables = jax.jit(lambda key: jm.init(
        key, jnp.asarray(x["rgb"]), jnp.asarray(x["lidar"]),
        jnp.asarray(x["tp"]), jnp.asarray(x["tpi"]), jnp.asarray(x["vel"]),
        train=False))(jax.random.PRNGKey(0))
    variables = _randomize_stats(jax.device_get(
        {k: dict(v) for k, v in variables.items()}))
    tm = LidarCenterNet(cfg, dtype=torch.float32, device="cpu")
    tm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return cfg, jm, variables, tm, x


def _torch_args(x):
    return [torch.from_numpy(x[k]) for k in ("rgb", "lidar", "tp", "tpi",
                                              "vel")]


def test_weight_round_trip_is_exact(models):
    """JAX tree -> port state dict -> the JAX package's converter gives back
    every leaf bit for bit, and nothing more or less."""
    cfg, _, variables, tm, _ = models
    back = convert_lidar_centernet_statedict(tm.state_dict(), cfg)
    for col in ("params", "batch_stats"):
        want = dict(_flat_leaves(variables[col]))
        got = dict(_flat_leaves(back[col]))
        assert got.keys() == want.keys(), col
        for path, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[path]), v,
                                          err_msg="/".join(path))


def test_forward_parity(models):
    _, jm, variables, tm, x = models
    want = jax.jit(lambda v, *a: jm.apply(v, *a, train=False,
                                          compute_aux=False))(
        variables, *[jnp.asarray(x[k]) for k in ("rgb", "lidar", "tp",
                                                 "tpi", "vel")])
    with torch.no_grad():
        got = tm(*_torch_args(x))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_forward_ego_parity(models):
    _, jm, variables, tm, x = models
    wp_j, boxes_j, labels_j = jax.jit(
        lambda v, *a: jm.apply(v, *a, method="forward_ego"))(
        variables, *[jnp.asarray(x[k]) for k in ("rgb", "lidar", "tp",
                                                 "tpi", "vel")])
    wp, boxes, labels = tm.forward_ego(*_torch_args(x))
    assert boxes.shape == boxes_j.shape and labels.dtype == torch.int32
    np.testing.assert_allclose(wp.numpy(), np.asarray(wp_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(boxes_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(labels_j))


def test_compute_aux_and_other_families_raise(models):
    """compute_aux (training's maps) is ported and matches the JAX
    package; the other backbone families build and run (their parity is
    held in tests/test_torch_families.py)."""
    import dataclasses

    cfg, jm, variables, tm, x = models
    want = jax.jit(lambda v, *a: jm.apply(v, *a, train=False,
                                          compute_aux=True))(
        variables, *[jnp.asarray(x[k]) for k in ("rgb", "lidar", "tp",
                                                 "tpi", "vel")])
    with torch.no_grad():
        got = tm(*_torch_args(x), compute_aux=True)
    assert set(got) == set(want)
    for k in ("pred_bev", "pred_semantic", "pred_depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    other = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  backbone="late_fusion"))
    late = LidarCenterNet(other, dtype=torch.float32, device="cpu")
    assert type(late._model).__name__ == "LateFusionBackbone"
    with torch.no_grad():
        out = late(*_torch_args(x), compute_aux=True)
    assert set(out) == set(want)
    for k in want:
        assert out[k].shape == want[k].shape, k
        assert torch.isfinite(out[k]).all(), k


def test_reference_replica_checkpoint_loads_strictly(tmp_path):
    """The test-suite's torch replica of the reference model (reference
    names, DDP prefix) loads into the port with strict=True, aliases of
    the reference's timm surgery included, and drives like it."""
    cfg = _parity_config()
    torch.manual_seed(5)
    ref = TorchLidarCenterNet().eval()
    state = {f"module.{k}": v for k, v in ref.state_dict().items()}
    # what the reference's timm surgery adds: an alias of the stem and of
    # each stage, and timm's unused classifier head
    feats = "module._model.image_encoder.features."
    state[f"{feats}conv1.conv.weight"] = state[f"{feats}stem.conv.weight"]
    state[f"{feats}layer1.b1.conv1.conv.weight"] = \
        state[f"{feats}s1.b1.conv1.conv.weight"]
    state[f"{feats}head.fc.weight"] = torch.zeros(3, 192)
    path = tmp_path / "model_0.pth"
    torch.save(state, path)

    tm = LidarCenterNet(cfg, dtype=torch.float32, device="cpu")
    tm.load_state_dict(load_reference_checkpoint(str(path), cfg),
                       strict=True)
    assert torch.equal(tm.output.weight, ref.output.weight)

    x = _inputs(seed=4)
    with torch.no_grad():
        got = tm(*_torch_args(x))
        want = ref(*[torch.from_numpy(np.transpose(a, (0, 3, 1, 2)))
                     if a.ndim == 4 else torch.from_numpy(a)
                     for a in (x["rgb"], x["lidar"], x["tp"], x["tpi"])],
                   torch.from_numpy(x["vel"][:, None]))
    np.testing.assert_allclose(got["pred_wp"].numpy(),
                               want["pred_wp"].numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got["head_heatmap"].numpy(),
        np.transpose(want["head_heatmap"].numpy(), (0, 2, 3, 1)),
        rtol=RTOL, atol=ATOL)


def test_lidar_stem_registered_as_conv1_is_renamed():
    state = {"module._model.lidar_encoder._model.conv1.weight": 1,
             "module._model.lidar_encoder._model.layer2.b1.x": 2,
             "module.head.heatmap_head.0.weight": 3}
    assert canonical_reference_state(state, _parity_config()) == {
        "_model.lidar_encoder._model.stem.conv.weight": 1,
        "head.heatmap_head.0.weight": 3}
