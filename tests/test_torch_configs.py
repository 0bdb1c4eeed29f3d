"""The port vs the JAX package at GPT settings the port refused before it
took general pools, antialiased resizes and any attention shape:
``_parity_config()`` (64x128 RGB, 64x64 LiDAR, regnety_micro with stage
widths 24 / 48 / 96 / 192, 4 GPT layers) with

  * image anchors (3, 5) and LiDAR anchors (3, 3): pools that do not
    divide (16x32 -> 3x5, ..., an upsampling 2x4 -> 3x5) and resizes
    that shrink (3x5 -> 2x4, 3x3 -> 2x2), which jax.image.resize
    antialiases. The forward_ego case is the probe that raised on the
    port before ("adaptive_avg_pool supports exact divisors only");
  * 8 heads: D = 3 / 6 / 12 / 24, odd at stage 1.

fp32 on the CPU, dropout off, the same weights on both sides (seeded
numpy arrays in the JAX tree, carried by ``state_dict_from_jax``):
``forward``, ``forward_ego`` and the train-mode loss dict within rtol
1e-3 / atol 1e-4 (tests/test_full_import.py's bound). One jitted JAX
program per configuration gives all three.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_full_import import _parity_config
from test_torch_threads import torch_threads_per_worker  # noqa: F401
from test_torch_train import SMALL, _numpy_variables, _torch_batch
from transfuser_tpu.data.synthetic import synthetic_batch
from transfuser_tpu.models.lidar_centernet import LidarCenterNet as JaxModel
from transfuser_tpu.train.losses import compute_losses as jax_losses
from transfuser_tpu.train.losses import total_loss as jax_total
from transfuser_tpu.train.trainer import _model_inputs as jax_inputs
from transfuser_torch.data.pack import unpack_batch
from transfuser_torch.models import LidarCenterNet
from transfuser_torch.train.jax_import import state_dict_from_jax
from transfuser_torch.train.losses import compute_losses, total_loss
from transfuser_torch.train.trainer import _model_inputs

RTOL, ATOL = 1e-3, 1e-4
CASES = {
    "anchors_3x5_3x3": dict(img_vert_anchors=3, img_horz_anchors=5,
                            lidar_vert_anchors=3, lidar_horz_anchors=3),
    "n_head_8": dict(n_head=8),
}


def _config(name):
    cfg = _parity_config()
    gpt = dataclasses.replace(cfg.model.gpt, embd_pdrop=0.0, attn_pdrop=0.0,
                              resid_pdrop=0.0, **CASES[name])
    return cfg.replace(model=dataclasses.replace(cfg.model, gpt=gpt))


@functools.lru_cache(maxsize=None)
def _case(name):
    """Both packages' eval forward, forward_ego and train-mode losses on
    one batch."""
    cfg = _config(name)
    batch = synthetic_batch(cfg, 2, seed=5, **SMALL)
    jm = JaxModel(cfg, dtype=jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    args, extra = jax_inputs(jbatch)
    variables = _numpy_variables(jax.eval_shape(
        lambda k: jm.init(k, *args, train=False, **extra),
        jax.random.PRNGKey(0)), seed=1)

    def programs(variables, batch):
        args, extra = jax_inputs(batch)
        out = jm.apply(variables, *args, train=False, compute_aux=False,
                       **extra)
        ego = jm.apply(variables, *args, method="forward_ego", **extra)
        train_out, _ = jm.apply(variables, *args, train=True,
                                mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                **extra)
        detailed = jax_losses(train_out, batch, cfg)
        return out, ego, detailed, jax_total(detailed, cfg)

    want = jax.device_get(jax.jit(programs)(variables, jbatch))

    tm = LidarCenterNet(cfg, dtype=torch.float32, device="cpu")
    tm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    tbatch = unpack_batch(_torch_batch(batch))
    targs, textra = _model_inputs(tbatch)
    tm.eval()
    with torch.no_grad():
        out = tm(*targs, **textra, compute_aux=False)
        ego = tm.forward_ego(*targs, **textra)
    tm.train()
    with torch.no_grad():
        detailed = compute_losses(tm(*targs, **textra, compute_aux=True),
                                  tbatch, cfg)
    got = (out, ego, detailed, total_loss(detailed, cfg))
    return got, want


@pytest.mark.parametrize("name", list(CASES))
def test_forward_equals_jax(name):
    (got, _, _, _), (want, _, _, _) = _case(name)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_ego_equals_jax(name):
    (_, (wp, boxes, labels), _, _), (_, (wp_j, boxes_j, labels_j), _, _) = \
        _case(name)
    np.testing.assert_allclose(wp.numpy(), wp_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(boxes.numpy(), boxes_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(labels.numpy(), labels_j)


@pytest.mark.parametrize("name", list(CASES))
def test_train_losses_equal_jax(name):
    (_, _, detailed, loss), (_, _, detailed_j, loss_j) = _case(name)
    assert set(detailed) == set(detailed_j)
    for k, v in detailed_j.items():
        np.testing.assert_allclose(detailed[k].item(), v, rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(loss.item(), loss_j, rtol=RTOL, atol=ATOL)
