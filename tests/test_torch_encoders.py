"""The port's ResNet and ConvNeXt trunks vs the JAX package's, fp32 on the
CPU, with the same weights on both sides.

Each trunk's JAX variables (init, then non-identity BatchNorm statistics
and ConvNeXt layer scales, so every path carries signal) are carried to
the port in timm's names by the weight bridge's trunk converters; each
stage then runs on the JAX trunk's output of the stage before it.
Tolerance rtol 1e-3 / atol 1e-4, the bound tests/test_regnet_import.py
holds deep conv stacks to (the summation order differs between XLA:CPU
and torch's CPU kernels). The full-size trunks are held to JAX by their
parameter trees' shapes, from ``jax.eval_shape`` (nothing compiled).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.models import encoders as jenc
from transfuser_torch.models.encoders import make_encoder, trunk_family
from transfuser_torch.models.layers import LayerNorm2d
from transfuser_torch.train.jax_import import (_TRUNK_FROM_STATE,
                                               _TRUNK_TO_STATE)

RTOL, ATOL = 1e-3, 1e-4
TRUNKS = ["resnet_micro", "resnet18", "convnext_tiny"]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _randomized(variables, seed):
    """BatchNorm statistics and ConvNeXt layer scales away from their
    init (identity and 1e-6)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v)
            if k == "mean":
                v = rng.uniform(-0.3, 0.3, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "gamma":
                v = rng.uniform(0.2, 0.6, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(variables)


@pytest.fixture(scope="module", params=TRUNKS)
def trunk(request):
    """(arch, the port's trunk, the JAX input of each stage, the JAX
    output of each stage), stage names 'stem', 0..3."""
    arch = request.param
    jm = jenc.make_encoder(arch, 3, jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 64, 96, 3)).astype(
        np.float32)
    v = jax.device_get(jax.jit(lambda k: jm.init(k, jnp.asarray(x)))(
        jax.random.PRNGKey(0)))
    v = _randomized({k: dict(c) for k, c in v.items()}, seed=3)

    def run(v, x):
        outs = [jm.apply(v, x, method=lambda m, a: m.stem(a))]
        for i in range(4):
            outs.append(jm.apply(v, outs[-1],
                                 method=lambda m, a, i=i: m.stage(i, a)))
        return outs

    outs = [np.asarray(o) for o in jax.jit(run)(v, jnp.asarray(x))]
    state = {}
    _TRUNK_TO_STATE[trunk_family(arch)](state, "", v["params"],
                                        v.get("batch_stats", {}))
    tm = make_encoder(arch, 3).eval()
    tm.load_state_dict(state, strict=True)
    names = ["stem", 0, 1, 2, 3]
    return arch, tm, dict(zip(names, [x] + outs[:-1])), dict(zip(names, outs))


@pytest.mark.parametrize("stage", ["stem", 0, 1, 2, 3])
def test_trunk_stage(trunk, stage):
    _, tm, inputs, want = trunk
    x = torch.from_numpy(np.array(inputs[stage]))
    with torch.no_grad():
        got = tm.stem_nhwc(x) if stage == "stem" else tm.stage_nhwc(stage, x)
    assert tuple(got.shape) == want[stage].shape
    np.testing.assert_allclose(got.numpy(), want[stage], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ["resnet34", "convnext_base"])
@pytest.mark.parametrize("in_channels", [3, 4])
def test_full_size_trunk_parameter_shapes(arch, in_channels):
    """The image trunk and a LiDAR trunk (4 input channels) hold the JAX
    trunk's tree, leaf for leaf and shape for shape."""
    jm = jenc.make_encoder(arch, in_channels, jnp.float32)
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 64, 64, in_channels), jnp.float32))
    tm = make_encoder(arch, in_channels)
    p, s = _TRUNK_FROM_STATE[trunk_family(arch)](tm.state_dict(), "")
    for col, got in (("params", p), ("batch_stats", s)):
        want = {k: tuple(a.shape)
                for k, a in _leaves(dict(shapes.get(col, {})))}
        assert {k: a.shape for k, a in _leaves(got)} == want, col
    assert tm.feature_dims == jm.feature_dims


def test_layer_norm_2d_equals_flax_layer_norm():
    """timm's channels-first LayerNorm2d against flax's LayerNorm over the
    NHWC channels (eps 1e-6); bf16 in, bf16 out, computed in fp32."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 5, 7, 12)) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 12).astype(np.float32)
    want = nn.LayerNorm(epsilon=1e-6).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    ln = LayerNorm2d(12, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = ln(xt).permute(0, 2, 3, 1)
        half = ln(xt.bfloat16())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert half.dtype == torch.bfloat16
    np.testing.assert_allclose(half.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=2 ** -7, atol=2e-2)
