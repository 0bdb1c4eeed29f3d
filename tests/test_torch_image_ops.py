"""The port's adaptive pooling and bilinear resize against the JAX
package's (transfuser_tpu/ops/image_ops.py), fp32 on the CPU, within
1e-5: tests/test_image_ops.py's pool cases (exact divisors, an upsampling
pool and ragged windows), and resizes that shrink, which jax.image.resize
antialiases (one axis shrinking and the other growing too), beside the
upsampling resizes the shipped anchors give."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_threads import torch_threads_per_worker  # noqa: F401
from transfuser_tpu.ops import image_ops as jax_ops
from transfuser_torch.ops import flops, image_ops

TOL = 1e-5


def _x(hw, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("in_hw, out_hw", [
    ((40, 176), (5, 22)),   # transfuser image anchors, exact divisor
    ((64, 64), (8, 8)),     # LiDAR anchors
    ((2, 4), (5, 22)),      # general (upsampling) path
    ((10, 44), (5, 22)),
    ((7, 13), (3, 5)),      # ragged windows
    ((16, 32), (3, 5)),     # the tiny model's stage 1 at anchors 3x5
])
def test_adaptive_avg_pool_equals_jax(in_hw, out_hw):
    x = _x(in_hw, seed=sum(in_hw))
    got = image_ops.adaptive_avg_pool(torch.from_numpy(x), out_hw).numpy()
    want = np.asarray(jax_ops.adaptive_avg_pool(jnp.asarray(x), out_hw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_exact_divisors_keep_the_reshape_mean():
    """The shipped anchors' pools stay a reshape and a mean, bit for
    bit."""
    x = torch.from_numpy(_x((40, 176), seed=1)).permute(0, 3, 1, 2)
    want = x.reshape(2, 3, 5, 8, 22, 8).mean(dim=(3, 5))
    assert torch.equal(image_ops.adaptive_avg_pool_nchw(x, (5, 22)), want)


@pytest.mark.parametrize("in_hw, out_hw", [
    ((5, 22), (2, 4)),      # stage 4's grid back to a 2x4 map
    ((20, 88), (5, 22)),    # anchors 20x88 back to stage 4
    ((13, 7), (5, 3)),
    ((8, 8), (3, 3)),
    ((5, 22), (4, 30)),     # shrinks in H, grows in W
    ((3, 5), (2, 4)),       # the tiny model's stage 4 at anchors 3x5
    ((5, 22), (40, 176)),   # upsampling, as the shipped anchors give
    ((13, 7), (40, 30)),
])
def test_resize_bilinear_equals_jax(in_hw, out_hw):
    x = _x(in_hw, seed=sum(in_hw) + 1)
    got = image_ops.resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    want = np.asarray(jax_ops.resize_bilinear(jnp.asarray(x), out_hw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_downsampling_resize_counts_no_flops():
    """The antialiased resize's matrix products count nothing under the
    FLOP counter, as F.interpolate's upsample counts nothing."""
    x = torch.from_numpy(_x((20, 88), seed=2)).permute(0, 3, 1, 2)
    with flops.FlopCounter() as counter:
        image_ops.resize_bilinear_nchw(x, (5, 22))
        image_ops.resize_bilinear_nchw(x, (40, 176))
    assert counter.total == 0


@pytest.mark.parametrize("op, out_hw", [("pool", (3, 5)), ("pool", (40, 60)),
                                        ("resize", (5, 22)),
                                        ("resize", (4, 30))])
def test_bf16_within_bf16_rounding_of_fp32(op, out_hw):
    """bf16 in, bf16 out: within a few bf16 ulps of the fp32 result."""
    x = torch.from_numpy(_x((20, 88), seed=3)).permute(0, 3, 1, 2)
    fn = (image_ops.adaptive_avg_pool_nchw if op == "pool"
          else image_ops.resize_bilinear_nchw)
    got = fn(x.bfloat16(), out_hw)
    want = fn(x, out_hw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 4 * scale * 2.0 ** -8
