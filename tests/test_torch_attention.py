"""The port's attention vs the Pallas TPU kernel (interpret mode on the CPU)
and the JAX einsum reference, in fp32; and the CUDA kernel vs its plain
version on a card, where there is one."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transfuser_tpu.ops.attention import (pallas_attention,
                                          reference_attention as jax_ref)
from transfuser_torch.ops import kernels
from transfuser_torch.ops.attention import (_check, attention,
                                            reference_attention)

# as tests/test_attention.py holds the Pallas kernel to the einsum path
RTOL, ATOL = 2e-4, 2e-5
SHAPES = [(2, 174, 4, 18), (1, 64, 4, 128), (1, 174, 4, 54),
          (1, 174, 4, 144), (1, 174, 4, 378)]


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_attention_matches_pallas_and_reference(shape):
    q, k, v = _qkv(shape, seed=sum(shape))
    kernels.reset_launches()
    got = attention(*[torch.from_numpy(a) for a in (q, k, v)]).numpy()
    assert kernels.launches["attention"] == 0  # CPU: the plain version
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        got, np.asarray(pallas_attention(jq, jk, jv, interpret=True)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref(jq, jk, jv)),
                               rtol=RTOL, atol=ATOL)


def test_bf16_keeps_probabilities_fp32():
    """bf16 in, bf16 out, but P.V in fp32 as in the Pallas kernel: equal to
    the fp32 computation on the bf16-rounded inputs, rounded once."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv((1, 40, 2, 24), seed=3))
    got = reference_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = reference_attention(q.float(), k.float(), v.float())
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("bad", ["shape", "dtype", "T", "D", "stride"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 8, 2, 4)
    k, v = q.clone(), q.clone()
    if bad == "shape":
        k = k[:, :4]
    elif bad == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "T":
        q = k = v = torch.zeros(1, 1025, 1, 4)
    elif bad == "D":
        q = k = v = torch.zeros(1, 4, 1, 513)
    else:
        q = torch.zeros(1, 8, 4, 2).transpose(2, 3)
    with pytest.raises((ValueError, TypeError)):
        _check(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kernel_matches_plain_version_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for shape in [(1, 174, 4, d) for d in (18, 54, 144, 378)] + \
            [(2, 174, 4, 18), (1, 200, 4, 40)]:
        q, k, v = (torch.from_numpy(a).to("cuda", dtype)
                   for a in _qkv(shape, seed=1))
        before = kernels.launches["attention"]
        got = attention(q, k, v)
        torch.cuda.synchronize()
        assert kernels.launches["attention"] == before + 1
        want = reference_attention(q, k, v).float()
        # fp32: summation order only; bf16: one ulp at the output's scale
        if dtype == torch.float32:
            rtol, atol = 1e-5, 1e-5
        else:
            rtol, atol = 0.0, float(want.abs().max()) * 2.0 ** -7
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_kernel_refuses_inputs_that_need_a_gradient_on_card():
    """The kernel has no backward (nor had the Pallas kernel): on the card
    the wrapper raises rather than return an output with no grad_fn; under
    no_grad it launches as before. On the CPU the plain version stays
    differentiable."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv((1, 16, 2, 8), seed=4))
    attention(q, k, v).sum().backward()
    assert q.grad is not None
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    qc = q.detach().cuda().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        attention(qc, qc.detach(), qc.detach())
    with torch.no_grad():
        attention(qc, qc, qc)
