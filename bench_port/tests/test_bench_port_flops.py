"""The benchmark's FLOP count (``bench_port/flops.py``) equals the
formulas at small shapes, and the model's count is the sum of its
layers' formulas."""

import pytest
import torch
import torch.nn.functional as F

from bench_port import flops, harness
from bench_port.reference import model as ref
from bench_port.reference import train as ref_train
from tiny import tiny_config


def _count(fn, device="meta"):
    with flops.FlopCounter() as c:
        fn()
    return c


def test_matrix_products():
    a, b = torch.empty(5, 7, device="meta"), torch.empty(7, 3, device="meta")
    assert _count(lambda: a @ b).total == 2 * 5 * 7 * 3
    w, x = torch.empty(3, 7, device="meta"), torch.empty(4, 5, 7,
                                                        device="meta")
    assert _count(lambda: F.linear(x, w, torch.empty(3, device="meta"))
                  ).total == 2 * 20 * 7 * 3


@pytest.mark.parametrize("groups", [1, 3])
def test_convolution_forward_and_backward(groups):
    x = torch.randn(2, 6, 9, 11, requires_grad=True)
    w = torch.randn(12, 6 // groups, 3, 3, requires_grad=True)
    fwd = 2 * 2 * (5 * 6) * 12 * (6 // groups) * 9  # stride 2, pad 1
    with flops.FlopCounter() as c:
        y = F.conv2d(x, w, stride=2, padding=1, groups=groups)
    assert c.total == fwd
    with flops.FlopCounter() as c:
        y.sum().backward()
    # each gradient of a grouped convolution costs its forward
    assert c.total == 2 * fwd


def test_attention_counts_four_b_h_t2_d():
    b, t, h, d = 2, 17, 4, 6
    q = [torch.empty(b, t, h, d, device="meta") for _ in range(3)]
    assert _count(lambda: ref.attention(*q)).total == 4 * b * h * t * t * d


def test_model_count_is_the_sum_of_its_layers():
    """The tiny model's forward count equals the formulas summed over its
    convolutions, linears, GRU cell and attention calls, each from the
    shapes a forward hook sees."""
    raw = tiny_config(harness.load_json(
        f"{harness.HERE}/configs/transfuser.json"))["config"]
    cfg = ref.namespace(raw)
    model = ref.build(cfg, "cpu")
    total = []

    def conv_hook(m, inp, out):
        total.append(flops.conv_flops(inp[0].shape, m.weight.shape,
                                      out.shape))

    def linear_hook(m, inp, out):
        total.append(2 * inp[0].numel() // inp[0].shape[-1]
                     * m.in_features * m.out_features)

    def gru_hook(m, inp, out):
        n = inp[0].shape[0]
        total.append(2 * n * 3 * m.hidden_size
                     * (m.input_size + m.hidden_size))

    def attn_hook(m, inp, out):
        b, t, c = inp[0].shape
        total.append(4 * b * t * t * c)

    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(conv_hook)
        elif isinstance(mod, torch.nn.Linear):
            mod.register_forward_hook(linear_hook)
        elif isinstance(mod, torch.nn.GRUCell):
            mod.register_forward_hook(gru_hook)
        elif isinstance(mod, ref.SelfAttention):
            mod.register_forward_hook(attn_hook)
    x = flops._meta_inputs(cfg, 1, False)
    x = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in x.items()}
    with torch.no_grad():
        model(**ref_train.model_inputs(x))
    assert flops.forward_flops(ref, cfg) == sum(total)


@pytest.mark.parametrize("name, forward, step", [
    ("transfuser", 70730397184, 2763008593920),
    ("transfuser-pillars", 71118472704, 2777042571264)])
def test_flagship_counts(name, forward, step):
    """The full-size counts of each accepted configuration, on the meta
    device, through the reference module its file names: one forward and
    one training step at batch 12 (the flagship's 2.763 TFLOP, as the
    port's bench counted its first step)."""
    raw = harness.load_json(f"{harness.HERE}/configs/{name}.json")
    run_ref = harness.reference(raw)
    cfg = run_ref.namespace(raw["config"])
    assert flops.forward_flops(run_ref, cfg) == forward
    assert flops.train_step_flops(run_ref, cfg, 12) == step
