"""A preview on the card of a ConvNeXt-Base TransFuser training cell: the
test's own configuration (``convnext_config.py``) at its published
widths, batch 12, through the train driver and its comparison with a
4 s window; skips without a card. It prints one line, ``convnext
preview: {...}``: the peak memory, samples/s, the seconds the comparison
takes, the numbers read (the program's and the fp8 control's) and the
seeded layer scale's effect, the first step's loss of the reference with
one stage-2 block's branch zeroed, at 1.0 and at timm's 1e-6:

    python -m pytest bench_port/tests/test_bench_port_convnext_card.py \
        -m cuda -s
"""

import json
import math
import time

import pytest
import torch

from bench_port import harness
from bench_port.reference import train as ref_train
from bench_port.weights import seeded_state_dict
from convnext_config import use_convnext

SEED = 2147483999
BLOCK = "_model.image_encoder.features.stages.2.blocks.13.gamma"


def _loss1(run, out, gamma):
    """The reference's first-step loss from the seeded weights, with every
    layer scale at ``gamma``: whole, and with ``BLOCK``'s zeroed."""
    ref, cfg = run.ref, out.cfg
    state = seeded_state_dict(ref, cfg, out.weights_seed, run.device)
    for k, v in state.items():
        if k.endswith(".gamma"):
            v.fill_(gamma)
    got = []
    with ref.plain_fp32():
        model = ref.build(cfg, run.device)
        for zero in (False, True):
            if zero:
                state[BLOCK].zero_()
            got.append(ref_train.loss_at(model, cfg, out.batches[0], state,
                                         0))
    del model, state
    torch.cuda.empty_cache()
    return got


@pytest.mark.cuda
def test_the_convnext_base_train_cell_is_compared(card, monkeypatch,
                                                 tmp_path):
    use_convnext(monkeypatch, tmp_path / "transfuser-convnext.json",
                 "convnext_base")
    harness.cache_dirs()
    run = harness.prepare("transfuser.train", SEED, 4.0, False,
                          time.perf_counter())
    run.device = card
    run.card = torch.cuda.get_device_name(card)
    driver = harness.load_module("drivers", run.mix["driver"])
    out = driver.run(run)
    t0 = time.perf_counter()
    readings = driver.compare(run, out)
    compare_s = time.perf_counter() - t0
    control = driver.compare(run, out, control=True)
    whole, zeroed = _loss1(run, out, 1.0)
    whole_timm, zeroed_timm = _loss1(run, out, 1e-6)
    preview = {
        "card": run.card, "memory_peak_bytes": run.memory_peak,
        "samples_per_s": run.e2e["train_samples_per_s"],
        "steps": run.units, "setup_s": run.setup_s, "compare_s": compare_s,
        "flops_per_step": run.flops_per_unit, "readings": readings,
        "control": control,
        "loss1_block_zeroed": {"gamma_1": [whole, zeroed],
                               "gamma_1e-6": [whole_timm, zeroed_timm]}}
    print("convnext preview: " + json.dumps(preview), flush=True)
    assert run.units > 0
    assert "bn_stats_gap" not in readings
    assert "after_bn_stats_gap" not in readings
    assert readings and all(math.isfinite(v) for v in readings.values())
    total = torch.cuda.get_device_properties(card).total_memory
    assert 0 < run.memory_peak < total
