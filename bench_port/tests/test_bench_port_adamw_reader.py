"""``adamw_roofline.train``: the elements it bounds the update by are the
trainable elements of the run's reference model, which equal those of
the port's ``AdamW.params`` for both training configurations; and its
reading is that bound over the device time of AdamW's kernels, whichever
implement it (PyTorch's ``_foreach`` kernels or the port's)."""

import json
from types import SimpleNamespace

import pytest

from bench_port import harness
from bench_port.peaks import peaks

CARD = "NVIDIA H100 80GB HBM3"
ELEMENTS = {"transfuser": 168018327, "transfuser-pillars": 168028471}


@pytest.fixture(scope="module")
def reader():
    return harness.load_module("metrics", "adamw_roofline.train")


def _config(name):
    config = harness.load_json(f"{harness.HERE}/configs/{name}.json")
    ref = harness.reference(config)
    return config, ref, ref.namespace(config["config"])


@pytest.mark.parametrize("name", sorted(ELEMENTS))
def test_elements_equal_the_ports_optimizer(reader, name):
    from transfuser_torch.config import GlobalConfig
    from transfuser_torch.models import LidarCenterNet
    from transfuser_torch.train.train_state import make_optimizer

    config, ref, cfg = _config(name)
    port_cfg = GlobalConfig.from_json(json.dumps(config["config"]))
    model = LidarCenterNet(port_cfg, device="meta")
    opt = make_optimizer(model.parameters(), port_cfg)
    port = sum(p.numel() for p in opt.params)
    assert reader.trainable_elements(ref, cfg) == port == ELEMENTS[name]


class _Trace:
    units = 6

    def __init__(self, kernels):
        self.kernels = kernels

    def device_s_matching(self, patterns):
        return sum(s for n, s in self.kernels.items()
                   if any(p in n for p in patterns))


@pytest.mark.parametrize("kernels", [
    {"void at::native::(anonymous namespace)::multi_tensor_apply_kernel":
     0.03, "cudnn_conv": 1.0},
    {"(anonymous namespace)::tf_adamw_step(AdamWArgs)": 0.03},
], ids=["foreach", "kernel"])
def test_reading_is_the_bound_over_the_update_kernels(reader, kernels):
    config, ref, cfg = _config("transfuser")
    run = SimpleNamespace(traced=_Trace(kernels), card=CARD, ref=ref,
                          cfg=cfg)
    want = 100 * 28 * ELEMENTS["transfuser"] / peaks(CARD)[1] * 6 / 0.03
    assert reader.read(run) == pytest.approx(want, rel=1e-12)
    run.traced = _Trace({"cudnn_conv": 1.0})
    assert reader.read(run) is None
