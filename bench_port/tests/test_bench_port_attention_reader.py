"""``attention_roofline.frame``'s least time of a forward's attention
calls: the GPT widths come from the run's reference module, so that a
configuration on another trunk is read at its own widths, and the
flagship's bound is the one pinned before."""

import pytest

from bench_port import harness
from bench_port.peaks import attention_bound_s
from bench_port.reference import convnext
from convnext_config import convnext_config

CARD = "NVIDIA H100 80GB HBM3"
# the flagship's bound per forward, as read before the widths came from
# the reference module (RegNetY-032: 72 / 216 / 576 / 1512)
TRANSFUSER = 3.949124776119403e-06


@pytest.fixture(scope="module")
def reader():
    return harness.load_module("metrics", "attention_roofline.frame")


def _config(config):
    ref = harness.reference(config)
    return ref, ref.namespace(config["config"])


def test_the_flagships_bound_is_unchanged(reader):
    config = harness.load_json(f"{harness.HERE}/configs/transfuser.json")
    assert reader.bound_per_forward(*_config(config), CARD) == TRANSFUSER


def test_a_convnext_configuration_reads_its_own_widths(reader):
    ref, cfg = _config(convnext_config("convnext_base"))
    assert ref is convnext
    g = cfg.model.gpt
    t = (g.img_vert_anchors * g.img_horz_anchors
         + g.lidar_vert_anchors * g.lidar_horz_anchors)
    want = sum(g.n_layer * attention_bound_s(1, t, g.n_head, w // g.n_head,
                                             2, CARD)
               for w in (128, 256, 512, 1024))
    assert reader.bound_per_forward(ref, cfg, CARD) == want
    assert want != TRANSFUSER
