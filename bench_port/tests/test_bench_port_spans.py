"""The readers of the program's spans (``spans.py``, ``metrics/``) on
hand-built traces: nesting, self time, the division by the traced units,
None without a root span and 0.0 without a stage's, and the device's
idle time outside the root spans."""

from types import SimpleNamespace

import numpy as np
import pytest

from bench_port import harness, spans
from bench_port.trace import Trace

US = 1000  # the trace's clock is in ns; the cases are written in us

FRAME_READERS = ("agent.host_ms.frame", "agent.wait_ms.frame",
                 "model.encoders_ms.frame", "model.fusion_ms.frame",
                 "model.outputs_ms.frame", "kernels.attention_host_ms.frame",
                 "device.idle_outside_spans.frame")
TRAIN_READERS = ("train.forward_ms.train", "train.losses_ms.train",
                 "train.backward_ms.train", "train.update_ms.train",
                 "device.idle_outside_spans.train")

# two compute frames and an action-repeat frame between them; ATen events
# among the spans; the second frame has no model.decode
FRAME_HOST = [
    ("agent.run_step", 100, 400), ("agent.tick", 100, 120),
    ("aten::copy_", 125, 130),
    ("model.forward_ego", 150, 300), ("model.encoders", 150, 200),
    ("aten::conv2d", 155, 160), ("model.fusion", 200, 260),
    ("kernels.attention", 210, 230), ("model.outputs", 260, 290),
    ("model.decode", 290, 300), ("agent.readback", 300, 380),
    ("agent.run_step", 450, 470), ("agent.tick", 450, 460),
    ("agent.run_step", 500, 800), ("model.forward_ego", 520, 700),
    ("model.encoders", 520, 600), ("model.fusion", 600, 650),
    ("kernels.attention", 610, 640), ("model.outputs", 650, 700),
    ("agent.readback", 700, 790),
]
# device work: three stretches inside frames, one in the cell's own loop
DEVICE = [(160, 280), (320, 350), (600, 690), (900, 950)]

TRAIN_HOST = [
    ("train.step", 0, 500), ("train.forward", 0, 200),
    ("model.encoders", 10, 100), ("train.losses", 200, 250),
    ("train.backward", 250, 400), ("train.clip", 400, 430),
    ("train.update", 430, 490),
    ("train.step", 520, 1000), ("train.forward", 520, 720),
    ("train.losses", 720, 770), ("train.backward", 770, 920),
    ("train.clip", 920, 950), ("train.update", 950, 1000),
]


def make_trace(host, device=DEVICE, units=2, window=(0, 1000)):
    host = sorted(host, key=lambda h: h[1])
    return Trace(
        names=["kernel"] * len(device),
        start=np.array([s * US for s, _ in device], np.int64),
        end=np.array([e * US for _, e in device], np.int64),
        kernel=np.ones(len(device), bool),
        window_start=window[0] * US, window_end=window[1] * US, units=units,
        host=dict(start=np.array([h[1] * US for h in host], np.int64),
                  end=np.array([h[2] * US for h in host], np.int64),
                  names=np.array([h[0] for h in host], dtype=object)))


def read(name, trace):
    return harness.load_module("metrics", name).read(
        SimpleNamespace(traced=trace))


@pytest.mark.parametrize("name, want_ms", [
    # frames 300 + 300 us less forwards 150 + 180 and waits 80 + 90
    ("agent.host_ms.frame", (600 - 330 - 170) / 2 / 1000),
    ("agent.wait_ms.frame", (80 + 90) / 2 / 1000),
    # no spans nested in the encoders: the ATen event inside stays in
    ("model.encoders_ms.frame", (50 + 80) / 2 / 1000),
    # less the attention wrapper nested inside
    ("model.fusion_ms.frame", ((60 - 20) + (50 - 30)) / 2 / 1000),
    ("model.outputs_ms.frame", (30 + 50 + 10) / 2 / 1000),
    ("kernels.attention_host_ms.frame", (20 + 30) / 2 / 1000),
])
def test_frame_readers_per_compute_frame(name, want_ms):
    assert read(name, make_trace(FRAME_HOST)) == pytest.approx(want_ms)


def test_host_wait_and_forwards_make_up_the_compute_frames():
    t = make_trace(FRAME_HOST)
    forwards = spans.total_s(spans.spans(t, "model.forward_ego"))
    whole = (read("agent.host_ms.frame", t) + read("agent.wait_ms.frame", t)
             + 1e3 * forwards / t.units)
    assert whole == pytest.approx(1e3 * spans.total_s(
        spans.compute_frames(t)) / t.units)
    assert len(spans.compute_frames(t)) == 2  # the repeat frame is not one


def test_idle_outside_the_root_spans():
    # window 1000, busy 290; root spans 620, of which busy 240:
    # idle outside = 1000 - 290 - (620 - 240) = 330
    t = make_trace(FRAME_HOST)
    assert read("device.idle_outside_spans.frame", t) == pytest.approx(33.0)
    # with no device work at all, idle outside is the time between frames
    t = make_trace(FRAME_HOST, device=[])
    assert read("device.idle_outside_spans.frame", t) == pytest.approx(38.0)


@pytest.mark.parametrize("name, want_ms", [
    # the model's span inside included
    ("train.forward_ms.train", (200 + 200) / 2 / 1000),
    ("train.losses_ms.train", (50 + 50) / 2 / 1000),
    ("train.backward_ms.train", (150 + 150) / 2 / 1000),
    ("train.update_ms.train", ((30 + 60) + (30 + 50)) / 2 / 1000),
    # outside the steps: 500-520 idle; busy 900-950 is inside a step
    ("device.idle_outside_spans.train", 100 * 20 / 1000),
])
def test_train_readers_per_step(name, want_ms):
    assert read(name, make_trace(TRAIN_HOST)) == pytest.approx(want_ms)


@pytest.mark.parametrize("name", FRAME_READERS + TRAIN_READERS)
def test_none_without_a_root_span(name):
    """The parent program opens no span: every reader is silent, and so
    it is with no trace or no traced unit."""
    aten = [("aten::mm", 10, 20), ("aten::add", 30, 40)]
    assert read(name, make_trace(aten)) is None
    assert read(name, None) is None
    host = FRAME_HOST if name.endswith("frame") else TRAIN_HOST
    assert read(name, make_trace(host, units=0)) is None


def test_a_stage_without_its_span_reads_zero():
    """A forward whose stages left no span (captured in a CUDA graph, say)
    reads 0.0 where its root is there."""
    bare = [h for h in FRAME_HOST if not h[0].startswith(
        ("model.encoders", "model.fusion", "model.outputs", "model.decode",
         "kernels."))]
    t = make_trace(bare)
    for name in ("model.encoders_ms.frame", "model.fusion_ms.frame",
                 "model.outputs_ms.frame", "kernels.attention_host_ms.frame"):
        assert read(name, t) == 0.0
    steps = [h for h in TRAIN_HOST if h[0] == "train.step"]
    for name in TRAIN_READERS[:4]:
        assert read(name, make_trace(steps)) == 0.0


def test_self_time_of_nested_spans():
    # a span holding a child that holds a grandchild: the child's whole
    # length comes off once; a sibling with the same name counts apart
    host = [("model.fusion", 0, 100), ("model.encoders", 10, 50),
            ("kernels.attention", 20, 30), ("model.fusion", 200, 260)]
    t = make_trace(host)
    assert spans.self_s(t, "model.fusion") == pytest.approx(
        ((100 - 40) + 60) * US / 1e9)
    assert spans.self_s(t, "model.encoders") == pytest.approx(30 * US / 1e9)


def test_interval_helpers():
    iv = np.array([[5, 9], [0, 3], [2, 4], [10, 12]])
    np.testing.assert_array_equal(spans.union(iv),
                                  [[0, 4], [5, 9], [10, 12]])
    merged = spans.union(iv)
    np.testing.assert_array_equal(
        spans.covered(merged, [0, 3, -5, 11], [12, 6, 0, 20]),
        [10, 2, 0, 1])


def test_every_new_metric_has_its_reader_and_entry():
    spec = harness.spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in FRAME_READERS + TRAIN_READERS:
        m = entries[name]
        assert m["source"] == "device_trace" and m["better"] == "lower"
        harness.load_module("metrics", name)
        assert all(w.endswith(".frame") == name.endswith(".frame")
                   for w in m["workloads"])
