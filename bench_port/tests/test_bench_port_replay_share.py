"""The reader of ``model.replay_share.frame`` on hand-built traces: 0.0
where no forward replays (the eager program), 100 where every compute
frame's forward holds a ``model.replay`` span, the share in between, and
None without a root span."""

from bench_port import harness
from test_bench_port_spans import FRAME_HOST, make_trace, read

NAME = "model.replay_share.frame"


def test_replay_share_of_the_compute_frames_forwards():
    assert read(NAME, make_trace(FRAME_HOST)) == 0.0
    # replayed: no stages inside the forwards, a replay span instead
    replayed = [h for h in FRAME_HOST if not h[0].startswith(
        ("model.encoders", "model.fusion", "model.outputs", "model.decode",
         "kernels."))] + [("model.replay", 160, 290),
                          ("model.replay", 530, 690)]
    assert read(NAME, make_trace(replayed)) == 100.0
    # one of the two forwards replays; a replay span outside every
    # forward (the cell's own loop) counts for none
    half = FRAME_HOST + [("model.replay", 530, 690), ("model.replay", 850,
                                                      860)]
    assert read(NAME, make_trace(half)) == 50.0
    assert read(NAME, make_trace([("aten::mm", 10, 20)])) is None
    assert read(NAME, None) is None


def test_replay_share_entry():
    m = {m["name"]: m for m in harness.spec()["per_layer"]}[NAME]
    assert (m["unit"], m["better"], m["moves"], m["workloads"]) == (
        "%", "higher", "frame_ms_p50", ["transfuser.frame"])
