"""The reader of ``train.replay_share.train`` on hand-built traces: 0.0
where no step replays (the eager program), 100 where every traced
``train.step`` holds a ``train.replay`` span, the share in between, and
None without a root span."""

from bench_port import harness
from test_bench_port_spans import TRAIN_HOST, make_trace, read

NAME = "train.replay_share.train"
PHASES = ("train.forward", "train.losses", "train.backward", "train.clip",
          "train.update", "model.")


def test_replay_share_of_the_traced_steps():
    assert read(NAME, make_trace(TRAIN_HOST)) == 0.0
    # replayed: no phases inside the steps, a replay span instead
    replayed = [h for h in TRAIN_HOST if not h[0].startswith(PHASES)] + [
        ("train.replay", 10, 490), ("train.replay", 530, 990)]
    assert read(NAME, make_trace(replayed)) == 100.0
    # the first step eager, the second replayed; a replay span outside
    # every step counts for none
    half = TRAIN_HOST + [("train.replay", 530, 990),
                         ("train.replay", 505, 515)]
    assert read(NAME, make_trace(half)) == 50.0
    assert read(NAME, make_trace([("aten::mm", 10, 20)])) is None
    assert read(NAME, make_trace(TRAIN_HOST, units=0)) is None
    assert read(NAME, None) is None


def test_replay_share_entry():
    m = {m["name"]: m for m in harness.spec()["per_layer"]}[NAME]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
            m["workloads"]) == (
        "%", "higher", "program_span", "trainer (train/trainer.py train_step)",
        "train_samples_per_s", ["transfuser.train",
                                "transfuser-pillars.train"])
