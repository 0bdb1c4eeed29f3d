"""Host time of the training step's ``train.losses`` spans per traced step:
the in-graph CenterNet targets and the loss terms."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "train.step"):
        return None
    return spans.per_unit_ms(
        t, spans.total_s(spans.spans(t, "train.losses")))
