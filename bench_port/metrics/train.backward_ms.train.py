"""Host time of the training step's ``train.backward`` spans per traced
step: clearing the gradients and ``loss.backward()``."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "train.step"):
        return None
    return spans.per_unit_ms(
        t, spans.total_s(spans.spans(t, "train.backward")))
