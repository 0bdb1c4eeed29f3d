"""Host time of the training step's ``train.forward`` spans per traced
step: unpacking the batch, the dropout generator and the model's forward
with the auxiliary maps, every span nested inside included."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "train.step"):
        return None
    return spans.per_unit_ms(
        t, spans.total_s(spans.spans(t, "train.forward")))
