"""Host time of the optimizer per traced step: the ``train.clip`` (AGC
and the global-norm clip) and ``train.update`` (AdamW's passes, and under
ZeRO-1 the owners' broadcasts) spans."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "train.step"):
        return None
    return spans.per_unit_ms(t, spans.total_s(spans.spans(t, "train.clip"))
                             + spans.total_s(spans.spans(t, "train.update")))
