"""Host time of the attention kernel's wrapper per traced compute frame:
the ``kernels.attention`` spans (checks, layout, argument packing and the
launch of csrc/attention.cu)."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "model.forward_ego"):
        return None
    return spans.per_unit_ms(t, spans.total_s(
        spans.spans(t, "kernels.attention")))
