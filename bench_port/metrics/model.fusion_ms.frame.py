"""Self time of the model's ``model.fusion`` spans per traced compute
frame (host time, the ATen calls they make included; the
``kernels.attention`` wrapper spans inside them excluded)."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "model.forward_ego"):
        return None
    return spans.per_unit_ms(t, spans.self_s(t, "model.fusion"))
