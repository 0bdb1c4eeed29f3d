"""Self time of the model's ``model.outputs`` (channel convs, global
pool, top-down FPN, waypoint GRU, CenterNet head) and ``model.decode``
(the heatmap's top-k boxes) spans per traced compute frame."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "model.forward_ego"):
        return None
    return spans.per_unit_ms(t, spans.self_s(t, "model.outputs")
                             + spans.self_s(t, "model.decode"))
