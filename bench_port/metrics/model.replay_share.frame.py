"""The share of the traced compute frames' ``model.forward_ego`` spans
that replay a CUDA graph: 100 x those holding a ``model.replay`` span over
all of them. A program that replays none reads 0.0."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "agent.run_step"):
        return None
    forwards = spans.spans(t, "model.forward_ego")
    forwards = forwards[spans.inside(forwards, spans.compute_frames(t))]
    if not len(forwards):
        return None
    replayed = spans.holds(forwards, spans.spans(t, "model.replay"))
    return 100.0 * float(replayed.any(axis=1).mean())
