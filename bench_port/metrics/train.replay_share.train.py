"""The share of the traced steps' ``train.step`` spans that replay a CUDA
graph: 100 x those holding a ``train.replay`` span over all of them. A
program that replays none reads 0.0."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "train.step"):
        return None
    steps = spans.spans(t, "train.step")
    replayed = spans.holds(steps, spans.spans(t, "train.replay"))
    return 100.0 * float(replayed.any(axis=1).mean())
