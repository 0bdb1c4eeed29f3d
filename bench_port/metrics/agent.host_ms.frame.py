"""The agent's own host time per traced compute frame, from the program's
spans: each compute frame's ``agent.run_step`` less the members'
``model.forward_ego`` and the ``agent.readback`` wait inside it."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "agent.run_step"):
        return None
    frames = spans.compute_frames(t)
    forwards = spans.spans(t, "model.forward_ego")
    waits = spans.spans(t, "agent.readback")
    host = (spans.total_s(frames)
            - spans.total_s(forwards[spans.inside(forwards, frames)])
            - spans.total_s(waits[spans.inside(waits, frames)]))
    return spans.per_unit_ms(t, host)
