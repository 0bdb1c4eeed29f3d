"""The host's wait for the card per traced compute frame: the
``agent.readback`` spans (the one device-to-host copy of the members'
outputs, which waits for their forwards to finish)."""

from bench_port import spans


def read(run):
    t = run.traced
    if not spans.has_root(t, "agent.run_step"):
        return None
    waits = spans.spans(t, "agent.readback")
    frames = spans.compute_frames(t)
    return spans.per_unit_ms(
        t, spans.total_s(waits[spans.inside(waits, frames)]))
