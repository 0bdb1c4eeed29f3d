"""The agent's own host time per compute frame: ``run_step``'s wall time
less the time inside the members' ``forward_ego`` (the benchmark's span
around each call), over the timed compute frames."""


def read(run):
    if not run.units:
        return None
    h = run.host
    return 1e3 * (h["run_step_s"] - h["forward_ego_s"]) / run.units
