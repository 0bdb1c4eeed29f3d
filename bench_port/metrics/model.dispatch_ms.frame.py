"""Host time inside the members' ``forward_ego`` per compute frame (the
benchmark's span around each call): the time to enqueue the forwards,
which return without waiting for the card."""


def read(run):
    if not run.units:
        return None
    return 1e3 * run.host["forward_ego_s"] / run.units
