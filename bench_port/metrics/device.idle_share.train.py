"""The card's idle share of the traced window: 100 x (1 - the union of
the device's operation intervals / the window)."""


def read(run):
    t = run.traced
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
