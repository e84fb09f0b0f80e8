"""``device_idle``: the share of the traced stretch in which the device ran
no kernel, copy or set: 1 - (union of the device intervals) / (wall
time)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
