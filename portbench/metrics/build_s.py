"""``build_s``: the window's time, to the end of its last build, over the
``build_index`` calls completed in it (each ends in a device sync)."""


def read(run):
    drv = run.driver
    return (drv.t_last - drv.t0) / run.units if run.units else None
