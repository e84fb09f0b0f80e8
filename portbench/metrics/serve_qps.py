"""``serve_qps``: requests answered inside the window over its length."""


def read(run):
    drv = run.driver
    done = sum(1 for rec in run.records if rec[4] and rec[2] <= drv.t_end)
    return done / (drv.t_end - drv.t0) if run.records else None
