"""``batch_qps``: queries answered by whole ``answer_batch`` calls over the
time from the window's start to the end of its last batch (the batch in
flight when the window's seconds run out finishes and counts)."""


def read(run):
    drv = run.driver
    n = sum(len(rec[0]) for rec in run.records if rec[4])
    return n / (drv.t_last - drv.t0) if n else None
