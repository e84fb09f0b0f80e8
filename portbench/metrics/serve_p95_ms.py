"""``serve_p95_ms``: the 95th percentile of the latency, submit to answer,
of every request submitted in the window (those still in flight when it
closes are waited for; a failed request counts with its time)."""
import numpy as np


def read(run):
    lat = [(rec[2] - rec[1]) * 1e3 for rec in run.records]
    return float(np.percentile(lat, 95)) if lat else None
