"""``phase1_decided_share``: the share of query jobs the phase-1 filter
cascade answered, FALSE or TRUE, over the window (``QueryStats``)."""


def read(run):
    d = run.delta
    if not d.get("query.n_jobs"):
        return None
    return 100.0 * (d["query.filter_false"] + d["query.filter_true"]) / \
        d["query.n_jobs"]
