"""``phase2_fused_share``: the share of phase-2 rounds over the window that
ran as one ``class_round`` kernel launch each: ``QueryStats.fused_rounds``
over ``exact_rounds``.  A program without the counter reports nothing."""


def read(run):
    d = run.delta
    if not d.get("query.exact_rounds") or "query.fused_rounds" not in d:
        return None
    return 100.0 * d["query.fused_rounds"] / d["query.exact_rounds"]
