"""``phase2_grouped_share``: the share of the window's phase-2 chunks that
shared their ``class_round`` launches with another chunk (a lockstep
group of full-graph chunks): ``QueryStats.grouped_chunks`` over the
chunks run, full and compacted.  A program without the counter reports
nothing."""


def read(run):
    d = run.delta
    chunks = d.get("query.full_chunks", 0) + d.get("query.compacted_chunks",
                                                   0)
    if not chunks or "query.grouped_chunks" not in d:
        return None
    return 100.0 * d["query.grouped_chunks"] / chunks
