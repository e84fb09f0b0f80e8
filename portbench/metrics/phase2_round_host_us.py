"""``phase2_round_host_us``: phase 2's time outside its host syncs, per
phase-2 round, over the window: ``(QueryStats.phase2_s - sync_wait_s) /
exact_rounds``.  The host's own work a round (launches and Python), with
the waits for the device taken out."""


def read(run):
    d = run.delta
    if not d.get("query.exact_rounds") or "query.sync_wait_s" not in d:
        return None
    return 1e6 * (d["query.phase2_s"] - d["query.sync_wait_s"]) / \
        d["query.exact_rounds"]
