"""``update_rebuild_share``: the share of the window's updates whose
maintenance fell back to a full, layout-pinned rebuild
(``ServeStats.update_rebuilds / updates``)."""


def read(run):
    d = run.delta
    if not d.get("serve.updates") or "serve.update_rebuilds" not in d:
        return None
    return 100.0 * d["serve.update_rebuilds"] / d["serve.updates"]
