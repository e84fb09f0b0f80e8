"""``phase2_syncs``: host reads of the phase-2 round loops' flags per
batch over the window (``QueryStats.host_syncs``); each waits for the
device's queued rounds."""


def read(run):
    d = run.delta
    if not run.units or "query.host_syncs" not in d:
        return None
    return d["query.host_syncs"] / run.units
