"""``serve_batch_ms``: the mean time ``QueryServer``'s scheduler spent on
one batch, dedup to the last answer handed out, over the batches of the
window (``ServeStats.batch_s / batches``)."""


def read(run):
    d = run.delta
    if not d.get("serve.batches") or "serve.batch_s" not in d:
        return None
    return 1e3 * d["serve.batch_s"] / d["serve.batches"]
