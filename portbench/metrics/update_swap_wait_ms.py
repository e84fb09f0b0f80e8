"""``update_swap_wait_ms``: the mean time an update's barrier waited in
``QueryServer``'s queue, from being queued to the swap (the batches ahead
of it served first), over the window's updates
(``ServeStats.swap_wait_s / updates``)."""


def read(run):
    d = run.delta
    if not d.get("serve.updates") or "serve.swap_wait_s" not in d:
        return None
    return 1e3 * d["serve.swap_wait_s"] / d["serve.updates"]
