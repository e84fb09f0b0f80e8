"""``serve_queue_wait_ms``: the mean time a request waited in
``QueryServer``'s queue, from ``submit`` to the scheduler taking it off,
over the window (``ServeStats.queue_wait_s / dequeued``)."""


def read(run):
    d = run.delta
    if not d.get("serve.dequeued") or "serve.queue_wait_s" not in d:
        return None
    return 1e3 * d["serve.queue_wait_s"] / d["serve.dequeued"]
