"""``serve_batch_size``: requests per scheduler batch of ``QueryServer``
over the window (``ServeStats.served / batches``)."""


def read(run):
    d = run.delta
    if not d.get("serve.batches"):
        return None
    return d["serve.served"] / d["serve.batches"]
