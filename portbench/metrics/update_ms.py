"""``update_ms``: the mean index maintenance of an update applied in the
window, ``ServeStats.update_s`` (the span ``serve.update``:
``update_index`` on the writer's thread, retries included) over
``updates``."""


def read(run):
    d = run.delta
    if not d.get("serve.updates") or "serve.update_s" not in d:
        return None
    return 1e3 * d["serve.update_s"] / d["serve.updates"]
