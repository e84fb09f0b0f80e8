"""``class_stack_mb``: the label-class stacks made in the window, in device
megabytes per applied update: those packed (``LABEL_CLASS_PACKS["bytes"]``:
the engine LRU's misses and the compacted chunks' own packs) and those
copied on the device to be patched (``["copied_bytes"]``:
``Engine.apply_delta``), over ``ServeStats.updates``."""


def read(run):
    d = run.delta
    if not d.get("serve.updates") or "class_packs.bytes" not in d:
        return None
    made = d["class_packs.bytes"] + d.get("class_packs.copied_bytes", 0)
    return made / 1e6 / d["serve.updates"]
