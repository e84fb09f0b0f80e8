"""``phase2_operand_mb``: the class operand the window's phase-2 rounds
were given, in megabytes a round: ``QueryStats.operand_bytes`` (each
``class_round`` launch's edge lists, row pointers, columns and labels,
per active direction) over ``exact_rounds``.  A program without the counter
reports nothing."""


def read(run):
    d = run.delta
    if not d.get("query.exact_rounds") or "query.operand_bytes" not in d:
        return None
    return d["query.operand_bytes"] / d["query.exact_rounds"] / 1e6
