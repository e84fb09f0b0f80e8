"""``phase2_rounds``: phase-2 expansion rounds per batch over the window
(``QueryStats.exact_rounds``); each round ends in a host sync."""


def read(run):
    return run.delta.get("query.exact_rounds", 0) / run.units \
        if run.units else None
