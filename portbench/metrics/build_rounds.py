"""``build_rounds``: fixpoint rounds of the last timed build's closure
(``TDRIndex.fixpoint_rounds``)."""


def read(run):
    rounds = run.driver.after.get("fixpoint_rounds")
    return float(rounds) if isinstance(rounds, int) else None
