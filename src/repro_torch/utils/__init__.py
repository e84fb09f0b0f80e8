"""Cost accounting of the LM dry-run (per-chip step costs, the H100
roofline and the report tables), and the spans and loop-sync counters of
the port's host work (``spans``)."""
