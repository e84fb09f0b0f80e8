"""Cost accounting of the LM dry-run: per-chip step costs, the H100
roofline and the report tables."""
