"""Plain NumPy reference of what the benchmark compares the program with.

Nothing here imports the program (``repro_torch``), the JAX package or
JAX.  It reads only what the benchmark generated itself: the graph's edge
arrays and the query specs.

- ``graphs``: the paper's §VI-A Erdős–Rényi generator (a frozen copy).
- ``pcr``: boolean, distance, route-count and witness answers of
  pattern-constrained reachability, by search over (vertex, label subset).
- ``rpq``: regular path queries, by search over (vertex, NFA state).
- ``tdr``: the TDR index planes of paper Alg. 1, worked out in NumPy.
"""
