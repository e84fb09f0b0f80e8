"""``build_host_ms``: the host precompute of the last timed build: its DFS
forest, hash layout and way routing, and the engine's packing of the
adjacency operands (``TDRIndex.build_stats``: ``dfs_s + layout_s +
pack_s``)."""


def read(run):
    st = getattr(getattr(run.driver, "index", None), "build_stats", None)
    if st is None:
        return None
    return 1e3 * (st.dfs_s + st.layout_s + st.pack_s)
