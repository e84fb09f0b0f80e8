"""The paper's own engine config: distributed TDR index build dry-run.

Production sizing: a twitter-scale digraph (|V|=42M, |E|=632M) with 256-bit
Bloom ways, vertex-partitioned over the full mesh.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class TDRGraphConfig:
    name: str = "tdr-graph"
    n_vertices: int = 41_652_231         # twitter (paper Table II)
    n_edges: int = 632_007_285
    vtx_bits: int = 256
    rounds: int = 16                     # fixpoint rounds lowered


CONFIG = TDRGraphConfig()
