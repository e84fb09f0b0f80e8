"""Packed-word OR closure engine — one core shared by build & query.

Everything the TDR pipeline computes — index construction (§IV Alg. 1),
vertical k-level propagation and the query-side product-graph expansion
(§V Alg. 2) — is one primitive applied in different shapes:

    out[a] = OR_{(a,b) ∈ E} x[b]

over packed int32 words (32 graph bits per word), behind two backends:

* ``segment`` — plain torch: gather the edge rows, OR-scatter them
  (``bitset.segment_or_words``).  Any device, any graph size.
* ``matmul`` — the packed adjacency bit-matrix (``[V, ceil(V/32)]``, bit j
  of row i == edge i→j) through ``kernels.ops``: the hand-written CUDA
  kernels on a card, their plain versions on the CPU.  Dense ``V×V/8``
  bytes, held to a cap (``Engine.dense_cap``): on a card an operand over
  it raises ``DenseCapError``; on the CPU the work falls back to
  ``segment`` with a ``DenseCapWarning``.

``"auto"`` resolves to ``matmul`` on CUDA and ``segment`` on the CPU; the
``REPRO_ENGINE_BACKEND`` environment variable replaces that default (never a
backend that was asked for by name).  Both backends are bit-exact against
each other and against the JAX package.
Each fixpoint is a Python loop with one host sync per round (the JAX
package runs one device ``while_loop``); converged planes and round counts
are the same.

``propagate`` and ``closure`` take a semiring (``sr=``, default
``BOOLEAN``): lane carriers (DIST16/DIST8/COUNT, ``repro_torch.semiring``)
run ``lane_matmul`` on ``matmul`` and a gather plus a lane scatter
reduction on ``segment``, always through the dense cores.

The mesh-aware primitives (``all_gather_words``, ``propagate_sharded``,
``closure_sharded``, ``closure_sharded_delta``) run the same rounds
vertex-sharded, one process per shard (``repro_torch.distributed``).
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from . import bitset
from .bitset import resolve_device  # noqa: F401  (re-exported)
from .compressed import BlockCompressed, compress_blocks, patch_blocks
from .graph import Graph, csr_row_edges
from .kernels import _build, ops
from .semiring import BOOLEAN, Semiring

ENV_BACKEND = "REPRO_ENGINE_BACKEND"
BACKENDS = ("segment", "matmul")
CPU_DENSE_BYTES = 1 << 28   # the JAX package's max_dense_bytes default

# label-class stacks packed by ``Engine.label_class_adjacency`` (its LRU's
# misses), across every engine of this process
LABEL_CLASS_PACKS: collections.Counter = collections.Counter()


class DenseCapWarning(UserWarning):
    """On the CPU, a dense operand would exceed the dense cap; the work
    runs on the segment path instead."""


class DenseCapError(RuntimeError):
    """On a card, a dense matmul operand does not fit: the card path
    launches its kernels or raises, it never falls back."""


def resolve_backend(requested: str | None, device: torch.device) -> str:
    """``"auto"``/None -> ``REPRO_ENGINE_BACKEND`` when it is set, else
    ``matmul`` on CUDA and ``segment`` on the CPU.  The variable replaces
    the default only: a backend asked for by name always wins, so backend
    sweeps and equality checks cannot be collapsed onto one backend by the
    environment."""
    req = requested or "auto"
    if req == "auto":
        req = os.environ.get(ENV_BACKEND, "").strip() or "auto"
    if req == "auto":
        return "matmul" if device.type == "cuda" else "segment"
    if req not in BACKENDS:
        raise ValueError(f"unknown engine backend {req!r}; expected one of "
                         f"{('auto',) + BACKENDS}")
    return req


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    backend: str = "auto"        # "auto" | "segment" | "matmul"
    bit_chunk: int = 64          # transient chunk width (bits) for segment ORs
    max_dense_bytes: int | None = None  # dense-operand cap (Engine.dense_cap)
    sparse: bool = True          # block-sparse / frontier closure fixpoints
    block_rows: int = 8          # row-block height of the block-sparse operand
    block_words: int = 1         # word-block width  (8x1 = 8x32-bit blocks)
    sparse_dense_frac: float = 0.5  # segment: frontier fraction -> dense round

    @property
    def chunk_words(self) -> int:
        return max(1, self.bit_chunk // bitset.WORD)


# ------------------------------------------------------- adjacency packing
def pack_adjacency_np(graph: Graph, *, reverse: bool = False) -> np.ndarray:
    """Packed adjacency bit-matrix uint32 ``[V, ceil(V/32)]``.

    Forward: bit v of row u == edge u→v.  Reverse: bit u of row v == edge
    u→v."""
    v_n = graph.n_vertices
    kw = bitset.n_words(v_n)
    a = np.zeros((v_n, kw), dtype=np.uint32)
    src, dst = graph.src, graph.indices
    rows, cols = (dst, src) if reverse else (src, dst)
    bitset.set_bits_np(a, (rows,), cols)
    return a


def pack_label_class_edges_np(src: np.ndarray, dst: np.ndarray,
                              labels: np.ndarray, n_vertices: int,
                              special_labels, *,
                              reverse: bool = True) -> np.ndarray:
    """Per-label-class packed adjacency ``[C+1, V, ceil(V/32)]`` from raw
    edge arrays: one bit-matrix per *special* label (required or forbidden
    by some pending query) plus a final neutral class OR-ing every other
    edge (always allowed, identity transition for every query)."""
    kw = bitset.n_words(n_vertices)
    special = list(special_labels)
    out = np.zeros((len(special) + 1, n_vertices, kw), dtype=np.uint32)
    rows, cols = (dst, src) if reverse else (src, dst)
    cls = np.full(labels.shape[0], len(special), dtype=np.int64)
    for i, l in enumerate(special):
        cls[labels == l] = i
    bitset.set_bits_np(out, (cls, rows), cols)
    return out


# --------------------------------------------------------------- closures
def _matmul_rows(adj: torch.Tensor, x: torch.Tensor,
                 sr: Semiring = BOOLEAN) -> torch.Tensor:
    """``(+)_j adj[i,j] (x) x[j]`` with x's rows zero-padded to adj's bit
    width (pad rows carry no adjacency bits, so they never select).  Lane
    carriers apply ``sr.extend`` after the reduce; min is monotone, so
    that equals extending before it."""
    k = adj.shape[1] * bitset.WORD
    if x.shape[0] < k:
        x = torch.cat([x, x.new_zeros((k - x.shape[0],) + x.shape[1:])])
    if sr.packed:
        return ops.frontier_step(adj, x)
    return sr.extend(ops.frontier_step_lanes(adj, x, op=sr.op, cap=sr.cap))


def _fixpoint(base: torch.Tensor, step, max_iters: int,
              sr: Semiring = BOOLEAN):
    """lfp(R = base (+) step(R)) with the reference's round count: a round
    runs while the previous one changed R, and the round that changes
    nothing is counted."""
    r, rounds, changed = base, 0, True
    while changed and rounds < max_iters:
        r, ch = sr.accumulate(r, step(r))
        changed = bool(ch)
        rounds += 1
    return r, rounds


def _closure_blocksparse(base: torch.Tensor, comp: BlockCompressed,
                         max_iters: int):
    """Delta-form fixpoint over the block-compressed adjacency: each round
    expands only the newly set rows.  OR distributes, so ``R ∨ A⊗new``
    reaches the same fixpoint as ``R ∨ A⊗R`` in the same rounds, while the
    frontier's k-blocks go dark and the kernel skips them."""
    r, new, rounds, changed = base, base, 0, True
    while changed and rounds < max_iters:
        nxt = ops.frontier_step_sparse(comp, new) & ~r
        r = r | nxt
        new = nxt
        changed = bool((nxt != 0).any())
        rounds += 1
    return r, rounds


# ------------------------------------------------- mesh-aware primitives
# These run on every rank of a ``distributed.ShardMesh`` at once (SPMD: one
# process per shard).  The vertex dimension is split into contiguous blocks
# of ``per`` rows, rank s owning block s, and the only traffic between
# ranks is the all-gather of packed int32 words plus one int32 flag per
# fixpoint round.  Every rank calls every collective in the same order.


def _on_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` made contiguous; raises unless it lives on the mesh's device
    (the collectives never move a tensor between devices)."""
    if x.device.type != mesh.device.type or (
            x.device.index is not None and mesh.device.index is not None
            and x.device.index != mesh.device.index):
        raise ValueError(f"a tensor on {x.device} cannot cross a mesh on "
                         f"{mesh.device}")
    return x.contiguous()


def all_gather_words(x_local: torch.Tensor, mesh) -> torch.Tensor:
    """Gather every rank's packed int32 block ``[per, W]`` into the full
    table ``[size·per, W]``, rank-major (rank s's rows at ``s·per``)."""
    x = _on_mesh(x_local, mesh)
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x, group=mesh.group)
    return out


def all_reduce_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """Elementwise max of an int32 tensor over the ranks (in place; also
    returned).  An OR of 0/1 flags and answers, a max of round counts."""
    if x.dtype != torch.int32:
        raise TypeError(f"all_reduce_max takes int32, got {x.dtype}")
    _on_mesh(x, mesh)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return x


def propagate_sharded(x_local: torch.Tensor, gather_idx: torch.Tensor,
                      scatter_idx: torch.Tensor, valid_words: torch.Tensor,
                      mesh, *, num_segments: int,
                      chunk_words: int) -> torch.Tensor:
    """One sharded round ``out[a] = OR_{(a,b)} x[b]`` over packed words.

    ``gather_idx`` holds the *global* remote endpoint of each edge this
    rank owns (it indexes the gathered table), ``scatter_idx`` the owned
    endpoint as a local row, and ``valid_words`` ``[e_max, 1]`` all-ones
    or all-zeros int32 words that zero the padding slots."""
    full = all_gather_words(x_local, mesh)
    vals = full[gather_idx] & valid_words
    return bitset.segment_or_words(vals, scatter_idx,
                                   num_segments=num_segments,
                                   chunk_words=chunk_words)


def _any_across(mask: torch.Tensor, mesh) -> bool:
    """Whether ``mask`` holds a True on any rank (one int32 all-reduce)."""
    flag = mask.any().to(torch.int32).reshape(1)
    return bool(all_reduce_max(flag, mesh).item())


def closure_sharded(base: torch.Tensor, step, mesh, *, max_iters: int):
    """lfp(R = base ∨ step(R)) over this rank's rows; returns (R, rounds).

    The changed flag is the round's own new bits (``upd & ~r``), reduced
    over the ranks every round, so every rank stops at the same round.
    Rounds count as ``_fixpoint`` counts them: the round that changes
    nothing is counted."""
    r, rounds, changed = base, 0, True
    while changed and rounds < max_iters:
        new = step(r) & ~r
        changed = _any_across(new != 0, mesh)
        r = r | new
        rounds += 1
    return r, rounds


def closure_sharded_delta(base: torch.Tensor, gather_idx: torch.Tensor,
                          scatter_idx: torch.Tensor,
                          valid_words: torch.Tensor, mesh, *, per: int,
                          v_pad: int, chunk_words: int, row_budget: int,
                          max_iters: int):
    """Delta-row exchange fixpoint: ship changed rows, not the table.

    Each rank keeps a pending bitmap of its rows that carry bits the other
    ranks have not seen, and per round ships exactly ``budget`` slots of
    ``(global id, packed row)`` as one int32 ``[budget, 1 + W]`` block:
    its first ``budget`` pending rows in ascending order, the rest padded
    with the sentinel id ``v_pad`` and a zero row.  Receivers scatter the
    shipped rows into a zeroed table and run the ordinary local OR
    reduction.  A row left over when the budget binds ships on a later
    round, and a row that changes after shipping becomes pending again,
    so the result equals ``closure_sharded``'s for any budget >= 1 (the
    OR fixpoint is unique); a binding budget only adds rounds.  Stops
    when no rank has a pending row.  Returns ``(R, rounds)``."""
    dev = base.device
    budget = min(row_budget, per)
    w = base.shape[1]
    row0 = mesh.rank * per
    lane = torch.arange(per, dtype=torch.int32, device=dev)
    zero_row = base.new_zeros((1, w))
    r, rounds, changed = base, 0, True
    pend = (base != 0).any(dim=1)
    while changed and rounds < max_iters:
        ship = torch.where(pend, lane, per).sort().values[:budget].long()
        live = ship < per
        payload = torch.cat([r, zero_row])[ship]        # sentinel: zero row
        gid = torch.where(live, ship + row0, v_pad).to(torch.int32)
        slots = all_gather_words(torch.cat([gid[:, None], payload], dim=1),
                                 mesh)                   # [S·budget, 1 + W]
        # real ids are distinct within a round (a row ships only from its
        # owner); every sentinel slot writes the same zero row
        tbl = torch.zeros((v_pad + 1, w), dtype=r.dtype, device=dev)
        tbl[slots[:, 0].long()] = slots[:, 1:]
        upd = bitset.segment_or_words(
            tbl[:v_pad][gather_idx] & valid_words, scatter_idx,
            num_segments=per, chunk_words=chunk_words)
        new = upd & ~r
        shipped = torch.zeros(per + 1, dtype=torch.bool, device=dev)
        shipped[ship] = True
        pend = (pend & ~shipped[:per]) | (new != 0).any(dim=1)
        changed = _any_across(pend, mesh)
        r = r | new
        rounds += 1
    return r, rounds


# ------------------------------------------------------------------ engine
class Engine:
    """OR-semiring propagation over one graph, packed words in and out, on
    one device.  Holds the edge lists and (for ``matmul``) the packed and
    block-compressed adjacencies, so build and query calls reuse them."""

    # distinct special-label sets whose class matrices stay resident; each
    # costs (C+1) dense adjacencies, so the cache is a small LRU
    LABEL_ADJ_CACHE = 4

    def __init__(self, graph: Graph, config: EngineConfig = EngineConfig(),
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self._attach(graph)
        backend = resolve_backend(config.backend, self.device)
        if backend == "matmul" and not self.dense_fits(
                graph.n_vertices * bitset.n_words(graph.n_vertices) * 4,
                "the dense adjacency"):
            backend = "segment"
        self.backend = backend

    def _attach(self, graph: Graph) -> None:
        """Set what belongs to one graph: the graph, its edge lists on the
        device, and empty operand caches."""
        self.graph = graph
        self._adj: dict[bool, torch.Tensor] = {}
        self._bcomp: dict[bool, BlockCompressed] = {}
        # an OrderedDict: move_to_end refreshes an entry in one step, so a
        # reader on another thread never sees it missing
        self._label_adj: collections.OrderedDict[tuple, torch.Tensor] = \
            collections.OrderedDict()
        self._rev_graph: Graph | None = None
        self.edge_src = torch.from_numpy(graph.src.astype(np.int64)).to(
            self.device)
        self.edge_dst = torch.from_numpy(graph.indices.astype(np.int64)).to(
            self.device)

    # ---------------------------------------------------------- dense cap
    def dense_cap(self) -> int:
        """Bytes a new dense matmul operand may take: ``max_dense_bytes``
        when set; else, on a card, what it can still allocate (free device
        memory plus what torch's allocator holds unused); on the CPU the
        JAX package's 256 MiB."""
        if self.config.max_dense_bytes is not None:
            return self.config.max_dense_bytes
        if self.device.type != "cuda":
            return CPU_DENSE_BYTES
        free, _ = torch.cuda.mem_get_info(self.device)
        return (free + torch.cuda.memory_reserved(self.device)
                - torch.cuda.memory_allocated(self.device))

    def dense_fits(self, nbytes: int, what: str) -> bool:
        """Whether a dense operand of ``nbytes`` may be built.  Over the
        cap, on a card: drop the resident label-class stacks (a cache) and
        raise ``DenseCapError`` if that does not make room; on the CPU:
        warn and return False, and the caller takes the segment path."""
        if nbytes <= self.dense_cap():
            return True
        msg = (f"engine: {what} needs {nbytes / 1e6:.0f} MB, over the dense "
               f"cap of {self.dense_cap() / 1e6:.0f} MB")
        if self.device.type == "cuda":
            self._drop_label_stacks(len(self._label_adj))
            if nbytes <= self.dense_cap():
                return True
            raise DenseCapError(msg + "; pass backend='segment' to run "
                                "without the matmul kernels")
        warnings.warn(msg + "; running it on the segment path",
                      DenseCapWarning, stacklevel=3)
        return False

    # ------------------------------------------------------------ operands
    def adjacency(self, *, reverse: bool = False) -> torch.Tensor:
        """Cached packed adjacency bit-matrix int32 ``[V, ceil(V/32)]``."""
        if reverse not in self._adj:
            self._adj[reverse] = bitset.np_to_words(
                pack_adjacency_np(self.graph, reverse=reverse), self.device)
        return self._adj[reverse]

    def block_adjacency(self, *, reverse: bool = False) -> BlockCompressed:
        """Cached block-compressed adjacency (the sparse-closure operand)."""
        if reverse not in self._bcomp:
            self._bcomp[reverse] = compress_blocks(
                pack_adjacency_np(self.graph, reverse=reverse),
                br=self.config.block_rows, bw=self.config.block_words,
                nbits=self.graph.n_vertices, device=self.device)
        return self._bcomp[reverse]

    def label_class_adjacency(self, special_labels, *,
                              reverse: bool = True) -> torch.Tensor:
        """Per-label-class adjacency ``[C+1, V, Kw]`` (LRU-cached).

        ``reverse=True`` (bit j of row i == edge j→i) drives forward
        frontier expansion; ``reverse=False`` the backward frontier."""
        labels = tuple(sorted(set(int(l) for l in special_labels)))
        key = (labels, reverse)
        if key in self._label_adj:
            self._label_adj.move_to_end(key)                 # refresh LRU
        else:
            self._drop_label_stacks(
                len(self._label_adj) - self.LABEL_ADJ_CACHE + 1)
            LABEL_CLASS_PACKS["stacks"] += 1
            g = self.graph
            packed = pack_label_class_edges_np(g.src, g.indices, g.labels,
                                               g.n_vertices, labels,
                                               reverse=reverse)
            try:
                stack = bitset.np_to_words(packed, self.device)
            except torch.OutOfMemoryError:
                # another process on the card took what dense_fits saw
                # free: make room from this cache, as dense_fits would
                self._drop_label_stacks(len(self._label_adj))
                stack = bitset.np_to_words(packed, self.device)
            self._label_adj[key] = stack
        return self._label_adj[key]

    def _drop_label_stacks(self, n: int) -> None:
        """Evict the ``n`` least recently used class stacks.  On a card
        their memory goes back to the device, not to this process's
        allocator cache: other processes sharing the card (the replicas
        of a fleet) cannot allocate from a cache they do not own."""
        if n <= 0:
            return
        for _ in range(min(n, len(self._label_adj))):
            self._label_adj.popitem(last=False)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- primitives
    def segment_or(self, values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
        """OR-reduce packed rows by arbitrary segment ids (projections)."""
        return bitset.segment_or_words(values, segment_ids,
                                       num_segments=num_segments,
                                       chunk_words=self.config.chunk_words)

    def _edges(self, reverse: bool):
        """(gather, scatter) endpoints of one propagation direction."""
        if reverse:
            return self.edge_src, self.edge_dst
        return self.edge_dst, self.edge_src

    def propagate(self, x: torch.Tensor, *, reverse: bool = False,
                  sr: Semiring = BOOLEAN) -> torch.Tensor:
        """One semiring round: ``out[a] = (+)_{(a,b)} extend(x[b])``
        (``reverse`` flips the edges).  ``sr=BOOLEAN`` is the packed OR
        round; lane carriers run one lane per column of ``x``."""
        if self.backend == "matmul":
            return _matmul_rows(self.adjacency(reverse=reverse), x, sr=sr)
        gather, scatter = self._edges(reverse)
        if sr.packed:
            return self.segment_or(x[gather], scatter, self.graph.n_vertices)
        return sr.segment_combine(sr.extend(x[gather]), scatter,
                                  num_segments=self.graph.n_vertices)

    def closure(self, base: torch.Tensor, *, reverse: bool = False,
                max_iters: int | None = None,
                sparse: bool | None = None,
                sr: Semiring = BOOLEAN) -> tuple[torch.Tensor, int]:
        """Least fixpoint ``R = base (+) propagate(R)``; returns (R, rounds).

        ``sparse`` routes the fixpoint through the block-sparse kernel
        (``matmul``) or frontier-compacted edge gathers (``segment``); both
        are bit-identical to the dense fixpoint.  The default (``None`` and
        ``EngineConfig.sparse``) engages it always on ``segment`` and on
        ``matmul`` when the engine runs on a card; on the CPU the matmul
        closure stays dense, as the reference's interpret mode does.
        ``sparse=True`` forces it anywhere.

        ``sr`` selects the semiring.  A fixpoint needs an idempotent (+),
        so COUNT is refused (route counting is the bounded DP of
        ``tdr_query.count_routes``).  Lane carriers always run the dense
        cores: the block-sparse and frontier machinery is specific to the
        packed boolean layout."""
        max_iters = max_iters or self.graph.n_vertices
        if not sr.idempotent:
            raise ValueError(
                f"closure needs an idempotent semiring, got {sr.name}; "
                "use a bounded DP (tdr_query.count_routes) instead")
        if not sr.packed:
            if self.backend == "matmul":
                adj = self.adjacency(reverse=reverse)
                return _fixpoint(base, lambda r: _matmul_rows(adj, r, sr=sr),
                                 max_iters, sr)
            return _fixpoint(
                base, lambda r: self.propagate(r, reverse=reverse, sr=sr),
                max_iters, sr)
        if sparse is None:
            sparse = self.config.sparse and (
                self.backend == "segment" or self.device.type == "cuda")
        if self.backend == "matmul":
            if sparse:
                return _closure_blocksparse(
                    base, self.block_adjacency(reverse=reverse), max_iters)
            adj = self.adjacency(reverse=reverse)
            return _fixpoint(base, lambda r: _matmul_rows(adj, r), max_iters)
        if sparse:
            return self._closure_segment_frontier(base, reverse=reverse,
                                                  max_iters=max_iters)
        return _fixpoint(base, lambda r: self.propagate(r, reverse=reverse),
                         max_iters)

    # ------------------------------------------------------------- updates
    def apply_delta(self, graph: Graph, added: np.ndarray,
                    removed: np.ndarray, *, device="cuda") -> "Engine":
        """New engine over the post-update ``graph`` (same vertex set), on
        this engine's device, with its config and resolved backend.

        ``device`` (the card by default) must be where this engine lives.
        Cached dense adjacencies are patched, not repacked: the rows whose
        edge set changed (sources for the forward matrix, destinations for
        the reverse one) are re-derived from the new CSR and written into
        a new tensor on the device.  Cached label-class stacks are patched
        the same way, class by class, so a server's pinned stacks survive
        an update without a repack.  Cached block operands go through
        ``compressed.patch_blocks``, live lists included.  This engine and
        its operands are left as they were."""
        _check_same_device(self.device, device)
        if graph.n_vertices != self.graph.n_vertices:
            raise ValueError("apply_delta requires a fixed vertex set")
        new = copy.copy(self)   # device, config and resolved backend
        new._attach(graph)
        csrs = {False: graph}

        def touched_rows(reverse: bool) -> np.ndarray:
            col = 1 if reverse else 0
            return np.unique(np.concatenate(
                [added[:, col], removed[:, col]])).astype(np.int64)

        def patched_row_bits(reverse: bool, rows: np.ndarray, kw: int,
                             labels: tuple | None = None) -> np.ndarray:
            """New bits of ``rows`` [R, kw], or per label class
            [C+1, R, kw] (the last class every other label)."""
            if reverse not in csrs:
                csrs[reverse] = graph.reverse()
            g = csrs[reverse]
            counts = (g.indptr[rows + 1] - g.indptr[rows]).astype(np.int64)
            pos = np.repeat(np.arange(rows.shape[0]), counts)
            eidx = csr_row_edges(g.indptr, rows)
            if labels is None:
                rowbits = np.zeros((rows.shape[0], kw), dtype=np.uint32)
                bitset.set_bits_np(rowbits, (pos,), g.indices[eidx])
                return rowbits
            cls = np.full(eidx.shape[0], len(labels), dtype=np.int64)
            for i, l in enumerate(labels):
                cls[g.labels[eidx] == l] = i
            rowbits = np.zeros((len(labels) + 1, rows.shape[0], kw),
                               dtype=np.uint32)
            bitset.set_bits_np(rowbits, (cls, pos), g.indices[eidx])
            return rowbits

        for reverse, adj in self._adj.items():
            rows = touched_rows(reverse)
            if rows.size == 0:
                new._adj[reverse] = adj
                continue
            rowbits = patched_row_bits(reverse, rows, adj.shape[1])
            new._adj[reverse] = adj.index_put(
                (torch.from_numpy(rows).to(self.device),),
                bitset.np_to_words(rowbits, self.device))
        # a snapshot: a server's scheduler may refresh this LRU while an
        # update is built from the engine it serves on
        for (labels, reverse), stack in list(self._label_adj.items()):
            rows = touched_rows(reverse)
            if rows.size:
                stack = stack.clone()
                stack[:, torch.from_numpy(rows).to(self.device)] = \
                    bitset.np_to_words(patched_row_bits(
                        reverse, rows, stack.shape[2], labels), self.device)
            new._label_adj[(labels, reverse)] = stack
        for reverse, comp in self._bcomp.items():
            rows = touched_rows(reverse)
            if rows.size == 0:
                new._bcomp[reverse] = comp
                continue
            new._bcomp[reverse] = patch_blocks(
                comp, rows, patched_row_bits(reverse, rows, comp.shape[1]))
        return new

    def _gather_csr(self, reverse: bool) -> Graph:
        """CSR grouped by each round's *gather* endpoint."""
        if reverse:
            return self.graph
        if self._rev_graph is None:
            self._rev_graph = self.graph.reverse()
        return self._rev_graph

    def _closure_segment_frontier(self, base: torch.Tensor, *, reverse: bool,
                                  max_iters: int) -> tuple[torch.Tensor, int]:
        """Two-stage delta fixpoint for the segment backend: dense rounds
        while the frontier covers more than ``sparse_dense_frac`` of the
        vertices, then rounds that gather only the edges incident to the
        frontier rows (falling back to a dense round if it re-widens)."""
        v = self.graph.n_vertices
        g = self._gather_csr(reverse)
        thresh = int(self.config.sparse_dense_frac * v)
        cw = self.config.chunk_words
        r, new, rounds, n_act = base, base, 0, v + 1
        # stage 1: high-occupancy rounds run dense
        while n_act > thresh and rounds < max_iters:
            new = self.propagate(r, reverse=reverse) & ~r
            n_act = int((new != 0).any(dim=-1).sum())
            r = r | new
            rounds += 1
        # stage 2: small-frontier tail over the frontier's edges only
        while rounds < max_iters:
            act = np.flatnonzero((new != 0).any(dim=-1).cpu().numpy())
            if act.size == 0:
                break
            rounds += 1
            if act.size > thresh:
                upd = self.propagate(new, reverse=reverse)
            else:
                counts = (g.indptr[act + 1] - g.indptr[act]).astype(np.int64)
                gat = np.repeat(act.astype(np.int64), counts)
                scat = g.indices[csr_row_edges(g.indptr, act)].astype(
                    np.int64)
                upd = bitset.segment_or_words(
                    new[torch.from_numpy(gat).to(self.device)],
                    torch.from_numpy(scat).to(self.device),
                    num_segments=v, chunk_words=cw)
            nxt = upd & ~r
            r = r | nxt
            new = nxt
        return r, rounds


def _check_same_device(have: torch.device, device) -> None:
    """Raise unless ``device`` (resolved; the card raises without one) is
    ``have``.  A device without an index stands for the current card, or
    for index 0 of any other type."""
    def norm(d: torch.device) -> torch.device:
        if d.index is not None:
            return d
        return torch.device(d.type, torch.cuda.current_device()
                            if d.type == "cuda" else 0)

    dev = resolve_device(device)
    if norm(dev) != norm(have):
        raise ValueError(f"operands live on {have}, asked to run on {dev}")


def jit_cache_entries() -> int:
    """What the port has materialised for a new shape or content: kernel
    library builds and loads (``kernels/_build.library``) plus label-class
    stacks packed on a miss of ``Engine.label_class_adjacency``'s LRU.

    The counterpart of the JAX package's count of compiled variants.  The
    serving layer reads its delta over a window: zero means steady traffic
    built, loaded and packed nothing new (torch itself compiles nothing
    per shape).  The class stacks make the count move on the CPU too, on
    the matmul backend."""
    return (sum(_build.LIBRARY_EVENTS.values())
            + sum(LABEL_CLASS_PACKS.values()))


def make_engine(graph: Graph, backend: str | None = None,
                config: EngineConfig | None = None,
                device="cuda") -> Engine:
    """Engine factory: ``backend`` shorthand overrides ``config.backend``."""
    cfg = config or EngineConfig()
    if backend is not None:
        cfg = dataclasses.replace(cfg, backend=backend)
    return Engine(graph, cfg, device=device)
