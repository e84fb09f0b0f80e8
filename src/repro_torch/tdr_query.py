"""Answering boolean PCR queries with the TDR index (paper §V, Alg. 2).

A planner/executor split, batched over the whole query set, on packed int32
words through ``repro_torch.engine``:

Planner — ``compile_queries`` flattens DNF terms into a ``QueryPlan``:
packed required/forbidden label-slot planes, packed raw forbidden-label
rows and padded required-label ids.  Per-pattern rows are cached on the
index keyed by the canonical pattern (``pattern_rows``).

Phase 1 — *filter cascade* (index math only, ``_filter_cascade``):
``u == v`` with no required label is TRUE; a Bloom miss in ``N_out(u)`` or
``N_in(v)`` is FALSE; a DFS-interval ancestor with an unconstrained term is
TRUE; the per-way group predicate (the ``way_filter`` kernel through
``kernels.ops.filter_ways_at``, which reads the index rows itself)
refutes the rest or leaves them UNKNOWN.

Phase 2 — *corridor-compacted bidirectional expansion* for the UNKNOWN
jobs, in chunks of ``exact_chunk`` jobs.  A chunk whose Bloom corridor
``N_out(u) ∩ N_in(v)`` union is small runs on the induced subgraph,
renumbered and padded onto the ``{2^k, 3·2^(k-1)}`` grid; near-total
corridors run on the full graph.  Forward states (vertex, seen
required-subset) expand from ``u`` while backward states expand from
``v``, both as ``[V', Q]`` packed subset bitfields; a query finishes when
some vertex holds forward state s₁ and backward state s₂ with
``s₁ | s₂ == full_mask``.  One round is, on the ``matmul`` backend, one
``class_round`` kernel launch over each direction's per-row edge lists
(every edge's subset transition in both directions, the corridor mask
and the meet), and a batch's full-graph chunks share it: they run side
by side as one lockstep group, one launch and one host read a round,
each chunk stopping on its own rule; on ``segment``, a gather, a
per-edge subset transition and an OR over padded incidence rows.

``exact_mode="legacy"`` keeps the first phase-2 executor: one direction
from ``u`` over the full graph until every target state is reached (on
``matmul`` one ``bitset_matmul`` per label class per round).

The expansion is exact (the corridor is a superset of every u→v path), so
answers equal the DFS oracle bit for bit.  Every loop is a Python loop
with one host sync per round; plan shapes, round counts and ``QueryStats``
equal the JAX package's.  Each phase, the plan compile, the class-stack
preparation, the edge reductions and every loop's host sync is a span of
``utils/spans`` (``repro_torch.query.*``, ``repro_torch.sync``).

The other query kinds (``QUERY_KINDS``) run lane DPs over the same
corridor-compacted subgraphs, at the bottom of this module: ``dist_batch``
/ ``dist`` (shortest pattern-constrained hop distance, a bidirectional
(min, +) fixpoint; on ``matmul`` one ``lane_matmul`` per label class per
direction per round), ``witness`` (an actual shortest path) and
``count_routes`` (bounded, saturating walk counts), and ``answer_mixed``
routes a batch of mixed kinds.  Regular path queries (``rpq_batch``) run
the same bidirectional expansion over NFA states instead of subset
states; on ``matmul`` one ``bitset_matmul`` per label class per direction
per round.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import bitset
from . import engine as engine_mod
from . import graph as graph_mod
from . import pattern as pat
from . import rpq as rpq_mod
from . import dfs_baseline as dfs_mod
from .compressed import edge_lists
from .kernels import ops, ref
from .semiring import COUNT_CAP, DIST16, narrow, widen
from .tdr_build import TDRIndex, _null_words
from .utils import spans

FALSE, TRUE, UNKNOWN = 0, 1, 2

#: phase-2 executors of the other kinds (``dist_batch``, ``witness``,
#: ``count_routes``, ``rpq_batch``)
KIND_MODES = ("auto", "compact", "full")
#: phase-2 executors of boolean answers: the kinds' plus "legacy", the
#: retained one-directional full-graph executor
EXACT_MODES = KIND_MODES + ("legacy",)

#: query kinds the planner accepts (one per query): boolean reachability,
#: shortest pattern-constrained hop distance, an actual witness path,
#: bounded route counting, and regular path queries.  ``answer_plan``
#: serves "bool"; ``dist_batch`` / ``witness`` / ``count_routes`` the
#: next three; "rpq" queries carry a regex AST instead of a pattern.
QUERY_KINDS = ("bool", "dist", "witness", "count", "rpq")


def _i32(x: int) -> int:
    """The int32 with the low 32 bits of the non-negative int ``x``."""
    return x - (1 << 32) if x >= 1 << 31 else x


# ------------------------------------------------------------------ plans
@dataclasses.dataclass
class QueryPlan:
    """Planner output: one flattened DNF-term job per row, packed planes.

    ``req_w``/``forb_w`` are label-*slot* planes (the index's Bloom space,
    used by the filter cascade); ``forb_raw_w`` is packed over raw label
    ids — the executor's edge-forbid test must be exact."""
    qid: np.ndarray         # int32 [J] query id (-1 = padding row)
    u: np.ndarray           # int32 [J]
    v: np.ndarray           # int32 [J]
    req_w: np.ndarray       # uint32 [J, Wl]   required label-slot plane
    forb_w: np.ndarray      # uint32 [J, Wl]   forbidden label-slot plane
    forb_raw_w: np.ndarray  # uint32 [J, WL]   raw forbidden labels (packed)
    req_labels: np.ndarray  # int32 [J, max_m] raw required ids, -1 padded
    full_mask: np.ndarray   # int32 [J]        target subset state
    n_queries: int
    max_m: int
    # per-query kind (one of QUERY_KINDS); () means all "bool"
    kinds: tuple = ()

    @property
    def n_jobs(self) -> int:
        return int(self.qid.shape[0])

    def pad_to(self, jp: int) -> "QueryPlan":
        """Pad the job axis (padding rows: qid=-1 self-queries, empty
        pattern -> TRUE in the cascade but never landing in answers)."""
        j = self.n_jobs
        if jp <= j:
            return self
        p = jp - j

        def zrows(a):
            return np.concatenate(
                [a, np.zeros((p,) + a.shape[1:], dtype=a.dtype)])

        return QueryPlan(
            qid=np.concatenate([self.qid, np.full(p, -1, np.int32)]),
            u=zrows(self.u), v=zrows(self.v),
            req_w=zrows(self.req_w), forb_w=zrows(self.forb_w),
            forb_raw_w=zrows(self.forb_raw_w),
            req_labels=np.concatenate(
                [self.req_labels, np.full((p, self.max_m), -1, np.int32)]),
            full_mask=zrows(self.full_mask),
            n_queries=self.n_queries, max_m=self.max_m, kinds=self.kinds)


@dataclasses.dataclass
class QueryStats:
    n_queries: int = 0
    n_jobs: int = 0
    filter_false: int = 0
    filter_true: int = 0
    exact_jobs: int = 0
    plan_lookups: int = 0      # pattern-plan cache probes (compile_queries)
    plan_misses: int = 0       # ... that had to run DNF + plane scatters
    # query ids that reached phase 2 in the last answer_plan call
    exact_qids: list = dataclasses.field(default_factory=list, repr=False)
    corridor_active: int = 0   # Σ |V'| over dispatched phase-2 chunks
    corridor_total: int = 0    # Σ |V|  over dispatched phase-2 chunks
    compacted_chunks: int = 0  # phase-2 chunks run on an induced subgraph
    full_chunks: int = 0       # phase-2 chunks run on the full graph
    saturated_chunks: int = 0  # chunks whose probe the summaries answered
    phase1_s: float = 0.0      # planner + filter cascade wall time
    phase2_s: float = 0.0      # exact expansion wall time
    # phase-2 round loops' host reads of their flags, and the seconds the
    # host waited in them (the device's queued rounds finishing)
    host_syncs: int = 0
    sync_wait_s: float = 0.0
    # phase-2 rounds that ran as one ``class_round`` kernel launch each
    fused_rounds: int = 0
    # bytes of edge lists (row pointers, columns and labels) the
    # ``class_round`` launches were given, per active direction
    operand_bytes: int = 0
    # chunks that shared their ``class_round`` launches with another chunk
    # (a lockstep group of full-graph chunks)
    grouped_chunks: int = 0
    _round_parts: list = dataclasses.field(default_factory=list, repr=False)

    def add_chunk(self, rounds: int, syncs: int, wait_s: float,
                  n_active: int, v_total: int,
                  compacted: bool | None = None, fused_rounds: int = 0,
                  operand_bytes: int = 0, grouped: bool = False) -> None:
        """Fold one phase-2 chunk's counters in.  ``compacted`` None (the
        lane kinds) counts the chunk as neither compacted nor full.  A
        lockstep group's syncs and operand bytes come in with its first
        chunk."""
        self._round_parts.append(rounds)
        self.grouped_chunks += grouped
        self.host_syncs += syncs
        self.sync_wait_s += wait_s
        self.corridor_active += n_active
        self.corridor_total += v_total
        self.fused_rounds += fused_rounds
        self.operand_bytes += operand_bytes
        if compacted is not None:
            self.compacted_chunks += compacted
            self.full_chunks += not compacted

    @property
    def exact_rounds(self) -> int:
        return int(sum(self._round_parts))

    @property
    def corridor_occupancy(self) -> float:
        """Mean |V'|/|V| over phase-2 chunks (1.0 when nothing compacted)."""
        if not self.corridor_total:
            return 1.0
        return self.corridor_active / self.corridor_total


class PatternRows(NamedTuple):
    """Per-pattern compiled plan rows (one row per DNF term) — everything
    in a ``QueryPlan`` that does not depend on the endpoints."""
    req_w: np.ndarray       # uint32 [T, Wl]
    forb_w: np.ndarray      # uint32 [T, Wl]
    forb_raw_w: np.ndarray  # uint32 [T, WL]
    req_labels: np.ndarray  # int32 [T, max_m]
    full_mask: np.ndarray   # int32 [T]

    @property
    def n_terms(self) -> int:
        return int(self.full_mask.shape[0])


PLAN_CACHE_CAP = 4096   # canonical patterns retained per index

# guards the per-index plan-cache dicts (LRU pop/reinsert is not atomic)
_plan_cache_lock = threading.Lock()


def _compile_pattern_rows(index: TDRIndex, p: pat.Pattern,
                          max_m: int) -> PatternRows:
    """Compile one pattern's DNF terms into packed plan rows."""
    cfg = index.cfg
    wl = bitset.n_words(cfg.lab_bits)
    wraw = bitset.n_words(max(index.graph.n_labels, 1))
    terms = pat.to_dnf(p)
    t_n = len(terms)
    req_w = np.zeros((t_n, wl), dtype=np.uint32)
    forb_w = np.zeros((t_n, wl), dtype=np.uint32)
    forb_raw_w = np.zeros((t_n, wraw), dtype=np.uint32)
    req_labels = np.full((t_n, max_m), -1, dtype=np.int32)
    full_mask = np.zeros(t_n, dtype=np.int32)
    req_j, req_l, forb_j, forb_l = [], [], [], []
    for j, term in enumerate(terms):
        if len(term.require) > max_m:
            raise ValueError(
                f"term with {len(term.require)} required labels exceeds "
                f"max_m={max_m}; decompose the pattern")
        rl = sorted(term.require)
        req_j += [j] * len(rl); req_l += rl
        forb_j += [j] * len(term.forbid); forb_l += sorted(term.forbid)
        req_labels[j, :len(rl)] = rl
        full_mask[j] = (1 << len(rl)) - 1
    if req_j:
        rj = np.asarray(req_j); rl = np.asarray(req_l, np.int64)
        bitset.set_bits_np(req_w, (rj,), index.lab_slot[rl])
    if forb_j:
        fj = np.asarray(forb_j); fl = np.asarray(forb_l, np.int64)
        bitset.set_bits_np(forb_w, (fj,), index.lab_slot[fl])
        bitset.set_bits_np(forb_raw_w, (fj,), fl)
    return PatternRows(req_w, forb_w, forb_raw_w, req_labels, full_mask)


def pattern_rows(index: TDRIndex, p: pat.Pattern, max_m: int = 4,
                 stats: "QueryStats | None" = None,
                 kind: str = "bool") -> PatternRows:
    """Cached plan rows for one pattern (canonical-key LRU on the index);
    ``stats`` counts the lookup and the miss, if any.  ``kind`` partitions
    the LRU per query kind, as the serving layer keys its result cache:
    the rows are the same, but one kind's traffic never refreshes or
    evicts another's entries."""
    return _cached_rows(
        index, (pat.canonical_key(p), max_m, kind), stats,
        lambda: _compile_pattern_rows(index, pat.canonicalize(p), max_m))


def _cached_rows(index: TDRIndex, key: tuple, stats, compile_fn):
    """The index's plan-row LRU: ``key``'s entry, or ``compile_fn()``'s
    result stored under it (compiled outside the lock).  ``stats`` counts
    the lookup and the miss, if any."""
    if stats is not None:
        stats.plan_lookups += 1
    cache = index._plan_cache
    with _plan_cache_lock:
        rows = cache.get(key)
        if rows is not None:
            cache[key] = cache.pop(key)     # refresh LRU position
            return rows
    if stats is not None:
        stats.plan_misses += 1
    rows = compile_fn()
    with _plan_cache_lock:
        while len(cache) >= PLAN_CACHE_CAP:
            cache.pop(next(iter(cache)))
        cache[key] = rows
    return rows


def compile_queries(index: TDRIndex,
                    queries: Sequence[tuple[int, int, pat.Pattern]],
                    max_m: int = 4,
                    stats: "QueryStats | None" = None) -> QueryPlan:
    """Compile (u, v, pattern[, kind]) tuples into a ``QueryPlan``.  The
    optional fourth element is one of ``QUERY_KINDS`` (default "bool"); it
    does not change the plan rows, only which executor serves the query."""
    with spans.span("query.compile"):
        cfg = index.cfg
        wl = bitset.n_words(cfg.lab_bits)
        wraw = bitset.n_words(max(index.graph.n_labels, 1))
        kinds = []
        for q in queries:
            kind = q[3] if len(q) > 3 else "bool"
            if kind not in QUERY_KINDS:
                raise ValueError(
                    f"unknown query kind {kind!r}; expected one of "
                    f"{QUERY_KINDS}")
            if kind == "rpq":
                raise ValueError(
                    "kind='rpq' queries carry a regex AST, not a pattern; "
                    "route them through answer_mixed")
            kinds.append(kind)
        queries = [(q[0], q[1], q[2]) for q in queries]
        rows_per_q = [pattern_rows(index, p, max_m, stats=stats)
                      for (_, _, p) in queries]
        counts = np.asarray([r.n_terms for r in rows_per_q], dtype=np.int64)

        def cat(name, empty_cols):
            parts = [getattr(r, name) for r in rows_per_q if r.n_terms]
            if not parts:
                dt = np.int32 if name in ("req_labels", "full_mask") else \
                    np.uint32
                shape = (0,) if name == "full_mask" else (0, empty_cols)
                return np.zeros(shape, dtype=dt)
            return np.concatenate(parts)

        uv = np.asarray([(u, v) for (u, v, _) in queries],
                        dtype=np.int32).reshape(len(queries), 2)
        qid = np.repeat(np.arange(len(queries), dtype=np.int32), counts)
        return QueryPlan(
            qid=qid,
            u=np.repeat(uv[:, 0], counts),
            v=np.repeat(uv[:, 1], counts),
            req_w=cat("req_w", wl), forb_w=cat("forb_w", wl),
            forb_raw_w=cat("forb_raw_w", wraw),
            req_labels=cat("req_labels", max_m),
            full_mask=cat("full_mask", 0),
            n_queries=len(queries), max_m=max_m,
            kinds=tuple(kinds) if any(k != "bool" for k in kinds) else ())


# ---------------------------------------------------------------- phase 1
def _filter_cascade(u, v, req_w, forb_w, null_w, vtx_packed, h_vtx, h_lab,
                    v_vtx, v_lab, n_out, n_in, sat_out, sat_in, push, pop):
    """Vectorised filter cascade -> verdict int [J] in {FALSE, TRUE,
    UNKNOWN}.  ``sat_out``/``sat_in`` are the level-1 summaries of the
    compressed ``N_out``/``N_in``: a saturated row answers its membership
    test without the word-level containment."""
    vbits = vtx_packed[v]            # [J, Wv]
    ubits = vtx_packed[u]

    req_empty = (req_w == 0).all(dim=-1)
    forb_empty = (forb_w == 0).all(dim=-1)

    same = u == v                    # u == v: the empty path
    true_same = same & req_empty

    # global membership filters (sound negatives), summary first
    topo_out = sat_out[u] | bitset.words_contain(n_out[u], vbits)
    topo_in = sat_in[v] | bitset.words_contain(n_in[v], ubits)
    topo_maybe = topo_out & topo_in

    # interval: DFS-forest ancestor => reachable (sound positive)
    anc = (push[u] < push[v]) & (pop[v] < pop[u])
    true_anc = anc & req_empty & forb_empty & ~same

    # per-way group pruning (the way_filter kernel on a card)
    way_ok = ops.filter_ways_at(u, v, req_w, forb_w, null_w, vtx_packed,
                                h_vtx, h_lab, v_vtx, v_lab)
    any_way = way_ok.any(dim=-1)

    maybe = topo_maybe & (any_way | same)
    verdict = torch.where(true_same | true_anc, TRUE,
                          torch.where(maybe, UNKNOWN, FALSE))
    # u == v with required labels: only a cycle through u can satisfy
    return torch.where(same & ~req_empty,
                       torch.where(any_way, UNKNOWN, FALSE), verdict)


def _cascade_rows(index: TDRIndex, plan: QueryPlan, rows: slice):
    """``_filter_cascade`` over the plan's jobs ``rows`` on the index's
    device -> verdict int [len(rows)] (a tensor on that device)."""
    dev = index.device
    sat_out_d, sat_in_d = index.summary_flags_dev()
    return _filter_cascade(
        _to_long(plan.u[rows], dev), _to_long(plan.v[rows], dev),
        bitset.np_to_words(plan.req_w[rows], dev),
        bitset.np_to_words(plan.forb_w[rows], dev),
        bitset.np_to_words(_null_words(index.cfg), dev),
        index.vtx_packed, index.h_vtx, index.h_lab, index.v_vtx,
        index.v_lab, index.n_out, index.n_in, sat_out_d, sat_in_d,
        index.push, index.pop)


# ---------------------------------------------------------------- phase 2
def _state_has_masks(n_states: int, max_m: int) -> list:
    """HAS[i] = packed mask of subset-states whose bit i is set."""
    has = [0] * max(max_m, 1)
    for i in range(max_m):
        for s in range(n_states):
            if (s >> i) & 1:
                has[i] |= 1 << s
    return has


def _sup_table(n_states: int) -> list:
    """SUP[t] = packed mask of subset-states s with ``s ⊇ t``."""
    sup = [0] * n_states
    for t in range(n_states):
        for s in range(n_states):
            if s & t == t:
                sup[t] |= 1 << s
    return sup


def _corridor_member(u, v, n_out, n_in, vtx_packed):
    """Corridor membership bool [J, V] (endpoints always members)."""
    mem = (bitset.words_contain(n_out[u][:, None, :], vtx_packed[None])
           & bitset.words_contain(n_in[v][:, None, :], vtx_packed[None]))
    iota = torch.arange(u.shape[0], device=u.device)
    mem[iota, v] = True
    mem[iota, u] = True
    return mem


def _corridor_mask(u, v, n_out, n_in, vtx_packed):
    """Packed Bloom corridor ``V_out(u) ∩ V_in(v)`` as a [V, Q] word mask
    (all-ones where vertex x may lie on a u→v path)."""
    return bitset.full_words_where(
        _corridor_member(u, v, n_out, n_in, vtx_packed).T.contiguous())


def _edge_state_masks(lab, req_labels, forb_raw_w, n_states: int,
                      max_m: int, neutral=None):
    """Per-(edge|class, query) transition operands ``(allow, has, sh)``,
    each int32 ``[E|C, Q]``.  ``neutral`` marks class rows that merge all
    labels special for nobody (always allowed, identity transition).  The
    forbid test reads the raw packed forbidden rows."""
    labx = lab.clamp(min=0)
    okbit = (forb_raw_w[:, labx >> 5] >> (labx & 31)[None, :]) & 1
    allow_b = okbit == 0                                        # [Q, E|C]
    if neutral is not None:
        allow_b = neutral[None, :] | allow_b
    allow = bitset.full_words_where(allow_b).T.contiguous()     # [E|C, Q]
    has_c = _state_has_masks(n_states, max_m)
    shape = (lab.shape[0], req_labels.shape[0])
    has = torch.full(shape, -1, dtype=torch.int32, device=lab.device)
    sh = torch.zeros(shape, dtype=torch.int32, device=lab.device)
    for i in range(max_m):   # require-sets hold distinct labels
        match = req_labels[:, i][None, :] == lab[:, None]
        if neutral is not None:
            match = match & ~neutral[:, None]
        has = torch.where(match, _i32(has_c[i]), has)
        sh = torch.where(match, 1 << i, sh)
    return allow, has, sh


def _sup_need(full_mask, n_states: int):
    """sup_need[s1, q] = packed mask of backward states completing s1 to
    ``full_mask[q]`` (s2 with ``s1 | s2 ⊇ full``) -> int32 [S, Q]."""
    sup = torch.tensor([_i32(x) for x in _sup_table(n_states)],
                       dtype=torch.int32, device=full_mask.device)
    rows = [sup[(full_mask & ((n_states - 1) & ~s1)).long()]
            for s1 in range(n_states)]
    return torch.stack(rows)


def _bidi_loop(f0, b0, push_f, push_b, cor_w, meet, max_rounds: int):
    """Alternating bidirectional fixpoint.  One iteration = one forward +
    one backward expansion; a query's columns freeze once it meets
    (``meet(f, b)`` -> bool [Q]), and a direction whose last push added
    nothing is at its fixpoint and skips its push.  One host sync per
    iteration reads the three loop flags; returns ``(done, rounds,
    syncs)``."""
    syncs = spans.Syncs()
    f, b = f0, b0
    done = meet(f, b)
    cf, cb, all_done = True, True, syncs.read(done.all())
    rounds = 0
    while (cf or cb) and not all_done and rounds < max_rounds:
        mask = cor_w & bitset.full_words_where(~done)[None, :]
        new_f = push_f(f) & mask & ~f if cf else torch.zeros_like(f)
        f = f | new_f
        new_b = push_b(b) & mask & ~b if cb else torch.zeros_like(b)
        b = b | new_b
        done = done | meet(f, b)
        cf, cb, all_done = syncs.read(torch.stack(
            [(new_f != 0).any(), (new_b != 0).any(), done.all()]))
        rounds += 1
    return done, rounds, syncs


def _seed(idx, v_p: int, q_n: int, val=1, cols=None):
    """[V', Q] frontier holding ``val`` (default: subset state ∅) at row
    idx[k] of column ``cols[k]`` (default: column k), zero elsewhere;
    ``val`` is a scalar or an int32 [Q]."""
    f0 = torch.zeros((v_p, q_n), dtype=torch.int32, device=idx.device)
    if cols is None:
        cols = torch.arange(q_n, device=idx.device)
    f0[idx, cols] = val
    return f0


def _reduce_edges(val, scatter_idx, ids, v_p: int, chunk_words: int):
    """OR the per-edge rows ``val`` [E', Q] into their ``scatter_idx``
    vertex: over the padded incidence gather matrices ``ids`` (edge ids
    grouped by vertex, the sentinel ``E'`` pointing at an appended zero
    row; one level, or two on a virtual-row split of heavy tails), or,
    when ``ids`` is None, by packed segment-ORs."""
    if ids is None:
        with spans.span("query.reduce_segment"):
            return bitset.segment_or_words(val, scatter_idx,
                                           num_segments=v_p,
                                           chunk_words=chunk_words)
    with spans.span("query.reduce_gather"):
        val = torch.cat([val, val.new_zeros((1, val.shape[1]))])
        for level in ids:
            out = val[level[:, 0]]
            for j in range(1, level.shape[1]):
                out = out | val[level[:, j]]
            val = out
    return val                                                   # [V', Q]


def _bidi_segment_core(su, sv, req_labels, forb_raw_w, full_mask, cor_w,
                       sub_lab, sub_src, sub_dst, ids_in, ids_out,
                       n_states: int, max_m: int, max_rounds: int,
                       chunk_words: int):
    """Segment-backend bidirectional fixpoint over a (sub)graph's edge
    lists.  ``ids_in`` / ``ids_out`` are padded incidence gather matrices
    (edge ids grouped by dst / src; the sentinel ``E'`` points at an
    appended zero row); ``None`` falls back to packed segment-ORs."""
    q_n = su.shape[0]
    v_p = cor_w.shape[0]
    allow, has, sh = _edge_state_masks(sub_lab, req_labels, forb_raw_w,
                                       n_states, max_m)
    sup_need = _sup_need(full_mask, n_states)

    def push(frontier, gather_idx, ids, scatter_idx):
        val = ref.subset_transition(frontier[gather_idx] & allow, has,
                                    sh)                         # [E', Q]
        return _reduce_edges(val, scatter_idx, ids, v_p, chunk_words)

    return _bidi_loop(
        _seed(su, v_p, q_n), _seed(sv, v_p, q_n),
        lambda f: push(f, sub_src, ids_in, sub_dst),
        lambda b: push(b, sub_dst, ids_out, sub_src),
        cor_w, lambda f, b: ref.subset_meet(f, b, sup_need), max_rounds)


def _group_columns(n: int, width: int) -> np.ndarray:
    """Columns of ``n`` chunks of ``width`` jobs laid side by side in one
    lockstep group, each from the start of a 32-column pass -> int64
    ``[n, width]``.  The columns past a chunk's width up to its next pass
    (``width`` not a multiple of 32) belong to no chunk."""
    stride = bitset.n_words(width) * bitset.WORD
    return np.arange(n)[:, None] * stride + np.arange(width)[None, :]


def _bidi_matmul_core(su, sv, lists_rev, lists_fwd, req_labels,
                      forb_raw_w, full_mask, cor_w, n_states: int,
                      max_m: int, max_rounds: Sequence[int], width: int):
    """Matmul-backend bidirectional fixpoint of a lockstep group of
    ``len(max_rounds)`` chunks on one (sub)graph's per-row edge lists (the
    forward frontier reads the edges into each row), with the transition
    operands ``[L, Q]`` of every label.  The chunks lie side by side on
    the column axis (``_group_columns``): ``su``/``sv`` and the other
    operands span the group's ``Q`` columns; only each chunk's own columns
    are seeded, so the rest carry no bits.  Each round is one
    ``ops.class_round`` for the whole group: every edge's subset
    transition in both directions, the corridor mask and the meet, one
    launch on a card, which reads the last round's per-pass flags on the
    device.  The meet before the first round is the same call with both
    directions off.  One host sync a call reads the flags and done words,
    and each chunk stops on its own rule, as if it ran alone: (forward or
    backward added a bit) and not every column done and below its own
    ``max_rounds``; a chunk stopped at that cap has its passes' flags
    cleared, so it is frozen.  Returns ``(done, rounds, syncs,
    operand_bytes)``: ``done`` numpy bool ``[n, width]``, ``rounds`` each
    chunk's, ``operand_bytes`` the lists' bytes each launch was given in
    its active directions."""
    q_n = cor_w.shape[1]
    v_p = cor_w.shape[0]
    dev = su.device
    cols = _group_columns(len(max_rounds), width)
    passes = cols[:, ::bitset.WORD] // bitset.WORD         # [n, passes]
    n_pass = bitset.n_words(q_n)
    allow, has, sh = _edge_state_masks(
        torch.arange(lists_rev.n_labels, device=dev), req_labels,
        forb_raw_w, n_states, max_m)
    sup_need = _sup_need(full_mask, n_states)
    syncs = spans.Syncs()

    def read(state):
        words = np.asarray(syncs.read(state), dtype=np.int32)
        done = np.unpackbits(words[2].view(np.uint8), bitorder="little")
        added = (words[:2, passes] != 0).any(axis=2)           # [2, n]
        return added[0], added[1], done[cols].astype(bool)

    cols_t = torch.from_numpy(cols.reshape(-1)).to(dev)
    f, b = (_seed(e[cols_t], v_p, q_n, cols=cols_t) for e in (su, sv))
    start = torch.tensor([[1] * n_pass, [1] * n_pass, [0] * n_pass],
                         dtype=torch.int32, device=dev)
    _, _, state = ops.class_round(lists_rev, lists_fwd, allow, has, sh,
                                  sup_need, cor_w, f, b, start, False, False)
    _, _, done = read(state)
    cap = np.asarray(max_rounds)
    rounds = np.zeros(len(cap), dtype=np.int64)
    on = ~done.all(axis=1) & (rounds < cap)
    cf = cb = True
    nbytes = 0
    while on.any():
        f, b, state = ops.class_round(lists_rev, lists_fwd, allow, has, sh,
                                      sup_need, cor_w, f, b, state, cf, cb)
        nbytes += cf * lists_rev.nbytes + cb * lists_fwd.nbytes
        added_f, added_b, now = read(state)
        rounds += on
        done = np.where(on[:, None], now, done)
        live = (added_f | added_b) & ~done.all(axis=1)
        stop_cap = on & live & (rounds >= cap)
        on &= live & (rounds < cap)
        if on.any():
            for k in np.flatnonzero(stop_cap):
                state[:2, passes[k, 0]:passes[k, -1] + 1] = 0
        cf, cb = bool(added_f[on].any()), bool(added_b[on].any())
    return done, rounds.tolist(), syncs, nbytes


# -------------------------------------------- legacy one-directional executor
def _expand_loop(f0, upd_of, v, full_mask, max_rounds: int):
    """One-directional fixpoint over a full-graph frontier ``[V, Q]``: run
    until every query's target state bit is set, nothing changes, or
    ``max_rounds``.  Finished queries' columns freeze, and ``changed``
    comes from the round's own new bits; one host sync per round.  Returns
    ``(done, rounds, syncs)``."""
    syncs = spans.Syncs()
    iota = torch.arange(v.shape[0], device=v.device)

    def done_of(f):
        return ((f[v, iota] >> full_mask) & 1) != 0

    f = f0
    done = done_of(f)
    changed, all_done, rounds = True, syncs.read(done.all()), 0
    while changed and not all_done and rounds < max_rounds:
        new = upd_of(f) & ~f & bitset.full_words_where(~done)[None, :]
        f = f | new
        done = done | done_of(f)
        changed, all_done = syncs.read(torch.stack(
            [(new != 0).any(), done.all()]))
        rounds += 1
    return done, rounds, syncs


def _legacy_segment(u, v, req_labels, forb_raw_w, full_mask, cor_w, elab,
                    edge_src, edge_dst, n_states: int, max_m: int,
                    max_rounds: int, chunk_words: int):
    """Legacy segment form: one round is a gather of the source rows, the
    per-edge subset transition and a packed segment-OR into the
    destinations."""
    allow, has, sh = _edge_state_masks(elab, req_labels, forb_raw_w,
                                       n_states, max_m)
    v_n = cor_w.shape[0]

    def upd_of(f):
        val = ref.subset_transition(f[edge_src] & allow, has, sh)  # [E, Q]
        return bitset.segment_or_words(val, edge_dst, num_segments=v_n,
                                       chunk_words=chunk_words) & cor_w

    return _expand_loop(_seed(u, v_n, u.shape[0]), upd_of, v, full_mask,
                        max_rounds)


def _legacy_matmul(u, v, class_adj, class_label, req_labels, forb_raw_w,
                   full_mask, cor_w, n_states: int, max_m: int,
                   max_rounds: int):
    """Legacy matmul form: one ``bitset_matmul`` per label class per round
    on the full graph's reverse class stack."""
    neutral = class_label < 0
    allow, has, sh = _edge_state_masks(class_label, req_labels, forb_raw_w,
                                       n_states, max_m, neutral=neutral)
    v_n = cor_w.shape[0]

    def upd_of(f):
        upd = torch.zeros_like(f)
        for c in range(class_adj.shape[0]):
            y = engine_mod._matmul_rows(class_adj[c], f)[:v_n]
            upd = upd | ref.subset_transition(
                y & allow[c][None, :], has[c][None, :], sh[c][None, :])
        return upd & cor_w

    return _expand_loop(_seed(u, v_n, u.shape[0]), upd_of, v, full_mask,
                        max_rounds)


# ---------------------------------------------------------------- executor
class PlanDevice(NamedTuple):
    """Device copy of the plan's job-axis arrays (made once per batch)."""
    u: torch.Tensor
    v: torch.Tensor
    req_labels: torch.Tensor
    forb_raw_w: torch.Tensor
    full_mask: torch.Tensor

    @classmethod
    def of(cls, plan: QueryPlan, device) -> "PlanDevice":
        return cls(_to_long(plan.u, device), _to_long(plan.v, device),
                   _to_long(plan.req_labels, device),
                   bitset.np_to_words(plan.forb_raw_w, device),
                   torch.from_numpy(plan.full_mask).to(device))

    def rows(self, jobs: np.ndarray | torch.Tensor, m_eff: int):
        """``(req_labels, forb_raw_w, full_mask)`` of ``jobs`` (numpy, or
        already on the device), the required labels cut to ``m_eff``
        columns."""
        j = jobs if torch.is_tensor(jobs) else _to_long(jobs, self.u.device)
        return (self.req_labels[j][:, :m_eff], self.forb_raw_w[j],
                self.full_mask[j])


def _pad_first(rows: np.ndarray, width: int) -> np.ndarray:
    """``rows`` padded along its first axis to ``width`` with copies of
    its first row.  A chunk's padding jobs repeat its first job, which
    changes neither its answers nor its corridor union."""
    if len(rows) >= width:
        return rows
    return np.concatenate(
        [rows, np.repeat(rows[:1], width - len(rows), axis=0)])


def _chunks(jobs: np.ndarray, width: int):
    """``(c0, padded jobs, real_n)`` for each ``width``-job chunk of
    ``jobs``, the tail chunk padded by ``_pad_first``."""
    for c0 in range(0, len(jobs), width):
        part = jobs[c0:c0 + width]
        yield c0, _pad_first(part, width), len(part)


class Subgraph(NamedTuple):
    """The graph one phase-2 chunk runs on: a corridor's induced subgraph,
    renumbered, or the full graph (``sub_ids`` and ``renum`` None)."""
    sub_ids: np.ndarray | None  # local -> original vertex ids
    renum: np.ndarray | None    # original -> local vertex ids (-1 outside)
    src: np.ndarray             # edge sources int32 [E']
    dst: np.ndarray             # edge targets int32 [E']
    lab: np.ndarray             # edge labels int32 [E']
    n_sub: int                  # |V'| before padding
    v_p: int                    # padded vertex bucket

    def endpoints(self, plan: QueryPlan, jobs: np.ndarray, device):
        """The jobs' ``(u, v)`` in this graph's numbering, on ``device``."""
        return tuple(_to_long(e if self.renum is None else self.renum[e],
                              device) for e in (plan.u[jobs], plan.v[jobs]))


@dataclasses.dataclass
class ChunkResult:
    """Result of one phase-2 chunk."""
    reached: torch.Tensor | np.ndarray   # bool [Q]
    rounds: int
    n_active: int = 0       # |V'| this chunk ran on
    compacted: bool = False  # ran on an induced subgraph
    syncs: spans.Syncs = dataclasses.field(default_factory=spans.Syncs)
    fused_rounds: int = 0   # rounds run by the class_round kernel
    operand_bytes: int = 0  # class lists those rounds were given
    grouped: bool = False   # shared its launches with another chunk


def _to_long(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)


def _class_stacks_fit(eng: "engine_mod.Engine", special: tuple[int, ...],
                      v_p: int) -> bool:
    """``Engine.dense_fits`` for a chunk's two class stacks ``[C+1, V',
    Kw]``: the test that sends a chunk to the matmul core."""
    n_mats = 2 * (len(special) + 1)
    return eng.dense_fits(
        n_mats * v_p * bitset.n_words(v_p) * 4,
        f"this chunk's {n_mats} label-class adjacency matrices")


def _edge_lists(eng: "engine_mod.Engine", special: tuple[int, ...],
                v_p: int, edges=None):
    """A boolean matmul chunk's operands ``(lists_rev, lists_fwd)``: the
    edges of ``_class_stacks``'s stacks as per-row ``EdgeLists``, the
    engine's own for the full graph (``edges`` None), else built on the
    host from a compacted chunk's ``(src, dst, lab)``, whose bytes count
    in ``engine.LABEL_CLASS_PACKS["list_bytes"]``.  The chunk takes the
    matmul core where its dense stacks would fit: None when they do not
    fit the dense cap on the CPU (the caller runs its segment core); on a
    card ``Engine.dense_fits`` raises instead, as for the stacks."""
    with spans.span("query.class_stacks"):
        if not _class_stacks_fit(eng, special, v_p):
            return None
        if edges is None:
            return tuple(eng.edge_lists(reverse=rev) for rev in (True, False))
        src, dst, lab = edges
        n_labels = eng.graph.n_labels
        lists = tuple(edge_lists(dst if rev else src, src if rev else dst,
                                 lab, v_p, n_labels, eng.device)
                      for rev in (True, False))
        engine_mod.LABEL_CLASS_PACKS["list_bytes"] += sum(
            a.nbytes for a in lists)
        return lists


def _class_stacks(eng: "engine_mod.Engine", special: tuple[int, ...],
                  v_p: int, edges=None):
    """A matmul chunk's label-class operands ``(adj_rev, adj_fwd,
    class_label)``: one class per ``special`` label plus the neutral one
    (label -1), as ``[C+1, V', Kw]`` stacks from the engine's LRU for the
    full graph (``edges`` None), else packed on the host from a compacted
    chunk's ``(src, dst, lab)`` (padding rows repeat a real edge, which
    sets the same bit twice).  Either pack adds its device bytes to
    ``engine.LABEL_CLASS_PACKS["bytes"]`` (an LRU hit adds none).  None
    when the stacks do not fit the dense cap on the CPU (the caller runs
    its segment core); on a card ``Engine.dense_fits`` raises instead."""
    with spans.span("query.class_stacks"):
        if not _class_stacks_fit(eng, special, v_p):
            return None
        if edges is None:
            adj = [eng.label_class_adjacency(special, reverse=rev)
                   for rev in (True, False)]
        else:
            adj = [bitset.np_to_words(engine_mod.pack_label_class_edges_np(
                *edges, v_p, special, reverse=rev), eng.device)
                for rev in (True, False)]
            engine_mod.LABEL_CLASS_PACKS["bytes"] += sum(
                a.numel() * a.element_size() for a in adj)
        return (*adj, _to_long(np.asarray(special + (-1,)), eng.device))


class ExactExecutor:
    """Phase-2 executor bound to one (index, engine) pair: holds the full
    graph's host edge lists (``full``), which per-chunk corridor
    compaction reads, and its cached incidence.

    It holds the pair weakly: the engine caches its executor, and a
    strong reference back would make index, engine and executor a cycle
    that only the cyclic collector frees, so a dropped index (a server's
    pre-update one) would keep its engine's device operands, class stacks
    included, until a full collection."""

    # cap on the padded-incidence gather transient (bytes); beyond it the
    # round falls back to packed segment reductions (extreme hub skew)
    GATHER_BYTES_CAP = 1 << 28
    # cap on a lockstep group's [V', Q] frontier (bytes): 2,048 columns,
    # 64 chunks of 32, at V' = 32,768; past it the next group starts
    GROUP_BYTES_CAP = 1 << 28

    def __init__(self, index: TDRIndex, eng: "engine_mod.Engine"):
        self._index = weakref.ref(index)
        self._engine = weakref.ref(eng)
        g = index.graph
        self.full = Subgraph(None, None, g.src, np.asarray(g.indices),
                             np.asarray(g.labels), g.n_vertices, g.n_vertices)
        self._full_inc: dict[int, tuple] = {}   # sentinel -> incidence
        self._elab: torch.Tensor | None = None

    @property
    def index(self) -> TDRIndex:
        return self._index()

    @property
    def engine(self) -> "engine_mod.Engine":
        return self._engine()

    def special_labels(self, plan: QueryPlan,
                       jobs: np.ndarray) -> tuple[int, ...]:
        """Labels some pending job requires or forbids (the matmul backend
        gets one adjacency class per special label + one neutral)."""
        req = plan.req_labels[jobs]
        spec = set(int(l) for l in req[req >= 0])
        forb = np.bitwise_or.reduce(plan.forb_raw_w[jobs], axis=0)
        bits = np.unpackbits(forb.astype("<u4").view(np.uint8),
                             bitorder="little")
        spec.update(np.flatnonzero(bits).tolist())
        return tuple(sorted(spec))

    def eff_states(self, plan: QueryPlan, jobs: np.ndarray,
                   pin_m: int | None = None) -> tuple[int, int]:
        """(m_eff, n_states) for the pending set: the widest require-set
        actually present, not the plan-level ``max_m`` cap.  ``pin_m``
        (serving) raises it to a fixed floor, capped at ``max_m``, so
        steady traffic keeps one state width whatever a batch holds; a
        wider state set only carries more empty states.  Raises past the
        32 states one int32 word holds."""
        m_eff = int((plan.req_labels[jobs] >= 0).sum(axis=1).max(initial=0))
        if pin_m is not None:
            m_eff = min(max(m_eff, pin_m), plan.max_m)
        if m_eff > 5:
            raise ValueError(
                f"max_m={m_eff} needs {1 << m_eff} subset states; the "
                "packed executors hold at most 32 (max_m <= 5)")
        return m_eff, 1 << m_eff

    # ------------------------------------------------------------ planning
    def chunk_union_counts(self, pd: PlanDevice, jobs: np.ndarray,
                           chunk: int) -> np.ndarray:
        """Exact corridor-union size per ``chunk``-sized job group (the
        compaction probe).  The tail group is padded with its own first
        job, which leaves its union unchanged."""
        pj = np.concatenate([grp for _, grp, _ in _chunks(jobs, chunk)])
        out = []
        for _, mem in self._corridor_slices(
                pd, pj, max(chunk, (256 // chunk) * chunk)):
            union = mem.reshape(-1, chunk, mem.shape[1]).any(dim=1)
            out.append(union.sum(dim=1).cpu().numpy())
        return np.concatenate(out).astype(np.int32)

    def corridor_members(self, pd: PlanDevice,
                         jobs: np.ndarray) -> np.ndarray:
        """Corridor membership bool [P, V] (fetched only for the jobs of
        chunks that will compact), in slices of 256 jobs."""
        out = np.empty((len(jobs), self.index.graph.n_vertices), dtype=bool)
        for i0, mem in self._corridor_slices(pd, jobs, 256):
            out[i0:i0 + 256] = mem.cpu().numpy()
        return out

    def _corridor_slices(self, pd: PlanDevice, jobs: np.ndarray,
                         step: int):
        """``(i0, membership bool [step, V])`` on the device for each
        ``step``-job slice of ``jobs``."""
        idx = self.index
        for i0 in range(0, len(jobs), step):
            sl = _to_long(jobs[i0:i0 + step], idx.device)
            yield i0, _corridor_member(pd.u[sl], pd.v[sl], idx.n_out,
                                       idx.n_in, idx.vtx_packed)

    # ------------------------------------------------------------ dispatch
    def run_chunk(self, plan: QueryPlan, pd: PlanDevice, jobs: np.ndarray,
                  member: np.ndarray | None, special: tuple[int, ...],
                  mode: str, pin_m: int | None = None) -> ChunkResult:
        """Expand one padded chunk of pending jobs.  ``mode == "legacy"``
        -> the one-directional full-graph executor; ``member is None`` ->
        full-graph bidirectional expansion on the segment core (corridor
        built on the device; on matmul ``run_full_chunks`` runs those);
        else corridor compaction over the member rows, on the matmul core
        as a lockstep group of one where the backend is matmul."""
        idx, eng = self.index, self.engine
        if mode == "legacy":
            reached, rounds, syncs = self._run_legacy(plan, pd, jobs, special)
            return ChunkResult(reached, rounds, idx.graph.n_vertices,
                               syncs=syncs)
        dev = idx.device
        q_n = len(jobs)
        m_eff, n_states = self.eff_states(plan, jobs, pin_m)

        sub = self.subgraph(None if member is None else member.any(axis=0),
                            mode)
        compacted = sub.sub_ids is not None
        if compacted and sub.src.shape[0] == 0:
            # corridor holds no edges: only the empty path exists, and
            # phase 1 already answered those — nothing is reachable
            return ChunkResult(np.zeros(q_n, bool), 0, sub.n_sub, True)
        req_labels, forb_raw_w, full_mask = pd.rows(jobs, m_eff)
        su, sv = sub.endpoints(plan, jobs, dev)
        if compacted:
            cor = np.zeros((sub.v_p, q_n), dtype=bool)
            cor[:sub.n_sub] = member[:, sub.sub_ids].T
            cor_w = bitset.full_words_where(torch.from_numpy(cor).to(dev))
        else:
            cor_w = _corridor_mask(su, sv, idx.n_out, idx.n_in,
                                   idx.vtx_packed)
        max_rounds = sub.v_p * n_states + 1

        lists = None
        if eng.backend == "matmul" and compacted:
            lists = _edge_lists(eng, special, sub.v_p,
                                (sub.src, sub.dst, sub.lab))
        if lists is not None:
            reached, (rounds,), syncs, nbytes = _bidi_matmul_core(
                su, sv, *lists, req_labels, forb_raw_w, full_mask, cor_w,
                n_states, m_eff, [max_rounds], q_n)
            return ChunkResult(reached[0], rounds, sub.n_sub, compacted,
                               syncs, rounds if su.is_cuda else 0, nbytes)

        reached, rounds, syncs = _bidi_segment_core(
            su, sv, req_labels, forb_raw_w, full_mask, cor_w,
            *self.device_edges(sub),
            *self.incidence(sub, sub.src.shape[0], q_n), n_states, m_eff,
            max_rounds, eng.config.chunk_words)
        return ChunkResult(reached, rounds, sub.n_sub, compacted, syncs)

    def run_full_chunks(self, plan: QueryPlan, pd: PlanDevice,
                        chunks: list, special: tuple[int, ...],
                        pin_m: int | None = None) -> list | None:
        """Expand padded full-graph chunks (``run_chunk`` with ``member``
        None) on the matmul backend as lockstep groups: side by side on
        the column axis, each group's operands built once and each round
        one ``class_round`` launch and one host read for all its chunks,
        groups cut at ``GROUP_BYTES_CAP``.  Each chunk's ``ChunkResult``
        equals its own run's; a group's syncs and operand bytes come with
        its first chunk.  None when the chunks take the segment core (not
        ``matmul``, or over the dense cap on the CPU)."""
        eng = self.engine
        if eng.backend != "matmul":
            return None
        v_p = self.full.v_p
        lists = _edge_lists(eng, special, v_p)
        if lists is None:
            return None
        width = len(chunks[0])
        stride = bitset.n_words(width) * bitset.WORD
        cap_cols = self.GROUP_BYTES_CAP // (4 * v_p)
        per_group = max(1, (cap_cols - width) // stride + 1)
        out = []
        for g0 in range(0, len(chunks), per_group):
            out += self._run_group(plan, pd, chunks[g0:g0 + per_group],
                                   lists, pin_m)
        return out

    def _run_group(self, plan: QueryPlan, pd: PlanDevice, chunks: list,
                   lists, pin_m: int | None) -> list:
        """One lockstep group of full-graph chunks (``run_full_chunks``):
        the column of each chunk's pass past its width repeats its first
        job, which the seeds leave empty.  The group runs at its widest
        subset-state count; a narrower chunk's states never reach the
        extra ones, so its rounds are its own."""
        idx = self.index
        dev = idx.device
        width = len(chunks[0])
        states = [self.eff_states(plan, jobs, pin_m) for jobs in chunks]
        m_eff = max(m for m, _ in states)
        stride = bitset.n_words(width) * bitset.WORD
        q_n = (len(chunks) - 1) * stride + width
        col_jobs = _to_long(np.concatenate(
            [_pad_first(jobs, stride) for jobs in chunks])[:q_n], dev)
        req_labels, forb_raw_w, full_mask = pd.rows(col_jobs, m_eff)
        su, sv = pd.u[col_jobs], pd.v[col_jobs]
        step = 256
        cor_w = torch.cat([_corridor_mask(su[c0:c0 + step], sv[c0:c0 + step],
                                          idx.n_out, idx.n_in,
                                          idx.vtx_packed)
                           for c0 in range(0, q_n, step)], dim=1)
        v_p = self.full.v_p
        reached, rounds, syncs, nbytes = _bidi_matmul_core(
            su, sv, *lists, req_labels, forb_raw_w, full_mask, cor_w,
            1 << m_eff, m_eff, [v_p * n + 1 for _, n in states], width)
        grouped = len(chunks) > 1
        return [ChunkResult(reached[k], rounds[k], self.full.n_sub, False,
                            syncs if k == 0 else spans.Syncs(),
                            rounds[k] if su.is_cuda else 0,
                            nbytes if k == 0 else 0, grouped)
                for k in range(len(chunks))]

    def subgraph(self, active: np.ndarray | None, mode: str) -> Subgraph:
        """The graph a chunk with corridor ``active`` (bool [V]) runs on:
        its induced subgraph, the vertex count padded onto the grid from
        32; the full graph when ``active`` is None, or in "auto" mode when
        that bucket is not below V (the probe over-estimated)."""
        if active is not None:
            n_sub = int(active.sum())
            v_p = graph_mod.pad_bucket(max(n_sub, 1), lo=32)
            if mode != "auto" or v_p < self.full.v_p:
                return Subgraph(*graph_mod.induced_edges(
                    self.index.graph, active, src=self.full.src), n_sub, v_p)
        return self.full

    def incidence(self, sub: Subgraph, sentinel: int, q_n: int):
        """Padded incidence gather matrices ``(ids_in, ids_out)`` of
        ``sub``'s edges on the device: edge ids grouped by dst / by src,
        ``sentinel`` in the empty slots; the full graph's are cached per
        sentinel.  ``(None, None)`` when their gather transient over
        ``q_n`` jobs would pass ``GATHER_BYTES_CAP``: the rounds then
        reduce by packed segment-ORs."""
        full = sub.sub_ids is None
        inc = self._full_inc.get(sentinel) if full else None
        if inc is None:
            dev = self.index.device
            inc = tuple(
                tuple(_to_long(a, dev) for a in
                      graph_mod.incidence_plan(keys, sub.v_p, sentinel))
                for keys in (sub.dst, sub.src))
            if full:
                self._full_inc[sentinel] = inc
        if sum(a.numel() for ids in inc for a in ids) * q_n * 4 > \
                self.GATHER_BYTES_CAP:
            return None, None
        return inc

    def _run_legacy(self, plan: QueryPlan, pd: PlanDevice,
                    jobs: np.ndarray, special: tuple[int, ...]):
        """The one-directional full-graph expansion (``exact_mode=
        "legacy"``, kept as a comparison executor): frontier ``[V, Q]``,
        bit s of word (i, q) set when vertex i is reached in subset state
        s, at the plan's whole state width ``1 << plan.max_m`` (no pin).
        On ``matmul`` the reverse class stack is held to the dense cap:
        over it a card raises ``DenseCapError`` and the CPU warns and runs
        the segment form."""
        idx, eng = self.index, self.engine
        dev = idx.device
        v_n = idx.graph.n_vertices
        n_states = 1 << plan.max_m
        max_rounds = v_n * n_states + 1
        uu, vv = _to_long(plan.u[jobs], dev), _to_long(plan.v[jobs], dev)
        req_labels, forb_raw_w, full_mask = pd.rows(jobs, plan.max_m)
        cor_w = _corridor_mask(uu, vv, idx.n_out, idx.n_in, idx.vtx_packed)
        n_cls = len(special) + 1
        if eng.backend == "matmul" and eng.dense_fits(
                n_cls * v_n * bitset.n_words(v_n) * 4,
                f"{n_cls} label-class adjacency matrices"):
            return _legacy_matmul(
                uu, vv, eng.label_class_adjacency(special),
                _to_long(np.asarray(special + (-1,)), dev), req_labels,
                forb_raw_w, full_mask, cor_w, n_states, plan.max_m,
                max_rounds)
        return _legacy_segment(
            uu, vv, req_labels, forb_raw_w, full_mask, cor_w,
            *self.device_edges(self.full), n_states, plan.max_m,
            max_rounds, eng.config.chunk_words)

    def device_edges(self, sub: Subgraph) -> tuple:
        """``sub``'s ``(lab, src, dst)`` on the index's device: the full
        graph's are the engine's, with its labels cached here."""
        dev = self.index.device
        if sub.sub_ids is not None:
            return tuple(_to_long(a, dev) for a in (sub.lab, sub.src, sub.dst))
        if self._elab is None:
            self._elab = _to_long(self.full.lab, dev)
        return self._elab, self.engine.edge_src, self.engine.edge_dst


def _executor(index: TDRIndex, eng: "engine_mod.Engine") -> ExactExecutor:
    ex = getattr(eng, "_executor", None)
    if ex is None or ex.index is not index:
        ex = ExactExecutor(index, eng)
        eng._executor = ex
    return ex


# ----------------------------------------------------------------- driver
def _pinned(special: tuple[int, ...],
            special_labels: Sequence[int] | None) -> tuple[int, ...]:
    """The label-class set ``special`` widened by a serving pin."""
    if special_labels is None:
        return special
    return tuple(sorted(set(int(l) for l in special_labels) | set(special)))


def _check_device(index: TDRIndex, device) -> None:
    """Raise unless ``device`` (default: the card) is where the index is."""
    engine_mod._check_same_device(index.device, device)


def answer_batch(index: TDRIndex,
                 queries: Sequence[tuple[int, int, pat.Pattern]],
                 *, max_m: int = 4, exact_chunk: int = 32,
                 stats: QueryStats | None = None,
                 filters_only: bool = False,
                 backend: str | None = None,
                 exact_mode: str = "auto",
                 engine_config: "engine_mod.EngineConfig | None" = None,
                 mesh=None, device="cuda") -> np.ndarray:
    """Answer a batch of PCR queries.  Returns bool [n_queries].

    ``device`` defaults to the card and must be where ``index`` lives
    (pass ``device="cpu"`` for an index built on the CPU); under ``mesh``
    (a ``distributed.ShardMesh``; the call is then collective) the mesh's
    device is the device.  ``filters_only`` stops after the phase-1
    cascade (see ``answer_plan``)."""
    stats = stats if stats is not None else QueryStats()
    with spans.span("query.phase1", stats, "phase1_s"):
        _check_device(index, device if mesh is None else mesh.device)
        plan = compile_queries(index, queries, max_m=max_m, stats=stats)
    return answer_plan(index, plan, exact_chunk=exact_chunk, stats=stats,
                       filters_only=filters_only, backend=backend,
                       exact_mode=exact_mode, engine_config=engine_config,
                       mesh=mesh)


def answer_plan(index: TDRIndex, plan: QueryPlan,
                *, exact_chunk: int = 32,
                stats: QueryStats | None = None,
                filters_only: bool = False,
                backend: str | None = None,
                exact_mode: str = "auto",
                engine_config: "engine_mod.EngineConfig | None" = None,
                special_labels: Sequence[int] | None = None,
                pin_m: int | None = None,
                pad_lo: int = 16,
                mesh=None) -> np.ndarray:
    """Answer a compiled ``QueryPlan`` on the index's device.  Returns
    bool [plan.n_queries].

    ``backend``/``engine_config`` select the engine backend for phase 2.
    ``exact_mode`` picks the phase-2 executor: "auto" (corridor-compacted
    whenever the padded corridor bucket is smaller than V), "compact"
    (force compaction), "full" (full graph) or "legacy" (the retained
    one-directional full-graph executor, ``ExactExecutor._run_legacy``,
    which ignores ``pin_m``).  The job axis is padded
    onto the ``{2^k, 3·2^(k-1)}`` grid from ``pad_lo`` up, as in the
    reference.  ``filters_only`` returns right after phase 1 with every
    UNKNOWN job counted as reachable: an upper bound of the answers, which
    measures the cascade's pruning.

    The serving pins fix what would otherwise follow a batch's content:
    ``pin_m`` the subset-state width (``ExactExecutor.eff_states``) and
    ``special_labels`` the label-class set, unioned with the labels the
    batch needs, so the matmul backend's class stacks come from the
    engine's LRU.  A pin can widen a set but never narrow it, so answers
    never change.

    ``mesh`` (a ``distributed.ShardMesh`` whose device holds the index)
    makes the call collective: every rank passes the same plan, runs the
    cascade on its slice of the job axis (padded to a multiple of the
    mesh size) and its share of the phase-2 chunks, and returns the whole
    answers, with ``stats`` equal to a single-device run's."""
    if plan.max_m > 5:
        raise ValueError(
            f"max_m={plan.max_m}: the packed executor holds subset states "
            "in one 32-bit bitfield, so at most 5 required labels per term "
            "(32 states); decompose the pattern")
    if exact_mode not in EXACT_MODES:
        raise ValueError(f"unknown exact_mode {exact_mode!r}; expected one "
                         f"of {EXACT_MODES}")
    if any(k != "bool" for k in plan.kinds):
        raise ValueError(
            "answer_plan serves kind='bool' plans only; route mixed-kind "
            "batches through answer_mixed (or dist_batch / witness / "
            "count_routes directly)")
    stats = stats if stats is not None else QueryStats()
    if mesh is not None:
        _check_device(index, mesh.device)
    with spans.span("query.phase1", stats, "phase1_s"):
        eng = index.engine(backend, engine_config)
        stats.n_queries += plan.n_queries
        stats.n_jobs += plan.n_jobs
        answers = np.zeros(plan.n_queries, dtype=bool)
        if plan.n_jobs == 0:
            return answers

        # pad the job axis onto the bucket grid (and, under a mesh, further
        # to a multiple of its size)
        plan_p = plan.pad_to(graph_mod.pad_bucket(plan.n_jobs, lo=pad_lo))
        if mesh is not None:
            plan_p = plan_p.pad_to(
                -(-plan_p.n_jobs // mesh.size) * mesh.size)
            from . import distributed  # deferred: it imports this module
            verdict = distributed.filter_cascade_sharded(index, plan_p,
                                                         mesh)
        else:
            verdict = _cascade_rows(index, plan_p,
                                    slice(None)).cpu().numpy()

        real = plan_p.qid >= 0
        stats.filter_false += int(((verdict == FALSE) & real).sum())
        stats.filter_true += int(((verdict == TRUE) & real).sum())
        np.logical_or.at(answers, plan_p.qid[(verdict == TRUE) & real],
                         True)

    pending = np.flatnonzero((verdict == UNKNOWN) & real)
    # jobs whose query is already TRUE need no exact work
    pending = pending[~answers[plan_p.qid[pending]]]
    if filters_only:
        np.logical_or.at(answers, plan_p.qid[pending], True)
        return answers
    stats.exact_jobs += len(pending)
    stats.exact_qids = np.unique(plan_p.qid[pending]).tolist()
    if len(pending) == 0:
        return answers

    with spans.span("query.phase2", stats, "phase2_s"):
        ex = _executor(index, eng)
        v_n = index.graph.n_vertices
        special = _pinned(ex.special_labels(plan_p, pending), special_labels)
        pd = PlanDevice.of(plan_p, index.device)

        # chunk layout + compaction probe: membership [P, V] is fetched
        # only for the jobs of chunks that will actually compact
        groups = [pending[c0:c0 + exact_chunk]
                  for c0 in range(0, len(pending), exact_chunk)]
        compact_flags = [exact_mode == "compact"] * len(groups)
        if exact_mode == "auto":
            # summary-first probe skip: a chunk whose every job has
            # ALL_ONE N_out[u] and N_in[v] rows has corridor == V exactly,
            # so it runs on the full graph without a probe
            flags = index.summary_flags()
            probe = [i for i, grp in enumerate(groups) if not (
                flags["sat_out"][plan_p.u[grp]]
                & flags["sat_in"][plan_p.v[grp]]).all()]
            stats.saturated_chunks += len(groups) - len(probe)
            if probe:
                unions = ex.chunk_union_counts(
                    pd, np.concatenate([groups[i] for i in probe]),
                    exact_chunk)
                for i, u in zip(probe, unions):
                    compact_flags[i] = (
                        graph_mod.pad_bucket(int(u), lo=32) < v_n)
        # under a mesh each rank runs the chunks it owns; membership is
        # fetched only for the compacted chunks this process runs
        size, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)
        owners = _chunk_owners(compact_flags, size)
        runs = [o == rank for o in owners]
        mine = [grp for grp, flag, run in zip(groups, compact_flags, runs)
                if flag and run]
        if mine:
            member = ex.corridor_members(pd, np.concatenate(mine))

        # per chunk: rounds, host syncs, |V'|, compacted, fused rounds,
        # operand bytes as their low 31 bits and the rest, grouped (int32
        # words, as every payload that crosses ranks; zeros for another
        # rank's); the seconds waited in the syncs are this process's own
        parts = np.zeros((len(groups), 8), dtype=np.int32)
        wait_s = [0.0] * len(groups)
        todo = [(i, jobs, real_n) for i, (_, jobs, real_n) in
                enumerate(_chunks(pending, exact_chunk)) if runs[i]]
        full = [(i, jobs) for i, jobs, _ in todo if not compact_flags[i]]
        # this process's full-graph chunks on matmul run as lockstep groups
        results = {}
        if full and exact_mode != "legacy":
            res = ex.run_full_chunks(plan_p, pd, [j for _, j in full],
                                     special, pin_m)
            results = dict(zip((i for i, _ in full), res or ()))
        off = 0     # this process's next row of ``member``
        for i, jobs, real_n in todo:
            res = results.get(i)
            if res is None:
                rows = None
                if compact_flags[i]:
                    rows = _pad_first(member[off:off + real_n], exact_chunk)
                    off += real_n
                res = ex.run_chunk(plan_p, pd, jobs, rows, special,
                                   exact_mode, pin_m)
            reached = np.asarray(res.reached.cpu() if torch.is_tensor(
                res.reached) else res.reached)[:real_n]
            np.logical_or.at(answers, plan_p.qid[jobs[:real_n][reached]],
                             True)
            parts[i] = (res.rounds, res.syncs.n, res.n_active,
                        res.compacted, res.fused_rounds,
                        res.operand_bytes & _LOW31, res.operand_bytes >> 31,
                        res.grouped)
            wait_s[i] = res.syncs.wait_s
        if mesh is not None:
            answers, parts = _combine_ranks(answers, parts, owners, mesh)
        for (rounds, syncs, n_active, compacted, fused, lo, hi, grouped), \
                w in zip(parts.tolist(), wait_s):
            stats.add_chunk(rounds, syncs, w, n_active, v_n,
                            bool(compacted), fused, lo + (hi << 31),
                            bool(grouped))
    return answers


_LOW31 = (1 << 31) - 1


def _chunk_owners(compact_flags, size: int) -> list[int]:
    """The rank that runs each phase-2 chunk: the c-th compacted chunk on
    rank ``c % size``, every full-graph chunk on rank 0 (the lead rank,
    which holds the V-sized class stacks)."""
    owners, c = [], 0
    for flag in compact_flags:
        owners.append(c % size if flag else 0)
        c += bool(flag)
    return owners


def _combine_ranks(answers: np.ndarray, parts: np.ndarray, owners: list,
                   mesh) -> tuple[np.ndarray, np.ndarray]:
    """OR the ranks' answers (one int32 all-reduce) and take each chunk's
    counters from the rank that ran it (one gather), in chunk order."""
    dev = mesh.device
    ans = torch.from_numpy(answers.astype(np.int32)).to(dev)
    answers = engine_mod.all_reduce_max(ans, mesh).cpu().numpy() != 0
    table = engine_mod.all_gather_words(torch.from_numpy(parts).to(dev),
                                        mesh).cpu().numpy()
    table = table.reshape(mesh.size, len(owners), parts.shape[1])
    return answers, table[owners, np.arange(len(owners))]


def answer(index: TDRIndex, u: int, v: int, p: pat.Pattern, **kw) -> bool:
    """Single-query convenience wrapper over ``answer_batch``."""
    return bool(answer_batch(index, [(u, v, p)], **kw)[0])


# ------------------------------------------------- semiring query kinds
# The executors below answer the non-boolean QUERY_KINDS over the same
# corridor-compacted subgraphs phase 2 uses, with a (min, +) distance DP
# ("dist"/"witness") or a saturating route-count DP ("count") instead of
# the packed boolean closure.  Product-graph states are the same (vertex,
# seen-required-subset) pairs; the carrier is a dense [V', J, S] lane
# plane.  Distance planes hold their uint16 values widened to int32
# (DIST_INF = 65535 is INF) and are narrowed to the stored uint16 lanes
# only for ``lane_matmul``; count planes are int64, so no sum can wrap
# before its clamp.
#
# Reusing the corridor is sound: every vertex on a u→v walk is reachable
# from u and co-reachable to v, so it lies in the Bloom corridor
# N_out(u) ∩ N_in(v) — compaction never cuts a path or a counted walk.

#: distance-plane INF (the uint16 carrier's saturation point)
DIST_INF = DIST16.inf

# int32 sentinel for the bidirectional meet arithmetic: it dominates any
# real distance (<= DIST_INF - 1), and sentinel + sentinel cannot wrap
_DBIG = 1 << 24


def _edge_dist_ops(lab, req_labels, forb_raw_w, max_m: int, evalid=None,
                   neutral=None):
    """Per-(job, edge|class) DP operands: ``allow`` bool [J, E] (edge
    usable for the job) and ``sh`` int32 [J, E] (the subset bit the edge's
    label sets, 0 if not required).  ``evalid`` masks bucket-padding edge
    rows, which would double-count in the sum DP; ``neutral`` marks merged
    label-class rows (always allowed, no subset bit)."""
    labx = lab.clamp(min=0)
    okbit = (forb_raw_w[:, labx >> 5] >> (labx & 31)[None, :]) & 1
    allow = okbit == 0                                          # [J, E|C]
    if neutral is not None:
        allow = allow | neutral[None, :]
    if evalid is not None:
        allow = allow & evalid[None, :]
    sh = torch.zeros((req_labels.shape[0], lab.shape[0]), dtype=torch.int32,
                     device=lab.device)
    for i in range(max_m):   # require-sets hold distinct ids
        match = req_labels[:, i][:, None] == lab[None, :]
        if neutral is not None:
            match = match & ~neutral[None, :]
        sh = torch.where(match, 1 << i, sh)
    return allow, sh


def _subset_step(y, sh, allow, s_idx):
    """Per-edge subset transition of a [rows, J, S] plane: target state s
    takes min(y[s], y[s ^ sh]) where it holds the edge's subset bit (or
    the edge sets none), INF where the edge is not allowed."""
    alt = torch.take_along_dim(y, (s_idx ^ sh).long(), dim=2)
    ok = ((s_idx & sh) == sh) & allow
    return torch.where(ok, torch.minimum(y, alt), DIST_INF)


def _dist_meet(df, db, full_mask, best, n_states: int):
    """best[j] = min over vertices x and state pairs (s1, s2) with
    ``s1 | s2 == full_mask[j]`` of ``df[x,j,s1] + db[x,j,s2]``."""
    dfi = torch.where(df == DIST_INF, _DBIG, df)
    dbi = torch.where(db == DIST_INF, _DBIG, db)
    s_idx = torch.arange(n_states, dtype=torch.int32, device=df.device)
    for s1 in range(n_states):
        valid = (s1 | s_idx)[None, :] == full_mask[:, None]      # [J, S]
        tot = dfi[:, :, s1:s1 + 1] + dbi                         # [V', J, S]
        tot = torch.where(valid[None], tot, _DBIG)
        best = torch.minimum(best, tot.amin(dim=(0, 2)))
    return best


def _dist_bidi_loop(df0, db0, push_f, push_b, full_mask, it_cap: int,
                    n_states: int, max_rounds: int):
    """Alternating bidirectional (min, +) fixpoint.  A job is done once
    its best meet value is <= 2·it: after ``it`` rounds each plane holds
    every product distance <= it exactly, so any path of length <= 2·it
    has met.  The loop test runs before each round, and a direction whose
    last push relaxed nothing skips its push, as in the JAX package; one
    host sync per round reads the three flags.  Returns ``(best, rounds,
    syncs)``."""
    syncs = spans.Syncs()
    df, db = df0, db0
    best = _dist_meet(df, db, full_mask,
                      torch.full((df.shape[1],), _DBIG, dtype=torch.int32,
                                 device=df.device), n_states)
    cf, cb, it = True, True, 0
    all_done = syncs.read((best <= 0).all())
    while (cf or cb) and not all_done and it < max_rounds and it < it_cap:
        ndf = torch.minimum(df, push_f(df)) if cf else df
        ndb = torch.minimum(db, push_b(db)) if cb else db
        best = _dist_meet(ndf, ndb, full_mask, best, n_states)
        it += 1
        cf, cb, all_done = syncs.read(torch.stack(
            [(ndf != df).any(), (ndb != db).any(),
             (best <= 2 * it).all()]))
        df, db = ndf, ndb
    return best, it, syncs


def _dist_seed(idx, v_p: int, n_states: int):
    """[V', J, S] INF plane with distance 0 at (idx[j], j, state ∅)."""
    j_n = idx.shape[0]
    d = torch.full((v_p, j_n, n_states), DIST_INF, dtype=torch.int32,
                   device=idx.device)
    d[idx, torch.arange(j_n, device=idx.device), 0] = 0
    return d


def _dist_bidi(su, sv, req_labels, forb_raw_w, full_mask, sub_src, sub_dst,
               sub_lab, evalid, it_cap: int, v_p: int, n_states: int,
               max_m: int, max_rounds: int):
    """Segment-family bidirectional distance core over a (sub)graph's edge
    lists: one round = lane gather, per-edge subset transition,
    saturating +1, segment-min scatter."""
    allow, sh = _edge_dist_ops(sub_lab, req_labels, forb_raw_w, max_m,
                               evalid=evalid)
    allow_t = allow.T[:, :, None]                               # [E, J, 1]
    sh_t = sh.T[:, :, None]
    s_idx = torch.arange(n_states, dtype=torch.int32, device=su.device)

    def push(dist, gat, scat):
        val = _subset_step(dist[gat], sh_t, allow_t, s_idx)     # [E, J, S]
        val = val + (val < DIST_INF).to(torch.int32)            # saturating +1
        out = torch.full((v_p,) + val.shape[1:], DIST_INF, dtype=torch.int32,
                         device=val.device)
        return out.scatter_reduce_(
            0, scat[:, None, None].expand_as(val), val, "amin")

    return _dist_bidi_loop(
        _dist_seed(su, v_p, n_states), _dist_seed(sv, v_p, n_states),
        lambda d: push(d, sub_src, sub_dst),
        lambda d: push(d, sub_dst, sub_src),
        full_mask, it_cap, n_states, max_rounds)


def _dist_bidi_matmul(su, sv, req_labels, forb_raw_w, full_mask, adj_rev,
                      adj_fwd, class_label, it_cap: int, n_states: int,
                      max_m: int, max_rounds: int):
    """Kernel-backend distance core: one ``lane_matmul`` (min) per label
    class per direction per round, over the plane flattened to [V', J·S]
    uint16 lanes.  ``_matmul_rows`` applies the DIST16 extend (saturating
    +1) after each product; min is monotone, so that equals extending
    before it, and the per-class results combine by lane min."""
    j_n = su.shape[0]
    v_p = adj_rev.shape[1]
    neutral = class_label < 0
    allow, sh = _edge_dist_ops(class_label, req_labels, forb_raw_w, max_m,
                               neutral=neutral)                 # [J, C]
    s_idx = torch.arange(n_states, dtype=torch.int32, device=su.device)

    def push(dist, adj_set):
        lanes = narrow(dist.reshape(v_p, j_n * n_states), DIST16.bits)
        upd = torch.full_like(dist, DIST_INF)
        for c in range(adj_set.shape[0]):
            y = widen(engine_mod._matmul_rows(
                adj_set[c], lanes, sr=DIST16)[:v_p]).reshape(
                    v_p, j_n, n_states)
            upd = torch.minimum(upd, _subset_step(
                y, sh[:, c][None, :, None], allow[:, c][None, :, None],
                s_idx))
        return upd

    return _dist_bidi_loop(
        _dist_seed(su, v_p, n_states), _dist_seed(sv, v_p, n_states),
        lambda d: push(d, adj_rev), lambda d: push(d, adj_fwd),
        full_mask, it_cap, n_states, max_rounds)


def _dist_forward_parents(su: int, req_labels, forb_raw_w, sub_src, sub_dst,
                          sub_lab, evalid, v_p: int, n_states: int,
                          max_m: int, max_rounds: int):
    """Single-term forward distance DP with parent-edge planes.

    Unit weights make the DP BFS-layered (a cell's first finite write is
    its final distance), so a parent is recorded only on ``winner`` cells
    (``upd < dist``): the round's arriving values are compared with the
    winning value and the least matching edge id is scattered.  Per-edge
    parent scatters are edge-indexed, so witnesses use this segment core
    on both backends."""
    allow, sh = _edge_dist_ops(sub_lab, req_labels[None, :],
                               forb_raw_w[None, :], max_m, evalid=evalid)
    allow = allow[0][:, None, None]                             # [E, 1, 1]
    sh = sh[0][:, None, None]
    dev = sub_src.device
    s_idx = torch.arange(n_states, dtype=torch.int32, device=dev)
    eids = torch.arange(sub_lab.shape[0], dtype=torch.int32,
                        device=dev)[:, None]
    d = torch.full((v_p, n_states), DIST_INF, dtype=torch.int32, device=dev)
    d[su, 0] = 0
    par = torch.full((v_p, n_states), -1, dtype=torch.int32, device=dev)
    idx = sub_dst[:, None].expand(-1, n_states)
    changed, rounds = True, 0
    while changed and rounds < max_rounds:
        val = _subset_step(d[sub_src][:, None], sh, allow, s_idx)[:, 0]
        val = val + (val < DIST_INF).to(torch.int32)            # [E, S]
        upd = torch.full_like(d, DIST_INF).scatter_reduce_(0, idx, val,
                                                           "amin")
        winner = upd < d                  # first discovery == final dist
        match = (val == upd[sub_dst]) & (val < DIST_INF)
        cand = torch.where(match, eids, 1 << 30)
        parc = torch.full_like(d, (1 << 31) - 1).scatter_reduce_(
            0, idx, cand, "amin")
        par = torch.where(winner, parc, par)
        d = torch.minimum(d, upd)
        changed = bool(winner.any())
        rounds += 1
    return d, par, rounds


def _count_forward(su, sv, req_labels, forb_raw_w, full_mask, sub_src,
                   sub_dst, sub_lab, evalid, hops: int, v_p: int,
                   n_states: int, max_m: int, cap: int):
    """Bounded route-count DP: w[x, j, s] = number of length-r walks from
    u reaching x having seen subset s, every partial sum clamped at
    ``cap``.  A target state s collects from s (label already seen) and,
    when the edge's label is required (``sh > 0``), from s ^ sh.  Int64
    planes; per-edge clamp + sum + clamp equals clamping the true total
    (saturating add of non-negative values is associative)."""
    j_n = su.shape[0]
    dev = su.device
    allow, sh = _edge_dist_ops(sub_lab, req_labels, forb_raw_w, max_m,
                               evalid=evalid)
    allow_t = allow.T[:, :, None]
    sh_t = sh.T[:, :, None]
    s_idx = torch.arange(n_states, dtype=torch.int32, device=dev)
    iota = torch.arange(j_n, device=dev)
    w = torch.zeros((v_p, j_n, n_states), dtype=torch.int64, device=dev)
    w[su, iota, 0] = 1
    total = ((su == sv) & (full_mask == 0)).to(torch.int64)   # empty walk
    alt_idx = (s_idx[None, None, :] ^ sh_t).long()
    ok = ((s_idx[None, None, :] & sh_t) == sh_t) & allow_t
    for _ in range(hops):
        rows = w[sub_src]                                       # [E, J, S]
        alt = torch.take_along_dim(rows, alt_idx, dim=2)
        contrib = rows + torch.where(sh_t > 0, alt, 0)
        val = torch.where(ok, contrib.clamp(max=cap), 0)
        w = torch.zeros_like(w).index_add_(0, sub_dst, val).clamp(max=cap)
        total = (total + w[sv, iota, full_mask.long()]).clamp(max=cap)
    return total


class _KindChunk(NamedTuple):
    """Operands of one lane-DP chunk: its ``Subgraph``, the jobs'
    endpoints in its numbering on the device, and its edges on the host,
    padded onto the bucket grid."""
    sub: Subgraph
    su: torch.Tensor            # renumbered sources int64 [J]
    sv: torch.Tensor            # renumbered targets int64 [J]
    src: np.ndarray             # edge sources int32 [E'] (bucket-padded)
    dst: np.ndarray             # edge targets int32 [E']
    lab: np.ndarray             # edge labels int32 [E']
    evalid: np.ndarray          # bool [E'], False on padding rows

    @property
    def v_p(self) -> int:
        return self.sub.v_p

    @property
    def stack_edges(self):
        """The edges ``_class_stacks`` packs: the subgraph's own, never
        the padding rows (in an edgeless corridor those make up 0 -> 0);
        None for a full-graph chunk, whose stacks come from the engine's
        LRU."""
        sub = self.sub
        return None if sub.sub_ids is None else (sub.src, sub.dst, sub.lab)

    def edges_on_device(self):
        """``(src, dst, lab, evalid)`` on the chunk's device, in the lane
        cores' argument order."""
        dev = self.su.device
        return (*(_to_long(a, dev) for a in (self.src, self.dst, self.lab)),
                torch.from_numpy(self.evalid).to(dev))


def _kind_chunk(ex: ExactExecutor, plan: QueryPlan, pd: PlanDevice,
                jobs: np.ndarray, exact_mode: str) -> _KindChunk:
    """One job chunk's graph for the lane DPs (``ExactExecutor.subgraph``
    over the chunk's corridor, or the full graph in "full" mode), its
    edge padding rows masked through ``evalid`` instead of relying on
    idempotence."""
    active = None
    if exact_mode != "full":
        active = ex.corridor_members(pd, jobs).any(axis=0)
    sub = ex.subgraph(active, exact_mode)
    e_real = int(sub.src.shape[0])
    e_p = graph_mod.pad_bucket(max(e_real, 1), lo=32)
    evalid = np.arange(e_p) < e_real
    if e_real:      # padding rows repeat the first edge
        edges = (np.ascontiguousarray(_pad_first(a, e_p))
                 for a in (sub.src, sub.dst, sub.lab))
    else:           # corridor holds no edges: the DP sees a masked bucket
        edges = (np.zeros(e_p, np.int32) for _ in range(3))
    return _KindChunk(sub, *sub.endpoints(plan, jobs, ex.index.device),
                      *edges, evalid)


def _kind_setup(index: TDRIndex, queries, *, max_m: int, backend,
                engine_config, stats, device, what: str, exact_mode: str,
                pin_m: int | None):
    """Shared prologue of the lane executors: device check, plan, engine,
    executor, state width and the plan's device arrays."""
    if exact_mode not in KIND_MODES:
        raise ValueError(f"unknown exact_mode {exact_mode!r} for {what}; "
                         "expected auto | compact | full")
    _check_device(index, device)
    plan = compile_queries(index, queries, max_m=max_m, stats=stats)
    eng = index.engine(backend, engine_config)
    ex = _executor(index, eng)
    m_eff, n_states = ex.eff_states(plan, np.arange(plan.n_jobs), pin_m)
    return plan, eng, ex, m_eff, n_states, PlanDevice.of(plan, index.device)


def dist_batch(index: TDRIndex,
               queries: Sequence[tuple[int, int, pat.Pattern]],
               *, k: int | None = None, max_m: int = 4,
               exact_chunk: int = 32, backend: str | None = None,
               exact_mode: str = "auto",
               engine_config: "engine_mod.EngineConfig | None" = None,
               special_labels: Sequence[int] | None = None,
               pin_m: int | None = None,
               stats: QueryStats | None = None,
               device="cuda") -> np.ndarray:
    """Shortest pattern-constrained hop distances.  Returns int64
    [n_queries]; -1 = unreachable (or farther than ``k`` when a k-hop
    bound is given; the bound also caps the DP at ceil(k/2) rounds).

    Multi-term patterns take the min over terms.  On the ``matmul``
    backend each chunk runs the per-label-class ``lane_matmul`` core; its
    class stack is held to the engine's dense cap (over it a card raises
    ``DenseCapError``, the CPU warns and runs the segment core).
    ``special_labels`` and ``pin_m`` are the serving pins of
    ``answer_plan``.  ``device`` defaults to the card and must be where
    ``index`` lives."""
    stats = stats if stats is not None else QueryStats()
    with spans.span("query.phase2", stats, "phase2_s"):
        plan, eng, ex, m_eff, n_states, pd = _kind_setup(
            index, queries, max_m=max_m, backend=backend,
            engine_config=engine_config, stats=stats, device=device,
            what="dist", exact_mode=exact_mode, pin_m=pin_m)
        stats.n_queries += plan.n_queries
        stats.n_jobs += plan.n_jobs
        out = np.full(plan.n_queries, -1, np.int64)
        if plan.n_jobs == 0:
            return out
        best_j = np.full(plan.n_jobs, _DBIG, np.int64)
        for _, jobs, real_n in _chunks(np.arange(plan.n_jobs), exact_chunk):
            ch = _kind_chunk(ex, plan, pd, jobs, exact_mode)
            max_rounds = ch.v_p * n_states + 1
            it_cap = max_rounds if k is None else max(-(-int(k) // 2), 0)
            req, frw, fm = pd.rows(jobs, m_eff)
            stacks = None
            if eng.backend == "matmul":
                stacks = _class_stacks(
                    eng, _pinned(ex.special_labels(plan, jobs),
                                 special_labels),
                    ch.v_p, ch.stack_edges)
            if stacks is not None:
                best, rounds, syncs = _dist_bidi_matmul(
                    ch.su, ch.sv, req, frw, fm, *stacks, it_cap, n_states,
                    m_eff, max_rounds)
            else:
                best, rounds, syncs = _dist_bidi(
                    ch.su, ch.sv, req, frw, fm, *ch.edges_on_device(),
                    it_cap, ch.v_p, n_states, m_eff, max_rounds)
            best_j[jobs[:real_n]] = best.cpu().numpy()[:real_n]
            stats.add_chunk(rounds, syncs.n, syncs.wait_s, ch.sub.n_sub,
                            index.graph.n_vertices)
        bq = np.full(plan.n_queries, _DBIG, np.int64)
        np.minimum.at(bq, plan.qid, best_j)
        reach = bq < _DBIG
        out[reach] = bq[reach]
        if k is not None:
            out[out > int(k)] = -1
        stats.exact_jobs += plan.n_jobs
        return out


def dist(index: TDRIndex, u: int, v: int, p: pat.Pattern, **kw) -> int:
    """Single-query shortest pattern-constrained distance (hops), -1 if
    unreachable; a wrapper over ``dist_batch``."""
    return int(dist_batch(index, [(u, v, p)], **kw)[0])


def witness(index: TDRIndex, u: int, v: int, p: pat.Pattern,
            *, max_m: int = 4, backend: str | None = None,
            exact_mode: str = "auto",
            engine_config: "engine_mod.EngineConfig | None" = None,
            pin_m: int | None = None,
            stats: QueryStats | None = None, device="cuda"
            ) -> list[tuple[int, int, int]] | None:
    """An actual shortest witness path for a PCR query.

    Returns a list of ``(x, y, label)`` edges chaining u→v whose label set
    satisfies ``p`` and whose length is the exact shortest
    pattern-constrained distance; ``[]`` when the empty path answers
    (u == v and some term requires nothing); ``None`` when unreachable.
    Every returned path is replayed against the graph through
    ``dfs_baseline.verify_witness`` before it leaves this function."""
    plan, eng, ex, m_eff, n_states, pd = _kind_setup(
        index, [(u, v, p)], max_m=max_m, backend=backend,
        engine_config=engine_config, stats=stats, device=device,
        what="witness", exact_mode=exact_mode, pin_m=pin_m)
    if plan.n_jobs == 0:
        return None
    ch = _kind_chunk(ex, plan, pd, np.arange(plan.n_jobs), exact_mode)
    max_rounds = ch.v_p * n_states + 1
    edges = ch.edges_on_device()
    best_t, best_len, planes = -1, None, []
    for t in range(plan.n_jobs):
        dplane, par, _ = _dist_forward_parents(
            int(ch.su[t]), pd.req_labels[t, :m_eff], pd.forb_raw_w[t],
            *edges, ch.v_p, n_states, m_eff, max_rounds)
        planes.append((dplane, par))
        d_t = int(dplane[int(ch.sv[t]), int(plan.full_mask[t])])
        if d_t < DIST_INF and (best_len is None or d_t < best_len):
            best_t, best_len = t, d_t
    if best_len is None:
        return None
    if best_len == 0:
        return []
    dn = planes[best_t][0].cpu().numpy().astype(np.int64)
    pn = planes[best_t][1].cpu().numpy()
    req = plan.req_labels[best_t]
    x = int(ch.sv[best_t])
    state = int(plan.full_mask[best_t])
    path: list[tuple[int, int, int]] = []
    while dn[x, state] > 0:
        e = int(pn[x, state])
        px, lx = int(ch.src[e]), int(ch.lab[e])
        shx = 0
        for i in range(m_eff):
            if int(req[i]) == lx:
                shx = 1 << i
        want = dn[x, state] - 1
        nxt = None
        # the pre-edge state dropped the edge's subset bit, or already had
        # the label; either predecessor one hop closer is valid
        for so in ([state, state ^ shx] if shx else [state]):
            if dn[px, so] == want:
                nxt = so
                break
        if nxt is None:
            raise RuntimeError("witness backtrack: broken parent chain "
                               f"at vertex {x}, state {state}")
        path.append((px, x, lx))
        x, state = px, nxt
    path.reverse()
    if ch.sub.sub_ids is not None:   # map compacted ids back to the graph
        path = [(int(ch.sub.sub_ids[a]), int(ch.sub.sub_ids[b]), l)
                for (a, b, l) in path]
    if len(path) != best_len or not dfs_mod.verify_witness(
            index.graph, u, v, p, path):
        raise RuntimeError("witness verification failed: extracted path "
                           "does not replay on the graph")
    return path


def count_routes(index: TDRIndex, u: int, v: int, p: pat.Pattern,
                 *, hops: int, cap: int = COUNT_CAP, max_m: int = 4,
                 backend: str | None = None, exact_mode: str = "auto",
                 engine_config: "engine_mod.EngineConfig | None" = None,
                 pin_m: int | None = None,
                 stats: QueryStats | None = None, device="cuda") -> int:
    """Number of pattern-satisfying u→v walks of length <= ``hops``,
    saturating at ``cap`` (``semiring.COUNT_CAP`` by default).

    Walks, not simple paths: a cycle counts per traversal, the
    product-graph DP that ``dfs_baseline.count_routes`` runs.  Single-DNF-
    term patterns only (terms overlap, so a per-term sum would
    double-count).  ``cap`` is held to ``E'·cap < 2^32``, the JAX package's
    bound for its uint32 accumulator, so both refuse the same inputs."""
    if len(pat.to_dnf(p)) != 1:
        raise ValueError(
            f"count_routes needs a single-DNF-term pattern, got "
            f"{len(pat.to_dnf(p))} terms")
    plan, eng, ex, m_eff, n_states, pd = _kind_setup(
        index, [(u, v, p)], max_m=max_m, backend=backend,
        engine_config=engine_config, stats=stats, device=device,
        what="count", exact_mode=exact_mode, pin_m=pin_m)
    ch = _kind_chunk(ex, plan, pd, np.arange(plan.n_jobs), exact_mode)
    if ch.src.shape[0] * cap >= 1 << 32:
        raise ValueError(
            f"cap={cap} with {ch.src.shape[0]} edges could wrap the "
            "uint32 count accumulator; lower the cap")
    total = _count_forward(
        ch.su, ch.sv, pd.req_labels[:, :m_eff], pd.forb_raw_w, pd.full_mask,
        *ch.edges_on_device(), int(hops), ch.v_p, n_states, m_eff, int(cap))
    return int(total[0])


# ------------------------------------------------- regular path queries
# RPQs (``repro_torch.rpq``) constrain the *order* of a path's labels,
# which the subset-state planes above cannot express.  The fragment that
# DNF lowering absorbs exactly (unions of single-atom stars, the RPQ
# spelling of LCR) rides ``answer_plan`` untouched; everything else runs
# the corridor expansion generalized from subset states to Glushkov NFA
# states: the ``[V', J]`` plane's word holds "NFA states reachable at
# vertex x" (forward) / "states from which (v, accept) is reachable"
# (backward), per-edge transitions come from the per-job ``[L, 32]`` NFA
# tables, and a query meets once some vertex holds ``f & b != 0``.  The
# filter cascade still prunes via the regex's label over-approximation,
# but only its FALSE verdicts are sound (set logic is order-blind), so it
# runs ``filters_only`` and its survivors go to the product executor.


class RpqRows(NamedTuple):
    """Per-regex compiled operands (endpoint-independent, cached like
    ``PatternRows`` under the same LRU with kind "rpq" keys)."""
    tab: np.ndarray             # uint32 [L, 32]  forward NFA table
    rtab: np.ndarray            # uint32 [L, 32]  reverse NFA table
    accept: int                 # uint32 accept-state bitmask
    nullable: bool              # ε ∈ L(r): u == v answers True
    nfa_states: int             # Glushkov state count (<= 32)
    lowered: object             # exact pattern.Pattern lowering, or None
    approx: object              # over-approximation pattern (prune only)
    feasible: bool              # False: some required label can't exist
    alpha: tuple                # in-graph alphabet (matmul label classes)

    @property
    def n_terms(self) -> int:
        return 1                # one product-executor job per query


def _compile_rpq_rows(index: TDRIndex, r, max_m: int) -> RpqRows:
    n_labels = index.graph.n_labels
    nfa = rpq_mod.compile_nfa(r, n_labels)
    lowered = rpq_mod.lower_to_pattern(r, n_labels)
    approx, feasible = rpq_mod.approx_pattern(r, n_labels,
                                              max_require=max_m)
    alpha = tuple(sorted(a for a in rpq_mod.alphabet(r) if a < n_labels))
    return RpqRows(tab=nfa.tab, rtab=nfa.rtab, accept=int(nfa.accept),
                   nullable=bool(nfa.nullable), nfa_states=nfa.n_states,
                   lowered=lowered, approx=approx, feasible=feasible,
                   alpha=alpha)


def rpq_rows(index: TDRIndex, r, max_m: int = 4,
             stats: "QueryStats | None" = None) -> RpqRows:
    """Cached compiled operands for one RPQ (canonical key, the same
    bounded LRU and lock as ``pattern_rows``)."""
    return _cached_rows(
        index, (rpq_mod.canonical_key(r), max_m, "rpq"), stats,
        lambda: _compile_rpq_rows(index, rpq_mod.canonicalize(r), max_m))


def _nfa_apply(masks, tab_e, q_u: int = 32):
    """Union of ``tab_e[..., q]`` over the set bits q < ``q_u`` of
    ``masks``: one NFA step applied to a packed state-subset plane, the
    reference's ``q_u``-way unroll.  The executors run ``_nfa_apply_lut``;
    this is what the tests hold it to."""
    out = torch.zeros_like(masks)
    for q in range(q_u):
        hit = ((masks >> q) & 1) != 0
        out = out | torch.where(hit, tab_e[..., q], 0)
    return out


def _nfa_luts(tabs, q_u: int):
    """Byte lookup tables of NFA tables ``tabs`` int32 [R, J, 32] (R label
    or class rows, J jobs) -> int32 [R, J, nb, 256], nb = ceil(q_u / 8):
    entry [r, j, b, x] is the union of ``tabs[r, j, 8b + i]`` over the set
    bits i of byte x, with the columns from ``q_u`` on dropped (the
    chunk's NFAs never set those states)."""
    nb = -(-q_u // 8)
    t = tabs[..., :q_u]
    if q_u < 8 * nb:
        t = torch.cat([t, t.new_zeros(t.shape[:-1] + (8 * nb - q_u,))], -1)
    t = t.reshape(t.shape[:-1] + (nb, 8, 1))
    x = torch.arange(256, dtype=torch.int32, device=tabs.device)
    lut = torch.zeros(t.shape[:-2] + (256,), dtype=torch.int32,
                      device=tabs.device)
    for i in range(8):
        lut = lut | torch.where(((x >> i) & 1) != 0, t[..., i, :], 0)
    return lut


def _lut_bases(rows, q_n: int, nb: int):
    """Per byte b, the flat offset of table (rows, job) in a
    ``_nfa_luts`` result: ``((rows * J + j) * nb + b) * 256`` int64, with
    ``rows`` [...] broadcast against the job axis."""
    j = torch.arange(q_n, device=rows.device)
    base = (rows[..., None] * q_n + j) * nb
    return [(base + b) * 256 for b in range(nb)]


def _nfa_apply_lut(masks, bases, lut_flat):
    """``_nfa_apply`` by byte lookups.  δ is linear over union
    (δ(S₁ ∪ S₂) = δ(S₁) ∪ δ(S₂)), so the image of a state set is the OR of
    the images of its bytes: nb gathers from the flat table ``lut_flat``
    at offsets ``bases[b]`` (``_lut_bases``) instead of 32 masked ORs.
    Words are int32, so every right shift is masked."""
    out = None
    for b, base in enumerate(bases):
        byte = (masks >> (8 * b)) & 255 if b else masks & 255
        val = lut_flat[base + byte]
        out = val if out is None else out | val
    return out


def _or_reduce0(x):
    """OR over the leading axis of an int32 tensor, by halving."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] | x[h:2 * h]
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def _rpq_sup_need(q_n: int, device="cpu"):
    """``ref.subset_meet``'s sup_need table specialized to the NFA meet:
    forward state q completes with exactly backward state q -> int32
    [32, Q] (row 31 is the int32 with only bit 31 set)."""
    bits = torch.tensor([_i32(1 << q) for q in range(32)],
                        dtype=torch.int32, device=device)
    return bits[:, None].expand(32, q_n)


def _rpq_meet(f, b):
    """done[q] = some vertex holds a forward state that is also a backward
    state: ``ref.subset_meet(f, b, _rpq_sup_need(Q))`` in one AND."""
    return ((f & b) != 0).any(dim=0)


def _rpq_bidi(su, sv, tabs, rtabs, accept, sub_src, sub_dst, sub_lab,
              evalid, ids_in, ids_out, *, v_p: int, max_rounds: int,
              chunk_words: int, q_u: int = 32):
    """Segment-backend product-graph fixpoint over a (sub)graph's edge
    lists.  One round = lane gather, per-edge NFA transition from the
    job's table (a byte lookup by the edge's label), OR over the padded
    in/out incidence (padding edges are never referenced there).  When
    the incidence is None (degree skew beyond the gather cap) the
    reduction is a packed segment-OR with padding edges masked by
    ``evalid``: a padding edge would make up a letter, and unlike the
    idempotent subset-state closure, a made-up edge changes the language.

    ``tabs``/``rtabs`` int32 [J, L, 32]; every NFA of the chunk has at
    most ``q_u`` states, so bits from ``q_u`` on are never set."""
    q_n = su.shape[0]
    nb = -(-q_u // 8)
    luts = [_nfa_luts(t.transpose(0, 1), q_u).reshape(-1)
            for t in (tabs, rtabs)]                     # [L, J, nb, 256]
    bases = _lut_bases(sub_lab, q_n, nb)                # [E', J] each
    ev = evalid[:, None]
    cor_w = torch.full((v_p, q_n), -1, dtype=torch.int32, device=su.device)

    def push(frontier, gat, lut, scat, ids):
        val = _nfa_apply_lut(frontier[gat], bases, lut)          # [E', J]
        if ids is None:
            val = torch.where(ev, val, 0)
        return _reduce_edges(val, scat, ids, v_p, chunk_words)

    return _bidi_loop(
        _seed(su, v_p, q_n), _seed(sv, v_p, q_n, accept),
        lambda f: push(f, sub_src, luts[0], sub_dst, ids_in),
        lambda b: push(b, sub_dst, luts[1], sub_src, ids_out),
        cor_w, _rpq_meet, max_rounds)


def _rpq_bidi_matmul(su, sv, tabs, rtabs, accept, adj_rev, adj_fwd,
                     class_label, *, max_rounds: int, q_u: int = 32):
    """Matmul-backend product-graph fixpoint: one ``bitset_matmul`` per
    label class per direction per round, then one byte-lookup NFA step
    over the stacked class results.  Every in-graph alphabet label of
    the chunk has its own class; the merged neutral class carries a zero
    transition table, sound because a label outside every job's alphabet
    has an all-zero NFA table row anyway."""
    q_n = su.shape[0]
    v_p = adj_rev.shape[1]
    n_c = class_label.shape[0]
    nb = -(-q_u // 8)
    live = (class_label >= 0)[:, None, None]
    labx = class_label.clamp(min=0)
    luts = [_nfa_luts(torch.where(live, t[:, labx, :].transpose(0, 1), 0),
                      q_u).reshape(-1)
            for t in (tabs, rtabs)]                     # [C+1, J, nb, 256]
    bases = _lut_bases(torch.arange(n_c, device=su.device)[:, None], q_n,
                       nb)                              # [C+1, 1, J] each
    cor_w = torch.full((v_p, q_n), -1, dtype=torch.int32, device=su.device)

    def push(frontier, adj_set, lut):
        ys = torch.stack([engine_mod._matmul_rows(adj_set[c], frontier)
                          for c in range(n_c)])          # [C+1, V', J]
        return _or_reduce0(_nfa_apply_lut(ys, bases, lut))

    return _bidi_loop(
        _seed(su, v_p, q_n), _seed(sv, v_p, q_n, accept),
        lambda f: push(f, adj_rev, luts[0]),
        lambda b: push(b, adj_fwd, luts[1]),
        cor_w, _rpq_meet, max_rounds)


def rpq_batch(index: TDRIndex, queries: Sequence[tuple], *,
              max_m: int = 4, exact_chunk: int = 32,
              backend: str | None = None, exact_mode: str = "auto",
              engine_config: "engine_mod.EngineConfig | None" = None,
              special_labels: Sequence[int] | None = None,
              pin_m: int | None = None, pad_lo: int = 16,
              q_unroll: int | None = None,
              stats: QueryStats | None = None,
              device="cuda") -> np.ndarray:
    """Answer ``(u, v, rpq)`` regular path queries.  Returns bool [n].

    ``q_unroll`` pins the NFA state width the transition steps read (a
    power of two in 4..32).  ``None`` derives the tightest width from each
    chunk's regexes; a serving layer pins 32 so the work per round never
    depends on which regexes a batch holds.  Like the other pins it can
    widen the width but never narrow it: a chunk whose NFAs need more
    states runs at their width (the JAX package would drop the states
    past the pin and answer wrongly).  ``special_labels``,
    ``pin_m`` and ``pad_lo`` are ``answer_plan``'s serving pins.
    ``device`` defaults to the card and must be where ``index`` lives.

    Three routes, all equal to ``dfs_baseline.answer_rpq``:

    * **lowered**: regexes in the index-expressible fragment
      (``rpq.lower_to_pattern``) become plain PCR queries through
      ``answer_plan``, bit for bit the equivalent pattern's answers;
    * **infeasible**: a required label no graph edge carries leaves only
      the empty path, so the answer is ``u == v and ε ∈ L(r)``;
    * **product**: everything else.  The filter cascade on the regex's
      over-approximation prunes (FALSE verdicts only), and the survivors
      run the corridor-compacted automaton-product expansion on either
      backend.  On ``matmul`` a chunk's class stack is held to the
      engine's dense cap (over it a card raises ``DenseCapError``, the
      CPU warns and runs the segment core).
    """
    if exact_mode not in KIND_MODES:
        raise ValueError(f"unknown exact_mode {exact_mode!r} for rpq; "
                         "expected auto | compact | full")
    if q_unroll is not None and q_unroll not in (4, 8, 16, 32):
        raise ValueError(f"q_unroll must be a power of two in 4..32, "
                         f"got {q_unroll!r}")
    stats = stats if stats is not None else QueryStats()
    out = np.zeros(len(queries), dtype=bool)
    # the planning stretch holds the lowered and filter answer_plan calls,
    # which count their own phases; it counts as phase 1 once the product
    # route runs
    with spans.span("query.phase1") as phase1:
        _check_device(index, device)
        eng = index.engine(backend, engine_config)
        if not queries:
            return out
        rows = [rpq_rows(index, r, max_m, stats=stats)
                for (_, _, r) in queries]
        plan_kw = dict(exact_chunk=exact_chunk, stats=stats,
                       backend=backend, exact_mode=exact_mode,
                       engine_config=engine_config,
                       special_labels=special_labels, pin_m=pin_m,
                       pad_lo=pad_lo)

        low_ix = [i for i, rw in enumerate(rows) if rw.lowered is not None]
        if low_ix:
            lowq = [(queries[i][0], queries[i][1], rows[i].lowered)
                    for i in low_ix]
            plan = compile_queries(index, lowq, max_m=max_m, stats=stats)
            out[low_ix] = answer_plan(index, plan, **plan_kw)

        hard_ix = []
        for i, rw in enumerate(rows):
            if rw.lowered is not None:
                continue
            if queries[i][0] == queries[i][1] and rw.nullable:
                out[i] = True       # the empty path spells ε
            elif rw.feasible:
                hard_ix.append(i)   # infeasible: out[i] stays False
        if not hard_ix:
            return out

        # phase 1: the cascade on the over-approximation.  A FALSE verdict
        # refutes the RPQ (every matching word satisfies the approximation);
        # filters_only returns the sound upper bound TRUE ∪ UNKNOWN
        approxq = [(queries[i][0], queries[i][1], rows[i].approx)
                   for i in hard_ix]
        aplan = compile_queries(index, approxq, max_m=max_m, stats=stats)
        ub = answer_plan(index, aplan, filters_only=True, **plan_kw)
        pos_of = {i: k for k, i in enumerate(hard_ix)}  # aplan job/query
        hard_ix = [i for i, alive in zip(hard_ix, ub) if alive]
        if not hard_ix:
            return out
    stats.phase1_s += phase1.seconds

    # phase 2: automaton-product expansion.  The approx plan has one term
    # per query (job k is approxq position k), so it doubles as the
    # endpoint plan and the corridor's source.
    with spans.span("query.phase2", stats, "phase2_s"):
        dev = index.device
        ex = _executor(index, eng)
        jobs_all = np.asarray([pos_of[i] for i in hard_ix], dtype=np.int64)
        pd = PlanDevice.of(aplan, dev)
        n_labels = index.graph.n_labels
        done_all = np.zeros(len(jobs_all), dtype=bool)
        for c0, jobs, real_n in _chunks(jobs_all, exact_chunk):
            ch = _kind_chunk(ex, aplan, pd, jobs, exact_mode)
            qrows = [rows[hard_ix[c0 + (j if j < real_n else 0)]]
                     for j in range(len(jobs))]
            q_u = 4
            while q_u < max(rw.nfa_states for rw in qrows):
                q_u *= 2
            if q_unroll is not None:
                q_u = max(q_u, q_unroll)
            max_rounds = ch.v_p * q_u + 1    # product-graph diameter bound
            tabs = bitset.np_to_words(np.stack([rw.tab for rw in qrows]), dev)
            rtabs = bitset.np_to_words(np.stack([rw.rtab for rw in qrows]),
                                       dev)
            accept = torch.tensor([_i32(rw.accept) for rw in qrows],
                                  dtype=torch.int32, device=dev)
            done = None
            if eng.backend == "matmul":
                special = set()
                for rw in qrows:
                    special.update(rw.alpha)
                if special_labels is not None:
                    special.update(int(l) for l in special_labels
                                   if 0 <= int(l) < n_labels)
                stacks = _class_stacks(eng, tuple(sorted(special)), ch.v_p,
                                       ch.stack_edges)
                if stacks is not None:
                    done, rounds, syncs = _rpq_bidi_matmul(
                        ch.su, ch.sv, tabs, rtabs, accept, *stacks,
                        max_rounds=max_rounds, q_u=q_u)
            if done is None:
                # padded-incidence gathers over the real edges only (the
                # padding rows' ids are never referenced); degree skew past
                # the cap falls back to masked segment-ORs
                done, rounds, syncs = _rpq_bidi(
                    ch.su, ch.sv, tabs, rtabs, accept,
                    *ch.edges_on_device(),
                    *ex.incidence(ch.sub, len(ch.src), len(jobs)),
                    v_p=ch.v_p, max_rounds=max_rounds,
                    chunk_words=eng.config.chunk_words, q_u=q_u)
            done_all[c0:c0 + real_n] = done.cpu().numpy()[:real_n]
            stats.add_chunk(rounds, syncs.n, syncs.wait_s, ch.sub.n_sub,
                            index.graph.n_vertices)
    out[hard_ix] = done_all
    stats.exact_jobs += len(jobs_all)
    return out


def answer_rpq(index: TDRIndex, u: int, v: int, r, **kw) -> bool:
    """Single-query convenience wrapper over ``rpq_batch``."""
    return bool(rpq_batch(index, [(u, v, r)], **kw)[0])


def answer_mixed(index: TDRIndex, queries: Sequence[tuple], *,
                 hops: int = 8, k: int | None = None,
                 cap: int = COUNT_CAP, max_m: int = 4,
                 backend: str | None = None, exact_mode: str = "auto",
                 engine_config: "engine_mod.EngineConfig | None" = None,
                 stats: QueryStats | None = None, device="cuda") -> list:
    """Answer a mixed-kind batch of ``(u, v, pattern[, kind])`` queries.

    Results align with the input order: bool for "bool", int distance (-1
    unreachable) for "dist", an edge list / [] / None for "witness", an
    int for "count" (bounded by ``hops``, clamped at ``cap``), and bool for
    "rpq" (whose third element is a ``repro_torch.rpq`` AST, not a
    pattern).  Same-kind queries batch together; "witness"/"count" run
    per query."""
    kinds = [(q[3] if len(q) > 3 else "bool") for q in queries]
    for kd in kinds:
        if kd not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {kd!r}; expected one "
                             f"of {QUERY_KINDS}")
    common = dict(max_m=max_m, backend=backend, exact_mode=exact_mode,
                  engine_config=engine_config, stats=stats, device=device)
    results: list = [None] * len(queries)
    bool_ix = [i for i, kd in enumerate(kinds) if kd == "bool"]
    if bool_ix:
        ans = answer_batch(index, [queries[i][:3] for i in bool_ix],
                           **common)
        for i, a in zip(bool_ix, ans):
            results[i] = bool(a)
    rpq_ix = [i for i, kd in enumerate(kinds) if kd == "rpq"]
    if rpq_ix:
        # the third element is a regex AST, which compile_queries would
        # reject, so the kinds are split before batching
        ans = rpq_batch(index, [queries[i][:3] for i in rpq_ix], **common)
        for i, a in zip(rpq_ix, ans):
            results[i] = bool(a)
    dist_ix = [i for i, kd in enumerate(kinds) if kd == "dist"]
    if dist_ix:
        ds = dist_batch(index, [queries[i][:3] for i in dist_ix], k=k,
                        **common)
        for i, dv in zip(dist_ix, ds):
            results[i] = int(dv)
    for i, kd in enumerate(kinds):
        if kd == "witness":
            results[i] = witness(index, *queries[i][:3], **common)
        elif kd == "count":
            results[i] = count_routes(index, *queries[i][:3], hops=hops,
                                      cap=cap, **common)
    return results
