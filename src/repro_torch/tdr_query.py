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
``kernels.ops.filter_ways``) refutes the rest or leaves them UNKNOWN.

Phase 2 — *corridor-compacted bidirectional expansion* for the UNKNOWN
jobs, in chunks of ``exact_chunk`` jobs.  A chunk whose Bloom corridor
``N_out(u) ∩ N_in(v)`` union is small runs on the induced subgraph,
renumbered and padded onto the ``{2^k, 3·2^(k-1)}`` grid; near-total
corridors run on the full graph.  Forward states (vertex, seen
required-subset) expand from ``u`` while backward states expand from
``v``, both as ``[V', Q]`` packed subset bitfields; a query finishes when
some vertex holds forward state s₁ and backward state s₂ with
``s₁ | s₂ == full_mask``.  One round is, on the ``matmul`` backend, one
``bitset_matmul`` per label class per direction; on ``segment``, a gather,
a per-edge subset transition and an OR over padded incidence rows.

The expansion is exact (the corridor is a superset of every u→v path), so
answers equal the DFS oracle bit for bit.  Every loop is a Python loop
with one host sync per round; plan shapes, round counts and ``QueryStats``
equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import bitset
from . import engine as engine_mod
from . import graph as graph_mod
from . import pattern as pat
from .kernels import ops
from .tdr_build import TDRIndex, _null_words

FALSE, TRUE, UNKNOWN = 0, 1, 2

EXACT_MODES = ("auto", "compact", "full")


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
            n_queries=self.n_queries, max_m=self.max_m)


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
    _round_parts: list = dataclasses.field(default_factory=list, repr=False)

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
                 stats: "QueryStats | None" = None) -> PatternRows:
    """Cached plan rows for one pattern (canonical-key LRU on the index);
    ``stats`` counts the lookup and the miss, if any."""
    key = (pat.canonical_key(p), max_m)
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
    rows = _compile_pattern_rows(index, pat.canonicalize(p), max_m)
    with _plan_cache_lock:
        while len(cache) >= PLAN_CACHE_CAP:
            cache.pop(next(iter(cache)))
        cache[key] = rows
    return rows


def compile_queries(index: TDRIndex,
                    queries: Sequence[tuple[int, int, pat.Pattern]],
                    max_m: int = 4,
                    stats: "QueryStats | None" = None) -> QueryPlan:
    """Compile (u, v, pattern) triples into a ``QueryPlan``."""
    cfg = index.cfg
    wl = bitset.n_words(cfg.lab_bits)
    wraw = bitset.n_words(max(index.graph.n_labels, 1))
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
        n_queries=len(queries), max_m=max_m)


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
    way_ok = ops.filter_ways(h_vtx[u], h_lab[u], v_vtx[u], v_lab[u],
                             vbits, req_w, forb_w, null_w)
    any_way = way_ok.any(dim=-1)

    maybe = topo_maybe & (any_way | same)
    verdict = torch.where(true_same | true_anc, TRUE,
                          torch.where(maybe, UNKNOWN, FALSE))
    # u == v with required labels: only a cycle through u can satisfy
    return torch.where(same & ~req_empty,
                       torch.where(any_way, UNKNOWN, FALSE), verdict)


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


def _transition(val, has, sh):
    """Apply subset transition ``s -> s | m`` to packed state bitfields:
    ``has`` masks the states that already hold the edge's required label
    (they stay), the rest shift up by ``sh = 2^i``.  ``has = ~0, sh = 0``
    is the identity."""
    return (val & has) | ((val & ~has) << sh)


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


def _meet(f, b, sup_need):
    """done[q] = ∃ vertex x, states s1 ∈ f[x,q], s2 ∈ b[x,q] with
    ``s1 | s2 == full_mask[q]`` (the bidirectional termination test)."""
    done = torch.zeros(f.shape[1], dtype=torch.bool, device=f.device)
    for s1 in range(sup_need.shape[0]):
        hit = (((f >> s1) & 1) != 0) & ((b & sup_need[s1][None, :]) != 0)
        done |= hit.any(dim=0)
    return done


def _bidi_loop(f0, b0, push_f, push_b, cor_w, sup_need, max_rounds: int):
    """Alternating bidirectional fixpoint.  One iteration = one forward +
    one backward expansion; a query's columns freeze once it meets, and a
    direction whose last push added nothing is at its fixpoint and skips
    its push.  One host sync per iteration reads the three loop flags."""
    f, b = f0, b0
    done = _meet(f, b, sup_need)
    cf, cb, all_done = True, True, bool(done.all())
    rounds = 0
    while (cf or cb) and not all_done and rounds < max_rounds:
        mask = cor_w & bitset.full_words_where(~done)[None, :]
        new_f = push_f(f) & mask & ~f if cf else torch.zeros_like(f)
        f = f | new_f
        new_b = push_b(b) & mask & ~b if cb else torch.zeros_like(b)
        b = b | new_b
        done = done | _meet(f, b, sup_need)
        cf, cb, all_done = torch.stack(
            [(new_f != 0).any(), (new_b != 0).any(), done.all()]).tolist()
        rounds += 1
    return done, rounds


def _seed(idx, v_p: int, q_n: int):
    """[V', Q] frontier holding subset state ∅ at row idx[q] of column q."""
    f0 = torch.zeros((v_p, q_n), dtype=torch.int32, device=idx.device)
    f0[idx, torch.arange(q_n, device=idx.device)] = 1
    return f0


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

    def reduce_cols(val, ids):
        out = val[ids[:, 0]]
        for j in range(1, ids.shape[1]):
            out = out | val[ids[:, j]]
        return out

    def push(frontier, gather_idx, ids, scatter_idx):
        val = _transition(frontier[gather_idx] & allow, has, sh)  # [E', Q]
        if ids is None:
            return bitset.segment_or_words(val, scatter_idx,
                                           num_segments=v_p,
                                           chunk_words=chunk_words)
        val = torch.cat([val, val.new_zeros((1, q_n))])
        for level in ids:   # 1 level, or virtual-row split on heavy tails
            val = reduce_cols(val, level)
        return val                                               # [V', Q]

    return _bidi_loop(
        _seed(su, v_p, q_n), _seed(sv, v_p, q_n),
        lambda f: push(f, sub_src, ids_in, sub_dst),
        lambda b: push(b, sub_dst, ids_out, sub_src),
        cor_w, sup_need, max_rounds)


def _bidi_matmul_core(su, sv, adj_rev, adj_fwd, class_label, req_labels,
                      forb_raw_w, full_mask, cor_w, n_states: int,
                      max_m: int, max_rounds: int):
    """Matmul-backend bidirectional fixpoint: one ``bitset_matmul`` per
    label class per direction per round on packed (sub-)adjacency
    bit-matrices (the forward frontier uses the reverse matrices)."""
    q_n = su.shape[0]
    v_p = cor_w.shape[0]
    neutral = class_label < 0
    allow, has, sh = _edge_state_masks(class_label, req_labels, forb_raw_w,
                                       n_states, max_m, neutral=neutral)
    sup_need = _sup_need(full_mask, n_states)

    def push(frontier, adj_set):
        upd = torch.zeros_like(frontier)
        for c in range(adj_set.shape[0]):
            y = engine_mod._matmul_rows(adj_set[c], frontier)[:v_p]
            upd = upd | _transition(y & allow[c][None, :], has[c][None, :],
                                    sh[c][None, :])
        return upd

    return _bidi_loop(
        _seed(su, v_p, q_n), _seed(sv, v_p, q_n),
        lambda f: push(f, adj_rev), lambda b: push(b, adj_fwd),
        cor_w, sup_need, max_rounds)


# ---------------------------------------------------------------- executor
class PlanDevice(NamedTuple):
    """Device copy of the plan's job-axis arrays (made once per batch)."""
    u: torch.Tensor
    v: torch.Tensor
    req_labels: torch.Tensor
    forb_raw_w: torch.Tensor
    full_mask: torch.Tensor


@dataclasses.dataclass
class ChunkResult:
    """Result of one phase-2 chunk."""
    jobs: np.ndarray        # padded job ids [Q]
    real_n: int
    reached: torch.Tensor | np.ndarray   # bool [Q]
    rounds: int
    n_active: int = 0       # |V'| this chunk ran on
    v_total: int = 0        # |V| of the full graph
    compacted: bool = False  # ran on an induced subgraph


def _to_long(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)


class ExactExecutor:
    """Phase-2 executor bound to one (index, engine) pair: holds the host
    mirrors for per-chunk corridor compaction and the cached full-graph
    incidence."""

    # cap on the padded-incidence gather transient (bytes); beyond it the
    # round falls back to packed segment reductions (extreme hub skew)
    GATHER_BYTES_CAP = 1 << 28

    def __init__(self, index: TDRIndex, eng: "engine_mod.Engine"):
        self.index = index
        self.engine = eng
        g = index.graph
        self.src_np = g.src
        self.dst_np = np.asarray(g.indices)
        self.lab_np = np.asarray(g.labels)
        self._full_inc: tuple | None = None

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

    def eff_states(self, plan: QueryPlan,
                   jobs: np.ndarray) -> tuple[int, int]:
        """(m_eff, n_states) for the pending set: the widest require-set
        actually present, not the plan-level ``max_m`` cap."""
        m_eff = int((plan.req_labels[jobs] >= 0).sum(axis=1).max(initial=0))
        return m_eff, 1 << m_eff

    # ------------------------------------------------------------ planning
    def chunk_union_counts(self, pd: PlanDevice, jobs: np.ndarray,
                           chunk: int) -> np.ndarray:
        """Exact corridor-union size per ``chunk``-sized job group (the
        compaction probe).  The tail group is padded with its own first
        job, which leaves its union unchanged."""
        idx = self.index
        groups = []
        for c0 in range(0, len(jobs), chunk):
            grp = jobs[c0:c0 + chunk]
            if len(grp) < chunk:
                grp = np.concatenate(
                    [grp, np.full(chunk - len(grp), grp[0], grp.dtype)])
            groups.append(grp)
        pj = np.concatenate(groups)
        step = max(chunk, (256 // chunk) * chunk)
        out = []
        for i0 in range(0, len(pj), step):
            sl = _to_long(pj[i0:i0 + step], idx.device)
            mem = _corridor_member(pd.u[sl], pd.v[sl], idx.n_out, idx.n_in,
                                   idx.vtx_packed)
            union = mem.reshape(-1, chunk, mem.shape[1]).any(dim=1)
            out.append(union.sum(dim=1).cpu().numpy())
        return np.concatenate(out).astype(np.int32)

    def corridor_members(self, pd: PlanDevice,
                         jobs: np.ndarray) -> np.ndarray:
        """Corridor membership bool [P, V] (fetched only for the jobs of
        chunks that will compact), in slices of 256 jobs."""
        idx = self.index
        out = np.empty((len(jobs), idx.graph.n_vertices), dtype=bool)
        for c0 in range(0, len(jobs), 256):
            sl = _to_long(jobs[c0:c0 + 256], idx.device)
            out[c0:c0 + 256] = _corridor_member(
                pd.u[sl], pd.v[sl], idx.n_out, idx.n_in,
                idx.vtx_packed).cpu().numpy()
        return out

    # ------------------------------------------------------------ dispatch
    def run_chunk(self, plan: QueryPlan, pd: PlanDevice, jobs: np.ndarray,
                  member: np.ndarray | None, special: tuple[int, ...],
                  mode: str) -> ChunkResult:
        """Expand one padded chunk of pending jobs.  ``member is None`` ->
        full-graph bidirectional expansion (corridor built on the device);
        else corridor compaction over the member rows."""
        idx, eng = self.index, self.engine
        dev = idx.device
        g = idx.graph
        q_n = len(jobs)
        v_n = g.n_vertices
        m_eff, n_states = self.eff_states(plan, jobs)
        if n_states > 32:
            raise ValueError(
                f"max_m={m_eff} needs {n_states} subset states; the packed "
                "executor holds at most 32 (max_m <= 5)")

        compacted = member is not None
        if compacted:
            active = member.any(axis=0)
            n_sub = int(active.sum())
            v_p = graph_mod.pad_bucket(n_sub, lo=32)
            if v_p >= v_n and mode == "auto":
                compacted = False   # probe over-estimated; run full
        jobs_t = _to_long(jobs, dev)
        req_labels = pd.req_labels[jobs_t][:, :m_eff]
        forb_raw_w = pd.forb_raw_w[jobs_t]
        full_mask = pd.full_mask[jobs_t]
        if compacted:
            sub_ids, renum, s, d, l = graph_mod.induced_edges(
                g, active, src=self.src_np)
            if s.shape[0] == 0:
                # corridor holds no edges: only the empty path exists, and
                # phase 1 already answered those — nothing is reachable
                return ChunkResult(jobs, q_n, np.zeros(q_n, bool), 0,
                                   n_sub, v_n, True)
            cor = np.zeros((v_p, q_n), dtype=bool)
            cor[:n_sub] = member[:, sub_ids].T
            cor_w = bitset.full_words_where(torch.from_numpy(cor).to(dev))
            su = _to_long(renum[plan.u[jobs]], dev)
            sv = _to_long(renum[plan.v[jobs]], dev)
        else:
            n_sub = v_p = v_n
            s, d, l = self.src_np, self.dst_np, self.lab_np
            su, sv = pd.u[jobs_t], pd.v[jobs_t]
            cor_w = _corridor_mask(su, sv, idx.n_out, idx.n_in,
                                   idx.vtx_packed)
        max_rounds = v_p * n_states + 1

        n_mats = 2 * (len(special) + 1)
        if eng.backend == "matmul" and eng.dense_fits(
                n_mats * v_p * bitset.n_words(v_p) * 4,
                f"this chunk's {n_mats} label-class adjacency matrices"):
            class_label = _to_long(np.asarray(special + (-1,)), dev)
            if compacted:
                adj_rev, adj_fwd = (
                    bitset.np_to_words(engine_mod.pack_label_class_edges_np(
                        s, d, l, v_p, special, reverse=rev), dev)
                    for rev in (True, False))
            else:
                adj_rev = eng.label_class_adjacency(special, reverse=True)
                adj_fwd = eng.label_class_adjacency(special, reverse=False)
            reached, rounds = _bidi_matmul_core(
                su, sv, adj_rev, adj_fwd, class_label, req_labels,
                forb_raw_w, full_mask, cor_w, n_states, m_eff, max_rounds)
            return ChunkResult(jobs, q_n, reached, rounds, n_sub, v_n,
                               compacted)

        if compacted:
            e_real = s.shape[0]
            ids_in = graph_mod.incidence_plan(d, v_p, e_real)
            ids_out = graph_mod.incidence_plan(s, v_p, e_real)
            lab_t, s_t, d_t = (_to_long(a, dev) for a in (l, s, d))
            in_t = tuple(_to_long(a, dev) for a in ids_in)
            out_t = tuple(_to_long(a, dev) for a in ids_out)
        else:
            lab_t, s_t, d_t, in_t, out_t = self._full_incidence()
        if sum(a.numel() for a in in_t + out_t) * q_n * 4 > \
                self.GATHER_BYTES_CAP:
            in_t = out_t = None
        reached, rounds = _bidi_segment_core(
            su, sv, req_labels, forb_raw_w, full_mask, cor_w, lab_t, s_t,
            d_t, in_t, out_t, n_states, m_eff, max_rounds,
            eng.config.chunk_words)
        return ChunkResult(jobs, q_n, reached, rounds, n_sub, v_n,
                           compacted)

    def _full_incidence(self):
        """Cached full-graph operand tuple for near-total corridors."""
        if self._full_inc is None:
            g = self.index.graph
            dev = self.index.device
            ids_in = graph_mod.incidence_plan(self.dst_np, g.n_vertices,
                                              g.n_edges)
            ids_out = graph_mod.incidence_plan(self.src_np, g.n_vertices,
                                               g.n_edges)
            self._full_inc = (
                _to_long(self.lab_np, dev), self.engine.edge_src,
                self.engine.edge_dst,
                tuple(_to_long(a, dev) for a in ids_in),
                tuple(_to_long(a, dev) for a in ids_out))
        return self._full_inc


def _executor(index: TDRIndex, eng: "engine_mod.Engine") -> ExactExecutor:
    ex = getattr(eng, "_executor", None)
    if ex is None or ex.index is not index:
        ex = ExactExecutor(index, eng)
        eng._executor = ex
    return ex


# ----------------------------------------------------------------- driver
def _check_device(index: TDRIndex, device) -> None:
    """Raise unless ``device`` (default: the card) is where the index is."""
    dev = engine_mod.resolve_device(device)
    have = index.device
    if dev.type != have.type or (dev.index is not None
                                 and dev.index != have.index):
        raise ValueError(f"index lives on {have}, asked to answer on {dev}")


def answer_batch(index: TDRIndex,
                 queries: Sequence[tuple[int, int, pat.Pattern]],
                 *, max_m: int = 4, exact_chunk: int = 32,
                 stats: QueryStats | None = None,
                 backend: str | None = None,
                 exact_mode: str = "auto",
                 engine_config: "engine_mod.EngineConfig | None" = None,
                 device="cuda") -> np.ndarray:
    """Answer a batch of PCR queries.  Returns bool [n_queries].

    ``device`` defaults to the card and must be where ``index`` lives
    (pass ``device="cpu"`` for an index built on the CPU)."""
    t0 = time.perf_counter()
    _check_device(index, device)
    plan = compile_queries(index, queries, max_m=max_m, stats=stats)
    return answer_plan(index, plan, exact_chunk=exact_chunk, stats=stats,
                       backend=backend, exact_mode=exact_mode,
                       engine_config=engine_config, _t0=t0)


def answer_plan(index: TDRIndex, plan: QueryPlan,
                *, exact_chunk: int = 32,
                stats: QueryStats | None = None,
                backend: str | None = None,
                exact_mode: str = "auto",
                engine_config: "engine_mod.EngineConfig | None" = None,
                _t0: float | None = None) -> np.ndarray:
    """Answer a compiled ``QueryPlan`` on the index's device.  Returns
    bool [plan.n_queries].

    ``backend``/``engine_config`` select the engine backend for phase 2.
    ``exact_mode`` picks the phase-2 executor: "auto" (corridor-compacted
    whenever the padded corridor bucket is smaller than V), "compact"
    (force compaction) or "full" (full graph).  The job axis is padded
    onto the ``{2^k, 3·2^(k-1)}`` grid from 16 up, as in the reference."""
    if plan.max_m > 5:
        raise ValueError(
            f"max_m={plan.max_m}: the packed executor holds subset states "
            "in one 32-bit bitfield, so at most 5 required labels per term "
            "(32 states); decompose the pattern")
    if exact_mode not in EXACT_MODES:
        raise ValueError(f"unknown exact_mode {exact_mode!r}; expected one "
                         f"of {EXACT_MODES}")
    t0 = _t0 if _t0 is not None else time.perf_counter()
    eng = index.engine(backend, engine_config)
    dev = index.device
    stats = stats if stats is not None else QueryStats()
    stats.n_queries += plan.n_queries
    stats.n_jobs += plan.n_jobs
    answers = np.zeros(plan.n_queries, dtype=bool)
    if plan.n_jobs == 0:
        return answers

    plan_p = plan.pad_to(graph_mod.pad_bucket(plan.n_jobs, lo=16))
    pd_u, pd_v = _to_long(plan_p.u, dev), _to_long(plan_p.v, dev)
    sat_out_d, sat_in_d = index.summary_flags_dev()
    verdict = _filter_cascade(
        pd_u, pd_v, bitset.np_to_words(plan_p.req_w, dev),
        bitset.np_to_words(plan_p.forb_w, dev),
        bitset.np_to_words(_null_words(index.cfg), dev),
        index.vtx_packed, index.h_vtx, index.h_lab, index.v_vtx,
        index.v_lab, index.n_out, index.n_in, sat_out_d, sat_in_d,
        index.push, index.pop).cpu().numpy()

    real = plan_p.qid >= 0
    stats.filter_false += int(((verdict == FALSE) & real).sum())
    stats.filter_true += int(((verdict == TRUE) & real).sum())
    np.logical_or.at(answers, plan_p.qid[(verdict == TRUE) & real], True)
    stats.phase1_s += time.perf_counter() - t0

    pending = np.flatnonzero((verdict == UNKNOWN) & real)
    # jobs whose query is already TRUE need no exact work
    pending = pending[~answers[plan_p.qid[pending]]]
    stats.exact_jobs += len(pending)
    stats.exact_qids = np.unique(plan_p.qid[pending]).tolist()
    if len(pending) == 0:
        return answers

    t1 = time.perf_counter()
    ex = _executor(index, eng)
    v_n = index.graph.n_vertices
    special = ex.special_labels(plan_p, pending)
    pd = PlanDevice(pd_u, pd_v, _to_long(plan_p.req_labels, dev),
                    bitset.np_to_words(plan_p.forb_raw_w, dev),
                    torch.from_numpy(plan_p.full_mask).to(dev))

    # chunk layout + compaction probe: membership [P, V] is fetched only
    # for the jobs of chunks that will actually compact
    starts = list(range(0, len(pending), exact_chunk))
    if exact_mode == "full":
        compact_flags = [False] * len(starts)
    elif exact_mode == "compact":
        compact_flags = [True] * len(starts)
    else:
        # summary-first probe skip: a chunk whose every job has ALL_ONE
        # N_out[u] and N_in[v] rows has corridor == V exactly, so it runs
        # on the full graph without a probe
        flags = index.summary_flags()
        jsat = (flags["sat_out"][plan_p.u[pending]]
                & flags["sat_in"][plan_p.v[pending]])
        sat_chunks = [bool(jsat[c0:c0 + exact_chunk].all())
                      for c0 in starts]
        stats.saturated_chunks += sum(sat_chunks)
        compact_flags = [False] * len(starts)
        probe_starts = [c0 for c0, s in zip(starts, sat_chunks) if not s]
        if probe_starts:
            probe_jobs = np.concatenate(
                [pending[c0:c0 + exact_chunk] for c0 in probe_starts])
            unions = ex.chunk_union_counts(pd, probe_jobs, exact_chunk)
            for c0, u in zip(probe_starts, unions):
                compact_flags[c0 // exact_chunk] = (
                    graph_mod.pad_bucket(int(u), lo=32) < v_n)
    member = None
    mem_off = {}
    if any(compact_flags):
        cjobs = np.concatenate(
            [pending[c0:c0 + exact_chunk]
             for c0, flag in zip(starts, compact_flags) if flag])
        member = ex.corridor_members(pd, cjobs)
        off = 0
        for c0, flag in zip(starts, compact_flags):
            if flag:
                n = len(pending[c0:c0 + exact_chunk])
                mem_off[c0] = (off, off + n)
                off += n

    for c0, flag in zip(starts, compact_flags):
        jobs = pending[c0:c0 + exact_chunk]
        real_n = len(jobs)
        rows = member[slice(*mem_off[c0])] if flag else None
        if real_n < exact_chunk:   # pad to the chunk width
            jobs = np.concatenate(
                [jobs, np.full(exact_chunk - real_n, jobs[0], np.int64)])
            if rows is not None:
                rows = np.concatenate(
                    [rows, np.repeat(rows[:1], exact_chunk - real_n,
                                     axis=0)])
        res = ex.run_chunk(plan_p, pd, jobs, rows, special, exact_mode)
        reached = np.asarray(res.reached.cpu() if torch.is_tensor(
            res.reached) else res.reached)[:real_n]
        np.logical_or.at(answers, plan_p.qid[jobs[:real_n][reached]], True)
        stats._round_parts.append(res.rounds)
        stats.corridor_active += res.n_active
        stats.corridor_total += res.v_total
        if res.compacted:
            stats.compacted_chunks += 1
        else:
            stats.full_chunks += 1
    stats.phase2_s += time.perf_counter() - t1
    return answers


def answer(index: TDRIndex, u: int, v: int, p: pat.Pattern, **kw) -> bool:
    """Single-query convenience wrapper over ``answer_batch``."""
    return bool(answer_batch(index, [(u, v, p)], **kw)[0])
