"""Continuous micro-batching PCR query server over the TDR index.

Online counterpart of ``tdr_query.answer_batch``: asynchronously arriving
``(u, v, pattern)`` requests are coalesced into shape-bucketed batches and
answered through ``tdr_query.answer_plan``, amortizing plan compilation,
phase-1 cascade dispatch, and phase-2 expansion across every request in
flight.  The server runs on its index's device (the card, or the CPU for
an index built there).  The design goal is **nothing new built at steady
state** (``engine.jit_cache_entries``: no kernel build or load, no
label-class stack packed after warmup):

* **Job-budget coalescing.**  The scheduler drains the queue until the
  *job* (DNF-term) budget ``ServeConfig.max_jobs`` is met or the batching
  window ``max_wait_ms`` closes.  Term counts are known at submit time for
  free — ``tdr_query.pattern_rows`` resolves each pattern against the
  hash-consed plan cache — so a batch never overflows its top bucket.
  (One exception: a single request with more DNF terms than ``max_jobs``
  is served alone; it pads past the warmed grid and is counted in
  ``ServeStats.overflow_batches``, not silently.)
* **Bucket-grid shapes.**  ``answer_plan`` pads the job axis onto the
  ``{2^k, 3·2^(k-1)}`` grid (``QueryPlan.pad_to`` / ``graph.pad_bucket``);
  ``warmup`` runs every bucket of the grid up to ``max_jobs`` once by
  replaying probe queries padded to each size.
* **Pinned statics.**  The two content-dependent operand shapes are
  pinned from the warmup sample: ``pin_m`` fixes the packed subset-state
  width and the special-label-class set is fixed for the ``matmul``
  backend's per-class adjacency, which then comes from the engine's LRU
  — so batch composition changes array *contents*, never shapes.
  ``exact_mode`` defaults to ``"full"``: serving trades the
  corridor-compaction win for hard shape stability and zero per-batch
  host compaction work (the corridor still masks compute on device).
* **Caching.**  A bounded result cache keyed ``(u, v, canonical pattern,
  kind, bound)`` resolves repeats without touching the queue; duplicates
  *within* a batch collapse onto one plan row set (fan-out at
  completion).  The kind lives in the key — a boolean hit can never
  answer a distance query — and the per-index plan-row LRU is
  partitioned by kind the same way (``tdr_query.pattern_rows``).
* **Query kinds.**  ``submit(..., kind=...)`` accepts every
  ``tdr_query.QUERY_KINDS`` member: "bool" batches through
  ``answer_plan`` as before; "dist" requests batch through
  ``tdr_query.dist_batch`` grouped by their k-bound; "witness" and
  "count" run per request
  through ``tdr_query.witness`` / ``count_routes``.  All ride the same
  micro-batching scheduler, warmup pins, and result cache.
* **Backpressure / admission control.**  The queue is bounded
  (``max_queue``): blocking submits wait for room (closed-loop clients),
  non-blocking submits raise ``QueueFull`` so open-loop front-ends can
  shed load instead of growing an unbounded backlog.
* **Live graph updates.**  ``submit_update`` applies edge
  insertions/deletions through ``tdr_build.update_index`` while serving
  continues on the old (immutable) index, then enqueues a FIFO barrier:
  the scheduler finishes every batch submitted before the update, swaps
  the index, and drops the ``(u, v, pattern)`` result cache (the
  per-index plan-row LRU is invalidated with it — the new index starts
  with an empty ``pattern_rows`` cache).  Queries submitted after
  ``submit_update`` returns are therefore always answered — and cached —
  against the post-update graph; queries submitted before it see the
  pre-update graph.  No batch ever straddles the swap.  The maintenance,
  the log append and the swap are the spans ``serve.update``,
  ``serve.wal`` and ``serve.swap`` (``ServeStats.update_s``,
  ``update_rebuilds``, ``swap_wait_s``).
* **Durability.**  ``persist_to(dir)`` checkpoints the index
  (``repro_torch.snapshot``) and attaches a write-ahead delta log
  (``repro_torch.deltalog``), in the JAX package's byte format: updates append their effective delta —
  fsync'd, CRC-framed — *before* the barrier swap, so
  ``QueryServer.recover(dir)`` after a crash replays snapshot + log into
  a state bit-identical to a rebuild of the final graph.  Transient
  update failures get bounded retry-with-backoff; exhausted retries
  raise ``UpdateFailed`` and flip ``ServeStats.degraded`` while reads
  keep being answered from the last-good index.  ``compact_every``
  checkpoints periodically, truncating the log.

* **Replication.**  ``QueryServer.follow(dir)`` bootstraps a read
  replica over a store some *other* process writes
  (``launch.fleet.FleetWriter``): the newest valid snapshot, loaded onto
  the caller's device, plus a replay of the log behind it.  Once
  started, a maintenance thread tails the log through a read-only
  ``deltalog.LogReader`` and applies each new record through
  ``update_index`` behind the same barrier as ``submit_update``, which
  a follower refuses.  ``ServeStats.applied_lsn`` advertises its log
  position for ``launch.router.FleetRouter``; ``wait_for_lsn`` holds a
  consistent read until the tail reaches it.

``repro_torch.engine.jit_cache_entries`` counts what the hot path
materialises per new shape or content; its delta over a window of
steady traffic after ``warmup`` is zero.

  PYTHONPATH=src python -m repro_torch.launch.serve --vertices 2000 \
      --requests 2000 --clients 32              # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import re
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np

from .. import bitset
from .. import deltalog as deltalog_mod
from .. import engine as engine_mod
from .. import graph as graph_mod
from .. import pattern as pat
from .. import rpq as rpq_mod
from .. import snapshot as snapshot_mod
from .. import tdr_build, tdr_query
from ..semiring import COUNT_CAP
from ..utils import spans

LOG_NAME = "deltas.wal"
_SNAP_RE = re.compile(r"snapshot-(\d+)\.tdr")


class QueueFull(RuntimeError):
    """Admission control: the server's request queue is at ``max_queue``."""


class UpdateFailed(RuntimeError):
    """An update exhausted its retries (or its barrier died) without
    applying: the server keeps answering reads against the last-good
    index in degraded mode (``ServeStats.degraded``)."""


class RecoveryError(RuntimeError):
    """``QueryServer.recover`` could not reconstruct a served index from
    the persist directory (no usable snapshot, or the delta log was
    compacted past every snapshot that validates)."""


def _snapshot_files(directory: str) -> list[tuple[int, str]]:
    """``(lsn, path)`` of every snapshot in ``directory``, ascending."""
    out = []
    for name in os.listdir(directory):
        m = _SNAP_RE.fullmatch(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort()
    return out


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_jobs: int = 256          # job-axis coalescing budget (grid top)
    min_bucket: int = 16         # lowest job bucket (answer_plan's floor)
    max_wait_ms: float = 2.0     # batching window after the first arrival
    max_queue: int = 4096        # queued requests before backpressure
    result_cache: int = 4096     # (u, v, pattern) entries; 0 disables
    backend: str | None = None   # engine backend (None = contract default)
    exact_mode: str = "full"     # hard shape stability (module docstring)
    max_m: int = 4
    # the saturation of "count" answers; count_routes refuses a graph
    # whose padded edges times the cap reach 2**32, so a larger graph
    # takes a lower cap
    count_cap: int = COUNT_CAP
    exact_chunk: int = 32
    # dirty-set fraction beyond which submit_update falls back to a full
    # (layout-pinned) rebuild — see tdr_build.update_index
    update_rebuild_threshold: float = 0.5
    # durability (active once persist_to/recover attaches a directory):
    # snapshot + compact the delta log every N applied updates (0 = only
    # on explicit checkpoint()); bounded retry-with-backoff for
    # transient update/log failures before declaring the update failed
    compact_every: int = 0
    update_retries: int = 2
    retry_backoff_s: float = 0.05


@dataclasses.dataclass
class ServeStats:
    submitted: int = 0
    served: int = 0              # requests answered via a batch
    batches: int = 0
    jobs: int = 0                # plan rows over all served batches
    cache_hits: int = 0          # resolved from the result cache
    dedup_hits: int = 0          # collapsed onto an in-batch duplicate
    rejected: int = 0            # non-blocking submits shed by admission
    unpinned_batches: int = 0    # batches whose m exceeded the warmup pin
    updates: int = 0             # graph updates applied (submit_update)
    # batches padded past the warmed bucket grid (a single request with
    # more DNF terms than max_jobs is still served, alone, but may
    # run a bucket warmup never ran — visible here, not silently)
    overflow_batches: int = 0
    # durability: highest LSN whose update the served index reflects
    # (replica routing reads this), whether the last update failed and
    # reads are being answered from the last-good index, and the
    # retry/checkpoint bookkeeping behind those two
    applied_lsn: int = 0
    degraded: bool = False
    update_failures: int = 0
    update_retries: int = 0
    snapshots: int = 0
    checkpoint_failures: int = 0
    # requests the scheduler took off the queue, and the seconds they
    # waited there (submit to popped), summed; the seconds of the batches
    # that ``batches`` counts (the span ``serve.batch``)
    dequeued: int = 0
    queue_wait_s: float = 0.0
    batch_s: float = 0.0
    # applied updates (``submit_update``, a follower's tail): the seconds
    # of their index maintenance (the span ``serve.update``), how many of
    # them fell back to a full rebuild, and the seconds their barriers
    # waited from being queued to the swap
    update_s: float = 0.0
    update_rebuilds: int = 0
    swap_wait_s: float = 0.0
    query_stats: "tdr_query.QueryStats" = dataclasses.field(
        default_factory=tdr_query.QueryStats)

    @property
    def mean_batch(self) -> float:
        return self.served / self.batches if self.batches else 0.0


#: result-cache miss sentinel: cached values include falsy answers
#: (witness None is *not* cached-able, dist -1 and count 0 are)
_MISS = object()


class _Request:
    __slots__ = ("u", "v", "pattern", "rkey", "terms", "kind", "hops",
                 "k", "with_lsn", "t_submit", "future")

    def __init__(self, u, v, pattern, rkey, terms, kind="bool", hops=8,
                 k=None, with_lsn=False):
        self.u = u
        self.v = v
        self.pattern = pattern
        self.rkey = rkey
        self.terms = terms
        self.kind = kind
        self.hops = hops
        self.k = k
        self.with_lsn = with_lsn
        self.t_submit = time.perf_counter()
        self.future: Future = Future()


class _UpdateBarrier:
    """Queue sentinel carrying a pre-built index: the scheduler serves
    everything queued ahead of it on the old index, then swaps and clears
    the result cache — the quiesce point of ``submit_update``.  ``lsn``
    is the write-ahead log position of the update (None when persistence
    is off); the scheduler refuses a swap that would move ``applied_lsn``
    backwards.  ``t_queued`` is when it was made, just before it is
    queued."""
    __slots__ = ("index", "lsn", "event", "exc", "t_queued")

    def __init__(self, index, lsn=None):
        self.index = index
        self.lsn = lsn
        self.event = threading.Event()
        self.exc: BaseException | None = None
        self.t_queued = time.perf_counter()


def _resolve(fut: Future, value=None, exc: BaseException | None = None):
    """Complete a future a client may cancel concurrently: the
    check-then-act window of ``cancelled()`` + ``set_result`` would raise
    InvalidStateError out of the scheduler thread."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except Exception:   # cancelled (or already resolved) — client's loss
        pass


def bucket_grid(lo: int, hi: int) -> list[int]:
    """The ``{2^k, 3·2^(k-1)}`` job buckets from ``lo`` up to covering
    ``hi`` (the shapes ``answer_plan`` can produce for this server)."""
    grid = []
    b = graph_mod.pad_bucket(lo, lo=lo)
    while True:
        grid.append(b)
        if b >= hi:
            return grid
        b = graph_mod.pad_bucket(b + 1, lo=lo)


class QueryServer:
    """Continuous micro-batching scheduler bound to one ``TDRIndex``.

    ``submit`` hands back a ``concurrent.futures.Future[bool]``; a daemon
    scheduler thread coalesces the queue into job-budgeted batches and
    answers them through the plan cache + ``answer_plan``.  Use as a
    context manager, or ``start()``/``stop()`` explicitly."""

    def __init__(self, index: "tdr_build.TDRIndex",
                 config: ServeConfig | None = None, **overrides):
        cfg = config or ServeConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.index = index
        self.config = cfg
        self.stats = ServeStats()
        self._queue: collections.deque[_Request] = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._results: collections.OrderedDict = collections.OrderedDict()
        self._update_lock = threading.Lock()   # serializes submit_update
        self._running = False
        self._stopped = False
        self._drain = True
        self._thread: threading.Thread | None = None
        self._pin_m: int | None = None
        self._special: tuple[int, ...] | None = None
        self._warmed_to = 0
        # durability state — attached by persist_to()/recover()
        self._log: "deltalog_mod.DeltaLog | None" = None
        self._persist_dir: str | None = None
        self._updates_since_snap = 0
        # replication state — attached by follow(): a read-only tailing
        # cursor over a log some *other* process appends to, plus the
        # maintenance thread applying what it yields.  _applied_cond
        # broadcasts every applied_lsn advance (wait_for_lsn).
        self._reader: "deltalog_mod.LogReader | None" = None
        self._poll_s = 0.05
        self._following = False
        self._tail_thread: threading.Thread | None = None
        self._applied_cond = threading.Condition(self._lock)

    def memory_stats(self) -> dict:
        """Resident index footprint: per-plane dense vs compressed bytes
        and the overall ratio (``TDRIndex.index_memory_stats``).  Reads
        the live index reference, so the numbers track update barriers."""
        return self.index.index_memory_stats()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "QueryServer":
        if self._thread is not None:
            return self
        self._running = True
        self._stopped = False
        self._thread = threading.Thread(target=self._loop,
                                        name="tdr-serve", daemon=True)
        self._thread.start()
        if self._reader is not None and self._tail_thread is None:
            # follower replica: tail the shared log alongside serving
            self._following = True
            self._tail_thread = threading.Thread(
                target=self._tail_loop, name="tdr-follow", daemon=True)
            self._tail_thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the scheduler.  ``drain`` serves whatever is queued first;
        otherwise queued futures are cancelled.  Later ``submit`` calls
        raise (their futures could never resolve) until ``start`` again."""
        tail = self._tail_thread
        if tail is not None:
            # stop tailing first, while the scheduler is still alive to
            # process any barrier the tail thread is waiting on
            self._following = False
            tail.join()
            self._tail_thread = None
        thread = self._thread
        if thread is None:
            return
        with self._lock:
            self._drain = drain
            self._running = False
            self._stopped = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
        thread.join()
        self._thread = None
        with self._lock:
            leftovers = list(self._queue)
            self._queue.clear()
        for req in leftovers:
            if isinstance(req, _UpdateBarrier):
                # the update's waiter must not hang on a dead scheduler
                req.exc = RuntimeError(
                    "QueryServer stopped before the update was applied")
                req.event.set()
            else:
                req.future.cancel()

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- submit
    def submit(self, u: int, v: int, p: pat.Pattern, *,
               kind: str = "bool", hops: int = 8, k: int | None = None,
               block: bool = True, timeout: float | None = None,
               with_lsn: bool = False) -> Future:
        """Enqueue one PCR query; the future resolves per ``kind``:
        bool ("bool"), int hop distance, -1 unreachable ("dist", optional
        k-hop bound ``k``), an edge-list witness path / [] / None
        ("witness"), a saturating walk count over <= ``hops`` hops
        ("count", single-DNF-term patterns only — rejected here, in the
        caller's thread, not on the scheduler), or bool for "rpq" —
        whose ``p`` is a ``repro_torch.rpq`` AST, not a pattern.

        ``block=True`` waits for queue room (backpressure, closed-loop
        clients); ``block=False`` raises ``QueueFull`` immediately when
        the queue is at ``max_queue`` (admission control, open-loop
        front-ends).

        ``with_lsn=True`` resolves the future to ``(answer, lsn)``
        instead — the ``applied_lsn`` of the index the answer was
        computed against (exact: no batch straddles an index swap, and
        the result cache is dropped at every swap).  Fleet replicas use
        this to stamp each answer with its read LSN."""
        cfg = self.config
        if kind not in tdr_query.QUERY_KINDS:
            raise ValueError(f"unknown query kind {kind!r}; expected one "
                             f"of {tdr_query.QUERY_KINDS}")
        # resolving the pattern against the plan cache here (caller's
        # thread) keeps DNF work off the scheduler thread and gives the
        # term count the job-budget coalescer needs.  RPQ queries carry
        # a regex AST instead of a pattern: same caller-thread compile
        # (Glushkov NFA + lowering), same per-index LRU.
        if kind == "rpq":
            if isinstance(p, (pat.Label, pat.Not, pat.And, pat.Or)):
                raise ValueError(
                    "kind='rpq' queries take a repro_torch.rpq AST, not "
                    "a pattern (use rpq.parse / rpq.lcr)")
            rows = tdr_query.rpq_rows(self.index, p, cfg.max_m)
            ckey = rpq_mod.canonical_key(p)
        else:
            rows = tdr_query.pattern_rows(self.index, p, cfg.max_m,
                                          kind=kind)
            ckey = pat.canonical_key(p)
        if kind == "count" and rows.n_terms != 1:
            raise ValueError(
                f"count queries need a single-DNF-term pattern, got "
                f"{rows.n_terms} terms")
        # the answer depends on the kind and its bound, so both live in
        # the cache key — a boolean hit can never answer a distance query
        bound = int(hops) if kind == "count" else \
            (None if k is None else int(k)) if kind == "dist" else None
        rkey = (int(u), int(v), ckey, kind, bound)
        req = _Request(int(u), int(v), p, rkey, rows.n_terms, kind,
                       int(hops), k, with_lsn)
        with self._lock:
            if self._stopped:
                # enqueueing into a dead queue would leave the future
                # unresolved forever (requests *before* the first start()
                # are fine: they queue until the scheduler spins up)
                raise RuntimeError("QueryServer is stopped")
            self.stats.submitted += 1
            if cfg.result_cache:
                hit = self._results.get(rkey, _MISS)
                if hit is not _MISS:
                    self._results.move_to_end(rkey)
                    self.stats.cache_hits += 1
                    # cached answers are valid for the *current* index
                    # (the cache is cleared at every swap), so the
                    # current applied_lsn is an exact read LSN
                    req.future.set_result(
                        (hit, self.stats.applied_lsn) if with_lsn
                        else hit)
                    return req.future
            deadline = None if timeout is None else \
                time.perf_counter() + timeout
            while len(self._queue) >= cfg.max_queue:
                if not block or not self._running:
                    self.stats.rejected += 1
                    raise QueueFull(
                        f"queue at max_queue={cfg.max_queue}")
                rem = None if deadline is None else \
                    deadline - time.perf_counter()
                if rem is not None and rem <= 0:
                    self.stats.rejected += 1
                    raise QueueFull(
                        f"queue at max_queue={cfg.max_queue} "
                        f"(timed out after {timeout}s)")
                self._not_full.wait(rem)
            self._queue.append(req)
            self._not_empty.notify()
        return req.future

    # -------------------------------------------------------------- updates
    def submit_update(self, edges_added=(), edges_removed=(), *,
                      rebuild_threshold: float | None = None,
                      timeout: float | None = None
                      ) -> "tdr_build.UpdateStats":
        """Apply a live graph update; blocks until the server serves from
        the updated index.  Returns the ``tdr_build.UpdateStats`` of the
        maintenance call (mode, dirty/patched rows, warm rounds).

        The new index is built *outside* the scheduler (serving continues
        on the old, immutable index), then a FIFO barrier quiesces the
        scheduler: every request submitted before this call is answered
        on the pre-update graph, the index swaps, and the ``(u, v, key)``
        result cache is dropped along with the per-index plan-row LRU
        (the swapped-in index starts with an empty ``pattern_rows``
        cache).  Requests submitted after this method returns are always
        answered against the post-update graph.  Concurrent updates are
        serialized.  On a stopped server with an empty queue the swap
        applies inline; with requests already queued it raises instead —
        those requests are owed pre-update answers and there is no
        scheduler to quiesce.  On timeout the barrier is withdrawn (the
        update provably did not and will not apply — including its log
        record, which is popped) unless the scheduler already holds it,
        in which case the imminent swap is waited out.

        With persistence attached (``persist_to``/``recover``) the
        effective delta is appended to the write-ahead log *before* the
        barrier swap, so an acked update is always recoverable; index
        maintenance and the log append each get
        ``ServeConfig.update_retries`` retries with exponential backoff,
        and exhausting them raises ``UpdateFailed`` while the server
        keeps answering reads on the last-good index
        (``ServeStats.degraded``).  The new index is built on the served
        index's device."""
        cfg = self.config
        if self._reader is not None:
            raise RuntimeError(
                "follower replicas apply updates from the shared log; "
                "publish through the fleet writer instead")
        st = tdr_build.UpdateStats()
        with self._update_lock:
            # self.index is stable here: it only changes at *our* barrier
            delta = self.index.graph.apply_updates(edges_added,
                                                   edges_removed)
            lsn = None
            try:
                new_idx = self._maintain(delta, rebuild_threshold, st)
                if self._log is not None:
                    # write-ahead ordering: the delta is durable before
                    # any served state can change (a crash between here
                    # and the swap replays it on recovery — the acked-
                    # or-acked-plus-one invariant)
                    with spans.span("serve.wal"):
                        lsn = self._with_retries(
                            lambda: self._log.append(delta.added,
                                                     delta.removed))
            except Exception as exc:
                with self._lock:
                    self.stats.degraded = True
                    self.stats.update_failures += 1
                raise UpdateFailed(
                    f"update failed after {cfg.update_retries + 1} "
                    "attempts; serving continues on the last-good "
                    "index") from exc
            bar = _UpdateBarrier(new_idx, lsn)
            inline = False
            with self._lock:
                if self._thread is None:
                    if self._queue:
                        # requests queued before the first start() must
                        # see the pre-update graph (the documented
                        # ordering), and with no scheduler there is
                        # nothing to quiesce them against
                        if lsn is not None:
                            self._log.pop_tail(lsn)
                        raise RuntimeError(
                            "submit_update on a stopped QueryServer with "
                            "queued requests; start() it first")
                    # idle stopped server: swap inline
                    self.index = new_idx
                    self._results.clear()
                    self._note_applied(lsn)
                    inline = True
                else:
                    self._queue.append(bar)
                    self._not_empty.notify()
            if inline:
                self._maybe_compact()
                return st
            if not bar.event.wait(timeout):
                # withdraw the barrier if it is still queued — leaving it
                # behind would let a *later* update (built from the
                # un-swapped index) overwrite this one's edges when both
                # barriers eventually process
                with self._lock:
                    try:
                        self._queue.remove(bar)
                        withdrawn = True
                        # the barrier held a max_queue slot: wake any
                        # submit blocked on backpressure, or it stalls
                        # until the next unrelated dequeue
                        self._not_full.notify_all()
                    except ValueError:
                        withdrawn = False   # already popped by scheduler
                if withdrawn:
                    if lsn is not None:
                        # under _update_lock no later append exists, so
                        # the record is provably the log tail — recovery
                        # must not replay an update that never applied
                        self._log.pop_tail(lsn)
                    raise TimeoutError(
                        f"update barrier not reached within {timeout}s; "
                        "update withdrawn")
                # the scheduler holds it: the swap is imminent — wait it
                # out so the update's effects are never in doubt
                bar.event.wait()
            if bar.exc is not None:
                # the scheduler refused the swap (or died holding the
                # barrier): roll the write-ahead record back so the log
                # never runs ahead of an update that was not applied
                if lsn is not None:
                    try:
                        self._log.pop_tail(lsn)
                    except Exception:
                        pass
                with self._lock:
                    self.stats.degraded = True
                    self.stats.update_failures += 1
                raise bar.exc
            with self._lock:
                self._note_applied(lsn)
            self._maybe_compact()
        return st

    def _maintain(self, delta, rebuild_threshold: float | None,
                  st: "tdr_build.UpdateStats"):
        """The served index maintained through ``delta`` on its device
        (``update_index`` under the retries), under the span
        ``serve.update``, whose seconds go to ``stats.update_s``; a
        rebuild counts in ``stats.update_rebuilds``.  Caller holds
        ``_update_lock``."""
        cfg = self.config
        threshold = (cfg.update_rebuild_threshold
                     if rebuild_threshold is None else rebuild_threshold)
        with spans.span("serve.update") as sp:
            new_idx = self._with_retries(
                lambda: tdr_build.update_index(
                    self.index, delta, backend=cfg.backend,
                    rebuild_threshold=threshold, stats=st,
                    device=self.index.device))
        with self._lock:
            self.stats.update_s += sp.seconds
            self.stats.update_rebuilds += st.mode == "rebuild"
        return new_idx

    def _with_retries(self, fn):
        """Run ``fn`` with ``ServeConfig.update_retries`` bounded retries
        and exponential backoff — transient maintenance/I/O failures
        (e.g. a momentarily full disk) don't immediately degrade."""
        cfg = self.config
        attempt = 0
        while True:
            try:
                return fn()
            except Exception:
                if attempt >= cfg.update_retries:
                    raise
                with self._lock:
                    self.stats.update_retries += 1
                time.sleep(cfg.retry_backoff_s * (2.0 ** attempt))
                attempt += 1

    def _note_applied(self, lsn: int | None) -> None:
        """Bookkeeping for a successfully applied update (caller holds
        ``_lock``): a success always clears degraded mode."""
        self.stats.updates += 1
        self.stats.degraded = False
        if lsn is not None:
            self.stats.applied_lsn = lsn
            self._applied_cond.notify_all()

    def wait_for_lsn(self, lsn: int, timeout: float | None = None) -> bool:
        """Block until the served index reflects log position ``lsn``
        (``applied_lsn >= lsn``); False on timeout.  The replica-side
        half of a consistent read: a router picks a replica believed
        caught up, the replica holds the query here if its heartbeat
        was stale."""
        with self._lock:
            return self._applied_cond.wait_for(
                lambda: self.stats.applied_lsn >= lsn, timeout)

    # ----------------------------------------------------------- durability
    def persist_to(self, directory: str) -> int:
        """Enable durability: checkpoint the current index into
        ``directory`` and attach the write-ahead delta log.

        Writes ``snapshot-<lsn>.tdr`` (see ``repro_torch.snapshot``) and
        opens/creates ``deltas.wal``; every subsequent ``submit_update``
        appends its effective delta to the log *before* the index swap,
        so ``QueryServer.recover(directory)`` reconstructs the served
        state after a crash.  Existing log records (from a prior run of
        this same server) are folded into the snapshot and compacted
        away.  Returns the snapshot's LSN."""
        with self._update_lock:
            if self._log is not None:
                raise RuntimeError(
                    f"persistence already attached to {self._persist_dir}")
            os.makedirs(directory, exist_ok=True)
            log = deltalog_mod.DeltaLog(os.path.join(directory, LOG_NAME))
            self._log = log
            self._persist_dir = directory
            with self._lock:
                # the live index reflects everything this server has
                # applied; pin the snapshot at the log head
                self.stats.applied_lsn = log.last_lsn
            return self._checkpoint_locked()

    @classmethod
    def recover(cls, directory: str, config: ServeConfig | None = None,
                device="cuda", **overrides) -> "QueryServer":
        """Reconstruct a server from a persist directory after a crash:
        load the newest snapshot that validates, replay delta-log records
        with LSN beyond it through ``tdr_build.update_index`` (bit-
        identical to a layout-pinned rebuild of the final graph), and
        return a stopped server with persistence attached — ``start()``
        it to serve.  The snapshot loads onto ``device`` (the card by
        default; it raises without one) and the replay runs there, on a
        fresh engine.  Falls back to older snapshots on ``SnapshotError``;
        raises ``RecoveryError`` when no snapshot can bridge to the
        (possibly compacted) log, and ``deltalog.LogCorrupt`` when the
        log itself fails validation."""
        cfg = config or ServeConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        snaps = _snapshot_files(directory) if os.path.isdir(directory) \
            else []
        if not snaps:
            raise RecoveryError(f"no snapshots in {directory!r}")
        log = deltalog_mod.DeltaLog(os.path.join(directory, LOG_NAME))
        try:
            idx, snap_lsn = cls._newest_valid_snapshot(
                directory, log.base_lsn, device)
            applied = snap_lsn
            for lsn, added, removed in log.replay(after_lsn=snap_lsn):
                delta = idx.graph.apply_updates(added, removed)
                idx = tdr_build.update_index(
                    idx, delta, backend=cfg.backend,
                    rebuild_threshold=cfg.update_rebuild_threshold,
                    device=device)
                applied = lsn
        except BaseException:
            log.close()
            raise
        server = cls(idx, cfg)
        server._log = log
        server._persist_dir = directory
        server.stats.applied_lsn = applied
        return server

    @staticmethod
    def _newest_valid_snapshot(directory: str, min_lsn: int, device):
        """``(index, lsn)`` from the newest snapshot that validates and
        sits at or past ``min_lsn`` (the log's base — an older snapshot
        cannot bridge a compacted log), loaded onto ``device``.  Falls
        back across snapshots on ``SnapshotError``; raises
        ``RecoveryError`` when none works."""
        snaps = _snapshot_files(directory) if os.path.isdir(directory) \
            else []
        if not snaps:
            raise RecoveryError(f"no snapshots in {directory!r}")
        problems = []
        for _, path in reversed(snaps):   # newest first
            try:
                idx, snap_lsn = snapshot_mod.load_index(path, device=device)
            except snapshot_mod.SnapshotError as exc:
                problems.append(f"{os.path.basename(path)}: {exc}")
                continue
            if snap_lsn < min_lsn:
                # the log was compacted past this snapshot — records it
                # needs no longer exist, it cannot seed a replay
                problems.append(
                    f"{os.path.basename(path)}: snapshot lsn {snap_lsn} "
                    f"predates compacted log base {min_lsn}")
                continue
            return idx, snap_lsn
        raise RecoveryError("no usable snapshot: " + "; ".join(problems))

    # ---------------------------------------------------------- follower
    @classmethod
    def follow(cls, directory: str, config: ServeConfig | None = None,
               *, poll_s: float = 0.05, device="cuda",
               **overrides) -> "QueryServer":
        """Bootstrap a read replica over a *shared* persist directory:
        restore the newest valid snapshot onto ``device`` (the card by
        default; it raises without one), replay the delta log behind it
        through a read-only ``deltalog.LogReader``, and return a stopped
        server whose ``start()`` both serves queries and keeps tailing
        the log (polling every ``poll_s``) — each new record a single
        writer appends is applied through ``update_index`` on the served
        index's device, behind the usual quiesce barrier, and
        ``ServeStats.applied_lsn`` advertises the replica's log position
        for router placement.

        The replica never writes to the shared store: ``submit_update``
        is refused (updates flow writer → log → every replica), and
        compaction by the writer is survived by re-bootstrapping from
        the newest snapshot when the log base passes the cursor."""
        device = bitset.resolve_device(device)
        cfg = config or ServeConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        reader = deltalog_mod.LogReader(
            os.path.join(directory, LOG_NAME))
        idx, applied = cls._bootstrap_replica(directory, cfg, reader,
                                              device)
        server = cls(idx, cfg)
        server._reader = reader
        server._persist_dir = directory
        server._poll_s = poll_s
        server.stats.applied_lsn = applied
        return server

    @classmethod
    def _bootstrap_replica(cls, directory: str, cfg: ServeConfig,
                           reader: "deltalog_mod.LogReader", device):
        """Newest valid snapshot at/past the log base, loaded onto
        ``device``, plus a replay of the reader to the current tip there.
        Returns ``(index, applied_lsn)`` with the reader's cursor left at
        ``applied_lsn``."""
        idx, snap_lsn = cls._newest_valid_snapshot(directory,
                                                   reader.base_lsn, device)
        reader.seek(snap_lsn)
        applied = snap_lsn
        while True:
            recs = reader.poll()
            if not recs:
                return idx, applied
            for lsn, added, removed in recs:
                delta = idx.graph.apply_updates(added, removed)
                idx = tdr_build.update_index(
                    idx, delta, backend=cfg.backend,
                    rebuild_threshold=cfg.update_rebuild_threshold,
                    device=device)
                applied = lsn

    def _tail_loop(self) -> None:
        """Follower maintenance thread: poll the shared log, apply each
        new record behind a barrier.  Failures never kill the thread —
        the replica flips ``ServeStats.degraded``, keeps answering reads
        from the last-good index, and retries (the record is re-delivered
        by rewinding the cursor), exactly the submit_update degraded-mode
        contract in replicated form."""
        err_sleep = min(1.0, 10 * self._poll_s)
        while self._following:
            try:
                recs = self._reader.poll()
            except deltalog_mod.LogCompactedPast:
                # the writer compacted past our cursor: the records we
                # need are gone — re-bootstrap from the newest snapshot
                try:
                    self._refollow()
                except Exception:
                    with self._lock:
                        self.stats.degraded = True
                    time.sleep(err_sleep)
                continue
            except Exception:
                with self._lock:
                    self.stats.degraded = True
                time.sleep(err_sleep)
                continue
            applied_all = True
            for lsn, added, removed in recs:
                if not self._following:
                    return
                try:
                    if not self._apply_replicated(lsn, added, removed):
                        return   # scheduler is shutting down
                except Exception:
                    # rewind so the record is re-delivered next poll
                    self._reader.seek(lsn - 1)
                    with self._lock:
                        self.stats.degraded = True
                        self.stats.update_failures += 1
                    applied_all = False
                    time.sleep(err_sleep)
                    break
            if not recs and applied_all:
                time.sleep(self._poll_s)

    def _apply_replicated(self, lsn: int, added, removed) -> bool:
        """Apply one shared-log record on a follower: the maintenance +
        barrier machinery of ``submit_update`` minus the write-ahead
        append (the record came *from* the log — it is already durable).
        False when the server is stopping underneath us."""
        with self._update_lock:
            if lsn <= self.stats.applied_lsn:
                return True   # overlap after a snapshot re-bootstrap
            delta = self.index.graph.apply_updates(added, removed)
            new_idx = self._maintain(delta, None, tdr_build.UpdateStats())
            return self._swap_in(new_idx, lsn)

    def _refollow(self) -> None:
        """Recover from ``LogCompactedPast``: rebuild the served state
        from the newest snapshot + log replay on the served index's
        device and swap it in as one barriered update (the reader's
        cursor lands on the new tip)."""
        cfg = self.config
        with self._update_lock:
            idx, applied = self._bootstrap_replica(
                self._persist_dir, cfg, self._reader, self.index.device)
            if applied > self.stats.applied_lsn:
                self._swap_in(idx, applied)

    def _swap_in(self, new_idx, lsn: int) -> bool:
        """Swap ``new_idx`` in at ``lsn`` through the scheduler barrier
        (inline when no scheduler runs); caller holds ``_update_lock``.
        False when the scheduler refused the swap or stopped before
        reaching the barrier.  The replica side's apply step."""
        bar = _UpdateBarrier(new_idx, lsn)
        with self._lock:
            if self._thread is None:
                self.index = new_idx
                self._results.clear()
                self._note_applied(lsn)
                return True
            self._queue.append(bar)
            self._not_empty.notify()
        bar.event.wait()
        if bar.exc is not None:
            return False
        with self._lock:
            self._note_applied(lsn)
        return True

    def checkpoint(self) -> int:
        """Snapshot the currently served index and compact the delta log
        (records the snapshot folds in are dropped; the previous
        snapshot is retained as a corruption fallback).  Returns the
        snapshot's LSN."""
        with self._update_lock:
            if self._log is None:
                raise RuntimeError(
                    "persistence is not attached; call persist_to() first")
            return self._checkpoint_locked()

    def close_persistence(self) -> None:
        """Detach the delta log (closing its file handle); later updates
        are no longer write-ahead logged."""
        with self._update_lock:
            if self._log is not None:
                self._log.close()
                self._log = None
                self._persist_dir = None

    def _checkpoint_locked(self) -> int:
        """Checkpoint under ``_update_lock``: ``self.index`` cannot swap
        while held, so index and ``applied_lsn`` are a consistent pair."""
        with self._lock:
            idx, lsn = self.index, self.stats.applied_lsn
        path = os.path.join(self._persist_dir, f"snapshot-{lsn:016d}.tdr")
        snapshot_mod.save_index(idx, path, lsn=lsn)
        with self._lock:
            self.stats.snapshots += 1
        self._updates_since_snap = 0
        # keep the two newest snapshots (fallback if the newest ever
        # fails validation) and drop log records both have folded in
        snaps = _snapshot_files(self._persist_dir)
        for _, old in snaps[:-2]:
            os.unlink(old)
        self._log.truncate_upto(snaps[-2:][0][0])
        return lsn

    def _maybe_compact(self) -> None:
        """Periodic checkpoint driver (holds ``_update_lock``): every
        ``compact_every`` applied updates.  A failed checkpoint never
        fails the update that triggered it — the update is already
        durable in the log — it only defers compaction."""
        if self._log is None:
            return
        self._updates_since_snap += 1
        every = self.config.compact_every
        if not every or self._updates_since_snap < every:
            return
        try:
            self._checkpoint_locked()
        except Exception:
            with self._lock:
                self.stats.checkpoint_failures += 1
            self._updates_since_snap = every   # retry on the next update

    # --------------------------------------------------------------- warmup
    def warmup(self, sample: Sequence[tuple[int, int, pat.Pattern]],
               ) -> int:
        """Run the serving shapes once from a representative sample.

        1. Answers the whole sample once, learning the pins: ``pin_m`` =
           the widest require-set seen, and the special-label-class set
           over the sample's plan rows.
        2. Picks *probe* queries — ones the filter cascade left for
           phase 2 (``QueryStats.exact_qids``) — and replays them padded
           to **every** bucket of the job grid up to ``max_jobs``, so
           both the cascade and the expansion run at every shape live
           traffic can produce.
        3. Runs one query of every other kind under the same pins.

        Returns how far ``engine.jit_cache_entries`` moved: the kernel
        library loaded (and built, on its first use) and the pinned
        label-class stacks and edge lists packed (a second warmup with
        the same sample returns 0)."""
        cfg = self.config
        idx = self.index
        n0 = engine_mod.jit_cache_entries()
        plan = tdr_query.compile_queries(idx, sample, max_m=cfg.max_m)
        self._pin_m = int((plan.req_labels >= 0).sum(axis=1).max(initial=0))
        if plan.n_jobs:
            eng = idx.engine(cfg.backend)
            ex = tdr_query._executor(idx, eng)
            self._special = ex.special_labels(
                plan, np.arange(plan.n_jobs, dtype=np.int64))
        qstats = tdr_query.QueryStats()
        self._answer(list(sample), stats=qstats)

        # probe set: phase-2 survivors, capped to the smallest bucket so
        # every padded replay keeps the same pending content
        probes, jobs = [], 0
        for qi in qstats.exact_qids:
            u, v, p = sample[qi][:3]
            t = tdr_query.pattern_rows(idx, p, cfg.max_m).n_terms
            if jobs + t > cfg.min_bucket:
                break
            probes.append((u, v, p))
            jobs += t
        if not probes and len(sample):
            probes = list(sample[:1])
        pplan = tdr_query.compile_queries(idx, probes, max_m=cfg.max_m)
        top = graph_mod.pad_bucket(cfg.max_jobs, lo=cfg.min_bucket)
        for b in bucket_grid(cfg.min_bucket, top):
            if b < pplan.n_jobs:
                continue
            tdr_query.answer_plan(
                idx, pplan.pad_to(b), exact_chunk=cfg.exact_chunk,
                backend=cfg.backend, exact_mode=self._kind_mode("bool"),
                special_labels=self._special, pin_m=self._pin_m,
                pad_lo=cfg.min_bucket)
        self._warmed_to = top

        # the other kinds run at fixed shapes under the serving pins —
        # dist chunks the job axis to exact_chunk, witness/count are
        # per-query, and their bounds (k, hops) only change round counts
        # — so one probe per kind covers every batch composition live
        # traffic can produce.
        if probes:
            u0, v0, p0 = probes[0]
            common = dict(max_m=cfg.max_m, backend=cfg.backend,
                          exact_mode=self._kind_mode(), pin_m=self._pin_m,
                          device=idx.device)
            tdr_query.dist_batch(idx, [(u0, v0, p0)], k=1,
                                 exact_chunk=cfg.exact_chunk,
                                 special_labels=self._special, **common)
            tdr_query.witness(idx, u0, v0, p0, **common)
            for q in probes + list(sample):
                cu, cv, cp = q[0], q[1], q[2]
                if len(pat.to_dnf(cp)) == 1:   # count: single-term only
                    tdr_query.count_routes(idx, cu, cv, cp, hops=1,
                                           cap=cfg.count_cap, **common)
                    break
            # rpq: lowered regexes ride the answer_plan shapes warmed
            # above; the product executor runs at fixed shapes under
            # "full" mode (job axis padded to exact_chunk, full-graph
            # corridor), so one product-route probe runs both its
            # phases.  The probe is (a|…)+ at u0==u0: inexpressible
            # (Plus, not Star), not nullable (no ε pre-answer), and its
            # over-approximation is label-free, so the filter cascade
            # cannot prune it — the NFA executor is guaranteed to run.
            n_l = idx.graph.n_labels
            rdemo = rpq_mod.plus(rpq_mod.alt(
                *(rpq_mod.Sym(i) for i in range(n_l))))
            # q_unroll pinned: the NFA step's width must not depend on
            # which regexes a live batch happens to hold
            tdr_query.rpq_batch(idx, [(u0, u0, rdemo)],
                                exact_chunk=cfg.exact_chunk,
                                special_labels=self._special,
                                pad_lo=cfg.min_bucket, q_unroll=32,
                                **common)
        return engine_mod.jit_cache_entries() - n0

    # ------------------------------------------------------------ scheduler
    def _loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            if isinstance(batch, _UpdateBarrier):
                # quiesce point: every pre-update batch has been served
                # by this thread already — swap and invalidate (the span
                # ``serve.swap``).  The monotonic-LSN check is defense in
                # depth: updates are serialized and barriers FIFO, so a
                # regressing LSN here means a withdrawn barrier leaked
                # back in — refuse the swap rather than serve a stale
                # index as current.
                with spans.span("serve.swap"), self._lock:
                    if batch.lsn is not None and \
                            batch.lsn <= self.stats.applied_lsn:
                        batch.exc = RuntimeError(
                            f"update barrier lsn {batch.lsn} <= applied "
                            f"lsn {self.stats.applied_lsn}: out-of-order "
                            "swap refused")
                    else:
                        self.index = batch.index
                        self._results.clear()
                        self.stats.swap_wait_s += \
                            time.perf_counter() - batch.t_queued
                        if batch.lsn is not None:
                            self.stats.applied_lsn = batch.lsn
                            self._applied_cond.notify_all()
                batch.event.set()
                continue
            if batch:
                try:
                    self._serve_batch(batch)
                except Exception as exc:  # noqa: BLE001 — the scheduler
                    # thread must never die silently: fail this batch's
                    # futures and keep serving
                    for req in batch:
                        _resolve(req.future, exc=exc)

    def _next_batch(self) -> "list[_Request] | _UpdateBarrier | None":
        """Block for the next coalesced batch (None = shut down).

        Drains until the job budget is met or ``max_wait_ms`` has passed
        since the first request of the batch — the continuous-batching
        tradeoff between latency (short wait) and amortization (full
        buckets).  An ``_UpdateBarrier`` at the queue head is returned
        alone (once everything ahead of it has been batched), so no
        batch ever straddles an index swap.  The wait is the span
        ``serve.next_batch``."""
        cfg = self.config
        with spans.span("serve.next_batch"), self._lock:
            while not self._queue:
                if not self._running:
                    return None
                self._not_empty.wait()
            if not self._running and not self._drain:
                return None
            deadline = time.perf_counter() + cfg.max_wait_ms * 1e-3
            batch: list[_Request] = []
            jobs = 0
            while True:
                while self._queue:
                    nxt = self._queue[0]
                    if isinstance(nxt, _UpdateBarrier):
                        if batch:   # serve what precedes the barrier first
                            self._not_full.notify_all()
                            return batch
                        self._queue.popleft()
                        self._not_full.notify_all()
                        return nxt
                    if batch and jobs + nxt.terms > cfg.max_jobs:
                        self._not_full.notify_all()
                        return batch
                    self._queue.popleft()
                    batch.append(nxt)
                    self.stats.dequeued += 1
                    self.stats.queue_wait_s += \
                        time.perf_counter() - nxt.t_submit
                    jobs += nxt.terms
                    if jobs >= cfg.max_jobs:
                        self._not_full.notify_all()
                        return batch
                self._not_full.notify_all()
                rem = deadline - time.perf_counter()
                if rem <= 0 or not self._running:
                    return batch
                self._not_empty.wait(rem)

    def _serve_batch(self, batch: list[_Request]) -> None:
        """Answer one coalesced batch (``_serve_requests``) under the span
        ``serve.batch``; a batch that ``stats.batches`` counts adds its
        seconds to ``stats.batch_s``."""
        with spans.span("serve.batch") as sp:
            counted = self._serve_requests(batch)
        if counted:
            with self._lock:
                self.stats.batch_s += sp.seconds

    def _serve_requests(self, batch: list[_Request]) -> bool:
        """Dedup → plan-cache compile → per-kind executors → fan results
        out to futures + result cache.  True when the batch ran the
        executors and counts in ``stats.batches``."""
        cfg = self.config
        uniq: dict = {}   # rkey -> (u, v, pattern, kind, hops, k)
        fanout: dict = collections.defaultdict(list)
        cached: list[tuple[_Request, object]] = []
        jobs_total = 0
        with self._lock:
            # the whole batch is served against self.index as of here —
            # swaps happen only on this (scheduler) thread, so this LSN
            # is the exact read position of every answer below
            lsn = self.stats.applied_lsn
            for req in batch:
                if cfg.result_cache:
                    hit = self._results.get(req.rkey, _MISS)
                    if hit is not _MISS:
                        self._results.move_to_end(req.rkey)
                        self.stats.cache_hits += 1
                        cached.append((req, hit))
                        continue
                if req.rkey in fanout:
                    self.stats.dedup_hits += 1
                else:
                    jobs_total += req.terms
                fanout[req.rkey].append(req)
                uniq.setdefault(req.rkey, (req.u, req.v, req.pattern,
                                           req.kind, req.hops, req.k))
        for req, hit in cached:
            _resolve(req.future, (hit, lsn) if req.with_lsn else hit)
        if not uniq:
            return False
        keys = list(uniq)
        try:
            answers = self._answer_keys(keys, uniq)
        except Exception as exc:  # noqa: BLE001 — surface on the futures
            for k in keys:
                for req in fanout[k]:
                    _resolve(req.future, exc=exc)
            return False
        with self._lock:
            self.stats.batches += 1
            self.stats.served += sum(len(v) for v in fanout.values())
            self.stats.jobs += jobs_total
            if self._warmed_to and jobs_total and \
                    graph_mod.pad_bucket(jobs_total, lo=cfg.min_bucket) \
                    > self._warmed_to:
                self.stats.overflow_batches += 1
            if cfg.result_cache:
                for k in keys:
                    while len(self._results) >= cfg.result_cache:
                        self._results.popitem(last=False)
                    self._results[k] = answers[k]
        for k in keys:
            for req in fanout[k]:
                _resolve(req.future,
                         (answers[k], lsn) if req.with_lsn
                         else answers[k])
        return True

    def _answer_keys(self, keys: list, uniq: dict) -> dict:
        """Run every kind's executor over its slice of the unique keys, on
        the served index's device; every answer comes back as a host
        value (bool, int, edge list).  Bool queries batch through
        ``answer_plan``; dist queries batch per k-bound; rpq queries
        batch through ``rpq_batch`` (lowered ones ride the same
        ``answer_plan`` shapes as bool traffic, product-route ones the
        fixed ``exact_chunk`` NFA shapes); witness/count run per query
        at fixed single-query shapes.  Each kind's executor is a span
        (``serve.bool``, ``serve.dist``, ``serve.rpq``, ``serve.witness``,
        ``serve.count``)."""
        cfg = self.config
        qstats = self.stats.query_stats
        out: dict = {}
        bool_keys = [kk for kk in keys if uniq[kk][3] == "bool"]
        if bool_keys:
            with spans.span("serve.bool"):
                ans = self._answer([uniq[kk][:3] for kk in bool_keys],
                                   stats=qstats)
            out.update(zip(bool_keys, (bool(a) for a in ans)))
        dist_groups: dict = collections.defaultdict(list)
        for kk in keys:
            if uniq[kk][3] == "dist":
                dist_groups[uniq[kk][5]].append(kk)
        common = dict(max_m=cfg.max_m, backend=cfg.backend,
                      exact_mode=self._kind_mode(), pin_m=self._pin_m,
                      stats=qstats, device=self.index.device)
        for kb, group in dist_groups.items():
            with spans.span("serve.dist"):
                ds = tdr_query.dist_batch(
                    self.index, [uniq[kk][:3] for kk in group], k=kb,
                    exact_chunk=cfg.exact_chunk,
                    special_labels=self._special, **common)
            out.update(zip(group, (int(d) for d in ds)))
        rpq_keys = [kk for kk in keys if uniq[kk][3] == "rpq"]
        if rpq_keys:
            with spans.span("serve.rpq"):
                ans = tdr_query.rpq_batch(
                    self.index, [uniq[kk][:3] for kk in rpq_keys],
                    exact_chunk=cfg.exact_chunk,
                    special_labels=self._special,
                    pad_lo=cfg.min_bucket, q_unroll=32, **common)
            out.update(zip(rpq_keys, (bool(a) for a in ans)))
        for kk in keys:
            u, v, p, kd, hops, _ = uniq[kk]
            if kd == "witness":
                with spans.span("serve.witness"):
                    out[kk] = tdr_query.witness(self.index, u, v, p,
                                                **common)
            elif kd == "count":
                with spans.span("serve.count"):
                    out[kk] = tdr_query.count_routes(
                        self.index, u, v, p, hops=hops,
                        cap=cfg.count_cap, **common)
        return out

    def _kind_mode(self, kind: str = "other") -> str:
        """The exact mode a kind runs: the boolean kind runs
        ``config.exact_mode``; the other kinds' executors refuse
        "legacy", so they run the shape-stable "full" in its place."""
        mode = self.config.exact_mode
        return "full" if mode == "legacy" and kind != "bool" else mode

    def _answer(self, queries, stats=None) -> np.ndarray:
        cfg = self.config
        plan = tdr_query.compile_queries(self.index, queries,
                                         max_m=cfg.max_m, stats=stats)
        if self._pin_m is not None:
            m = int((plan.req_labels >= 0).sum(axis=1).max(initial=0))
            if m > self._pin_m:
                self.stats.unpinned_batches += 1
        return tdr_query.answer_plan(
            self.index, plan, exact_chunk=cfg.exact_chunk, stats=stats,
            backend=cfg.backend, exact_mode=self._kind_mode("bool"),
            special_labels=self._special, pin_m=self._pin_m,
            pad_lo=cfg.min_bucket)


# ------------------------------------------------------------------- demo
def percentile(xs: list[float], q: float) -> float:
    """np.percentile with an empty-list guard — same estimator as the
    benchmark rows, so demo and CI-gated numbers are comparable."""
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def mixed_pool(g, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    pool = []
    for i in range(n):
        u = int(rng.integers(g.n_vertices))
        v = int(rng.integers(g.n_vertices))
        labs = rng.choice(g.n_labels, size=min(3, g.n_labels),
                          replace=False).tolist()
        p = [pat.all_of(labs[:2]), pat.any_of(labs),
             pat.none_of(labs[:2]),
             pat.parse(f"(l{labs[0]} | l{labs[1]}) & !l{labs[-1]}")][i % 4]
        pool.append((u, v, p))
    return pool


def main() -> None:
    ap = argparse.ArgumentParser(
        description="TDR query-serving demo: closed-loop clients against "
                    "the micro-batching scheduler")
    ap.add_argument("--vertices", type=int, default=2_000)
    ap.add_argument("--degree", type=float, default=1.5)
    ap.add_argument("--labels", type=int, default=8)
    ap.add_argument("--requests", type=int, default=2_000)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the index and the server run (default: the "
                         "card; it raises without one)")
    args = ap.parse_args()

    g = graph_mod.erdos_renyi(args.vertices, args.degree, args.labels,
                              seed=0)
    print(f"[serve] ER graph |V|={g.n_vertices} |E|={g.n_edges}")
    t0 = time.perf_counter()
    idx = tdr_build.build_index(g, tdr_build.TDRConfig(),
                                backend=args.backend, device=args.device)
    print(f"[serve] index build {time.perf_counter() - t0:.2f}s")

    pool = mixed_pool(g, 256)
    with QueryServer(idx, backend=args.backend) as server:
        mem = server.memory_stats()
        print(f"[serve] index planes "
              f"{mem['dense_bytes'] / 1e6:.1f} MB dense -> "
              f"{mem['compressed_bytes'] / 1e6:.1f} MB compressed "
              f"({mem['ratio']:.2f}x)")
        t0 = time.perf_counter()
        added = server.warmup(pool)
        print(f"[serve] warmup {time.perf_counter() - t0:.2f}s "
              f"({added} kernel builds, loads and class stacks)")

        n0 = engine_mod.jit_cache_entries()
        lat: list[float] = []
        lat_lock = threading.Lock()
        rng = np.random.default_rng(1)
        order = rng.integers(0, len(pool), size=args.requests)
        split = np.array_split(order, args.clients)

        def client(ids):
            for i in ids:
                u, v, p = pool[int(i)]
                t = time.perf_counter()
                server.submit(u, v, p).result()
                with lat_lock:
                    lat.append(time.perf_counter() - t)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(ids,))
                   for ids in split]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        st = server.stats
        print(f"[serve] {args.requests} requests / {args.clients} clients "
              f"in {wall:.2f}s = {args.requests / wall:.0f} q/s")
        print(f"[serve] p50={percentile(lat, 50) * 1e3:.1f}ms "
              f"p95={percentile(lat, 95) * 1e3:.1f}ms "
              f"p99={percentile(lat, 99) * 1e3:.1f}ms "
              f"mean_batch={st.mean_batch:.1f} "
              f"cache_hits={st.cache_hits} dedup={st.dedup_hits}")
        print(f"[serve] built, loaded or packed after warmup: "
              f"{engine_mod.jit_cache_entries() - n0}")


if __name__ == "__main__":
    main()
