"""Query placement for the replicated serving fleet (the JAX package's
placement rules and wire messages, over the port's ``launch.fleet``).

``FleetRouter`` sits between clients and a ``launch.fleet.Fleet``:
``submit`` returns a ``Future`` resolving to ``(answer, lsn)`` where
``lsn`` is the exact applied LSN of the replica index the answer was
computed against.  Placement policy:

* **Load balancing** — among eligible replicas, pick the one with the
  fewest router-inflight requests (heartbeat queue depth breaks ties),
  so a replica stalled behind a log-apply barrier naturally sheds load.
* **Consistent reads** (``min_lsn=L``) — eligible replicas are those
  whose last advertised LSN is already >= L; if none has caught up yet
  the router *redirects* to the highest-LSN replica and lets the
  replica-side ``QueryServer.wait_for_lsn`` hold the query until the
  tail applies L (the router never busy-waits).  The answer is then
  bit-identical to a single caught-up ``QueryServer``: same record
  sequence, same ``update_index`` path, same engine contract.
* **At-least-once dispatch** — a replica dying (SIGKILL, eviction)
  with requests in flight hands them back via ``Fleet.on_orphans``;
  the router re-dispatches each to a surviving replica, up to
  ``max_attempts``.  Reads are idempotent, so re-execution is safe; a
  request exhausting its attempts fails with ``ReplicaDied``.
"""
from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future

from .. import pattern as pat
from .. import rpq as rpq_mod
from .fleet import Fleet, FleetUnavailable, Replica, ReplicaDied


class _Pending:
    __slots__ = ("rid", "wire", "future", "attempts", "replica")

    def __init__(self, rid: int, wire: dict, future: Future):
        self.rid = rid
        self.wire = wire
        self.future = future
        self.attempts = 0
        self.replica: Replica | None = None


class FleetRouter:
    """Thin, stateless-per-request front door over a ``Fleet``."""

    def __init__(self, fleet: Fleet, *, max_attempts: int = 3):
        self.fleet = fleet
        self.max_attempts = int(max_attempts)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._inflight: dict[int, _Pending] = {}
        self.redispatched = 0
        self.redirected = 0     # consistent reads sent to a catching-up replica
        fleet.on_orphans = self._on_orphans
        # route answers arriving on each replica's reader thread back
        # into router futures (on top of the fleet's health handling)
        self._base_on_event = fleet._on_event

        def on_event(replica: Replica, msg: dict) -> None:
            self._base_on_event(replica, msg)
            if msg.get("ev") == "ans":
                self._resolve(msg)
        for r in fleet.members(ready_only=False):
            r._on_event = on_event
        self._on_event = on_event
        # new spawns need the same hook: wrap the fleet's spawner
        orig_spawn = fleet._spawn_locked

        def spawn_locked():
            r = orig_spawn()
            r._on_event = on_event
            return r
        fleet._spawn_locked = spawn_locked

    # -------------------------------------------------------------- submit
    def submit(self, u: int, v: int, p: pat.Pattern, *,
               kind: str = "bool", hops: int = 8, k: int | None = None,
               min_lsn: int = 0, lsn_timeout: float = 60.0) -> Future:
        """Route one PCR query; the future resolves to ``(answer, lsn)``
        with ``lsn >= min_lsn`` guaranteed for consistent reads.  For
        ``kind="rpq"`` the query ``p`` is a ``repro_torch.rpq`` regex AST
        (serialized as regex text on the wire) rather than a pattern."""
        rid = next(self._ids)
        ptxt = rpq_mod.unparse(p) if kind == "rpq" else pat.unparse(p)
        wire = {"op": "q", "id": rid, "u": int(u), "v": int(v),
                "p": ptxt, "kind": kind, "hops": int(hops)}
        if k is not None:
            wire["k"] = int(k)
        if min_lsn:
            wire["min_lsn"] = int(min_lsn)
            wire["lsn_timeout"] = float(lsn_timeout)
        pending = _Pending(rid, wire, Future())
        with self._lock:
            self._inflight[rid] = pending
        self._dispatch(pending)
        return pending.future

    def _pick(self, min_lsn: int) -> Replica:
        members = self.fleet.members()
        if not members:
            raise FleetUnavailable("no live replicas")
        caught_up = [r for r in members if r.lsn >= min_lsn]
        pool = caught_up or members
        if not caught_up:
            # redirect: highest-LSN replica blocks server-side via
            # wait_for_lsn until the tail applies min_lsn
            best = max(r.lsn for r in members)
            pool = [r for r in members if r.lsn == best]
            self.redirected += 1
        loads = {id(r): 0 for r in pool}
        with self._lock:
            for pend in self._inflight.values():
                if pend.replica is not None and id(pend.replica) in loads:
                    loads[id(pend.replica)] += 1
        return min(pool, key=lambda r: (loads[id(r)], r.queued))

    def _dispatch(self, pending: _Pending) -> None:
        while True:
            pending.attempts += 1
            if pending.attempts > self.max_attempts:
                self._fail(pending, ReplicaDied(
                    f"request {pending.rid} failed on "
                    f"{self.max_attempts} replicas"))
                return
            try:
                replica = self._pick(pending.wire.get("min_lsn", 0))
            except FleetUnavailable as exc:
                self._fail(pending, exc)
                return
            pending.replica = replica
            replica.pending[pending.rid] = pending
            if replica.send(pending.wire):
                return
            # pipe already broken — the reader thread will orphan
            # whatever was registered; retry against another member now
            replica.pending.pop(pending.rid, None)

    def _fail(self, pending: _Pending, exc: Exception) -> None:
        with self._lock:
            self._inflight.pop(pending.rid, None)
        if not pending.future.done():
            pending.future.set_exception(exc)

    # ------------------------------------------------------------- resolve
    def _resolve(self, msg: dict) -> None:
        rid = int(msg["id"])
        with self._lock:
            pending = self._inflight.pop(rid, None)
        if pending is None or pending.future.done():
            return
        if pending.replica is not None:
            pending.replica.pending.pop(rid, None)
        if msg.get("ok"):
            val = msg["val"]
            if isinstance(val, list):   # witness path edges over JSON
                val = [tuple(e) for e in val]
            pending.future.set_result((val, int(msg["lsn"])))
        else:
            pending.future.set_exception(
                RuntimeError(f"replica error: {msg.get('err')}"))

    def _on_orphans(self, orphans: list) -> None:
        """A replica died with these requests in flight: re-dispatch
        each to a survivor (reads are idempotent)."""
        for pending in orphans:
            if pending.future.done():
                continue
            self.redispatched += 1
            self._dispatch(pending)

    # -------------------------------------------------------------- status
    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)
