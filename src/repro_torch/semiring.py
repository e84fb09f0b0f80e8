"""Semiring carriers for the fixpoint engine and the query kinds.

The engine iterates ``r <- r (+) step(r)`` until a fixpoint.  This module
names the algebra, so the same propagate/closure cores (and the lane
kernel ``kernels.lane_matmul``) run four instantiations:

``BOOLEAN``
    the packed carrier: 32 graph bits per int32 word, ``combine`` =
    bitwise OR, ``extend`` = identity.  Its branches are the engine's
    own packed-OR idioms, so boolean planes stay bit-identical.

``DIST16`` / ``DIST8``
    hop distance (min, +) over saturating unsigned lanes: one lane per
    query/state column, ``INF`` = the lane's maximum, ``extend`` =
    saturating +1 (``d + (d < INF)``, never wraps).  Idempotent, so the
    closure fixpoint converges; drives ``tdr_query.dist`` / ``witness``.

``COUNT``
    bounded route counting with saturating add, capped at ``cap``.  Not
    idempotent: ``Engine.closure`` refuses it; route counting runs a
    hop-bounded DP in ``tdr_query.count_routes`` instead.

**Lane storage.**  torch has no ``minimum``, ``<`` or ``>>`` on
``uint16``/``uint32``, so a lane is *stored* at the JAX package's width
but in a dtype torch computes with: ``uint8`` as ``torch.uint8``,
``uint16`` as ``torch.int16`` and ``uint32`` as ``torch.int32``, each
holding the same bits (a DIST16 lane at INF reads -1 in its int16
storage).  Every compare and reduction first *widens* the stored bits to
their unsigned value (``widen``: int32 for 8- and 16-bit lanes, int64 for
32-bit lanes) and *narrows* the result back (``narrow``).  The lane
kernels read and write the stored width, so a DIST16 lane costs 2 bytes
on the card.  ``tdr_query``'s distance planes carry widened int32 values
between kernel calls.
"""
from __future__ import annotations

import dataclasses

import torch

from . import bitset

#: saturation cap for COUNT: 2^15 - 1, the JAX package's value.
COUNT_CAP = (1 << 15) - 1

_STORAGE = {"uint8": torch.uint8, "uint16": torch.int16,
            "uint32": torch.int32}
_BITS = {"uint8": 8, "uint16": 16, "uint32": 32}


def lane_bits(t: torch.Tensor) -> int:
    """Width in bits of the unsigned lanes a storage tensor holds."""
    return t.element_size() * 8


def lane_max(bits: int) -> int:
    return (1 << bits) - 1


def widen(t: torch.Tensor) -> torch.Tensor:
    """Stored lane bits -> their unsigned values (int32 for 8/16-bit
    lanes, int64 for 32-bit lanes)."""
    bits = lane_bits(t)
    if bits == 8:
        return t.to(torch.int32)
    if bits == 16:
        return t.to(torch.int32) & 0xFFFF
    return t.to(torch.int64) & 0xFFFFFFFF


def narrow(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned values in ``[0, 2^bits)`` -> the ``bits``-wide storage."""
    if bits == 8:
        return vals.to(torch.uint8)
    half = 1 << (bits - 1)
    vals = torch.where(vals >= half, vals - (half << 1), vals)
    return vals.to(torch.int16 if bits == 16 else torch.int32)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (+)/(x) algebra over one carrier lane.

    ``op`` names the lane combine the kernels implement ("or" | "min" |
    "sum"); ``packed`` marks the 32-bits-per-word boolean carrier.
    ``zero`` is the (+)-identity, ``one`` the weight of the empty path.
    ``idempotent`` is the closure's precondition (``combine(a, a) == a``).
    """

    name: str
    op: str                   # lane combine: "or" | "min" | "sum"
    dtype_name: str           # lane width, as the JAX package names it
    packed: bool              # 32 graph bits per int32 word?
    idempotent: bool          # combine(a, a) == a (closure well-defined)
    cap: int = 0              # saturation cap ("sum" only)

    # -- carrier ----------------------------------------------------------
    @property
    def dtype(self) -> torch.dtype:
        """Storage dtype of one lane (see the module note)."""
        return _STORAGE[self.dtype_name]

    @property
    def bits(self) -> int:
        return _BITS[self.dtype_name]

    @property
    def zero(self) -> int:
        """(+)-identity: 0 for or/sum, the lane maximum (INF) for min."""
        return lane_max(self.bits) if self.op == "min" else 0

    @property
    def one(self) -> int:
        """(x)-identity: the weight of the empty path."""
        return 0 if self.op == "min" else 1

    @property
    def inf(self) -> int:
        """The min-semiring's unreachable sentinel."""
        if self.op != "min":
            raise ValueError(f"{self.name}: inf only defined for min")
        return self.zero

    def init(self, shape, device="cuda") -> torch.Tensor:
        """A stored plane of (+)-identities, on the card unless the caller
        passes ``device="cpu"``."""
        return narrow(torch.full(shape, self.zero, dtype=torch.int64,
                                 device=bitset.resolve_device(device)),
                      self.bits)

    # -- algebra (stored lanes in, stored lanes out) -----------------------
    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(+): OR / elementwise min / saturating add."""
        if self.op == "or":
            return a | b
        if self.op == "min":
            return narrow(torch.minimum(widen(a), widen(b)), self.bits)
        return narrow((widen(a).to(torch.int64) + widen(b)).clamp(
            max=self.cap), self.bits)

    def extend(self, vals: torch.Tensor) -> torch.Tensor:
        """(x) with a unit edge weight: identity for or/sum, saturating +1
        for min (INF stays INF, INF-1 saturates to INF)."""
        if self.op != "min":
            return vals
        w = widen(vals)
        return narrow(w + (w < self.zero).to(w.dtype), self.bits)

    def segment_combine(self, vals: torch.Tensor, segment_ids: torch.Tensor,
                        *, num_segments: int,
                        chunk_words: int = 2) -> torch.Tensor:
        """(+)-reduce ``vals`` rows into ``num_segments`` rows; ids
        outside ``[0, num_segments)`` are dropped, as in the JAX package.

        The boolean carrier keeps the chunked packed-word OR; min takes
        ``scatter_reduce("amin")`` over an INF-filled plane, sum an int64
        ``index_add_`` and the clamp."""
        if self.op == "or":
            return bitset.segment_or_words(vals, segment_ids,
                                           num_segments=num_segments,
                                           chunk_words=chunk_words)
        dev = vals.device
        seg = segment_ids.to(device=dev, dtype=torch.int64)
        seg = torch.where((seg >= 0) & (seg < num_segments), seg,
                          num_segments)
        w = widen(vals)
        shape = (num_segments + 1,) + tuple(vals.shape[1:])
        if self.op == "min":
            out = torch.full(shape, self.zero, dtype=w.dtype, device=dev)
            idx = seg.reshape((-1,) + (1,) * (w.dim() - 1)).expand_as(w)
            out.scatter_reduce_(0, idx, w, "amin")
        else:
            out = torch.zeros(shape, dtype=torch.int64, device=dev)
            out.index_add_(0, seg, w.to(torch.int64))
            out = out.clamp(max=self.cap)
        return narrow(out[:num_segments], self.bits)

    def accumulate(self, r: torch.Tensor, upd: torch.Tensor):
        """One fixpoint round: fold ``upd`` into ``r``.  Returns ``(new_r,
        changed)`` with ``changed`` a 0-dim bool tensor.  The boolean
        branch is the ``upd & ~r`` new-bits idiom; min compares planes
        (monotone decreasing, so inequality is "some lane improved")."""
        if not self.idempotent:
            raise ValueError(
                f"{self.name}: accumulate/closure need an idempotent (+)")
        if self.op == "or":
            new = upd & ~r
            return r | new, (new != 0).any()
        wr = widen(r)
        new_r = torch.minimum(wr, widen(upd))
        return narrow(new_r, self.bits), (new_r != wr).any()


BOOLEAN = Semiring(name="boolean", op="or", dtype_name="uint32",
                   packed=True, idempotent=True)
DIST16 = Semiring(name="dist16", op="min", dtype_name="uint16",
                  packed=False, idempotent=True)
DIST8 = Semiring(name="dist8", op="min", dtype_name="uint8",
                 packed=False, idempotent=True)
COUNT = Semiring(name="count", op="sum", dtype_name="uint32",
                 packed=False, idempotent=False, cap=COUNT_CAP)

_BY_NAME = {s.name: s for s in (BOOLEAN, DIST16, DIST8, COUNT)}


def by_name(name: str) -> Semiring:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(
            f"unknown semiring {name!r}; have {sorted(_BY_NAME)}") from None
