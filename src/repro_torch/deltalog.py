"""Append-only write-ahead log of ``GraphDelta`` batches.

The durability counterpart of ``repro_torch.snapshot``: a snapshot pins
the expensive build at some log sequence number (LSN), and this log
records every graph update applied after it, so recovery is

    load latest valid snapshot  +  replay records with LSN > snapshot's
    through ``tdr_build.update_index``

which is bit-identical to a layout-pinned rebuild of the final graph
(the ``update_index`` contract).  Framing is crash-safe by construction:

* **File header.**  8-byte magic plus a CRC'd base LSN — the sequence
  number the log starts *after* (advanced by compaction), so an empty
  compacted log still knows its position in the sequence across
  restarts.
* **Record layout.**  ``magic u32 | header_crc u32 | lsn u64 |
  payload_len u32 | payload_crc u32 | payload`` — the header CRC covers
  ``(lsn, payload_len)`` so a flipped length byte can never silently
  misparse the stream, and the payload CRC covers the delta arrays.
* **Torn-tail truncation.**  Appends write sequentially, so a crash
  mid-append leaves a strict prefix of the record at the tail.  On open
  the log scans forward; an *incomplete* tail record (header shorter
  than 24 bytes, or a CRC-validated length that runs past EOF) is
  physically truncated away and every prior record replays.  Any other
  framing or CRC failure — a complete record that doesn't check out —
  raises ``LogCorrupt``: bit rot is detected, never replayed.
* **LSNs are dense and strictly increasing.**  ``append`` assigns
  ``last + 1`` (or validates a caller-provided LSN); the scanner rejects
  out-of-order records.  ``pop_tail`` removes exactly the newest record
  — the rollback hook for a write-ahead append whose apply was
  withdrawn — and ``truncate_upto`` drops the records a new snapshot
  has folded in (compaction), atomically.
* **fsync'd.**  Every append flushes and fsyncs before returning, so an
  acked update survives the process.
* **Multi-reader tailing.**  ``LogReader`` gives other *processes* a
  read-only cursor over the same file: replicas of a serving fleet tail
  the log a single writer appends to, each yielding exactly the records
  a recovering writer would replay as committed (torn in-flight appends
  are never yielded), and surviving ``truncate_upto`` compaction as
  long as their cursor is at or past the compaction point.

``append``/``replay`` speak ``(added, removed)`` int64 ``[N, 3]`` edge
arrays — exactly the effective-delta form of ``graph.GraphDelta``.

Numpy only, and the same on-disk format as the JAX package's log: a log
written by either package replays in the other.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib

import numpy as np

FILE_MAGIC = b"TDRWAL\x01\n"
REC_MAGIC = 0x7D31A106
_HEAD = struct.Struct("<IIQII")   # magic, header_crc, lsn, plen, pcrc
_FHEAD = struct.Struct("<QI")     # base_lsn, crc(base_lsn)

# injectable I/O seams: a fault-injection harness patches these to
# fail, short-write or corrupt the Nth call; every open and fsync of the
# log goes through them
_OPEN = open
_FSYNC = os.fsync


class LogCorrupt(RuntimeError):
    """A complete log record failed framing/CRC validation (bit rot,
    overwrite, or interleaved garbage) — replay must not proceed."""


class LogCompactedPast(RuntimeError):
    """A reader's cursor fell behind ``truncate_upto`` compaction: the
    records it still needs no longer exist.  The reader must
    re-bootstrap from a snapshot at or past the log's new base LSN."""


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _head_crc(lsn: int, plen: int) -> int:
    return _crc(struct.pack("<QI", lsn, plen))


def _file_header(base_lsn: int) -> bytes:
    return FILE_MAGIC + _FHEAD.pack(base_lsn,
                                    _crc(struct.pack("<Q", base_lsn)))


def _encode_payload(added: np.ndarray, removed: np.ndarray) -> bytes:
    a = np.ascontiguousarray(added, dtype=np.int64).reshape(-1, 3)
    r = np.ascontiguousarray(removed, dtype=np.int64).reshape(-1, 3)
    return (struct.pack("<II", a.shape[0], r.shape[0])
            + a.tobytes() + r.tobytes())


def _decode_payload(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    if len(data) < 8:
        raise LogCorrupt("log payload shorter than its counts")
    na, nr = struct.unpack_from("<II", data, 0)
    need = 8 + 24 * (na + nr)
    if len(data) != need:
        raise LogCorrupt(
            f"log payload length {len(data)} != declared {need}")
    a = np.frombuffer(data, dtype=np.int64, count=3 * na,
                      offset=8).reshape(na, 3)
    r = np.frombuffer(data, dtype=np.int64, count=3 * nr,
                      offset=8 + 24 * na).reshape(nr, 3)
    return a, r


def _encode_record(lsn: int, added, removed) -> bytes:
    payload = _encode_payload(np.asarray(added), np.asarray(removed))
    return _HEAD.pack(REC_MAGIC, _head_crc(lsn, len(payload)), lsn,
                      len(payload), _crc(payload)) + payload


@dataclasses.dataclass(frozen=True)
class LogRecord:
    lsn: int
    offset: int      # byte offset of the record header in the file
    length: int      # total record bytes (header + payload)
    added: np.ndarray
    removed: np.ndarray


class DeltaLog:
    """One append-only delta log file (see module docstring).

    Opening scans and validates the whole file: ``records`` holds every
    durable record in LSN order, ``truncated_bytes`` reports how much
    torn tail (if any) was cut.  The instance keeps the file handle open
    in append position; ``append``/``pop_tail``/``truncate_upto`` keep
    the in-memory record list and the file in lockstep.
    """

    def __init__(self, path: str, *, create: bool = True):
        self.path = path
        self.records: list[LogRecord] = []
        self.base_lsn = 0
        self.truncated_bytes = 0
        exists = os.path.exists(path)
        if not exists and not create:
            raise FileNotFoundError(path)
        if not exists:
            with _OPEN(path, "wb") as f:
                f.write(_file_header(0))
                f.flush()
                _FSYNC(f.fileno())
        self._scan()
        self._fh = _OPEN(path, "r+b")
        self._fh.seek(0, os.SEEK_END)

    # ------------------------------------------------------------- scan
    def _scan(self) -> None:
        with _OPEN(self.path, "rb") as f:
            data = f.read()
        hdr_len = len(FILE_MAGIC) + _FHEAD.size
        if len(data) < hdr_len:
            raise LogCorrupt("log file shorter than its header")
        if data[:len(FILE_MAGIC)] != FILE_MAGIC:
            raise LogCorrupt("bad magic: not a TDR delta log")
        base, bcrc = _FHEAD.unpack_from(data, len(FILE_MAGIC))
        if bcrc != _crc(struct.pack("<Q", base)):
            raise LogCorrupt("log base-LSN header failed its CRC")
        pos = hdr_len
        records: list[LogRecord] = []
        last_lsn = base
        self.truncated_bytes = 0
        while pos < len(data):
            remaining = len(data) - pos
            if remaining < _HEAD.size:
                break   # torn header at the tail
            magic, hcrc, lsn, plen, pcrc = _HEAD.unpack_from(data, pos)
            if magic != REC_MAGIC:
                raise LogCorrupt(
                    f"record at offset {pos}: bad record magic")
            if hcrc != _head_crc(lsn, plen):
                raise LogCorrupt(
                    f"record at offset {pos}: header failed its CRC")
            if _HEAD.size + plen > remaining:
                break   # torn payload at the tail (length is CRC-trusted)
            payload = data[pos + _HEAD.size:pos + _HEAD.size + plen]
            if _crc(payload) != pcrc:
                raise LogCorrupt(
                    f"record lsn={lsn} at offset {pos}: payload failed "
                    f"its CRC")
            if lsn != last_lsn + 1:
                raise LogCorrupt(
                    f"record at offset {pos}: LSN {lsn} after "
                    f"{last_lsn} (log must be dense and increasing)")
            added, removed = _decode_payload(payload)
            records.append(LogRecord(lsn=int(lsn), offset=pos,
                                     length=_HEAD.size + plen,
                                     added=added, removed=removed))
            last_lsn = int(lsn)
            pos += _HEAD.size + plen
        if pos < len(data):
            # physically drop the torn tail so appends restart cleanly
            self.truncated_bytes = len(data) - pos
            with _OPEN(self.path, "r+b") as f:
                f.truncate(pos)
                f.flush()
                _FSYNC(f.fileno())
        self.base_lsn = int(base)
        self.records = records

    # ------------------------------------------------------------ state
    @property
    def last_lsn(self) -> int:
        return self.records[-1].lsn if self.records else self.base_lsn

    def __len__(self) -> int:
        return len(self.records)

    # ----------------------------------------------------------- append
    def append(self, added, removed, *, lsn: int | None = None) -> int:
        """Durably append one delta; returns its LSN.

        The record is fully written, flushed, and fsync'd before this
        returns — write-ahead ordering means callers append *before*
        applying the update to any served state.  On any I/O failure the
        file is rolled back (best effort) to the pre-append length so
        the live log never carries a half-record, and the exception
        propagates.
        """
        nxt = self.last_lsn + 1
        if lsn is None:
            lsn = nxt
        elif lsn != nxt:
            raise ValueError(f"append lsn {lsn} != expected {nxt}")
        rec = _encode_record(lsn, added, removed)
        off = self._fh.tell()
        try:
            self._fh.write(rec)
            self._fh.flush()
            _FSYNC(self._fh.fileno())
        except BaseException:
            try:    # keep the live handle consistent after a failed write
                self._fh.truncate(off)
                self._fh.seek(off)
            except OSError:
                pass
            raise
        a, r = _decode_payload(rec[_HEAD.size:])
        self.records.append(LogRecord(lsn=lsn, offset=off,
                                      length=len(rec), added=a,
                                      removed=r))
        return lsn

    def pop_tail(self, lsn: int) -> None:
        """Remove the newest record iff it carries ``lsn`` — the
        rollback for a write-ahead append whose apply was withdrawn
        (e.g. an update barrier that timed out before the swap)."""
        if not self.records or self.records[-1].lsn != lsn:
            raise ValueError(
                f"pop_tail({lsn}): tail is "
                f"{self.records[-1].lsn if self.records else None}")
        rec = self.records.pop()
        self._fh.truncate(rec.offset)
        self._fh.seek(rec.offset)
        self._fh.flush()
        _FSYNC(self._fh.fileno())

    # ----------------------------------------------------------- replay
    def replay(self, after_lsn: int = 0):
        """Yield ``(lsn, added, removed)`` for records with
        ``lsn > after_lsn``, in order."""
        for rec in self.records:
            if rec.lsn > after_lsn:
                yield rec.lsn, rec.added, rec.removed

    # ------------------------------------------------------- compaction
    def truncate_upto(self, lsn: int) -> int:
        """Drop records with LSN <= ``lsn`` (a new snapshot folded them
        in) and advance the base LSN; returns how many were dropped.
        Atomic: the survivors are rewritten to a temp file that replaces
        the log."""
        lsn = min(int(lsn), self.last_lsn)
        if lsn <= self.base_lsn:
            return 0
        keep = [r for r in self.records if r.lsn > lsn]
        n_before = len(self.records)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with _OPEN(tmp, "wb") as f:
                f.write(_file_header(lsn))
                for rec in keep:
                    f.write(_encode_record(rec.lsn, rec.added,
                                           rec.removed))
                f.flush()
                _FSYNC(f.fileno())
            self._fh.close()
            self._fh = None
            os.replace(tmp, self.path)
        finally:
            # whichever version survived on disk (the replace is atomic),
            # rescan it and leave the instance with a live append handle
            # — a failed compaction must not brick the log
            if os.path.exists(tmp):
                os.unlink(tmp)
            if self._fh is None:
                self._scan()
                self._fh = _OPEN(self.path, "r+b")
                self._fh.seek(0, os.SEEK_END)
        return n_before - len(keep)

    # ---------------------------------------------------------- cleanup
    def close(self) -> None:
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "DeltaLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LogReader:
    """Read-only tailing cursor over a ``DeltaLog`` file — the
    multi-process counterpart of ``DeltaLog.replay`` for replicas that
    follow a log another process is appending to.

    The reader never mutates the file: it re-reads and re-validates on
    every ``poll`` (logs stay small under compaction, so the simplicity
    is worth the O(file) scan) and yields exactly the records a
    recovering *writer* would replay as committed:

    * A record is yielded only once its framing and both CRCs validate
      and its LSN extends the dense sequence — the same acceptance rule
      as ``DeltaLog._scan``.
    * A **torn tail** (a record the writer is still appending, or that a
      writer crash left half-written) is never yielded: an incomplete
      header, a CRC-trusted length running past EOF, or a payload-CRC
      failure *at end of file* all read as "in progress" and the poll
      simply stops there.  A payload-CRC failure with further bytes
      behind it cannot be an in-flight append and raises ``LogCorrupt``.
    * **Compaction-safe.**  ``truncate_upto`` atomically replaces the
      file; the reader detects the new base LSN and resumes at its
      cursor — records above the compaction point are yielded exactly
      once.  If compaction advanced *past* the cursor the needed records
      are gone and ``poll`` raises ``LogCompactedPast`` (re-bootstrap
      from a snapshot).
    * A log whose tip *retreated* below the cursor with the same base
      (the writer rolled back via ``pop_tail`` a record this reader
      already consumed) raises ``LogCorrupt`` — single-writer fleets
      must treat ``append`` as commit for reader correctness.

    ``seek(after_lsn)`` repositions the cursor (e.g. to re-deliver a
    record whose apply failed)."""

    def __init__(self, path: str, *, after_lsn: int = 0):
        self.path = path
        self.lsn = int(after_lsn)   # last consumed LSN (cursor)
        self.base_lsn = 0
        self.last_seen_lsn = 0      # log tip observed by the last poll
        self._probe()               # validate header + learn base_lsn

    def _probe(self) -> None:
        """Validate the file header and refresh ``base_lsn`` without
        touching the cursor — safe on a log compacted past the cursor
        (callers pick a snapshot >= ``base_lsn``, then ``seek``)."""
        with open(self.path, "rb") as f:
            head = f.read(len(FILE_MAGIC) + _FHEAD.size)
        if len(head) < len(FILE_MAGIC) + _FHEAD.size:
            raise LogCorrupt("log file shorter than its header")
        if head[:len(FILE_MAGIC)] != FILE_MAGIC:
            raise LogCorrupt("bad magic: not a TDR delta log")
        base, bcrc = _FHEAD.unpack_from(head, len(FILE_MAGIC))
        if bcrc != _crc(struct.pack("<Q", base)):
            raise LogCorrupt("log base-LSN header failed its CRC")
        self.base_lsn = int(base)

    def seek(self, after_lsn: int) -> None:
        """Reposition the cursor: the next ``poll`` re-delivers records
        with LSN > ``after_lsn``."""
        self.lsn = int(after_lsn)

    def poll(self, max_records: int | None = None
             ) -> list[tuple[int, np.ndarray, np.ndarray]]:
        """Return ``(lsn, added, removed)`` for every durable record
        beyond the cursor (possibly none), advancing the cursor past
        what is returned."""
        with open(self.path, "rb") as f:
            data = f.read()
        hdr_len = len(FILE_MAGIC) + _FHEAD.size
        if len(data) < hdr_len:
            raise LogCorrupt("log file shorter than its header")
        if data[:len(FILE_MAGIC)] != FILE_MAGIC:
            raise LogCorrupt("bad magic: not a TDR delta log")
        base, bcrc = _FHEAD.unpack_from(data, len(FILE_MAGIC))
        if bcrc != _crc(struct.pack("<Q", base)):
            raise LogCorrupt("log base-LSN header failed its CRC")
        self.base_lsn = int(base)
        if base > self.lsn:
            raise LogCompactedPast(
                f"log compacted to base {base} past reader cursor "
                f"{self.lsn}")
        out: list[tuple[int, np.ndarray, np.ndarray]] = []
        pos = hdr_len
        prev = int(base)
        while pos < len(data):
            remaining = len(data) - pos
            if remaining < _HEAD.size:
                break   # in-flight append: torn header
            magic, hcrc, lsn, plen, pcrc = _HEAD.unpack_from(data, pos)
            if magic != REC_MAGIC:
                raise LogCorrupt(
                    f"record at offset {pos}: bad record magic")
            if hcrc != _head_crc(lsn, plen):
                raise LogCorrupt(
                    f"record at offset {pos}: header failed its CRC")
            end = pos + _HEAD.size + plen
            if end > len(data):
                break   # in-flight append: torn payload
            payload = data[pos + _HEAD.size:end]
            if _crc(payload) != pcrc:
                if end == len(data):
                    # contents may lag the visible file length while the
                    # writer's single append is still landing — wait
                    break
                raise LogCorrupt(
                    f"record lsn={lsn} at offset {pos}: payload failed "
                    f"its CRC mid-log")
            if lsn != prev + 1:
                raise LogCorrupt(
                    f"record at offset {pos}: LSN {lsn} after {prev} "
                    f"(log must be dense and increasing)")
            prev = int(lsn)
            if lsn > self.lsn and \
                    (max_records is None or len(out) < max_records):
                out.append((int(lsn), *_decode_payload(payload)))
            pos = end
        if prev < self.lsn:
            raise LogCorrupt(
                f"log tip {prev} retreated below reader cursor "
                f"{self.lsn} (pop_tail under an active reader?)")
        self.last_seen_lsn = prev
        if out:
            self.lsn = out[-1][0]
        return out
