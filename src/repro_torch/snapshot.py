"""Checksummed snapshot serialization of a built ``TDRIndex``.

The TDR build is the expensive step of the whole system (full
label×vertex reachability, §IV), which makes losing a built index on
restart the most expensive failure a serving fleet can have.  This
module makes the index a durable on-disk artifact:

* **Versioned container.**  An 8-byte magic + u32 format version guard
  the file; a future layout change bumps ``VERSION`` and old readers
  raise ``SnapshotVersionMismatch`` instead of misparsing.
* **Per-section CRC.**  Every array travels as its own section with a
  crc32 recorded in the header; the header itself is CRC'd, and the
  magic/version words are covered by plain equality.  A truncated,
  bit-flipped, or torn-renamed file is *detected* (``SnapshotCorrupt``)
  — never silently served.
* **Compressed planes.**  Index planes are stored in the two-level
  compressed form of ``repro_torch.compressed`` (2-bit row/word states +
  mixed-word pool), so snapshots inherit the ~4.5–5x size win over the
  dense packed planes, and ``load_index`` seeds the index's
  compressed-plane cache from the very objects it read — the restored
  index starts with its summary flags and memory stats for free.
* **Maintenance state included.**  ``disc`` (the frozen hash layout),
  the one-hop base planes, converged closures, and vertical planes all
  round-trip, so a restored index chains ``tdr_build.update_index``
  exactly like the index that was saved: snapshot + delta-log replay
  (``repro_torch.deltalog``) is bit-identical to a layout-pinned rebuild
  of the final graph.
* **Atomic writes.**  ``save_index`` writes to a temp file, fsyncs,
  then renames into place (and fsyncs the directory), so a crash during
  save leaves either the old snapshot or the new one — never a partial
  file under the final name.

``save_index(index, path, lsn=...)`` / ``load_index(path, device=...)``
are the whole API; the ``lsn`` rides in the header so recovery knows
which delta-log records are already folded in.

The format is the JAX package's, byte for byte: planes leave the device
as the uint32 words their int32 tensors carry, and every other section
keeps the reference's dtype, so a snapshot written by either package
loads into the other bit-identically, and both write the same bytes for
the same index.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import torch

from . import bitset
from . import compressed as compressed_mod
from .graph import Graph
from .tdr_build import TDRConfig, TDRIndex

MAGIC = b"TDRSNAP\x01"
VERSION = 1

# injectable I/O seams: a fault-injection harness patches these to
# fail, short-write or corrupt the Nth call; every open and fsync of a
# snapshot goes through them
_OPEN = open
_FSYNC = os.fsync


class SnapshotError(RuntimeError):
    """Base class of every typed snapshot failure."""


class SnapshotCorrupt(SnapshotError):
    """Magic/CRC/length validation failed: the file is truncated, bit-
    flipped, or not a snapshot at all.  Never load past this."""


class SnapshotVersionMismatch(SnapshotError):
    """The file is a well-formed snapshot of an incompatible format
    version (or config schema) — rebuild or migrate, don't guess."""


# every plane a snapshot may carry (the union of TDRIndex.plane_specs
# and TDRIndex.aux_plane_specs keys) — load rejects anything else
_PLANE_NAMES = frozenset({
    "h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in",
    "r_vtx", "r_lab", "r_in",
    "base_v", "base_l", "base_r", "d_vtx", "d_lab",
})


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


class _Writer:
    """Accumulates named array sections; each remembers dtype, shape,
    byte offset (into the payload), length, and crc32."""

    def __init__(self):
        self.sections: list[dict] = []
        self.chunks: list[bytes] = []
        self.offset = 0

    def add(self, name: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        data = arr.tobytes()
        self.sections.append({
            "name": name, "dtype": arr.dtype.str,
            "shape": list(arr.shape), "offset": self.offset,
            "length": len(data), "crc": _crc(data)})
        self.chunks.append(data)
        self.offset += len(data)


class _Reader:
    """Validated section reads out of an in-memory payload."""

    def __init__(self, payload: bytes, sections: list[dict]):
        self.payload = payload
        self.by_name = {s["name"]: s for s in sections}

    def get(self, name: str) -> np.ndarray:
        sec = self.by_name.get(name)
        if sec is None:
            raise SnapshotCorrupt(f"snapshot is missing section {name!r}")
        lo, hi = sec["offset"], sec["offset"] + sec["length"]
        if hi > len(self.payload):
            raise SnapshotCorrupt(
                f"section {name!r} extends past end of file "
                f"(truncated snapshot?)")
        data = self.payload[lo:hi]
        if _crc(data) != sec["crc"]:
            raise SnapshotCorrupt(f"section {name!r} failed its CRC check")
        return np.frombuffer(data, dtype=np.dtype(sec["dtype"])).reshape(
            sec["shape"])


def _compressed_sections(w: _Writer, name: str,
                         c: compressed_mod.CompressedPlanes) -> dict:
    """Emit one compressed plane as five array sections + header meta."""
    w.add(f"{name}.row_states", c.row_states)
    w.add(f"{name}.mix_rows", c.mix_rows)
    w.add(f"{name}.word_states", c.word_states)
    w.add(f"{name}.pool", c.pool)
    w.add(f"{name}.pool_off", c.pool_off)
    return {"shape": list(c.shape), "nbits": c.nbits}


def _read_compressed(r: _Reader, name: str,
                     meta: dict) -> compressed_mod.CompressedPlanes:
    return compressed_mod.CompressedPlanes(
        shape=tuple(meta["shape"]), nbits=int(meta["nbits"]),
        row_states=r.get(f"{name}.row_states"),
        mix_rows=r.get(f"{name}.mix_rows"),
        word_states=r.get(f"{name}.word_states"),
        pool=r.get(f"{name}.pool"),
        pool_off=r.get(f"{name}.pool_off"))


def save_index(index: TDRIndex, path: str, *, lsn: int = 0) -> int:
    """Serialize ``index`` to ``path`` atomically; returns bytes written.

    ``lsn`` marks the last delta-log sequence number already folded into
    these planes (0 for a fresh build): recovery replays only records
    with a greater LSN.  Planes are stored two-level compressed; the
    maintenance state (``disc``, base/closure/vertical planes) rides
    along when present so the restored index updates incrementally.
    """
    w = _Writer()
    g = index.graph
    for name in ("indptr", "indices", "labels"):
        w.add(name, getattr(g, name))
    for name in ("push", "pop", "g_count"):
        w.add(name, getattr(index, name).cpu().numpy().astype(np.int32))
    w.add("vtx_words", index.vtx_words)
    w.add("lab_slot", index.lab_slot)
    if index.disc is not None:
        w.add("disc", np.asarray(index.disc, dtype=np.int32))

    comp_cache = index.compressed_planes()   # h_vtx..r_in, canonical form
    specs = dict(index.plane_specs())
    specs.update(index.aux_plane_specs())
    planes: dict = {}
    for name, (arr, nbits) in specs.items():
        c = comp_cache.get(name) or compressed_mod.compress(
            bitset.words_to_np(arr), nbits=nbits)
        planes[name] = _compressed_sections(w, name, c)

    header = {
        "version": VERSION,
        "lsn": int(lsn),
        "cfg": dataclasses.asdict(index.cfg),
        "graph": {"n_vertices": g.n_vertices, "n_labels": g.n_labels},
        "fixpoint_rounds": int(index.fixpoint_rounds),
        "planes": planes,
        "sections": w.sections,
    }
    hdr = json.dumps(header, separators=(",", ":")).encode()
    blob = (MAGIC + struct.pack("<III", VERSION, len(hdr), _crc(hdr))
            + hdr + b"".join(w.chunks))

    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with _OPEN(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            _FSYNC(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                  os.O_RDONLY)
    try:
        _FSYNC(dfd)
    finally:
        os.close(dfd)
    return len(blob)


def peek_lsn(path: str) -> int:
    """Header-only read: the LSN a snapshot was taken at (validated
    magic/version/header CRC, but section payloads untouched)."""
    with _OPEN(path, "rb") as f:
        data = f.read()
    header, _ = _parse_header(data)
    return int(header["lsn"])


def _parse_header(data: bytes) -> tuple[dict, bytes]:
    if len(data) < len(MAGIC) + 12:
        raise SnapshotCorrupt("file too short to be a snapshot")
    if data[:len(MAGIC)] != MAGIC:
        raise SnapshotCorrupt("bad magic: not a TDR snapshot")
    version, hlen, hcrc = struct.unpack_from("<III", data, len(MAGIC))
    if version != VERSION:
        raise SnapshotVersionMismatch(
            f"snapshot format v{version}, this reader is v{VERSION}")
    off = len(MAGIC) + 12
    hdr = data[off:off + hlen]
    if len(hdr) < hlen:
        raise SnapshotCorrupt("truncated snapshot header")
    if _crc(hdr) != hcrc:
        raise SnapshotCorrupt("snapshot header failed its CRC check")
    try:
        header = json.loads(hdr)
    except ValueError as e:
        raise SnapshotCorrupt(f"unparseable snapshot header: {e}") from e
    if header.get("version") != VERSION:
        raise SnapshotVersionMismatch(
            "header/trailer version disagreement")
    return header, data[off + hlen:]


def load_index(path: str, *, device="cuda") -> tuple[TDRIndex, int]:
    """Deserialize a snapshot onto ``device`` (the card by default; it
    raises without one); returns ``(index, lsn)``.

    Every section is CRC-validated before use; any mismatch raises
    ``SnapshotCorrupt`` (or ``SnapshotVersionMismatch`` for a format
    bump) — a damaged snapshot is *never* partially loaded.  The
    restored index is bit-identical to the one saved, carries the full
    maintenance state, and starts with its compressed-plane cache
    populated from the sections just read.  Planes land on the device as
    int32 views of their uint32 words; the graph, hash tables and integer
    rows are writable copies of the file's bytes.
    """
    dev = bitset.resolve_device(device)
    with _OPEN(path, "rb") as f:
        data = f.read()
    header, payload = _parse_header(data)
    r = _Reader(payload, header["sections"])

    try:
        cfg = TDRConfig(**header["cfg"])
    except TypeError as e:
        raise SnapshotVersionMismatch(
            f"snapshot config schema mismatch: {e}") from e
    gmeta = header["graph"]
    graph = Graph(int(gmeta["n_vertices"]), int(gmeta["n_labels"]),
                  *(np.array(r.get(f)) for f in ("indptr", "indices",
                                                 "labels")))
    if graph.indptr.shape != (graph.n_vertices + 1,):
        raise SnapshotCorrupt("graph indptr shape mismatch")

    planes_meta = header["planes"]
    dense: dict = {}
    comp: dict = {}
    for name, meta in planes_meta.items():
        if name not in _PLANE_NAMES:
            raise SnapshotCorrupt(f"unknown plane section {name!r}")
        c = _read_compressed(r, name, meta)
        dense[name] = c.decompress()
        comp[name] = c
    for name in ("h_vtx", "h_lab", "v_vtx", "v_lab", "n_out", "n_in"):
        if name not in dense:
            raise SnapshotCorrupt(f"snapshot is missing plane {name!r}")

    def on_dev(name):
        return (bitset.np_to_words(dense[name], dev) if name in dense
                else None)

    def rows(name):
        return torch.from_numpy(np.array(r.get(name), dtype=np.int32)).to(
            dev)

    idx = TDRIndex(
        cfg=cfg, graph=graph,
        h_vtx=on_dev("h_vtx"), h_lab=on_dev("h_lab"),
        v_vtx=on_dev("v_vtx"), v_lab=on_dev("v_lab"),
        n_out=on_dev("n_out"), n_in=on_dev("n_in"),
        push=rows("push"), pop=rows("pop"), g_count=rows("g_count"),
        vtx_words=np.array(r.get("vtx_words")),
        lab_slot=np.array(r.get("lab_slot")),
        fixpoint_rounds=int(header.get("fixpoint_rounds", 0)),
        disc=(np.array(r.get("disc")) if "disc" in r.by_name else None),
        base_v=on_dev("base_v"), base_l=on_dev("base_l"),
        base_r=on_dev("base_r"), r_vtx=on_dev("r_vtx"),
        r_lab=on_dev("r_lab"), r_in=on_dev("r_in"),
        d_vtx=on_dev("d_vtx"), d_lab=on_dev("d_lab"))
    # seed the compressed-plane cache with the canonical objects we just
    # validated — only the planes plane_specs() tracks (the maintenance
    # planes are not part of the cached/query-visible set)
    idx._comp = {k: v for k, v in comp.items()
                 if k in idx.plane_specs()}
    return idx, int(header["lsn"])
