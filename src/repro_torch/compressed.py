"""Two-level compressed bit-plane layout (§IV block decomposition).

``CompressedPlanes`` is the host-side (numpy) row/word summary of one packed
plane: a 2-bit ALL_ZERO / ALL_ONE / MIXED state per row, per-word states
for the MIXED rows, and a pool of the MIXED words.  The index reads its
level-1 row states as the ``sat_out``/``sat_in`` summary flags.

``BlockCompressed`` is the device operand of the block-sparse closure: a
``(row-block × word-block)`` state grid over a packed bit-matrix plus a
compacted pool of the MIXED blocks, with its fields as torch tensors on
the engine's device (packed words as int32).  The layout is the JAX
package's, so states, slots and pool compare equal across the two.  It
also carries the live lists the CUDA kernel walks in place of the state
grid: per row-block offsets into the MIXED list (whose position is the
pool slot) and into a list of the ONE blocks' word-blocks.

``EdgeLists`` is the boolean phase-2 round's operand (the ``class_round``
kernel): one direction's labelled edges as per-row lists of columns and
raw labels.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .bitset import resolve_device
from .graph import pad_bucket

WORD = 32
ALL_ZERO, ALL_ONE, MIXED = 0, 1, 2


def _valid_masks(w: int, nbits: int | None) -> np.ndarray:
    """Per-word valid-bit mask uint32 [w] (tail word may be partial)."""
    nbits = w * WORD if nbits is None else int(nbits)
    bits = np.minimum(np.maximum(nbits - WORD * np.arange(w), 0), WORD)
    return ((np.uint64(1) << bits.astype(np.uint64)) - 1).astype(np.uint32)


def _row_word_states(rows: np.ndarray, masks: np.ndarray):
    """(row_states uint8 [R], word_states uint8 [R, W]) of a dense plane."""
    zero = rows == 0
    ones = (rows == masks[None, :]) & (masks[None, :] != 0)
    wstates = np.where(zero, ALL_ZERO,
                       np.where(ones, ALL_ONE, MIXED)).astype(np.uint8)
    rstates = np.full(rows.shape[0], MIXED, dtype=np.uint8)
    rstates[zero.all(axis=1)] = ALL_ZERO
    rstates[ones.all(axis=1)] = ALL_ONE
    return rstates, wstates


@dataclasses.dataclass(frozen=True)
class CompressedPlanes:
    """Two-level compressed form of one packed plane (host-resident).
    ``decompress()`` is bit-identical to the dense plane it was built from."""
    shape: tuple                 # original plane shape (..., W)
    nbits: int                   # valid bits per row (tail words partial)
    row_states: np.ndarray       # uint8 [R]         (level 1)
    mix_rows: np.ndarray         # int64 [MR]        rows with state MIXED
    word_states: np.ndarray      # uint8 [MR, W]     (level 2, mixed rows)
    pool: np.ndarray             # uint32 [NW]       mixed words, row-major
    pool_off: np.ndarray         # int64 [MR + 1]    prefix into ``pool``

    @property
    def n_rows(self) -> int:
        return int(self.row_states.shape[0])

    @property
    def n_words(self) -> int:
        return int(self.shape[-1])

    @property
    def dense_nbytes(self) -> int:
        return self.n_rows * self.n_words * 4

    @property
    def nbytes(self) -> int:
        """Canonical storage only: 2-bit packed states plus pool words (the
        unpacked state views and prefix offsets are derivable caches)."""
        states = -(-self.n_rows // 4) - (-self.word_states.size // 4)
        return states + self.pool.size * 4

    @property
    def ratio(self) -> float:
        return self.dense_nbytes / max(self.nbytes, 1)

    def decompress(self) -> np.ndarray:
        masks = _valid_masks(self.n_words, self.nbits)
        out = np.zeros((self.n_rows, self.n_words), dtype=np.uint32)
        out[self.row_states == ALL_ONE] = masks[None, :]
        mixed = self.word_states == MIXED
        rows = np.where(self.word_states == ALL_ONE,
                        masks[None, :], np.uint32(0))
        rows[mixed] = self.pool
        out[self.mix_rows] = rows
        return out.reshape(self.shape)

    def same_as(self, other: "CompressedPlanes") -> bool:
        return (self.shape == other.shape and self.nbits == other.nbits
                and np.array_equal(self.row_states, other.row_states)
                and np.array_equal(self.word_states, other.word_states)
                and np.array_equal(self.pool, other.pool))

    def patch_rows(self, rows: np.ndarray,
                   new_rows: np.ndarray) -> "CompressedPlanes":
        """Re-summarize ``rows`` from their new dense words; every other
        row's states and pool segment are carried over untouched, so an
        update's cost is O(|patch| + pool) with no full decompress."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        if rows.size == 0:
            return self
        new_rows = np.asarray(new_rows, dtype=np.uint32)
        new_rows = new_rows.reshape(rows.size, self.n_words)
        masks = _valid_masks(self.n_words, self.nbits)
        r_new, w_new = _row_word_states(new_rows, masks)

        row_states = self.row_states.copy()
        row_states[rows] = r_new

        patched = np.zeros(self.n_rows, dtype=bool)
        patched[rows] = True
        keep = ~patched[self.mix_rows]
        pool_row = np.repeat(self.mix_rows,
                             np.diff(self.pool_off))        # [NW]
        pool_keep = keep[np.searchsorted(self.mix_rows, pool_row)]

        add = r_new == MIXED
        mix_ids = np.concatenate([self.mix_rows[keep], rows[add]])
        order = np.argsort(mix_ids, kind="stable")
        wstack = np.concatenate([self.word_states[keep], w_new[add]])
        pool_ids = np.concatenate(
            [pool_row[pool_keep],
             np.repeat(rows[add], (w_new[add] == MIXED).sum(axis=1))])
        pool_vals = np.concatenate(
            [self.pool[pool_keep], new_rows[add][w_new[add] == MIXED]])
        pool_order = np.argsort(pool_ids, kind="stable")
        wstates = wstack[order]
        counts = (wstates == MIXED).sum(axis=1, dtype=np.int64)
        return CompressedPlanes(
            shape=self.shape, nbits=self.nbits, row_states=row_states,
            mix_rows=mix_ids[order], word_states=wstates,
            pool=pool_vals[pool_order],
            pool_off=np.concatenate([[0], np.cumsum(counts)]))


def compress(plane, *, nbits: int | None = None) -> CompressedPlanes:
    """Compress a packed uint32 plane ``[..., W]`` (any leading dims)."""
    dense = np.asarray(plane, dtype=np.uint32)
    shape = dense.shape
    w = shape[-1] if dense.ndim else 1
    rows = dense.reshape(-1, w)
    nbits = w * WORD if nbits is None else int(nbits)
    masks = _valid_masks(w, nbits)
    rstates, wstates = _row_word_states(rows, masks)
    mix_rows = np.flatnonzero(rstates == MIXED).astype(np.int64)
    wstates = wstates[mix_rows]
    mixed = wstates == MIXED
    counts = mixed.sum(axis=1, dtype=np.int64)
    return CompressedPlanes(
        shape=shape, nbits=nbits, row_states=rstates, mix_rows=mix_rows,
        word_states=wstates, pool=rows[mix_rows][mixed],
        pool_off=np.concatenate([[0], np.cumsum(counts)]))


# ---------------------------------------------------- device block operand
@dataclasses.dataclass(frozen=True)
class BlockCompressed:
    """Block-state form of a packed bit-matrix for the block-sparse
    closure: states over ``(br rows × bw words)`` blocks plus a compacted,
    bucket-padded pool of the MIXED blocks.  Tensor fields live on one
    device; ``pool`` holds int32 views of the packed words."""
    shape: tuple                 # dense packed shape (M, Kw)
    nbits: int                   # valid columns (K bits)
    br: int
    bw: int
    states: torch.Tensor         # uint8 [MB, KB]
    slots: torch.Tensor          # int32 [MB, KB] pool slot (0 if uniform)
    pool: torch.Tensor           # int32 [P, br, bw] compacted MIXED blocks
    mix_bi: torch.Tensor         # int32 [P] row-block of pool slot (MB = pad)
    mix_bj: torch.Tensor         # int32 [P] word-block of pool slot
    n_mixed: int                 # live pool slots (<= P, rest padding)
    mix_off: torch.Tensor        # int32 [MB + 1] row-block offsets into
    #                              the MIXED list (entry = pool slot)
    one_off: torch.Tensor        # int32 [MB + 1] row-block offsets into one_bj
    one_bj: torch.Tensor         # int32 [n_one] word-block of each ONE block,
    #                              row-block-major

    @property
    def grid(self) -> tuple:
        return tuple(self.states.shape)


def _block_view(a: torch.Tensor, br: int, bw: int) -> torch.Tensor:
    """Rows ``[R·br, KB·bw]`` as blocks ``[R, KB, br, bw]``."""
    r, kb = a.shape[0] // br, a.shape[1] // bw
    return a.reshape(r, br, kb, bw).permute(0, 2, 1, 3)


def _block_states(blocks: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """uint8 ZERO/ONE/MIXED state of each block of ``blocks`` against the
    valid-bit masks ``full`` (same shape, zero outside the matrix)."""
    zero = (blocks == 0).all(dim=3).all(dim=2)
    ones = (blocks == full).all(dim=3).all(dim=2) & \
        (full != 0).all(dim=3).all(dim=2)
    return torch.where(zero, ALL_ZERO, torch.where(ones, ALL_ONE, MIXED)
                       ).to(torch.uint8)


def _assemble_blocks(shape: tuple, nbits: int, br: int, bw: int,
                     states: torch.Tensor, vals: torch.Tensor
                     ) -> BlockCompressed:
    """The operand from its block states and the MIXED blocks' words
    ``vals`` int32 ``[n_mixed, br, bw]`` in row-major state order: the
    bucket-padded pool, slots, MIXED list and the kernel's live lists."""
    mb, kb = states.shape
    dev = states.device
    bi, bj = torch.nonzero(states == MIXED, as_tuple=True)
    n_mixed = int(bi.numel())
    p = max(pad_bucket(max(n_mixed, 1), lo=8), 1)
    pool = torch.zeros((p, br, bw), dtype=torch.int32, device=dev)
    pool[:n_mixed] = vals
    slots = torch.zeros((mb, kb), dtype=torch.int32, device=dev)
    slots[bi, bj] = torch.arange(n_mixed, dtype=torch.int32, device=dev)
    pad_i = torch.full((p - n_mixed,), mb, dtype=torch.int32,
                       device=dev)                    # OOB segment sentinel
    mix_bi = torch.cat([bi.to(torch.int32), pad_i])
    mix_bj = torch.cat([bj.to(torch.int32), torch.zeros_like(pad_i)])
    one_bi, one_bj = torch.nonzero(states == ALL_ONE, as_tuple=True)
    return BlockCompressed(
        shape=tuple(shape), nbits=nbits, br=br, bw=bw, states=states,
        slots=slots, pool=pool, mix_bi=mix_bi, mix_bj=mix_bj,
        n_mixed=n_mixed, mix_off=_row_offsets(bi, mb),
        one_off=_row_offsets(one_bi, mb), one_bj=one_bj.to(torch.int32))


def _full_rows(rows: torch.Tensor, m: int, kw: int, kbw: int,
               nbits: int) -> torch.Tensor:
    """int32 ``[len(rows), kbw]`` valid-bit masks of matrix rows ``rows``
    (all zero for rows past ``m`` and columns past ``kw``)."""
    masks = np.zeros(kbw, dtype=np.uint32)
    masks[:kw] = _valid_masks(kw, nbits)
    full = torch.from_numpy(masks.view(np.int32)).to(rows.device)
    return torch.where((rows < m)[:, None], full[None, :], 0).to(torch.int32)


def compress_blocks(a_packed: np.ndarray, *, br: int = 8, bw: int = 1,
                    nbits: int | None = None,
                    device="cuda") -> BlockCompressed:
    """Build the block-state operand from a dense packed bit-matrix, on
    ``device`` (the card by default; pass ``device="cpu"`` without one).
    The blocks are classified on the host, then the operand moves.

    Blocks straddling the row or valid-column tail never classify
    ``ALL_ONE`` (the padding is zero and the tail mask partial), so the
    ONE short-circuit stays exact without per-block tail handling.
    """
    device = resolve_device(device)
    a = np.asarray(a_packed, dtype=np.uint32)
    m, kw = a.shape
    nbits = kw * WORD if nbits is None else int(nbits)
    mb, kb = -(-m // br), -(-kw // bw)
    pad = np.zeros((mb * br, kb * bw), dtype=np.uint32)
    pad[:m, :kw] = a
    blocks = _block_view(torch.from_numpy(pad.view(np.int32)), br, bw)
    full = _full_rows(torch.arange(mb * br), m, kw, kb * bw, nbits)
    states = _block_states(blocks, _block_view(full, br, bw))
    bi, bj = torch.nonzero(states == MIXED, as_tuple=True)
    return _assemble_blocks((m, kw), nbits, br, bw, states.to(device),
                            blocks[bi, bj].to(device))


def patch_blocks(comp: BlockCompressed, rows: np.ndarray,
                 row_words) -> BlockCompressed:
    """A new operand with matrix rows ``rows`` replaced by ``row_words``
    (packed words ``[len(rows), Kw]``, uint32 numpy or an int32 tensor).

    Only the row-block strips the rows touch are re-summarized, on the
    operand's device; untouched strips keep their states and blocks, and
    the pool, slots and live lists are re-compacted exactly as
    ``compress_blocks`` of the patched matrix lays them out.  ``comp`` is
    not written."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    if rows.size == 0:
        return comp
    dev = comp.states.device
    m, kw = comp.shape
    br, bw = comp.br, comp.bw
    mb, kb = comp.grid
    bi_np = np.unique(rows // br)
    bi_aff = torch.from_numpy(bi_np).to(dev)
    n_aff = bi_np.size

    # materialize the affected strips from the old block form
    st_aff = comp.states[bi_aff]                               # [S, KB]
    strip_rows = bi_aff[:, None] * br + torch.arange(br, device=dev)[None, :]
    full = _full_rows(strip_rows.reshape(-1), m, kw, kb * bw, comp.nbits)
    fullb = _block_view(full, br, bw)                          # [S,KB,br,bw]
    blocks = torch.where((st_aff == ALL_ONE)[:, :, None, None], fullb, 0
                         ).to(torch.int32)
    si, sj = torch.nonzero(st_aff == MIXED, as_tuple=True)
    blocks[si, sj] = comp.pool[comp.slots[bi_aff[si], sj].long()]
    # scatter the patch rows into the strips
    strip = blocks.permute(0, 2, 1, 3).reshape(n_aff * br, kb * bw)
    local = np.searchsorted(bi_np, rows // br) * br + rows % br
    words = torch.as_tensor(
        np.asarray(row_words, dtype=np.uint32).view(np.int32)
        if isinstance(row_words, np.ndarray) else row_words).to(dev)
    strip[torch.from_numpy(local).to(dev), :kw] = words.reshape(rows.size, kw)
    blocks = _block_view(strip, br, bw)
    states = comp.states.clone()
    states[bi_aff] = _block_states(blocks, fullb)

    # re-compact: untouched strips keep their pool blocks verbatim
    bi, bj = torch.nonzero(states == MIXED, as_tuple=True)
    pos = torch.full((mb,), -1, dtype=torch.int64, device=dev)
    pos[bi_aff] = torch.arange(n_aff, device=dev)
    touched = pos[bi] >= 0
    vals = torch.empty((bi.numel(), br, bw), dtype=torch.int32, device=dev)
    vals[~touched] = comp.pool[comp.slots[bi[~touched],
                                          bj[~touched]].long()]
    vals[touched] = blocks[pos[bi[touched]], bj[touched]]
    return _assemble_blocks(comp.shape, comp.nbits, br, bw, states, vals)


def decompress_blocks(comp: BlockCompressed) -> np.ndarray:
    """Dense packed bit-matrix uint32 ``[M, Kw]`` back from the block form
    (bit-identical), on the host."""
    m, kw = comp.shape
    mb, kb = comp.grid
    br, bw = comp.br, comp.bw
    states, slots = comp.states.cpu(), comp.slots.cpu()
    full = _block_view(_full_rows(torch.arange(mb * br), m, kw, kb * bw,
                                  comp.nbits), br, bw)
    blocks = torch.where((states == ALL_ONE)[:, :, None, None], full, 0
                         ).to(torch.int32)
    bi, bj = torch.nonzero(states == MIXED, as_tuple=True)
    blocks[bi, bj] = comp.pool.cpu()[slots[bi, bj].long()]
    dense = blocks.permute(0, 2, 1, 3).reshape(mb * br, kb * bw)
    return dense[:m, :kw].contiguous().numpy().view(np.uint32)


def _row_offsets(bi: torch.Tensor, mb: int) -> torch.Tensor:
    """int32 ``[mb + 1]`` offsets of each row-block's run in a list whose
    row-block ids ``bi`` are sorted (``np.nonzero`` order)."""
    off = torch.zeros(mb + 1, dtype=torch.int32, device=bi.device)
    off[1:] = torch.cumsum(torch.bincount(bi.long(), minlength=mb), 0)
    return off


# ------------------------------------------------------------ edge lists
class EdgeLists(NamedTuple):
    """One direction's labelled edges as per-row lists: row ``i``'s edges
    are ``row_ptr[i]:row_ptr[i + 1]`` of ``cols`` and ``labels``, each the
    column ``j`` of one edge of row ``i`` and its raw label, below
    ``n_labels``.  An edge may repeat: OR is idempotent.  Only
    ``edge_lists`` makes them, and it checks every row, column and
    label."""
    row_ptr: torch.Tensor    # int32 [V'+1]
    cols: torch.Tensor       # int32 [E]
    labels: torch.Tensor     # int32 [E]
    n_labels: int

    @property
    def nbytes(self) -> int:
        """Device bytes of the row pointers, columns and labels."""
        return 4 * (int(self.row_ptr.numel()) + 2 * int(self.cols.numel()))


def edge_lists(rows: np.ndarray, cols: np.ndarray, labels: np.ndarray,
               n_rows: int, n_labels: int, device) -> EdgeLists:
    """``EdgeLists`` of the edges ``rows[e] -> cols[e]`` labelled
    ``labels[e]`` (rows and columns below ``n_rows``).  Rows already
    grouped (a CSR's) keep their edge order."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    labels = np.asarray(labels, dtype=np.int64)
    if rows.shape[0] >= 1 << 31:
        raise ValueError(f"{rows.shape[0]} edges overflow int32 offsets")
    for name, a, top in (("row", rows, n_rows), ("column", cols, n_rows),
                         ("label", labels, n_labels)):
        if a.size and not (0 <= a.min() and a.max() < top):
            raise ValueError(f"a {name} lies outside [0, {top})")
    if rows.size and (np.diff(rows) < 0).any():
        order = np.argsort(rows, kind="stable")
        rows, cols, labels = rows[order], cols[order], labels[order]
    row_ptr = np.zeros(n_rows + 1, dtype=np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(rows, minlength=n_rows))
    dev = resolve_device(device)
    return EdgeLists(*(torch.from_numpy(a.astype(np.int32)).to(dev)
                       for a in (row_ptr, cols, labels)), int(n_labels))
