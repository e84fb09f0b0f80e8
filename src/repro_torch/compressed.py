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
"""
from __future__ import annotations

import dataclasses

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


def compress_blocks(a_packed: np.ndarray, *, br: int = 8, bw: int = 1,
                    nbits: int | None = None,
                    device="cuda") -> BlockCompressed:
    """Build the block-state operand from a dense packed bit-matrix, on
    ``device`` (the card by default; pass ``device="cpu"`` without one).

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
    blocks = (pad.reshape(mb, br, kb, bw).transpose(0, 2, 1, 3)
              .reshape(mb, kb, br, bw))
    full = np.zeros((mb * br, kb * bw), dtype=np.uint32)
    full[:m, :kw] = _valid_masks(kw, nbits)[None, :]
    full = (full.reshape(mb, br, kb, bw).transpose(0, 2, 1, 3)
            .reshape(mb, kb, br, bw))
    zero = (blocks == 0).all(axis=(2, 3))
    ones = ((blocks == full).all(axis=(2, 3))
            & (full != 0).all(axis=(2, 3)))
    states = np.where(zero, ALL_ZERO,
                      np.where(ones, ALL_ONE, MIXED)).astype(np.uint8)
    bi, bj = np.nonzero(states == MIXED)
    n_mixed = bi.size
    p = max(pad_bucket(max(n_mixed, 1), lo=8), 1)
    pool = np.zeros((p, br, bw), dtype=np.uint32)
    pool[:n_mixed] = blocks[bi, bj]
    slots = np.zeros((mb, kb), dtype=np.int32)
    slots[bi, bj] = np.arange(n_mixed, dtype=np.int32)
    pad_i = np.full(p - n_mixed, mb, dtype=np.int32)   # OOB segment sentinel
    mix_bi = np.concatenate([bi.astype(np.int32), pad_i])
    mix_bj = np.concatenate([bj.astype(np.int32),
                             np.zeros(p - n_mixed, np.int32)])
    states_t = torch.from_numpy(states).to(device)
    mix_bi_t = torch.from_numpy(mix_bi).to(device)
    one_bi, one_bj = torch.nonzero(states_t == ALL_ONE, as_tuple=True)
    return BlockCompressed(
        shape=(m, kw), nbits=nbits, br=br, bw=bw, states=states_t,
        slots=torch.from_numpy(slots).to(device),
        pool=torch.from_numpy(pool.view(np.int32)).to(device),
        mix_bi=mix_bi_t, mix_bj=torch.from_numpy(mix_bj).to(device),
        n_mixed=n_mixed, mix_off=_row_offsets(mix_bi_t[:n_mixed], mb),
        one_off=_row_offsets(one_bi, mb), one_bj=one_bj.to(torch.int32))


def _row_offsets(bi: torch.Tensor, mb: int) -> torch.Tensor:
    """int32 ``[mb + 1]`` offsets of each row-block's run in a list whose
    row-block ids ``bi`` are sorted (``np.nonzero`` order)."""
    off = torch.zeros(mb + 1, dtype=torch.int32, device=bi.device)
    off[1:] = torch.cumsum(torch.bincount(bi.long(), minlength=mb), 0)
    return off
