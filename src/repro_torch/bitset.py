"""Packed-bitset utilities on torch tensors.

Packed words travel as ``torch.int32``: the same 32 bits as the numpy
``uint32`` words of the host precompute (``np_to_words`` is a zero-copy
view), because torch lacks ``>>``, ``~``, ``<`` and reductions on
``uint32``.  Two consequences run through the whole package: every right
shift is arithmetic, so a bit is read as ``(w >> s) & 1``; and bit 31 is
the sign bit, so a word is tested with ``!= 0``, never ``> 0``.
"""
from __future__ import annotations

import numpy as np
import torch

WORD = 32


def n_words(nbits: int) -> int:
    return (nbits + WORD - 1) // WORD


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def np_to_words(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor on ``device`` (same bits)."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


def words_to_np(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy words (same bits)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a boolean tensor ``[..., nbits]`` into int32 words ``[..., W]``."""
    nbits = bits.shape[-1]
    w = n_words(nbits)
    pad = w * WORD - nbits
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))],
                         dim=-1)
    b = bits.reshape(bits.shape[:-1] + (w, WORD)).to(torch.int64)
    weights = torch.ones(WORD, dtype=torch.int64, device=bits.device) << \
        torch.arange(WORD, dtype=torch.int64, device=bits.device)
    return _wrap32((b * weights).sum(dim=-1))


def unpack_bits(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """Unpack int32 words ``[..., W]`` into boolean ``[..., nbits]``."""
    w = words.shape[-1]
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    bits = bits.reshape(words.shape[:-1] + (w * WORD,))
    return bits[..., :nbits] != 0


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    nbits = bits.shape[-1]
    w = n_words(nbits)
    pad = w * WORD - nbits
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), dtype=bits.dtype)], axis=-1
        )
    b = bits.reshape(bits.shape[:-1] + (w, WORD)).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(WORD, dtype=np.uint32))
    return (b * weights).sum(axis=-1, dtype=np.uint32)


def set_bits_np(words: np.ndarray, idx: tuple, positions: np.ndarray) -> None:
    """``words[idx + (positions >> 5,)] |= 1 << (positions & 31)`` in place.

    The one packed-word bit-scatter used to build hash rows, label planes,
    and adjacency bit-matrices; ``idx`` is the tuple of leading index
    arrays (may be empty for a flat word row)."""
    pos = positions.astype(np.int64)
    np.bitwise_or.at(words, tuple(idx) + (pos >> 5,),
                     (np.int64(1) << (pos & 31)).astype(np.uint32))


def segment_or_words(values: torch.Tensor, segment_ids: torch.Tensor, *,
                     num_segments: int, chunk_words: int = 2) -> torch.Tensor:
    """OR-reduce packed int32 rows ``[E, W]`` by segment -> ``[S, W]``.

    Bitwise OR is no scatter reduction torch offers, so the reduction
    unpacks ``chunk_words`` words at a time into a ``uint8`` bit plane,
    takes ``scatter_reduce("amax")`` over it, and repacks.  Segment ids
    outside ``[0, num_segments)`` are dropped, as in the reference."""
    e, w = values.shape
    dev = values.device
    out = torch.zeros((num_segments, w), dtype=torch.int32, device=dev)
    if e == 0 or w == 0:
        return out
    seg = segment_ids.to(device=dev, dtype=torch.int64)
    # out-of-range ids land in one extra row that is dropped (no host sync)
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    for c0 in range(0, w, chunk_words):
        chunk = values[:, c0:c0 + chunk_words]
        cw = chunk.shape[1]
        bits = unpack_bits(chunk, cw * WORD).to(torch.uint8)
        red = torch.zeros((num_segments + 1, cw * WORD), dtype=torch.uint8,
                          device=dev)
        red.scatter_reduce_(0, seg[:, None].expand(-1, cw * WORD), bits,
                            "amax")
        out[:, c0:c0 + cw] = pack_bits(red[:num_segments] != 0)
    return out


def or_reduce(words: torch.Tensor, axis: int) -> torch.Tensor:
    """Bitwise-OR reduction of packed words along ``axis`` (pairwise tree)."""
    x = words.movedim(axis, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=words.dtype,
                           device=words.device)
    while x.shape[0] > 1:
        n = x.shape[0]
        half = n // 2
        top = x[:half] | x[half:2 * half]
        x = torch.cat([top, x[2 * half:]]) if n % 2 else top
    return x[0]


def full_words_where(cond: torch.Tensor) -> torch.Tensor:
    """Broadcast a boolean mask to all-ones/all-zeros int32 words."""
    return torch.where(cond, -1, 0).to(torch.int32)


def words_contain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``b ⊆ a`` elementwise over trailing word axis -> bool [...]."""
    return ((a & b) == b).all(dim=-1)


def words_intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a ∩ b ≠ ∅`` over trailing word axis -> bool [...]."""
    return ((a & b) != 0).any(dim=-1)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Population count over the trailing word axis -> int32 (SWAR on the
    words widened to their unsigned int64 values)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum(dim=-1, dtype=torch.int32)
