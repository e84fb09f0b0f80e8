"""Logical bytes of the kernels' operations, and their roofline shares.

A product ``Y = A (x) X`` over a bit-matrix ``A`` is counted by what the
operation needs, whatever layout a kernel reads:

- each set bit of ``A`` once, as a 4-byte column index, plus one 4-byte
  row pointer per row of ``A`` (a CSR of ``A``);
- ``X`` once, and the output once.

The dense words of ``A`` are not counted, so a kernel that moves to a
sparse operand keeps its share at or under 100%.  The bound is the bytes
over the card's memory bandwidth; the share is the bound per call over the
device time per launch, both averaged over the traced stretch (the
profiler may drop events, so counts are taken per side).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet (80 GB HBM3)
INDEX_BYTES = 4                 # one column index or row pointer
# kernel -> (its device function, further device functions one call runs)
DEVICE_NAMES = {"bitset_matmul": ("bitset_matmul_kernel", ()),
                "lane_matmul": ("lane_matmul_kernel", ()),
                "block_sparse_matmul": ("block_sparse_kernel",
                                        ("col_or_kernel",))}
WORD_BITS = 32


def logical_bytes(nnz: int, rows: int, x_bytes: int, out_bytes: int) -> int:
    """Bytes a call needs: ``A`` as a CSR of ``nnz`` set bits over ``rows``
    rows, ``X`` and the output once each."""
    return INDEX_BYTES * (nnz + rows) + x_bytes + out_bytes


def popcount(words) -> int:
    """Set bits of an integer tensor of 32-bit words (any device)."""
    import torch
    flat = words.reshape(-1)
    total = 0
    step = 1 << 24
    for i in range(0, flat.numel(), step):
        x = flat[i:i + step].to(torch.int64) & 0xFFFFFFFF
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        total += int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())
    return total


def operand_bits(a) -> int:
    """Set bits of a product's ``A``: a packed int32 bit-matrix, or a
    block-compressed one (its MIXED blocks' words plus every bit of its
    ONE blocks)."""
    if hasattr(a, "pool"):
        mixed = popcount(a.pool[:a.n_mixed])
        return mixed + int(a.one_bj.numel()) * a.br * a.bw * WORD_BITS
    return popcount(a)


def call_bytes(calls) -> int:
    """Logical bytes of every recorded call of one kernel."""
    total = calls.x_bytes + calls.out_bytes
    for a, n, rows in calls.operands.values():
        total += n * INDEX_BYTES * (operand_bits(a) + rows)
    return total


def roofline(run, kernel: str):
    """Share (%) of the bandwidth bound that ``kernel`` reached in the
    traced stretch; ``None`` when it ran no call there."""
    t = run.trace
    if t is None or kernel not in t.calls or not t.calls[kernel].calls:
        return None
    primary, extra = DEVICE_NAMES[kernel]
    n_launch = dev_s = 0
    for name, (n, sec) in t.kernel_events.items():
        if primary in name:
            n_launch += n
            dev_s += sec
        elif any(e in name for e in extra):
            dev_s += sec
    if not n_launch or dev_s <= 0:
        return None
    calls = t.calls[kernel]
    bound_per_call = call_bytes(calls) / HBM_BYTES_PER_S / calls.calls
    return 100.0 * bound_per_call / (dev_s / n_launch)
