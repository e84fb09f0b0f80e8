"""Plain PyTorch versions of the seven hand kernels.

Each function computes what its CUDA kernel computes, on either device,
with packed words as int32 and semiring lanes in their stored width (see
``repro_torch.semiring``).  They are the kernels' CPU path and their
equality target on the card; nothing on the main path calls them when
the tensors live on a card.  The boolean contractions unpack bits and
threshold a float32 matmul, exact because every count stays below 2^24.
The lane contractions gather on A's set bits instead of materialising
``[M, K, W]``: each set bit ``(i, j)`` folds row ``j`` of X into row ``i``
of the output (``scatter_reduce("amin")``, an int64 ``index_add_`` then
the clamp, or an OR over the lanes' bit planes).
"""
from __future__ import annotations

import torch

from .. import bitset
from ..compressed import ALL_ONE, BlockCompressed
from ..semiring import lane_bits, lane_max, narrow, widen

WORD = 32
# float32 elements of one unpacked operand slab (bounds transient memory)
_SLAB = 1 << 26
# gathered lane elements per fold step (bounds transient memory)
_LANE_CHUNK = 1 << 22
LANE_OPS = ("or", "min", "sum")


def bitset_matmul_ref(a_packed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OR_j (A[i,j] & X[j,:]) — unpack + matmul + threshold + repack.

    ``a_packed`` int32 [M, K/32], ``x`` int32 [K, W] -> int32 [M, W]."""
    m, kw = a_packed.shape
    k, w = x.shape
    if kw * WORD != k:
        raise ValueError(f"shape mismatch: A {tuple(a_packed.shape)}, "
                         f"X {tuple(x.shape)}")
    x_bits = bitset.unpack_bits(x, w * WORD).to(torch.float32)   # [K, W*32]
    out = torch.empty((m, w), dtype=torch.int32, device=x.device)
    step = max(1, _SLAB // max(k, 1))
    for r0 in range(0, m, step):
        a_bits = bitset.unpack_bits(a_packed[r0:r0 + step], k)
        prod = a_bits.to(torch.float32) @ x_bits
        out[r0:r0 + step] = bitset.pack_bits(prod > 0)
    return out


def way_filter_ref(h_vtx, h_lab, v_vtx, v_lab, vbits, req, forb, null_plane):
    """Per-(job, way) viability predicate -> bool [J, G] (tdr_query phase 1).

    A way survives when it holds the target's bits and the required labels,
    and no vertical level is blocked (no real, non-forbidden label) before
    a level that already reached the target."""
    has_tgt = bitset.words_contain(h_vtx, vbits[:, None, :])
    has_req = bitset.words_contain(h_lab, req[:, None, :])
    real = v_lab & ~forb[:, None, None, :] & ~null_plane[None, None, None, :]
    blocked = (real == 0).all(dim=-1)                            # [J, G, k]
    reached = bitset.words_contain(v_vtx, vbits[:, None, None, :])
    reached_upto = torch.cumsum(reached.to(torch.int32), dim=-1) > 0
    not_before = torch.cat(
        [torch.ones_like(reached_upto[..., :1]), ~reached_upto[..., :-1]],
        dim=-1)
    refuted = (blocked & not_before).any(dim=-1)
    return has_tgt & has_req & ~refuted


def way_filter_at_ref(u, v, req, forb, null_plane, vtx_packed, h_vtx, h_lab,
                      v_vtx, v_lab):
    """``way_filter_ref`` on the index rows of the job endpoints: gather
    ``u``'s plane rows and ``v``'s target bits, then filter."""
    return way_filter_ref(h_vtx[u], h_lab[u], v_vtx[u], v_lab[u],
                          vtx_packed[v], req, forb, null_plane)


def unpacked_bf16(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """Packed rows as a bf16 0/1 matrix ``[N, nbits]``: the operand of the
    library yardstick a kernel is timed against (one bf16 ``torch.matmul``
    of the unpacked bits) and of ``ops.frontier_step_mxu``."""
    return bitset.unpack_bits(words, nbits).to(torch.bfloat16)


def pad_k(x: torch.Tensor, k_pad: int) -> torch.Tensor:
    """Zero-pad the row axis of ``x`` up to ``k_pad`` rows."""
    if x.shape[0] < k_pad:
        x = torch.cat([x, x.new_zeros((k_pad - x.shape[0],) + x.shape[1:])])
    return x


def k_block_summaries(x: torch.Tensor, kb: int, bk: int):
    """Per-k-block column-OR int32 [KB, W] and any-bit flags int32 [KB]."""
    xr = pad_k(x, kb * bk).reshape(kb, bk, x.shape[1])
    colr = bitset.or_reduce(xr, axis=1)
    xany = (xr != 0).any(dim=2).any(dim=1).to(torch.int32)
    return colr, xany


def block_sparse_matmul_ref(comp: BlockCompressed,
                            x: torch.Tensor) -> torch.Tensor:
    """B1's contraction over a ``BlockCompressed`` A: ONE blocks resolve
    through the k-block column-OR, MIXED blocks are contracted from the
    pool and OR-scattered into their row-blocks.  ``x`` int32 [V, W] with
    ``V <= K`` (zero-padded) -> int32 [M, W]."""
    m, _ = comp.shape
    mb, kb = comp.grid
    br, bw = comp.br, comp.bw
    bk = bw * WORD
    w = x.shape[1]
    xr = pad_k(x, kb * bk).reshape(kb, bk, w)
    colr, xany = k_block_summaries(x, kb, bk)

    one = (comp.states == ALL_ONE) & (xany != 0)[None, :]
    one_bi, one_bj = torch.nonzero(one, as_tuple=True)
    one_or = bitset.segment_or_words(colr[one_bj], one_bi, num_segments=mb)

    mix_or = torch.zeros((mb, br * w), dtype=torch.int32, device=x.device)
    p = comp.pool.shape[0]
    step = max(1, _SLAB // (bk * w * WORD))
    for p0 in range(0, p, step):
        a_bits = bitset.unpack_bits(comp.pool[p0:p0 + step], bk)  # [p,br,bk]
        x_blk = xr[comp.mix_bj[p0:p0 + step].long()]              # [p,bk,W]
        x_bits = bitset.unpack_bits(x_blk, w * WORD)
        prod = torch.bmm(a_bits.to(torch.float32), x_bits.to(torch.float32))
        contrib = bitset.pack_bits(prod > 0)                      # [p,br,W]
        mix_or |= bitset.segment_or_words(
            contrib.reshape(-1, br * w), comp.mix_bi[p0:p0 + step],
            num_segments=mb)
    out = mix_or.reshape(mb, br, w) | one_or[:, None, :]
    return out.reshape(mb * br, w)[:m]


def popcount_rows_ref(words: torch.Tensor) -> torch.Tensor:
    """Popcount over the trailing axis of int32 words [N, W] -> int32 [N]."""
    return bitset.popcount(words)


# ------------------------------------------------------------- lane forms
def lane_identity(op: str, bits: int) -> int:
    """(+)-identity of a lane combine: the lane maximum (INF) for min."""
    if op not in LANE_OPS:
        raise ValueError(f"unknown lane op {op!r}; expected one of "
                         f"{LANE_OPS}")
    return lane_max(bits) if op == "min" else 0


def set_bits(a_packed: torch.Tensor):
    """(row, column) int64 of every set bit of a packed bit-matrix
    ``[M, Kw]``, found from its non-zero words."""
    wi, wj = torch.nonzero(a_packed, as_tuple=True)
    shifts = torch.arange(WORD, dtype=torch.int32, device=a_packed.device)
    hit = ((a_packed[wi, wj][:, None] >> shifts) & 1) != 0    # [nw, 32]
    n, b = torch.nonzero(hit, as_tuple=True)
    return wi[n], wj[n] * WORD + b


def _lane_fold(out: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
               op: str, bits: int) -> None:
    """``out[rows[e]] (+)= vals[e]`` over int64 lane values, in place
    (sums are clamped by the caller, once, at the end)."""
    if rows.numel() == 0:
        return
    if op == "sum":
        out.index_add_(0, rows, vals)
        return
    idx = rows[:, None].expand_as(vals)
    if op == "min":
        out.scatter_reduce_(0, idx, vals, "amin")
        return
    for b in range(bits):   # OR: one amax per bit plane
        plane = torch.zeros_like(out).scatter_reduce_(
            0, idx, (vals >> b) & 1, "amax")
        out |= plane << b


def _fold_gathered(out, rows, cols, xv, op, bits) -> None:
    """Fold ``xv[cols[e]]`` into ``out[rows[e]]`` in bounded chunks."""
    step = max(1, _LANE_CHUNK // max(xv.shape[1], 1))
    for s0 in range(0, rows.numel(), step):
        _lane_fold(out, rows[s0:s0 + step], xv[cols[s0:s0 + step]], op,
                   bits)


def lane_matmul_ref(a_packed: torch.Tensor, x: torch.Tensor, *, op: str,
                    cap: int = 0) -> torch.Tensor:
    """``(+)_j (A[i,j] (x) X[j,:])`` over semiring lanes.

    ``a_packed`` int32 [M, K/32]; ``x`` stored lanes [K, W] (uint8 /
    int16 / int32 for 8 / 16 / 32-bit lanes) -> [M, W] in ``x``'s dtype.
    ``op``: "or", "min" (identity = the lane maximum, INF) or "sum"
    (saturating at ``cap``)."""
    m, kw = a_packed.shape
    k, w = x.shape
    if kw * WORD != k:
        raise ValueError(f"shape mismatch: A {tuple(a_packed.shape)}, "
                         f"X {tuple(x.shape)}")
    bits = lane_bits(x)
    out = torch.full((m, w), lane_identity(op, bits), dtype=torch.int64,
                     device=x.device)
    rows, cols = set_bits(a_packed)
    _fold_gathered(out, rows, cols, widen(x).to(torch.int64), op, bits)
    if op == "sum":
        out = out.clamp(max=cap)
    return narrow(out, bits)


def pad_k_lanes(x: torch.Tensor, k_pad: int, op: str) -> torch.Tensor:
    """Pad the row axis of stored lanes up to ``k_pad`` rows with the
    (+)-identity, so pad rows cannot perturb any op (an ALL_ONE k-block's
    column summary reduces over them)."""
    if x.shape[0] < k_pad:
        ident = lane_identity(op, lane_bits(x))
        pad = narrow(torch.full((k_pad - x.shape[0],) + x.shape[1:], ident,
                                dtype=torch.int64, device=x.device),
                     lane_bits(x))
        x = torch.cat([x, pad])
    return x


def k_block_lane_summaries(x: torch.Tensor, kb: int, bk: int, op: str,
                           cap: int):
    """Per-k-block column-(+) of stored lanes ``[KB, W]`` (x's dtype) and
    liveness flags int32 ``[KB]`` (some lane is not the identity)."""
    bits = lane_bits(x)
    ident = lane_identity(op, bits)
    xr = widen(pad_k_lanes(x, kb * bk, op)).reshape(kb, bk, x.shape[1])
    if op == "or":
        colr = bitset.or_reduce(xr, axis=1)
    elif op == "min":
        colr = xr.amin(dim=1)
    else:
        colr = xr.sum(dim=1, dtype=torch.int64).clamp(max=cap)
    xany = (xr != ident).any(dim=2).any(dim=1).to(torch.int32)
    return narrow(colr, bits), xany


def block_sparse_lane_matmul_ref(comp: BlockCompressed, x: torch.Tensor, *,
                                 op: str, cap: int = 0) -> torch.Tensor:
    """``lane_matmul_ref`` with A in ``BlockCompressed`` form: ONE blocks
    fold the k-block column-(+) into every row of their row-block, MIXED
    blocks fold the X rows their pool bits select.  ``x`` stored lanes
    ``[V, W]`` with ``V <= K`` (padded with the identity) -> ``[M, W]``."""
    m, _ = comp.shape
    mb, kb = comp.grid
    br, bw = comp.br, comp.bw
    bk = bw * WORD
    w = x.shape[1]
    bits = lane_bits(x)
    dev = x.device
    xv = widen(pad_k_lanes(x, kb * bk, op)).to(torch.int64)
    colr, xany = k_block_lane_summaries(x, kb, bk, op, cap)
    out = torch.full((mb * br, w), lane_identity(op, bits),
                     dtype=torch.int64, device=dev)

    one = (comp.states == ALL_ONE) & (xany != 0)[None, :]
    one_bi, one_bj = torch.nonzero(one, as_tuple=True)
    rows = (one_bi[:, None] * br
            + torch.arange(br, device=dev)[None, :]).reshape(-1)
    _fold_gathered(out, rows, one_bj.repeat_interleave(br),
                   widen(colr).to(torch.int64), op, bits)

    p_rows, p_cols = set_bits(comp.pool.reshape(-1, bw))     # [P*br, bw]
    slot = p_rows // br
    rows = comp.mix_bi.long()[slot] * br + p_rows % br
    cols = comp.mix_bj.long()[slot] * bk + p_cols
    _fold_gathered(out, rows, cols, xv, op, bits)
    if op == "sum":
        out = out.clamp(max=cap)
    return narrow(out, bits)[:m]


# ------------------------------------------------- phase-2 boolean rounds
def subset_transition(val, has, sh):
    """Apply subset transition ``s -> s | m`` to packed state bitfields:
    ``has`` masks the states that already hold the edge's required label
    (they stay), the rest shift up by ``sh = 2^i``.  ``has = ~0, sh = 0``
    is the identity."""
    return (val & has) | ((val & ~has) << sh)


def subset_meet(f, b, sup_need):
    """done[q] = ∃ vertex x, states s1 ∈ f[x,q], s2 ∈ b[x,q] with
    ``s1 | s2 == full_mask[q]`` (the bidirectional termination test);
    ``sup_need[s1, q]`` masks the backward states completing ``s1``."""
    done = torch.zeros(f.shape[1], dtype=torch.bool, device=f.device)
    for s1 in range(sup_need.shape[0]):
        hit = (((f >> s1) & 1) != 0) & ((b & sup_need[s1][None, :]) != 0)
        done |= hit.any(dim=0)
    return done


def class_push_ref(adj, x, allow, has, sh):
    """OR over label classes ``c`` of ``T_c((A_c ⊗ X) & allow[c])``: one
    ``bitset_matmul_ref`` per class of ``adj`` [C+1, V', Kw] on ``x``
    [V', Q] (its rows zero-padded to ``Kw * 32``), each class's subset
    transition, OR-ed -> [V', Q]."""
    v_p = x.shape[0]
    k = adj.shape[2] * WORD
    if k > v_p:
        x_k = torch.cat([x, x.new_zeros((k - v_p, x.shape[1]))])
    else:
        x_k = x
    upd = torch.zeros_like(x)
    for c in range(adj.shape[0]):
        y = bitset_matmul_ref(adj[c], x_k)
        upd = upd | subset_transition(y & allow[c][None, :], has[c][None, :],
                                      sh[c][None, :])
    return upd


def edge_push_ref(lists, x, allow, has, sh):
    """``class_push_ref`` on per-row edge lists (``compressed.EdgeLists``)
    with the transition operands ``[L, Q]`` of every label: gather each
    edge's frontier row ``x[j]``, apply its label's transition to
    ``x[j] & allow[l]``, and OR the edge rows into their row with a
    packed segment-OR -> [V', Q]."""
    row_ptr, cols, labels, _ = lists
    rows = torch.repeat_interleave(
        torch.arange(row_ptr.shape[0] - 1, device=row_ptr.device),
        (row_ptr[1:] - row_ptr[:-1]).long())
    lab = labels.long()
    val = subset_transition(x[cols.long()] & allow[lab], has[lab], sh[lab])
    return bitset.segment_or_words(val, rows, num_segments=x.shape[0])


def class_round_ref(lists_rev, lists_fwd, allow, has, sh, sup_need, cor_w,
                    f, b, state, cf: bool, cb: bool):
    """One phase-2 boolean round on the matmul backend (the ``class_round``
    kernel): each running direction's ``edge_push_ref`` (the forward
    frontier over the lists of edges into each row, the backward over
    those out of it), masked to the corridor and the unfinished columns,
    adds its new bits; then ``subset_meet``.  ``state`` int32 ``[3,
    ceil(Q/32)]`` is the last round's, per 32-column pass: forward flag,
    backward flag (0/1), done word.  A pass runs a direction when the gate
    ``cf`` / ``cb`` is on and its flag is set.  Returns ``(f_next, b_next,
    state)``, the new state per pass: whether each direction added a bit
    (with its gate off, the flag it was given), then the done words."""
    q = f.shape[1]
    n_pass = state.shape[1]
    done = bitset.unpack_bits(state[2], q)
    mask = cor_w & bitset.full_words_where(~done)[None, :]

    def push(lists, x, gate, flags):
        # a pass's flag on each of its columns
        run = (flags != 0).repeat_interleave(WORD)[:q] & gate
        if not bool(run.any()):
            return torch.zeros_like(x)
        new = edge_push_ref(lists, x, allow, has, sh) & mask & ~x
        return new & bitset.full_words_where(run)[None, :]

    def added(new, gate, flags):
        if not gate:
            return (flags != 0).to(torch.int32)
        cols = torch.zeros(n_pass * WORD, dtype=torch.bool, device=f.device)
        cols[:q] = (new != 0).any(dim=0)
        return cols.reshape(n_pass, WORD).any(dim=1).to(torch.int32)

    new_f = push(lists_rev, f, cf, state[0])
    new_b = push(lists_fwd, b, cb, state[1])
    f, b = f | new_f, b | new_b
    done = done | subset_meet(f, b, sup_need)
    return f, b, torch.stack([added(new_f, cf, state[0]),
                              added(new_b, cb, state[1]),
                              bitset.pack_bits(done)])
