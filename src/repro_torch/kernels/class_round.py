"""Wrapper of the ``class_round`` CUDA kernel (``csrc/class_round.cu``).

One phase-2 round of the boolean bidirectional subset expansion on the
matmul backend: for each active direction, every edge's subset
transition of the last round's frontier row it reads, OR-ed into its
row, the corridor and live-column mask, the new bits and the meet, in
one launch.  Each direction's edges come as per-row lists of columns and
raw labels (``compressed.EdgeLists``), the transition operands as one
row a label.  Several chunks of queries on one graph may share a launch,
side by side on the column axis, each on whole 32-column passes; the
round state (each direction's "added a bit" flag and the done words) is
kept per pass, and the next launch reads it on the device.  Replaces no
TPU kernel: the JAX package
runs the round as one XLA while-loop body over dense class stacks (see
the note in the source).  It is bound by the lists, frontiers, corridor
and outputs (~23 MB a pass and round at V' = 32,768).

``ref.class_round_ref`` computes the same on the CPU.
"""
from __future__ import annotations

import torch

from . import _build
from .. import bitset

MAX_STATES = 32    # subset states a packed word holds


def state_words(q: int) -> tuple[int, int]:
    """Shape ``[3, passes]`` of the round state of ``q`` columns: the
    forward flags, the backward flags and the done words of each
    32-column pass."""
    return 3, bitset.n_words(q)


def check_round(lists_rev, lists_fwd, allow, has, sh, sup_need, cor_w, f,
                b, state) -> None:
    """Raise unless the operands have one round's shapes: frontiers and
    corridor ``[V', Q]``; each direction's ``EdgeLists`` with ``V' + 1``
    row pointers and columns and labels of one length; label operands
    ``[L, Q]`` for the lists' ``L`` labels; ``sup_need`` ``[S, Q]`` with
    ``1 <= S <= 32``; ``state`` ``[3, ceil(Q / 32)]``.  The columns and
    labels are checked where ``compressed.edge_lists`` makes them."""
    if f.dim() != 2:
        raise ValueError(f"f has shape {tuple(f.shape)}; expected [V', Q]")
    v_p, q = f.shape
    n_l = lists_rev.n_labels
    want = {"b": (b, (v_p, q)), "cor_w": (cor_w, (v_p, q)),
            "allow": (allow, (n_l, q)), "has": (has, (n_l, q)),
            "sh": (sh, (n_l, q)), "state": (state, state_words(q))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape} (frontier {tuple(f.shape)})")
    for name, lists in (("lists_rev", lists_rev), ("lists_fwd", lists_fwd)):
        if tuple(lists.row_ptr.shape) != (v_p + 1,) or \
                lists.cols.dim() != 1 or lists.labels.shape != \
                lists.cols.shape:
            raise ValueError(
                f"{name} has row pointers {tuple(lists.row_ptr.shape)}, "
                f"columns {tuple(lists.cols.shape)} and labels "
                f"{tuple(lists.labels.shape)}; expected [{v_p + 1}], [E] "
                "and [E]")
        if lists.n_labels != n_l:
            raise ValueError(f"{name} has {lists.n_labels} labels, "
                             f"lists_rev {n_l}")
    if sup_need.dim() != 2 or sup_need.shape[1] != q or \
            not 1 <= sup_need.shape[0] <= MAX_STATES:
        raise ValueError(f"sup_need has shape {tuple(sup_need.shape)}; "
                         f"expected [S, {q}] with 1 <= S <= {MAX_STATES}")


def cuda_class_round(lists_rev, lists_fwd, allow, has, sh, sup_need, cor_w,
                     f, b, state, cf: bool, cb: bool):
    """Launch one round on CUDA tensors from the last round's ``state``;
    allocates ``f_next``, ``b_next`` and the zeroed new state ``[3,
    passes]``."""
    dev = f.device
    if dev.type != "cuda":
        raise ValueError("cuda_class_round takes CUDA tensors")
    check_round(lists_rev, lists_fwd, allow, has, sh, sup_need, cor_w, f, b,
                state)
    # in the C entry's order
    ins = dict(ptr_rev=lists_rev.row_ptr, col_rev=lists_rev.cols,
               lab_rev=lists_rev.labels, ptr_fwd=lists_fwd.row_ptr,
               col_fwd=lists_fwd.cols, lab_fwd=lists_fwd.labels, f=f, b=b,
               allow=allow, has=has, sh=sh, sup_need=sup_need, cor_w=cor_w,
               state=state)
    for name, t in ins.items():
        _build.check_operand(t, name, torch.int32, dev)
    v_p, q = f.shape
    f_next = torch.empty_like(f)
    b_next = torch.empty_like(b)
    out = torch.zeros(state_words(q), dtype=torch.int32, device=dev)
    _build.launch("class_round", "tdr_class_round", dev,
                  *(t.data_ptr() for t in ins.values()), f_next.data_ptr(),
                  b_next.data_ptr(), out.data_ptr(), v_p, q,
                  sup_need.shape[0], int(cf), int(cb))
    return f_next, b_next, out
