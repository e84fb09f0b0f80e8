"""Wrapper of the ``class_round`` CUDA kernel (``csrc/class_round.cu``).

One phase-2 round of the boolean bidirectional subset-state expansion on
the matmul backend: for each active direction, every label class's
product of its class matrix with the last round's frontier, the class's
subset transition, the OR over classes, the corridor and live-column
mask, the new bits and the meet, in one launch.  Replaces no TPU kernel:
the JAX package runs the round as one XLA while-loop body, which an eager
port spent some 300-400 launches on (see the note in the source).  It is
bound by reading the dense class stacks (4.56 GB a round at V' = 32,768
and 17 classes, 1.36 ms at 3.35 TB/s).

``ref.class_round_ref`` computes the same on the CPU.
"""
from __future__ import annotations

import torch

from . import _build
from .. import bitset

MAX_STATES = 32    # subset states a packed word holds


def check_round(adj_rev, adj_fwd, allow, has, sh, sup_need, cor_w, f, b,
                done_w) -> None:
    """Raise unless the operands have one round's shapes: stacks
    ``[C+1, V', Kw]`` with ``Kw * 32 >= V'``, frontiers and corridor
    ``[V', Q]``, class operands ``[C+1, Q]``, ``sup_need`` ``[S, Q]`` with
    ``1 <= S <= 32`` and ``done_w`` ``[ceil(Q / 32)]``."""
    if adj_rev.dim() != 3 or adj_rev.shape != adj_fwd.shape:
        raise ValueError(f"class stacks {tuple(adj_rev.shape)} and "
                         f"{tuple(adj_fwd.shape)} differ or are not 3-D")
    c1, v_p, kw = adj_rev.shape
    q = f.shape[1] if f.dim() == 2 else -1
    want = {"f": (f, (v_p, q)), "b": (b, (v_p, q)),
            "cor_w": (cor_w, (v_p, q)), "allow": (allow, (c1, q)),
            "has": (has, (c1, q)), "sh": (sh, (c1, q)),
            "done_w": (done_w, (bitset.n_words(q),))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape} (class stacks {tuple(adj_rev.shape)})")
    if kw * bitset.WORD < v_p:
        raise ValueError(f"class stacks of {kw} words a row hold fewer than "
                         f"V' = {v_p} columns")
    if sup_need.dim() != 2 or sup_need.shape[1] != q or \
            not 1 <= sup_need.shape[0] <= MAX_STATES:
        raise ValueError(f"sup_need has shape {tuple(sup_need.shape)}; "
                         f"expected [S, {q}] with 1 <= S <= {MAX_STATES}")


def cuda_class_round(adj_rev, adj_fwd, allow, has, sh, sup_need, cor_w, f,
                     b, done_w, cf: bool, cb: bool):
    """Launch one round on CUDA tensors; allocates ``f_next``, ``b_next``
    and the zeroed state words ``[changed_f, changed_b, done words...]``."""
    dev = f.device
    if dev.type != "cuda":
        raise ValueError("cuda_class_round takes CUDA tensors")
    # in the C entry's order
    ins = dict(adj_rev=adj_rev, adj_fwd=adj_fwd, f=f, b=b, allow=allow,
               has=has, sh=sh, sup_need=sup_need, cor_w=cor_w, done_w=done_w)
    for name, t in ins.items():
        _build.check_operand(t, name, torch.int32, dev)
    check_round(adj_rev, adj_fwd, allow, has, sh, sup_need, cor_w, f, b,
                done_w)
    c1, v_p, kw = adj_rev.shape
    q = f.shape[1]
    vec = kw % 4 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (adj_rev, adj_fwd))
    f_next = torch.empty_like(f)
    b_next = torch.empty_like(b)
    state = torch.zeros(2 + bitset.n_words(q), dtype=torch.int32,
                        device=dev)
    _build.launch("class_round", "tdr_class_round", dev,
                  *(t.data_ptr() for t in ins.values()), f_next.data_ptr(),
                  b_next.data_ptr(), state.data_ptr(), v_p, kw, q, c1,
                  sup_need.shape[0], int(cf), int(cb), int(vec))
    return f_next, b_next, state
