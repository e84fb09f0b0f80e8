"""Inputs of one phase-2 boolean class round (``ops.class_round``) for the
kernel's tests, on the CPU and on the card: label-class stacks packed from
a random labelled graph (four edges a vertex, 16 labels), the transition
operands of random required and forbidden labels, and frontiers, corridor
and done words drawn at random.  Imports no JAX."""
import numpy as np
import torch

from repro_torch import bitset, engine, tdr_query

N_LABELS = 16

# name -> (V', label classes, Q, subset states, extra words a stack row,
#          forward on, backward on, some columns already done)
CASES = {
    "main-s4": (32768, 17, 32, 4, 0, True, True, False),
    "main-s16": (32768, 17, 32, 16, 0, True, True, False),
    "compact-96": (96, 9, 32, 16, 0, True, True, False),
    "compact-1056-wide": (1056, 17, 32, 4, 3, True, True, False),
    "ragged-q8": (2048, 9, 8, 4, 0, True, True, False),
    "ragged-q40": (2048, 9, 40, 16, 0, True, True, False),
    "neutral-only": (2048, 1, 32, 4, 0, True, True, False),
    "forward-off": (2048, 9, 32, 4, 0, False, True, False),
    "backward-off": (2048, 9, 32, 16, 0, True, False, False),
    "meet-only": (2048, 9, 32, 4, 0, False, False, False),
    "done-columns": (2048, 9, 40, 4, 0, True, True, True),
    "states-32": (1024, 9, 32, 32, 0, True, True, False),
}
# the cases a CPU run takes in seconds
SMALL = tuple(n for n in CASES if CASES[n][0] < 32768)


def round_case(name: str, device, seed: int = 0):
    """``(operands, cf, cb, full_mask)`` of case ``name``: ``operands`` are
    the keyword arguments of ``ops.class_round`` but the two direction
    flags, ``full_mask`` the queries' target states (int64 numpy [Q])."""
    v, c1, q, n_states, extra, cf, cb, with_done = CASES[name]
    rng = np.random.default_rng([seed, list(CASES).index(name)])
    max_m = n_states.bit_length() - 1
    e = 4 * v
    src, dst = rng.integers(0, v, e), rng.integers(0, v, e)
    lab = rng.integers(0, N_LABELS, e)
    special = tuple(range(c1 - 1))       # the rest merge into the neutral
    stacks = []
    for rev in (True, False):
        a = engine.pack_label_class_edges_np(src, dst, lab, v, special,
                                             reverse=rev)
        if extra:    # wider rows, with bits past V' that select nothing
            a = np.concatenate(
                [a, np.zeros(a.shape[:2] + (extra,), np.uint32)], axis=2)
            a[:, rng.integers(0, v, 64), -1] |= np.uint32(1 << 7)
        stacks.append(bitset.np_to_words(a, device))

    n_req = rng.integers(0, min(max_m, c1 - 1) + 1, q)
    req = np.full((q, max_m), -1, np.int64)
    forb = np.zeros((q, 1), np.uint32)
    for j in range(q):
        req[j, :n_req[j]] = rng.choice(c1 - 1, n_req[j], replace=False)
        if c1 > 1 and rng.random() < 0.3:
            forb[j, 0] |= np.uint32(1 << int(rng.integers(c1 - 1)))
    full_mask = (1 << n_req) - 1
    class_label = torch.tensor(special + (-1,), device=device)
    allow, has, sh = tdr_query._edge_state_masks(
        class_label, torch.from_numpy(req).to(device),
        bitset.np_to_words(forb, device), n_states, max_m,
        neutral=class_label < 0)
    sup_need = tdr_query._sup_need(
        torch.from_numpy(full_mask.astype(np.int32)).to(device), n_states)

    def frontier():
        dens = rng.uniform(0.0, 0.03, q)
        vals = rng.integers(1, 1 << n_states, (v, q), dtype=np.uint64)
        vals = np.where(rng.random((v, q)) < dens, vals, 0)
        return bitset.np_to_words(vals.astype(np.uint32), device)

    cor = np.where(rng.random((v, q)) < 0.9, 0xFFFFFFFF, 0)
    done = rng.random(q) < (0.5 if with_done else 0.0)
    operands = dict(
        adj_rev=stacks[0], adj_fwd=stacks[1], allow=allow, has=has, sh=sh,
        sup_need=sup_need, cor_w=bitset.np_to_words(cor.astype(np.uint32),
                                                    device),
        f=frontier(), b=frontier(),
        done_w=bitset.np_to_words(bitset.pack_bits_np(done), device))
    return operands, cf, cb, full_mask
