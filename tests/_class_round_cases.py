"""Inputs of one phase-2 boolean class round (``ops.class_round``) for the
kernel's tests, on the CPU and on the card: a random labelled graph (four
edges a vertex, 16 labels) as each direction's per-row edge lists with
the transition operands of every label, the dense label-class stacks
packed from the same edges with the operands of every class (the
yardstick, ``dense_round``), for random required and forbidden labels,
and frontiers, corridor and done words drawn at random; and lockstep
groups of such chunks on one graph, side by side in one launch
(``group_case``), each to equal its own launch.  Imports no JAX."""
import numpy as np
import torch

from repro_torch import bitset, compressed, engine, tdr_query
from repro_torch.kernels import ref

N_LABELS = 16

# name -> (V', label classes, Q, subset states, extra words a stack row,
#          forward on, backward on, some columns already done, edges)
# edges: "random" (uniform endpoints), "repeats" (parallel edges under
# other labels and exact repeats, as a padded chunk repeats a real edge)
# or "sparse" (edges out of half the rows and into another half, the
# other rows empty)
CASES = {
    "main-s4": (32768, 17, 32, 4, 0, True, True, False, "random"),
    "main-s16": (32768, 17, 32, 16, 0, True, True, False, "random"),
    "compact-96": (96, 9, 32, 16, 0, True, True, False, "random"),
    "compact-1056-wide": (1056, 17, 32, 4, 3, True, True, False, "random"),
    "ragged-q8": (2048, 9, 8, 4, 0, True, True, False, "random"),
    "ragged-q40": (2048, 9, 40, 16, 0, True, True, False, "random"),
    "neutral-only": (2048, 1, 32, 4, 0, True, True, False, "random"),
    "forward-off": (2048, 9, 32, 4, 0, False, True, False, "random"),
    "backward-off": (2048, 9, 32, 16, 0, True, False, False, "random"),
    "meet-only": (2048, 9, 32, 4, 0, False, False, False, "random"),
    "done-columns": (2048, 9, 40, 4, 0, True, True, True, "random"),
    "states-32": (1024, 9, 32, 32, 0, True, True, False, "random"),
    "repeated-edges": (2048, 9, 32, 16, 0, True, True, False, "repeats"),
    "empty-rows": (2048, 9, 32, 4, 0, True, True, False, "sparse"),
}
# the cases a CPU run takes in seconds
SMALL = tuple(n for n in CASES if CASES[n][0] < 32768)


def case_edges(rng, v: int, kind: str):
    """``(src, dst, lab)`` of ``4 * v`` edges of one case."""
    e = 4 * v
    if kind == "sparse":
        src = rng.integers(0, v // 2, e)
        dst = rng.integers(v // 4, 3 * v // 4, e)
    else:
        src, dst = rng.integers(0, v, e), rng.integers(0, v, e)
    lab = rng.integers(0, N_LABELS, e)
    if kind == "repeats":
        par = rng.integers(0, e, e // 4)       # the same pair, other labels
        rep = rng.integers(0, e, e // 4)       # the same edge again
        src = np.concatenate([src, src[par], src[rep]])
        dst = np.concatenate([dst, dst[par], dst[rep]])
        lab = np.concatenate([lab, rng.integers(0, N_LABELS, e // 4),
                              lab[rep]])
    return src, dst, lab


def round_case(name: str, device, seed: int = 0):
    """``(operands, cf, cb, full_mask, dense)`` of case ``name``:
    ``operands`` are the keyword arguments of ``ops.class_round`` but the
    two direction gates (``lists_rev``/``lists_fwd``: the edges j→i / i→j
    of row i as ``EdgeLists``; ``allow``/``has``/``sh`` ``[L, Q]``; the
    last round's ``state`` ``[3, passes]`` with every pass's flags set),
    ``full_mask`` the queries' target states (int64 numpy [Q]) and
    ``dense`` the same round's dense operands: the class stacks
    ``adj_rev``/``adj_fwd`` ``[C+1, V', Kw]`` of the same edges (one class
    a special label, the last the neutral one) with ``allow``/``has``/
    ``sh`` ``[C+1, Q]``."""
    v, c1, q, n_states, extra, cf, cb, with_done, kind = CASES[name]
    rng = np.random.default_rng([seed, list(CASES).index(name)])
    graph = _graph(rng, v, c1, extra, kind, device)
    done_p = 0.5 if with_done else 0.0
    operands, full_mask, dense = _chunk(rng, graph, q, n_states, done_p,
                                        (1, 1), device)
    return operands, cf, cb, full_mask, dense


def _graph(rng, v: int, c1: int, extra: int, kind: str, device):
    """One case's random graph: ``(lists, stacks, special)``, each
    direction's ``EdgeLists`` and dense class stack (``extra`` words a
    row past ``V'``, with bits that select nothing)."""
    src, dst, lab = case_edges(rng, v, kind)
    special = tuple(range(c1 - 1))       # the rest merge into the neutral
    stacks, lists = [], []
    for rev in (True, False):
        a = engine.pack_label_class_edges_np(src, dst, lab, v, special,
                                             reverse=rev)
        if extra:    # wider rows, with bits past V' that select nothing
            a = np.concatenate(
                [a, np.zeros(a.shape[:2] + (extra,), np.uint32)], axis=2)
            a[:, rng.integers(0, v, 64), -1] |= np.uint32(1 << 7)
        stacks.append(bitset.np_to_words(a, device))
        lists.append(compressed.edge_lists(
            dst if rev else src, src if rev else dst, lab, v, N_LABELS,
            device))
    return lists, stacks, special


def _chunk(rng, graph, q: int, n_states: int, done_p: float, flags,
           device):
    """One chunk's round on ``graph`` (``_graph``): ``q`` queries of
    random required and forbidden labels at ``n_states`` subset states,
    frontiers, corridor and done columns (a share ``done_p``) drawn at
    random, every pass's flags ``flags`` -> ``(operands, full_mask,
    dense)`` as ``round_case`` returns them."""
    lists, stacks, special = graph
    v = lists[0].row_ptr.shape[0] - 1
    c1 = len(special) + 1
    max_m = n_states.bit_length() - 1
    n_req = rng.integers(0, min(max_m, c1 - 1) + 1, q)
    req = np.full((q, max_m), -1, np.int64)
    forb = np.zeros((q, 1), np.uint32)
    for j in range(q):
        req[j, :n_req[j]] = rng.choice(c1 - 1, n_req[j], replace=False)
        if c1 > 1 and rng.random() < 0.3:
            forb[j, 0] |= np.uint32(1 << int(rng.integers(c1 - 1)))
    full_mask = (1 << n_req) - 1
    class_label = torch.tensor(special + (-1,), device=device)
    req_t, forb_t = torch.from_numpy(req).to(device), bitset.np_to_words(
        forb, device)
    allow, has, sh = tdr_query._edge_state_masks(
        torch.arange(N_LABELS, device=device), req_t, forb_t, n_states,
        max_m)
    dense = dict(zip(("allow", "has", "sh"), tdr_query._edge_state_masks(
        class_label, req_t, forb_t, n_states, max_m,
        neutral=class_label < 0)), adj_rev=stacks[0], adj_fwd=stacks[1])
    sup_need = tdr_query._sup_need(
        torch.from_numpy(full_mask.astype(np.int32)).to(device), n_states)

    def frontier():
        dens = rng.uniform(0.0, 0.03, q)
        vals = rng.integers(1, 1 << n_states, (v, q), dtype=np.uint64)
        vals = np.where(rng.random((v, q)) < dens, vals, 0)
        return bitset.np_to_words(vals.astype(np.uint32), device)

    cor = np.where(rng.random((v, q)) < 0.9, 0xFFFFFFFF, 0)
    done = rng.random(q) < done_p
    n_pass = bitset.n_words(q)
    state = np.stack([np.full(n_pass, flags[0]), np.full(n_pass, flags[1]),
                      bitset.pack_bits_np(done).view(np.int32)])
    operands = dict(
        lists_rev=lists[0], lists_fwd=lists[1], allow=allow, has=has, sh=sh,
        sup_need=sup_need, cor_w=bitset.np_to_words(cor.astype(np.uint32),
                                                    device),
        f=frontier(), b=frontier(),
        state=torch.from_numpy(state.astype(np.int32)).to(device))
    return operands, full_mask, dense


# name -> (V', label classes, extra words a stack row, the launch's gates
#          (cf, cb), and per chunk: (Q, subset states, each pass's
#          (forward, backward) flags, done columns: "none", "some" or
#          "all")).  The chunks lie side by side, each from the start of a
#          32-column pass; columns between a chunk and the next pass carry
#          no bits, as in a lockstep group of ``tdr_query``.
GROUPS = {
    "group-3": (2048, 9, 0, (True, True),
                [(32, 4, (1, 1), "none"), (8, 16, (0, 1), "some"),
                 (32, 4, (1, 1), "all")]),
    "group-2-narrow-first": (1056, 17, 3, (True, True),
                             [(8, 4, (1, 1), "all"),
                              (40, 16, (1, 0), "some")]),
    "group-3-meet": (2048, 9, 0, (False, False),
                     [(32, 4, (1, 1), "none"), (8, 4, (0, 1), "some"),
                      (32, 16, (1, 0), "none")]),
    "group-3-main": (32768, 17, 0, (True, True),
                     [(32, 4, (1, 1), "none"), (32, 4, (1, 0), "some"),
                      (32, 4, (1, 1), "all")]),
}
SMALL_GROUPS = tuple(n for n in GROUPS if GROUPS[n][0] < 32768)


def group_case(name: str, device, seed: int = 0):
    """``(operands, cf, cb, chunks)`` of group ``name``: ``operands`` the
    keyword arguments of one ``ops.class_round`` launch for the whole
    group (the chunks' columns side by side, each chunk's ``sup_need``
    padded with zero rows to the widest state count, the columns past a
    chunk's width empty in ``f`` and ``b`` but open in the corridor and
    the transitions), ``cf``/``cb`` its gates, and ``chunks`` one
    ``(operands, cols, passes)`` each: the chunk's own round as
    ``round_case`` gives it, its columns in the group and its passes."""
    v, c1, extra, (cf, cb), specs = GROUPS[name]
    rng = np.random.default_rng([seed, 100 + list(GROUPS).index(name)])
    graph = _graph(rng, v, c1, extra, "random", device)
    chunks = []
    for q, n_states, flags, done in specs:
        done_p = {"none": 0.0, "some": 0.5, "all": 1.0}[done]
        ops_k, _, _ = _chunk(rng, graph, q, n_states, done_p, flags, device)
        chunks.append(ops_k)
    s_max = max(c["sup_need"].shape[0] for c in chunks)
    widths = [c["f"].shape[1] for c in chunks]
    strides = [bitset.n_words(w) * 32 for w in widths[:-1]] + [widths[-1]]
    offs = np.concatenate([[0], np.cumsum(strides)])

    def cat(key, fill, rows=None):
        parts = []
        for c, stride in zip(chunks, strides):
            t = c[key]
            if rows is not None and t.shape[0] < rows:
                t = torch.cat([t, t.new_zeros((rows - t.shape[0],
                                               t.shape[1]))])
            pad = stride - t.shape[1]
            parts.append(torch.cat([t, torch.full(
                (t.shape[0], pad), fill, dtype=t.dtype, device=device)],
                dim=1) if pad else t)
        return torch.cat(parts, dim=1)

    group = dict(lists_rev=chunks[0]["lists_rev"],
                 lists_fwd=chunks[0]["lists_fwd"],
                 allow=cat("allow", -1), has=cat("has", -1),
                 sh=cat("sh", 0), sup_need=cat("sup_need", -1, s_max),
                 cor_w=cat("cor_w", -1), f=cat("f", 0), b=cat("b", 0),
                 state=torch.cat([c["state"] for c in chunks], dim=1))
    out = []
    for k, c in enumerate(chunks):
        cols = np.arange(offs[k], offs[k] + widths[k])
        p0 = offs[k] // 32
        out.append((c, cols, np.arange(p0, p0 + bitset.n_words(widths[k]))))
    return group, cf, cb, out


def round_state(new_f, new_b, done, state, cf: bool, cb: bool):
    """The new state ``[3, passes]`` of a round that added ``new_f`` /
    ``new_b`` and ends with ``done`` (bool [Q]) from the last ``state``
    under gates ``cf``/``cb``: per pass whether each direction added a
    bit (a gated-off direction keeps its flag), then the done words."""
    n_pass = state.shape[1]

    def added(new, gate, flags):
        if not gate:
            return (flags != 0).to(torch.int32)
        cols = torch.zeros(n_pass * 32, dtype=torch.bool)
        cols[:new.shape[1]] = (new != 0).any(dim=0).cpu()
        return cols.reshape(n_pass, 32).any(dim=1).to(torch.int32).to(
            state.device)

    return torch.stack([added(new_f, cf, state[0]), added(new_b, cb,
                                                           state[1]),
                        bitset.pack_bits(done)])


def run_mask(state, q: int, gate: bool):
    """All-ones words on the columns of each pass that runs a direction
    under ``gate`` with flags ``state`` ([passes]), zero elsewhere."""
    run = (state != 0).repeat_interleave(32)[:q] & gate
    return bitset.full_words_where(run)[None, :]


def dense_round(dense, c, cf: bool, cb: bool):
    """The round of ``c`` (``round_case``'s operands) as the dense
    composition on ``dense``'s class stacks: ``ref.class_push_ref`` a
    direction (one ``bitset_matmul_ref`` a class) on the passes that run
    it, the corridor and live-column mask, the new bits and
    ``ref.subset_meet`` -> ``(f_next, b_next, state)`` as
    ``ops.class_round`` returns them."""
    ops = [dense[k] for k in ("allow", "has", "sh")]
    f, b, state = c["f"], c["b"], c["state"]
    q = f.shape[1]
    done = bitset.unpack_bits(state[2], q)
    mask = c["cor_w"] & bitset.full_words_where(~done)[None, :]
    new_f = (ref.class_push_ref(dense["adj_rev"], f, *ops) & mask & ~f
             & run_mask(state[0], q, cf))
    new_b = (ref.class_push_ref(dense["adj_fwd"], b, *ops) & mask & ~b
             & run_mask(state[1], q, cb))
    f, b = f | new_f, b | new_b
    done = done | ref.subset_meet(f, b, c["sup_need"])
    return f, b, round_state(new_f, new_b, done, state, cf, cb)


def stacks_of_lists(lists, special) -> torch.Tensor:
    """The label-class stack ``[C+1, V', ceil(V'/32)]`` holding the edges
    of an ``EdgeLists``: one class a ``special`` label, the last every
    other label."""
    row_ptr, cols, labels = (bitset.words_to_np(t).astype(np.int64)
                             for t in lists[:3])
    v_p = row_ptr.shape[0] - 1
    rows = np.repeat(np.arange(v_p), np.diff(row_ptr))
    cls = np.full(labels.shape, len(special), np.int64)
    for i, l in enumerate(special):
        cls[labels == l] = i
    out = np.zeros((len(special) + 1, v_p, bitset.n_words(v_p)), np.uint32)
    bitset.set_bits_np(out, (cls, rows), cols)
    return bitset.np_to_words(out, lists.row_ptr.device)
