// One phase-2 round of the boolean bidirectional subset-state expansion
// on the matmul backend, in one launch (sm_90a):
//
//     upd[i, q]    = OR over the edges (i, j, l) of row i:
//                      T_l,q( X[j, q] & allow[l, q] )
//     new[i, q]    = upd[i, q] & cor[i, q] & live[q] & ~X[i, q]
//     X_next       = X | new
//
// for the forward frontier (X = f, the edges j->i) and the backward one
// (X = b, the edges i->j), then the meet
//
//     done'[q] = done[q] | EXISTS i, s1 in f_next[i, q]:
//                          b_next[i, q] & sup_need[s1, q] != 0
//
// and, per 32-column pass, whether each direction added a bit.  T_l,q is
// the subset transition of label l for query q: states that hold the
// label's required bit stay, the rest move up by sh = 2^i
// ((y & has) | ((y & ~has) << sh)); a label no query of the chunk names
// has allow = ~0, has = ~0, sh = 0.  The transition and the allow mask
// distribute over OR, so each edge contributes T_l(X[j] & allow[l]) on
// its own: the dense form's per-class product y_c = OR_j A_c[i, j] & X[j]
// needs no sort by label here.  live[q] is "query q not done".
//
// Columns are independent, so several chunks of queries on one graph run
// in one launch side by side, each on whole passes (a lockstep group).
// The round state is per pass: `state_prev` [3, passes] holds the last
// round's forward flags, backward flags and done words.  A pass runs a
// direction when the launch's gate (cf / cb) is on and its flag is set;
// a direction whose last round added nothing in a pass is at its
// fixpoint there, and the pass copies it and reads no list.  The new
// state holds, per pass, whether each direction added a bit (or, with
// the gate off, the flag it was given), then the done words.
//
// Operand: each direction's edges as per-row lists
// (repro_torch.compressed.EdgeLists): row_ptr int32 [V'+1], and the
// column and the raw label of each edge, int32 [E] each; allow, has and
// sh are [L, Q], one row a label.  An edge may repeat (OR is
// idempotent).
//
// Replaces: no TPU kernel.  The JAX package runs the round inside one XLA
// while-loop body (src/repro/core/tdr_query.py::_bidi_loop with
// _bidi_matmul_core's push): a scan of the bitset_matmul Pallas kernel over
// dense class stacks [C+1, V', Kw].  This kernel first read those stacks
// too (4.56 GB a round at V' = 32768 and 17 classes, >99.9% zero words).
//
// Bound on this card: the bytes the round needs: both directions' lists
// (at V' = 32768, ~131,071 edges a direction: 2.4 MB), f, b and the
// corridor in, f_next and b_next out (4 MB each a pass), ~23 MB a pass
// and round, 0.007 ms at 3.35 TB/s.  The frontier rows an edge gathers
// come from L2 (a 4 MB frontier pass fits its 50 MB), so the time is the
// latency of a few dependent reads a warp, hidden by the warps in flight.
//
// Design: one warp per (row i, 32-column pass of Q): lane = query column.
// For each running direction the warp reads up to 32 of the row's entries
// (columns and labels) in two coalesced loads, broadcasts each by
// shuffle, and every lane gathers its word of the edge's frontier row (a
// 128-byte line for the warp), kUnroll gathers in flight; the label's
// allow/has/sh come through the read-only cache (every warp of a pass
// reads the same L x 3 lines, which stay in L1).  A warp whose row has
// no live, unreached corridor bit in a direction skips that direction's
// list: its new bits are 0 whatever the row holds.  The meet runs on the
// new words in registers; ballots give the pass's done bits and its two
// flags, which one lane ORs into `state` with an atomic.  Each round
// reads only the last round's buffers and writes fresh ones, so no warp
// sees another's update and rounds are bit-identical to the eager
// composition.  `state` ([3, passes] words) must be zero at launch.  The
// kernel allocates nothing and runs on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

// OR over row i's edges (j, l) of T_l(X[j, col] & allow[l, col]); lanes
// past Q (has_col false) return 0.
__device__ __forceinline__ uint32_t list_push(
    const int* __restrict__ row_ptr, const int* __restrict__ cols,
    const int* __restrict__ labs, const uint32_t* __restrict__ x,
    const uint32_t* __restrict__ allow, const uint32_t* __restrict__ has,
    const uint32_t* __restrict__ sh, int row, int q, int col, bool has_col,
    int lane) {
  const int beg = __ldg(row_ptr + row);
  const int end = __ldg(row_ptr + row + 1);
  uint32_t upd = 0u;
  for (int base = beg; base < end; base += 32) {
    const int n = min(32, end - base);   // warp-uniform
    const int my_col = lane < n ? __ldg(cols + base + lane) : 0;
    const int my_lab = lane < n ? __ldg(labs + base + lane) : 0;
    for (int k = 0; k < n; k += kUnroll) {
      int j[kUnroll], l[kUnroll];
      uint32_t xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        j[u] = __shfl_sync(kFull, my_col, (k + u) & 31);
        l[u] = __shfl_sync(kFull, my_lab, (k + u) & 31);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        xv[u] = (has_col && k + u < n)
                    ? __ldg(x + (long long)j[u] * q + col)
                    : 0u;
      // a missing edge gathers 0, and T_l(0) = 0 for every label
      if (has_col) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long ce = (long long)l[u] * q + col;
          const uint32_t t = xv[u] & __ldg(allow + ce);
          const uint32_t h = __ldg(has + ce);
          upd |= (t & h) | ((t & ~h) << __ldg(sh + ce));
        }
      }
    }
  }
  return upd;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
class_round_kernel(const int* __restrict__ ptr_rev,
                   const int* __restrict__ col_rev,
                   const int* __restrict__ lab_rev,
                   const int* __restrict__ ptr_fwd,
                   const int* __restrict__ col_fwd,
                   const int* __restrict__ lab_fwd,
                   const uint32_t* __restrict__ f,
                   const uint32_t* __restrict__ b,
                   const uint32_t* __restrict__ allow,
                   const uint32_t* __restrict__ has,
                   const uint32_t* __restrict__ sh,
                   const uint32_t* __restrict__ sup_need,
                   const uint32_t* __restrict__ cor,
                   const uint32_t* __restrict__ state_prev,
                   uint32_t* __restrict__ f_next,
                   uint32_t* __restrict__ b_next,
                   uint32_t* __restrict__ state,
                   int v_p, int q, int s, int cf, int cb) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= v_p) return;  // warp-uniform: the ballots below stay full-warp
  const int pass = blockIdx.y;
  const int n_pass = gridDim.y;
  const int col = pass * 32 + lane;
  const bool has_col = col < q;
  const long long e = (long long)row * q + col;
  const uint32_t flag_f = __ldg(state_prev + pass);
  const uint32_t flag_b = __ldg(state_prev + n_pass + pass);
  const uint32_t done_w = __ldg(state_prev + 2 * n_pass + pass);
  const bool run_f = cf && flag_f;
  const bool run_b = cb && flag_b;
  const bool live = has_col && !((done_w >> lane) & 1u);
  const uint32_t mask = live ? __ldg(cor + e) : 0u;
  uint32_t fv = has_col ? __ldg(f + e) : 0u;
  uint32_t bv = has_col ? __ldg(b + e) : 0u;

  uint32_t new_f = 0u, new_b = 0u;
  if (run_f && __any_sync(kFull, (mask & ~fv) != 0u))
    new_f = list_push(ptr_rev, col_rev, lab_rev, f, allow, has, sh, row, q,
                      col, has_col, lane) & mask & ~fv;
  if (run_b && __any_sync(kFull, (mask & ~bv) != 0u))
    new_b = list_push(ptr_fwd, col_fwd, lab_fwd, b, allow, has, sh, row, q,
                      col, has_col, lane) & mask & ~bv;
  fv |= new_f;
  bv |= new_b;
  if (has_col) {
    f_next[e] = fv;
    b_next[e] = bv;
  }

  // the meet on this row: a forward state s1 and a backward state that
  // completes it to the query's full mask
  bool hit = false;
  if (live && fv && bv) {
    uint32_t states = fv;
    while (states) {
      const int s1 = __ffs(states) - 1;
      states &= states - 1;
      if (s1 < s && (bv & __ldg(sup_need + (long long)s1 * q + col))) {
        hit = true;
        break;
      }
    }
  }
  const unsigned hits = __ballot_sync(kFull, hit);
  const unsigned added_f = __ballot_sync(kFull, new_f != 0u);
  const unsigned added_b = __ballot_sync(kFull, new_b != 0u);
  if (lane == 0) {
    // a gated-off direction keeps the flag it was given (row 0 writes it)
    const bool out_f = cf ? added_f != 0u : (row == 0 && flag_f);
    const bool out_b = cb ? added_b != 0u : (row == 0 && flag_b);
    const uint32_t done_or = hits | (row == 0 ? done_w : 0u);
    if (out_f) atomicOr(state + pass, 1u);
    if (out_b) atomicOr(state + n_pass + pass, 1u);
    if (done_or) atomicOr(state + 2 * n_pass + pass, done_or);
  }
}

}  // namespace

extern "C" int tdr_class_round(const void* ptr_rev, const void* col_rev,
                               const void* lab_rev, const void* ptr_fwd,
                               const void* col_fwd, const void* lab_fwd,
                               const void* f, const void* b,
                               const void* allow, const void* has,
                               const void* sh, const void* sup_need,
                               const void* cor, const void* state_prev,
                               void* f_next, void* b_next, void* state,
                               int v_p, int q, int s, int cf, int cb,
                               void* stream) {
  if (v_p > 0 && q > 0) {
    const dim3 grid((v_p + kWarpsPerBlock - 1) / kWarpsPerBlock,
                    (q + 31) / 32);
    class_round_kernel<<<grid, 32 * kWarpsPerBlock, 0,
                         (cudaStream_t)stream>>>(
        (const int*)ptr_rev, (const int*)col_rev, (const int*)lab_rev,
        (const int*)ptr_fwd, (const int*)col_fwd, (const int*)lab_fwd,
        (const uint32_t*)f, (const uint32_t*)b,
        (const uint32_t*)allow, (const uint32_t*)has, (const uint32_t*)sh,
        (const uint32_t*)sup_need, (const uint32_t*)cor,
        (const uint32_t*)state_prev, (uint32_t*)f_next, (uint32_t*)b_next,
        (uint32_t*)state, v_p, q, s, cf, cb);
  }
  return (int)cudaGetLastError();
}
