// One phase-2 round of the boolean bidirectional subset-state expansion
// on the matmul backend, in one launch (sm_90a):
//
//     y_c[i, q]    = OR_j ( A_c[i, j] AND X[j, q] )      every label class c
//     upd[i, q]    = OR_c T_c,q( y_c[i, q] & allow[c, q] )
//     new[i, q]    = upd[i, q] & cor[i, q] & live[q] & ~X[i, q]
//     X_next       = X | new
//
// for the forward frontier (X = f, A = the reverse class stack) and the
// backward one (X = b, A = the forward stack), then the meet
//
//     done'[q] = done[q] | EXISTS i, s1 in f_next[i, q]:
//                          b_next[i, q] & sup_need[s1, q] != 0
//
// and two flags, whether each direction added a bit.  T_c,q is the subset
// transition of class c for query q: states that hold the class's required
// label stay, the rest move up by sh = 2^i ((y & has) | ((y & ~has) << sh));
// the neutral class has has = ~0, sh = 0.  live[q] is "query q not done";
// a direction whose last round added nothing is copied and reads no A.
//
// Replaces: no TPU kernel.  The JAX package runs the round inside one XLA
// while-loop body (src/repro/core/tdr_query.py::_bidi_loop with
// _bidi_matmul_core's push): a scan of the bitset_matmul Pallas kernel over
// the classes plus XLA's elementwise ops.  Eagerly that was 2 (C+1) launches
// of the product and some 300-400 elementwise launches a round, bound by
// the host; here it is one launch and the host reads the flags and the
// done words once.
//
// Bound on this card: reading the class stacks.  Each is a dense packed
// bit-matrix [C+1, V', Kw] whose words are >99.9% zero; at V' = 32768 and
// 17 classes the two stacks are 4.56 GB a round (1.36 ms at 3.35 TB/s),
// against 8 MiB of frontiers, corridor and outputs.
//
// Design: one warp per (row i, 32-column pass of Q): lane = query column.
// For each active direction and class the warp streams row i of A_c in
// coalesced loads (16 bytes a lane when Kw is a multiple of 4, else 4),
// four in flight; a ballot finds the non-zero words, a shuffle broadcasts
// each, and its set bits pick the frontier rows that the lanes OR in, as
// bitset_matmul.cu does.  The class's transition runs in registers on the
// lane's word; allow/has/sh and sup_need are read through the read-only
// cache (every warp of a pass reads the same 32 words).  A warp whose row
// has no live, unreached corridor bit in a direction skips that
// direction's stream: its new bits are 0 whatever A holds.  The meet runs
// on the new words in registers; ballots give the pass's done bits and the
// two changed flags, which one lane ORs into `state` with an atomic.  Each
// round reads only the last round's buffers and writes fresh ones, so no
// warp sees another's update and rounds are bit-identical to the eager
// composition.  `state` ([2 + passes] words: changed_f, changed_b, then the
// done words) must be zero at launch.  The kernel allocates nothing and
// runs on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

// OR of the frontier rows picked by the set bits of one packed word.
__device__ __forceinline__ uint32_t or_rows(
    uint32_t bits, long long k0, const uint32_t* __restrict__ x, int v_p,
    int q, int col, bool has_col) {
  uint32_t acc = 0u;
  while (bits) {
    const int b = __ffs(bits) - 1;
    bits &= bits - 1;
    const long long j = k0 + b;
    if (has_col && j < v_p) acc |= __ldg(x + j * q + col);
  }
  return acc;
}

// y[i, col] = OR_j A[i, j] & X[j, col] for one row of one class: the row
// streamed once by the whole warp.
template <bool kVec>
__device__ __forceinline__ uint32_t row_product(
    const uint32_t* __restrict__ arow, int kw,
    const uint32_t* __restrict__ x, int v_p, int q, int col, bool has_col,
    int lane) {
  uint32_t acc = 0u;
  if (kVec) {
    const uint4* arow4 = reinterpret_cast<const uint4*>(arow);
    const int kw4 = kw >> 2;
    for (int base = 0; base < kw4; base += 32 * kUnroll) {
      uint4 words[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c4 = base + u * 32 + lane;
        words[u] = c4 < kw4 ? __ldg(arow4 + c4) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint4 w = words[u];
        unsigned live = __ballot_sync(kFull, (w.x | w.y | w.z | w.w) != 0u);
        while (live) {
          const int src = __ffs(live) - 1;
          live &= live - 1;
          const uint32_t w0 = __shfl_sync(kFull, w.x, src);
          const uint32_t w1 = __shfl_sync(kFull, w.y, src);
          const uint32_t w2 = __shfl_sync(kFull, w.z, src);
          const uint32_t w3 = __shfl_sync(kFull, w.w, src);
          const long long k0 = (long long)(base + u * 32 + src) * 128;
          acc |= or_rows(w0, k0, x, v_p, q, col, has_col);
          acc |= or_rows(w1, k0 + 32, x, v_p, q, col, has_col);
          acc |= or_rows(w2, k0 + 64, x, v_p, q, col, has_col);
          acc |= or_rows(w3, k0 + 96, x, v_p, q, col, has_col);
        }
      }
    }
  } else {
    for (int base = 0; base < kw; base += 32 * kUnroll) {
      uint32_t words[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * 32 + lane;
        words[u] = c < kw ? __ldg(arow + c) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        unsigned live = __ballot_sync(kFull, words[u] != 0u);
        while (live) {
          const int src = __ffs(live) - 1;
          live &= live - 1;
          const uint32_t bits = __shfl_sync(kFull, words[u], src);
          const long long k0 = (long long)(base + u * 32 + src) * 32;
          acc |= or_rows(bits, k0, x, v_p, q, col, has_col);
        }
      }
    }
  }
  return acc;
}

// OR over the classes of each class's transition of its product.
template <bool kVec>
__device__ __forceinline__ uint32_t class_push(
    const uint32_t* __restrict__ adj, const uint32_t* __restrict__ x,
    const uint32_t* __restrict__ allow, const uint32_t* __restrict__ has,
    const uint32_t* __restrict__ sh, int row, int v_p, int kw, int q,
    int c1, int col, bool has_col, int lane) {
  uint32_t upd = 0u;
  for (int c = 0; c < c1; ++c) {
    const uint32_t* arow = adj + ((long long)c * v_p + row) * kw;
    const uint32_t y =
        row_product<kVec>(arow, kw, x, v_p, q, col, has_col, lane);
    if (has_col) {
      const long long e = (long long)c * q + col;
      const uint32_t t = y & __ldg(allow + e);
      const uint32_t h = __ldg(has + e);
      upd |= (t & h) | ((t & ~h) << __ldg(sh + e));
    }
  }
  return upd;
}

template <bool kVec>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
class_round_kernel(const uint32_t* __restrict__ adj_rev,
                   const uint32_t* __restrict__ adj_fwd,
                   const uint32_t* __restrict__ f,
                   const uint32_t* __restrict__ b,
                   const uint32_t* __restrict__ allow,
                   const uint32_t* __restrict__ has,
                   const uint32_t* __restrict__ sh,
                   const uint32_t* __restrict__ sup_need,
                   const uint32_t* __restrict__ cor,
                   const uint32_t* __restrict__ done_prev,
                   uint32_t* __restrict__ f_next,
                   uint32_t* __restrict__ b_next,
                   uint32_t* __restrict__ state,
                   int v_p, int kw, int q, int c1, int s, int cf, int cb) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= v_p) return;  // warp-uniform: the ballots below stay full-warp
  const int pass = blockIdx.y;
  const int col = pass * 32 + lane;
  const bool has_col = col < q;
  const long long e = (long long)row * q + col;
  const uint32_t done_w = __ldg(done_prev + pass);
  const bool live = has_col && !((done_w >> lane) & 1u);
  const uint32_t mask = live ? __ldg(cor + e) : 0u;
  uint32_t fv = has_col ? __ldg(f + e) : 0u;
  uint32_t bv = has_col ? __ldg(b + e) : 0u;

  uint32_t new_f = 0u, new_b = 0u;
  if (cf && __any_sync(kFull, (mask & ~fv) != 0u))
    new_f = class_push<kVec>(adj_rev, f, allow, has, sh, row, v_p, kw, q, c1,
                             col, has_col, lane) & mask & ~fv;
  if (cb && __any_sync(kFull, (mask & ~bv) != 0u))
    new_b = class_push<kVec>(adj_fwd, b, allow, has, sh, row, v_p, kw, q, c1,
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
    const uint32_t done_or = hits | (row == 0 ? done_w : 0u);
    if (done_or) atomicOr(state + 2 + pass, done_or);
    if (added_f) atomicOr(state, 1u);
    if (added_b) atomicOr(state + 1, 1u);
  }
}

}  // namespace

extern "C" int tdr_class_round(const void* adj_rev, const void* adj_fwd,
                               const void* f, const void* b,
                               const void* allow, const void* has,
                               const void* sh, const void* sup_need,
                               const void* cor, const void* done_prev,
                               void* f_next, void* b_next, void* state,
                               int v_p, int kw, int q, int c1, int s, int cf,
                               int cb, int vec, void* stream) {
  if (v_p > 0 && q > 0) {
    const dim3 grid((v_p + kWarpsPerBlock - 1) / kWarpsPerBlock,
                    (q + 31) / 32);
    auto kernel = vec ? class_round_kernel<true> : class_round_kernel<false>;
    kernel<<<grid, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)adj_rev, (const uint32_t*)adj_fwd,
        (const uint32_t*)f, (const uint32_t*)b, (const uint32_t*)allow,
        (const uint32_t*)has, (const uint32_t*)sh, (const uint32_t*)sup_need,
        (const uint32_t*)cor, (const uint32_t*)done_prev, (uint32_t*)f_next,
        (uint32_t*)b_next, (uint32_t*)state, v_p, kw, q, c1, s, cf, cb);
  }
  return (int)cudaGetLastError();
}
