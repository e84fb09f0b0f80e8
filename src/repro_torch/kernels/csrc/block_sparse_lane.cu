// Block-sparse semiring lane product on Hopper (sm_90a): the
// out[i, c] = (+)_j (A[i, j] (x) X[j, c]) of lane_matmul.cu with A in the
// block form of repro_torch.compressed.BlockCompressed, walked through its
// live lists as block_sparse.cu walks them (the state grid is not read),
// and X in unsigned lanes of type T:
//
//   mix_off int32 [MB+1]   row-block offsets into the MIXED list; an entry's
//                          position is its pool slot
//   mix_bj  int32 [P]      k-block of each MIXED entry
//   pool    uint32 [P, br, bw]
//   one_off int32 [MB+1]   row-block offsets into one_bj
//   one_bj  int32 [n_one]  k-block of each ONE block
//   X       T [V, W]       (V <= KB*bw*32; rows past V read as the identity)
//   ->  out T [M, W]
//
// ZERO blocks add the identity (they are on no list); ONE blocks fold the
// k-block's column-(+) of X into every row of their row-block; MIXED blocks
// fold the X rows picked by the set bits of their pool block.  (+) is or,
// min or sum saturating at cap (lane_ops.cuh).
//
// Replaces: src/repro/kernels/block_sparse.py::block_sparse_lane_matmul
// (_lane_kernel, _block_sparse_lane_call), a (row-block, W tile, k-block)
// grid with slot ids brought in by scalar prefetch, which takes its col_r
// and x_any summaries from plain jnp outside the kernel.
//
// Bound on this card: bytes.  The call must read X once, the live lists
// and the MIXED pool blocks, and write out.  On a sparse graph a row-block
// holds a few dozen MIXED blocks of about one edge each, so the work is a
// chain of dependent gathers (list offsets -> k-block id and pool word ->
// X row -> fold), not a product: there is no tensor-core form, and X, the
// pool and the lists of the main-path operand (about 21 MB) stay in L2.
//
// Design: one launch per call on the caller's stream, two when the operand
// has ONE blocks.
//  1. col_reduce_kernel (only with ONE blocks): one thread per (k-block,
//     column) folds the k-block's X rows below V into col_r [KB, W].
//  2. block_sparse_lane_kernel: one warp per (row-block, W tile), four to a
//     block.  The tile's columns are cut into chunks of 16 bytes (packed
//     path: W * sizeof(T) a multiple of 16 and X 16-byte aligned) or of 4
//     lanes widened to 32 bits (scalar path), one chunk a lane, so the warp
//     splits into 32/group sub-groups of `group` lanes that each cover the
//     whole tile: a gathered X row is one coalesced read of 16 bytes a lane
//     (256 B at W = 128 uint16, two rows per warp-wide load).  The warp
//     takes the row-block's MIXED entries 32 at a time, one lane an entry,
//     and the block rows 8 at a time, their words 8 at a time.  Each lane
//     loads 8 words of its entry at once (16-byte loads where aligned); one
//     ballot per word appends the non-zero words, tagged with their X row
//     base and block row, to a shared list (position: popc of the ballot
//     below the lane), with no serial walk.  The sub-groups then share the
//     list out, kBatch words each with all their X loads in flight, and
//     fold each gathered row into their own shared tile of the group's rows
//     (read, fold, write: a sub-group's lanes own disjoint chunks, so no
//     atomics).  Folds run on packed lanes (__vminu2 / __vminu4 for min,
//     __vaddus2 / __vaddus4 then a min with cap for sum, a 64-bit add and
//     clamp for uint32 sum, | for or); the scalar path folds widened
//     lanes.  These folds and the chunk loads and stores (fold_packed,
//     fold_chunk, load_chunk, store_chunk) live in lane_ops.cuh, shared
//     with lane_matmul.cu.  At the end of a group the tiles of all
//     sub-groups fold into the output rows.  ONE entries, split over the
//     sub-groups, set the value the tiles start from.  Rows at or past V
//     are never gathered, so the caller pads nothing; nothing carries
//     between warps or launches.
//
// Why a shared list: on the card, walking the set bits with warp-uniform
// shuffles, one at a time, costs more than the gathers themselves; the
// list lets every lane place its words at once and spreads them evenly
// over the sub-groups.
//
// Departures from the TPU kernel: no x_any skip.  A dead k-block's X rows
// are the identity, so gathering them never changes a result; the skip
// would only save gathers that hit L2, at the price of a summary pass over
// X on every call and one more load on every entry's chain.
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_ops.cuh"

namespace {

using namespace tdr_lane;

constexpr int kWarps = 4;        // row-blocks per block of the product
constexpr int kBatch = 4;        // list words a sub-group has in flight
constexpr int kGroupWords = 8;   // pool words of an entry taken at once
constexpr int kGroupRows = 8;    // block rows a warp folds at once
constexpr int kListCap = 32 * kGroupWords;
constexpr int kColThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int OP>
__global__ void __launch_bounds__(kColThreads) col_reduce_kernel(
    const T* __restrict__ x, T* __restrict__ col_r, int v, int bk, int w,
    uint32_t cap) {
  const int c = blockIdx.y * kColThreads + threadIdx.x;
  if (c >= w) return;
  const long long r0 = (long long)blockIdx.x * bk;
  const long long r1 = min(r0 + bk, (long long)v);
  uint32_t acc = identity<T, OP>();
  for (long long r = r0; r < r1; ++r)
    acc = fold<OP>(acc, __ldg(x + r * w + c), cap);
  col_r[(long long)blockIdx.x * w + c] = static_cast<T>(acc);
}

// Words q0 .. q0+7 of an entry's block (zero at or past qb, which may lie
// inside the block), with 16-byte loads when the block size and q0 are
// multiples of four words (the pool is 16-byte aligned).
__device__ __forceinline__ void load8(const uint32_t* __restrict__ blk,
                                      int q0, int qb, bool vec,
                                      uint32_t* p) {
  if (vec) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(blk + q0));
    const uint4 b = q0 + 4 < qb
                        ? __ldg(reinterpret_cast<const uint4*>(blk + q0) + 1)
                        : make_uint4(0u, 0u, 0u, 0u);
    p[0] = a.x;
    p[1] = a.y;
    p[2] = a.z;
    p[3] = a.w;
    p[4] = b.x;
    p[5] = b.y;
    p[6] = b.z;
    p[7] = b.w;
#pragma unroll
    for (int e = 0; e < kGroupWords; ++e)
      if (q0 + e >= qb) p[e] = 0u;
  } else {
#pragma unroll
    for (int e = 0; e < kGroupWords; ++e)
      p[e] = q0 + e < qb ? __ldg(blk + q0 + e) : 0u;
  }
}

// tw columns a tile; group lanes cover a tile (a power of two <= 32,
// group chunks >= tw).  Shared memory: a list of kListCap words and
// kGroupRows tile rows of group chunks for each of the 32/group
// sub-groups, per warp.
template <typename T, int OP, bool PACKED>
__global__ void __launch_bounds__(kWarps * 32) block_sparse_lane_kernel(
    const int32_t* __restrict__ mix_off, const int32_t* __restrict__ mix_bj,
    const uint32_t* __restrict__ pool, const int32_t* __restrict__ one_off,
    const int32_t* __restrict__ one_bj, const T* __restrict__ col_r,
    const T* __restrict__ x, T* __restrict__ out, int m, int v, int mb,
    int br, int bw, int w, int tw, int group, uint32_t cap) {
  constexpr int kPer = PACKED ? 16 / (int)sizeof(T) : kChunk;  // lanes of T
  __shared__ uint2 s_list[kWarps][kListCap];
  __shared__ uint4 s_tile[kWarps][kGroupRows * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bi = blockIdx.x * kWarps + warp;
  if (bi >= mb) return;                 // warp-uniform; only __syncwarp below
  uint2* list = s_list[warp];
  const int w0 = blockIdx.y * tw;
  const int tcols = min(tw, w - w0);
  const int nch = (tcols + kPer - 1) / kPer;
  const int sub = lane / group;
  const int n_sub = 32 / group;
  const int ch = lane & (group - 1);
  const int c0 = ch * kPer;
  const bool cols = c0 < tcols;
  uint4* tile = s_tile[warp];           // [n_sub][kGroupRows][group]
  uint4* mine = tile + sub * kGroupRows * group + ch;
  const uint32_t capr = PACKED ? replicate<T>(cap) : cap;
  const uint32_t ident = chunk_identity<T, OP, PACKED>();
  const unsigned below = (1u << lane) - 1u;

  // all four list offsets in flight at once
  const int s0 = __ldg(mix_off + bi);
  const int s1 = __ldg(mix_off + bi + 1);
  const int o0 = __ldg(one_off + bi);
  const int o1 = __ldg(one_off + bi + 1);

  // ONE entries, split over the sub-groups: the value the tiles start from
  uint32_t start[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e) start[e] = ident;
  for (int e = o0 + sub; e < o1; e += n_sub) {
    if (cols) {
      uint32_t val[kChunk];
      load_chunk<T, OP, PACKED>(
          val, col_r + (long long)__ldg(one_bj + e) * w + w0, c0, tcols);
      fold_chunk<T, OP, PACKED>(start, val, capr);
    }
  }

  const int bk = bw * 32;
  const int bsz = br * bw;
  for (int r0 = 0; r0 < br; r0 += kGroupRows) {
    const int qa = r0 * bw;
    const int qb = min(br, r0 + kGroupRows) * bw;
#pragma unroll
    for (int r = 0; r < kGroupRows; ++r)
      mine[r * group] = make_uint4(start[0], start[1], start[2], start[3]);
    for (int c = s0; c < s1; c += 32) {
      const int s = c + lane;
      const bool has = s < s1;
      const int kbase = has ? __ldg(mix_bj + s) * bk : 0;
      const uint32_t* blk = pool + (long long)s * bsz;
      // word q0 + e is word wk of block row rl of the group; the X row of
      // its bit 0 is kbase + wk * 32, a multiple of 32 whose low bits carry
      // rl in the list
      int wk = 0;
      int rl = 0;
      for (int q0 = qa; q0 < qb; q0 += kGroupWords) {
        uint32_t p[kGroupWords];
        if (has) {
          load8(blk, q0, qb, ((bsz | q0) & 3) == 0, p);
        } else {
#pragma unroll
          for (int e = 0; e < kGroupWords; ++e) p[e] = 0u;
        }
        int n = 0;
#pragma unroll
        for (int e = 0; e < kGroupWords; ++e) {
          const unsigned live = __ballot_sync(kFull, p[e] != 0u);
          if (p[e] != 0u)
            list[n + __popc(live & below)] =
                make_uint2(p[e], (uint32_t)(kbase + wk * 32) | rl);
          n += __popc(live);
          if (++wk == bw) {
            wk = 0;
            ++rl;
          }
        }
        __syncwarp();
        for (int i0 = 0; i0 < n; i0 += n_sub * kBatch) {
          uint32_t wd[kBatch], base[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * n_sub + sub;
            const uint2 it = i < n ? list[i] : make_uint2(0u, 0u);
            wd[u] = it.x;
            base[u] = it.y;
          }
          bool more = true;
          while (more) {                // per sub-group
            more = false;
            int rr[kBatch];
            uint32_t val[kBatch][kChunk];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              rr[u] = -1;
              if (wd[u] != 0u) {
                const int row = (int)(base[u] & ~31u) + __ffs(wd[u]) - 1;
                wd[u] &= wd[u] - 1;
                more |= wd[u] != 0u;
                if (row < v && cols) {
                  rr[u] = (int)(base[u] & 31u);
                  load_chunk<T, OP, PACKED>(val[u], x + (long long)row * w + w0,
                                            c0, tcols);
                }
              }
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              if (rr[u] >= 0) {
                uint4 a = mine[rr[u] * group];
                uint32_t acc[kChunk] = {a.x, a.y, a.z, a.w};
                fold_chunk<T, OP, PACKED>(acc, val[u], capr);
                mine[rr[u] * group] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
              }
            }
          }
        }
        __syncwarp();                   // the list is rewritten next
      }
    }
    // fold the sub-groups' tiles into the group's output rows
    __syncwarp();
    const int rows = min(kGroupRows, br - r0);
    for (int i = lane; i < rows * nch; i += 32) {
      const int r = i / nch;
      const int k = i - r * nch;
      const long long orow = (long long)bi * br + r0 + r;
      const uint4 a = tile[r * group + k];
      uint32_t acc[kChunk] = {a.x, a.y, a.z, a.w};
      for (int g = 1; g < n_sub; ++g) {
        const uint4 b = tile[(g * kGroupRows + r) * group + k];
        const uint32_t val[kChunk] = {b.x, b.y, b.z, b.w};
        fold_chunk<T, OP, PACKED>(acc, val, capr);
      }
      if (orow < m)
        store_chunk<T, PACKED>(out + orow * w + w0, k * kPer, tcols, acc);
    }
    __syncwarp();                       // the tiles are rewritten next
  }
}

struct Args {
  const int32_t* mix_off;
  const int32_t* mix_bj;
  const uint32_t* pool;
  const int32_t* one_off;
  const int32_t* one_bj;
  const void* x;
  void* col_r;
  void* out;
  int m, v, mb, kb, n_one, br, bw, w, tw, group, packed;
  uint32_t cap;
};

template <typename T, int OP>
int launch_op(const Args& a, cudaStream_t st) {
  if (a.n_one > 0 && a.kb > 0) {
    col_reduce_kernel<T, OP>
        <<<dim3(a.kb, (a.w + kColThreads - 1) / kColThreads), kColThreads, 0,
           st>>>((const T*)a.x, (T*)a.col_r, a.v, a.bw * 32, a.w, a.cap);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.mb + kWarps - 1) / kWarps, (a.w + a.tw - 1) / a.tw);
#define TDR_LAUNCH(PK)                                                        \
  block_sparse_lane_kernel<T, OP, PK><<<grid, kWarps * 32, 0, st>>>(          \
      a.mix_off, a.mix_bj, a.pool, a.one_off, a.one_bj, (const T*)a.col_r,    \
      (const T*)a.x, (T*)a.out, a.m, a.v, a.mb, a.br, a.bw, a.w, a.tw,        \
      a.group, a.cap)
  if (a.packed) {
    TDR_LAUNCH(true);
  } else {
    TDR_LAUNCH(false);
  }
#undef TDR_LAUNCH
  return 0;
}

template <typename T>
int launch_type(const Args& a, int op, cudaStream_t st) {
  switch (op) {
    case kOr: return launch_op<T, kOr>(a, st);
    case kMin: return launch_op<T, kMin>(a, st);
    case kSum: return launch_op<T, kSum>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// col_r T [kb, w] is scratch the wrapper allocates; it is computed only
// when the operand has ONE blocks (n_one > 0).  packed is 1 only when
// w * lane_bytes % 16 == 0, x is 16-byte aligned and (for sum) cap fits a
// lane; tw is a multiple of the lanes a chunk holds (16 / lane_bytes
// packed, 4 scalar), at most 32 chunks; group is the least power of two
// with group chunks >= tw.  lane_bytes 1, 2 or 4; op 0 or, 1 min, 2 sum.
extern "C" int tdr_block_sparse_lane_matmul(
    const void* mix_off, const void* mix_bj, const void* pool,
    const void* one_off, const void* one_bj, const void* x, void* col_r,
    void* out, int m, int v, int mb, int kb, int n_one, int br, int bw, int w,
    int tw, int group, int packed, int lane_bytes, int op, unsigned cap,
    void* stream) {
  if (mb > 0 && w > 0) {
    const Args a{(const int32_t*)mix_off, (const int32_t*)mix_bj,
                 (const uint32_t*)pool,   (const int32_t*)one_off,
                 (const int32_t*)one_bj,  x, col_r, out, m, v, mb, kb, n_one,
                 br, bw, w, tw, group, packed, cap};
    const cudaStream_t st = (cudaStream_t)stream;
    int rc;
    switch (lane_bytes) {
      case 1: rc = launch_type<uint8_t>(a, op, st); break;
      case 2: rc = launch_type<uint16_t>(a, op, st); break;
      case 4: rc = launch_type<uint32_t>(a, op, st); break;
      default: rc = (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
