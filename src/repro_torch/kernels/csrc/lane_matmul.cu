// Semiring lane product on Hopper (sm_90a):
//
//     out[i, c] = (+)_j ( A[i, j] (x) X[j, c] )
//
// A is a packed bit-matrix (uint32 [M, Kw], bit j of row i); X holds one
// unsigned semiring lane per element (uint8, uint16 or uint32 [Kw*32, W]);
// out has X's lane type [M, W].  (+) is "or", "min" (identity = the lane
// maximum, INF) or "sum" (saturating at cap), see lane_ops.cuh; a clear
// bit of A contributes the identity.
//
// Replaces: src/repro/kernels/bitset_matmul.py::lane_matmul (_lane_kernel),
// the TPU kernel that walks every bit of a VMEM tile of A, branch-free, 32
// unrolled selects per word.
//
// Bound on this card: reading A.  Every caller passes a sparse graph
// operand, so the M*Kw*4 bytes of A (128 MiB at V = 32768) dwarf the X
// rows its set bits select and the output.  At 3.35 TB/s, with A read
// once and X's distinct selected rows once:
//   - dist_batch's product (one label class, 8,276 set bits, X DIST16
//     [32768, 128]): 134.2 MB of A + 8.4 MB out, 0.0431 ms;
//   - Engine.propagate(sr=COUNT) on the full adjacency (131,061 set bits,
//     X uint32 [32768, 128]): + 16.5 MB of X + 16.8 MB out, 0.0500 ms;
//   - a round of Engine.closure(sr=DIST8) over 256 sources (X uint8
//     [32768, 256]): + 8.2 MB of X + 8.4 MB out, 0.0450 ms.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (tools/chip_lane.py,
// two runs in turns with the kernel this one replaced): 0.0509 / 0.0508 ms
// on the first (was 0.0595 / 0.0595), 0.0631 / 0.0630 on the second (was
// 0.0801 / 0.0802) and 0.0549 / 0.0551 on the third (was 0.1041 /
// 0.1042, two passes over A).  This kernel on an all-zero A of the first
// row's shape, the stream of A and the output alone, takes 0.0503 ms
// (2.67 TB/s of A): that stream, not the gathers or the folds, holds the
// rows above their bounds.  PERF.md's kernel table (B4) has every row.
//
// Design.  A persistent grid (SM count x resident blocks) of warps strides
// over the rows of A, one row per warp at a time; nothing carries between
// rows, warps or launches, nothing is allocated, and the launch runs on
// the caller's stream.
//  1. Stream A once, wide.  A warp reads its row in segments of 512
//     words, kUnroll = 4 loads of 16 bytes a lane in flight (512 B a
//     warp-wide load), with the streaming cache hint: no word of A is read
//     twice, and X keeps its place in L2.  Four loads (about 64 registers,
//     32 warps an SM) ran at least as fast as eight, or as a prefetch of
//     the next row (100-134 registers, 8-16 warps an SM), in a one-off
//     comparison of the variants on the card.  A row whose length is not
//     a multiple of four words, or an A that is not 16-byte aligned, takes
//     4-byte loads of the same words.  A form that copied each row with
//     cp.async.bulk into a shared-memory ring (one mbarrier a stage)
//     measured slower on every row and was dropped (PERF.md, B4).
//  2. Compact the set bits.  The OR of the lane's words and one vote skip
//     an all-zero segment (most rows of a label class).  Otherwise each
//     lane counts its set bits, a warp scan gives it its place, and it
//     appends the column j of each bit to the warp's shared list.  The W
//     passes below walk that list, never A again.  A row with more than
//     kList set bits (a dense row) is folded kList bits at a time, and
//     only such a row is compacted again, for its later pieces and tiles.
//  3. Fold wide, with loads in flight.  The row of W lanes is cut into
//     chunks of 16 bytes (packed path: W * sizeof(T) a multiple of 16 and
//     X 16-byte aligned) or of 4 lanes widened to 32 bits (scalar path),
//     one chunk a lane; a tile of at most 32 chunks (512 B) is covered by
//     `group` lanes, so the warp splits into 32/group sub-groups that take
//     list entries kBatch at a time, issuing all their X-row loads before
//     any fold.  Folds run on packed lanes (lane_ops.cuh); a sum's cap
//     over the lane maximum, and uint32 sums, take the widened 64-bit add
//     and clamp.  Shuffles fold the sub-groups' accumulators together and
//     the first sub-group stores the tile.  W wider than one tile loops
//     over tiles, each walking the same list.
// Ragged M, Kw and W are masked here; the caller pads nothing.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_ops.cuh"

namespace {

using namespace tdr_lane;

constexpr int kWarps = 8;                    // warps a block
constexpr int kUnroll = 4;                   // 16-byte loads of A in flight
constexpr int kWords = 4 * kUnroll;          // A words a lane holds
constexpr int kSegWords = 32 * kWords;       // A words a warp reads at once
constexpr int kBatch = 4;                    // list entries in flight
constexpr int kList = 512;                   // set bits a warp's list holds
constexpr int kMaxDevices = 64;              // grid sizes cached per device
constexpr unsigned kFull = 0xffffffffu;

// ---- stream and compact A -----------------------------------------------
// Words base + 4 (32 u + lane) + e (e < 4) of a row of A into wd[4 u + e],
// zero at or past kw.  vec: kw % 4 == 0 and A 16-byte aligned.
__device__ __forceinline__ void load_seg(uint32_t* wd,
                                         const uint32_t* __restrict__ arow,
                                         int base, int kw, int lane,
                                         bool vec) {
  if (vec) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = base + 4 * (32 * u + lane);
      const uint4 v = q < kw ? __ldcs(reinterpret_cast<const uint4*>(arow + q))
                             : make_uint4(0u, 0u, 0u, 0u);
      wd[4 * u] = v.x;
      wd[4 * u + 1] = v.y;
      wd[4 * u + 2] = v.z;
      wd[4 * u + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int q = base + 4 * (32 * (i >> 2) + lane) + (i & 3);
      wd[i] = q < kw ? __ldcs(arow + q) : 0u;
    }
  }
}

__device__ __forceinline__ bool any_bits(const uint32_t* wd) {
  uint32_t any = 0u;
#pragma unroll
  for (int i = 0; i < kWords; ++i) any |= wd[i];
  return __any_sync(kFull, any != 0u);
}

// Appends the set bits of one segment held as load_seg leaves it.  Bit
// number pos of the row (counting n bits before the segment, then lane by
// lane) goes to list[pos - lo] when lo <= pos < lo + kList, as the column
// j it selects.  Returns n plus the segment's set bits.
__device__ __forceinline__ int append_bits(const uint32_t* wd, int base,
                                           int lane, int n, int lo,
                                           int* list) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) c += __popc(wd[i]);
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  int pos = n + incl - c;
  if (c > 0 && pos < lo + kList && pos + c > lo) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      uint32_t bits = wd[i];
      const int j0 = 32 * (base + 4 * (32 * (i >> 2) + lane) + (i & 3));
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        if (pos >= lo && pos < lo + kList) list[pos - lo] = j0 + b;
        ++pos;
      }
    }
  }
  return n + __shfl_sync(kFull, incl, 31);
}

// Streams a row of A from device memory, appending bits lo .. lo+kList-1
// to the list; returns the row's set bits.
__device__ __forceinline__ int compact_row(const uint32_t* __restrict__ arow,
                                           int kw, int lane, bool vec, int lo,
                                           int* list) {
  int n = 0;
  for (int base = 0; base < kw; base += kSegWords) {
    uint32_t wd[kWords];
    load_seg(wd, arow, base, kw, lane, vec);
    if (any_bits(wd)) n = append_bits(wd, base, lane, n, lo, list);
  }
  return n;
}

// ---- fold the listed X rows ---------------------------------------------
// Where a lane sits in the tile: chunk ch of sub-group sub.
struct Place {
  int sub, n_sub, c0, tw;
};

// acc (+)= the tile's chunk of X rows list[0 .. n), the sub-groups taking
// entries kBatch at a time with every load in flight before any fold.
template <typename T, int OP, bool PACKED>
__device__ __forceinline__ void fold_list(uint32_t* acc, const int* list,
                                          int n, const T* __restrict__ x,
                                          int w, int w0, int tcols,
                                          const Place& p, uint32_t capr) {
  const bool cols = p.c0 < tcols;
  for (int i0 = 0; i0 < n; i0 += p.n_sub * kBatch) {
    uint32_t val[kBatch][kChunk];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * p.n_sub + p.sub;
      if (i < n && cols) {
        load_chunk<T, OP, PACKED>(val[u], x + (long long)list[i] * w + w0,
                                  p.c0, tcols);
      } else {
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          val[u][e] = chunk_identity<T, OP, PACKED>();
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      fold_chunk<T, OP, PACKED>(acc, val[u], capr);
  }
}

// Folds the row's tiles and stores them; tot set bits, the first
// min(tot, kList) already listed.
template <typename T, int OP, bool PACKED>
__device__ __forceinline__ void finish_row(
    const uint32_t* __restrict__ arow, const T* __restrict__ x,
    T* __restrict__ orow, int kw, int w, bool vec, int tot, int lane,
    const Place& p, uint32_t capr, int* list) {
  const int group = 32 / p.n_sub;
  for (int w0 = 0; w0 < w; w0 += p.tw) {
    const int tcols = min(p.tw, w - w0);
    uint32_t acc[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e) acc[e] = chunk_identity<T, OP, PACKED>();
    for (int lo = 0; lo < tot; lo += kList) {
      if (lo > 0 || (w0 > 0 && tot > kList)) {   // a dense row only
        __syncwarp();
        compact_row(arow, kw, lane, vec, lo, list);
        __syncwarp();
      }
      fold_list<T, OP, PACKED>(acc, list, min(kList, tot - lo), x, w, w0,
                               tcols, p, capr);
    }
    if (tot > 0) {
      for (int off = group; off < 32; off <<= 1) {
        uint32_t v[kChunk];
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          v[e] = __shfl_xor_sync(kFull, acc[e], off);
        fold_chunk<T, OP, PACKED>(acc, v, capr);
      }
    }
    if (p.sub == 0 && p.c0 < tcols)
      store_chunk<T, PACKED>(orow + w0, p.c0, tcols, acc);
  }
}

// group: lanes covering a tile (a power of two <= 32).
template <typename T, int OP, bool PACKED>
__global__ void __launch_bounds__(kWarps * 32)
    lane_matmul_kernel(const uint32_t* __restrict__ a,
                       const T* __restrict__ x, T* __restrict__ out, int m,
                       int kw, int w, int group, int vec, uint32_t cap) {
  constexpr int kPer = PACKED ? 16 / (int)sizeof(T) : kChunk;  // lanes of T
  __shared__ int s_list[kWarps][kList];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long first = (long long)blockIdx.x * kWarps + warp;
  int* list = s_list[warp];
  Place p;
  p.n_sub = 32 / group;
  p.sub = lane / group;
  p.c0 = (lane & (group - 1)) * kPer;
  p.tw = group * kPer;
  const uint32_t capr = PACKED ? replicate<T>(cap) : cap;
  for (long long row = first; row < m; row += n_warps) {
    const uint32_t* arow = a + row * (long long)kw;
    __syncwarp();                      // the list is rewritten next
    const int tot = compact_row(arow, kw, lane, vec != 0, 0, list);
    __syncwarp();                      // the list is complete
    finish_row<T, OP, PACKED>(arow, x, out + row * (long long)w, kw, w,
                              vec != 0, tot, lane, p, capr, list);
  }
}

struct Args {
  const uint32_t* a;
  const void* x;
  void* out;
  int m, kw, w;
  uint32_t cap;
};

// Resident blocks of one instantiation on device dev (SM count x blocks an
// SM), read from the runtime on its first launch there and kept.
template <typename T, int OP, bool PACKED>
int resident_blocks(int dev, int* blocks) {
  static std::atomic<int> cached[kMaxDevices];
  if (dev < kMaxDevices && (*blocks = cached[dev].load()) > 0) return 0;
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lane_matmul_kernel<T, OP, PACKED>, kWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev].store(*blocks);
  return 0;
}

template <typename T, int OP, bool PACKED>
int launch_kernel(const Args& g, int group, bool vec, cudaStream_t st) {
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int rc = resident_blocks<T, OP, PACKED>(dev, &resident);
  if (rc != 0) return rc;
  const long long need = ((long long)g.m + kWarps - 1) / kWarps;
  const int blocks = (int)(need < resident ? need : resident);
  lane_matmul_kernel<T, OP, PACKED><<<blocks, kWarps * 32, 0, st>>>(
      g.a, (const T*)g.x, (T*)g.out, g.m, g.kw, g.w, group, vec ? 1 : 0,
      g.cap);
  return 0;
}

template <typename T, int OP>
int launch_op(const Args& g, cudaStream_t st) {
  // a packed lane cannot hold a sum whose cap passes the lane maximum
  const unsigned long long lane_top = (1ull << (8 * sizeof(T))) - 1;
  const bool wide_sum = OP == kSum && (unsigned long long)g.cap > lane_top;
  const bool vec = g.kw % 4 == 0 && (uintptr_t)g.a % 16 == 0;
  const bool packed = (long long)g.w * sizeof(T) % 16 == 0 &&
                      (uintptr_t)g.x % 16 == 0 &&
                      (uintptr_t)g.out % 16 == 0 && !wide_sum;
  const int per = packed ? 16 / (int)sizeof(T) : kChunk;
  const int chunks = (g.w + per - 1) / per;
  int group = 1;
  while (group < chunks && group < 32) group <<= 1;
  return packed ? launch_kernel<T, OP, true>(g, group, vec, st)
                : launch_kernel<T, OP, false>(g, group, vec, st);
}

template <typename T>
int launch_type(const Args& g, int op, cudaStream_t st) {
  switch (op) {
    case kOr: return launch_op<T, kOr>(g, st);
    case kMin: return launch_op<T, kMin>(g, st);
    case kSum: return launch_op<T, kSum>(g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// lane_bytes: 1, 2 or 4 (uint8 / uint16 / uint32 lanes); op: 0 or, 1 min,
// 2 sum.  Returns cudaGetLastError() after the launch.
extern "C" int tdr_lane_matmul(const void* a, const void* x, void* out, int m,
                               int kw, int w, int lane_bytes, int op,
                               unsigned cap, void* stream) {
  if (m > 0 && w > 0) {
    const Args g{(const uint32_t*)a, x, out, m, kw, w, cap};
    const cudaStream_t st = (cudaStream_t)stream;
    int rc;
    switch (lane_bytes) {
      case 1: rc = launch_type<uint8_t>(g, op, st); break;
      case 2: rc = launch_type<uint16_t>(g, op, st); break;
      case 4: rc = launch_type<uint32_t>(g, op, st); break;
      default: rc = (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
