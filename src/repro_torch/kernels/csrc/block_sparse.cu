// Block-sparse boolean-OR bit-matrix product on Hopper (sm_90a): the same
// out[i, w] = OR_j (A[i, j] AND X[j, w]) as bitset_matmul.cu, with A in the
// two-level block form of repro_torch.compressed.BlockCompressed:
//
//   states uint8 [MB, KB]   ZERO / ONE / MIXED per (br rows x bw words) block
//   slots  int32 [MB, KB]   pool slot of each MIXED block
//   pool   uint32 [P, br, bw]
//   x_any  int32 [KB]       k-block of X has a set bit (this call's frontier)
//   col_or uint32 [KB, W]   OR of X's rows in each k-block
//   X      uint32 [KB*bw*32, W]  ->  out uint32 [MB*br, W]
//
// Replaces: src/repro/kernels/block_sparse.py::block_sparse_matmul (_kernel,
// _block_sparse_call), which walks a (row-block, W tile, k-block) grid with
// the slot ids brought in by scalar prefetch.
//
// Bound on this card: bytes.  The call reads the MB*KB state bytes, the
// pool blocks and X rows that live blocks touch, and writes out; there are
// few word operations per byte.  In a delta closure the frontier (x_any)
// goes dark k-block by k-block, so late rounds read little besides states.
//
// Design: one warp per row-block and W tile (br*tw <= 256 outputs, at most
// 8 per lane, held in registers).  The warp scans the row-block's states
// 32 k-blocks at a time in one coalesced load, drops ZERO blocks and dead
// k-blocks, and loads each live block's slot id itself (Hopper has no
// scalar prefetch).  A ballot walks the live blocks in order: ONE blocks OR
// in col_or[k]; MIXED blocks OR in the X rows picked by the set bits of the
// pool block's row words.  The k loop runs inside the warp, so no sum
// crosses blocks and nothing is carried between launches.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kPerLane = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOne = 1;
constexpr int kMixed = 2;

__global__ void block_sparse_kernel(
    const uint8_t* __restrict__ states, const int32_t* __restrict__ slots,
    const uint32_t* __restrict__ pool, const int32_t* __restrict__ x_any,
    const uint32_t* __restrict__ col_or, const uint32_t* __restrict__ x,
    uint32_t* __restrict__ out, int mb, int kb, int br, int bw, int w,
    int tw) {
  const int lane = threadIdx.x & 31;
  const long long bi =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bi >= mb) return;  // warp-uniform
  const int w0 = blockIdx.y * tw;
  const int tcols = min(tw, w - w0);
  const int n_out = br * tcols;
  const long long bk = (long long)bw * 32;
  uint32_t acc[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) acc[t] = 0u;

  for (int k0 = 0; k0 < kb; k0 += 32) {
    const int k = k0 + lane;
    int st = 0;
    int slot = 0;
    if (k < kb) {
      st = states[bi * kb + k];
      if (st != 0 && x_any[k] == 0) st = 0;
      if (st == kMixed) slot = slots[bi * kb + k];
    }
    unsigned live = __ballot_sync(kFull, st != 0);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const long long kk = k0 + src;
      const int s = __shfl_sync(kFull, st, src);
      const int sl = __shfl_sync(kFull, slot, src);
      if (s == kOne) {
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
          const int o = lane + 32 * t;
          if (o < n_out) acc[t] |= col_or[kk * w + w0 + o % tcols];
        }
      } else {
        const uint32_t* blk = pool + (long long)sl * br * bw;
#pragma unroll
        for (int t = 0; t < kPerLane; ++t) {
          const int o = lane + 32 * t;
          if (o < n_out) {
            const int r = o / tcols;
            const int c = w0 + o % tcols;
            uint32_t a_acc = acc[t];
            for (int wk = 0; wk < bw; ++wk) {
              uint32_t bits = blk[r * bw + wk];
              const long long krow = kk * bk + wk * 32;
              while (bits) {
                const int b = __ffs(bits) - 1;
                bits &= bits - 1;
                a_acc |= x[(krow + b) * w + c];
              }
            }
            acc[t] = a_acc;
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int o = lane + 32 * t;
    if (o < n_out) {
      out[(bi * br + o / tcols) * w + w0 + o % tcols] = acc[t];
    }
  }
}

}  // namespace

// tw must satisfy br * tw <= 32 * kPerLane (the wrapper picks it).
extern "C" int tdr_block_sparse_matmul(const void* states, const void* slots,
                                       const void* pool, const void* x_any,
                                       const void* col_or, const void* x,
                                       void* out, int mb, int kb, int br,
                                       int bw, int w, int tw, void* stream) {
  if (mb > 0 && w > 0) {
    dim3 grid((mb + kWarpsPerBlock - 1) / kWarpsPerBlock,
              (w + tw - 1) / tw);
    block_sparse_kernel<<<grid, 32 * kWarpsPerBlock, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)states, (const int32_t*)slots, (const uint32_t*)pool,
        (const int32_t*)x_any, (const uint32_t*)col_or, (const uint32_t*)x,
        (uint32_t*)out, mb, kb, br, bw, w, tw);
  }
  return (int)cudaGetLastError();
}
