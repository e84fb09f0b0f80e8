// Block-sparse semiring lane product on Hopper (sm_90a): the
// out[i, c] = (+)_j (A[i, j] (x) X[j, c]) of lane_matmul.cu with A in the
// block form of repro_torch.compressed.BlockCompressed (see
// block_sparse.cu for the layout) and X in unsigned lanes of type T:
//
//   states uint8 [MB, KB], slots int32 [MB, KB], pool uint32 [P, br, bw]
//   x_any  int32 [KB]      k-block of X holds a non-identity lane
//   col_r  T [KB, W]       (+) of X's rows in each k-block
//   X      T [KB*bw*32, W] (K-padded with the identity)  ->  out T [MB*br, W]
//
// ZERO blocks and dead k-blocks add the identity (skipped); ONE blocks fold
// the k-block's col_r row; MIXED blocks fold the X rows picked by the set
// bits of the pool block.  x_any and col_r are computed outside the kernel
// in plain torch (kernels/ref.py::k_block_lane_summaries), as the TPU
// version computes them outside its kernel.
//
// Replaces: src/repro/kernels/block_sparse.py::block_sparse_lane_matmul
// (_lane_kernel, _block_sparse_lane_call), a (row-block, W tile, k-block)
// grid with slot ids brought in by scalar prefetch.
//
// Bound on this card: bytes: the state grid, the pool blocks and X rows of
// live blocks, and the output, at few operations per byte.
//
// Design: block_sparse.cu's walk with lane_matmul.cu's combine.  One warp
// per row-block and W tile (br*tw <= 256 outputs, at most 8 per lane, in
// 32-bit registers).  The warp loads 32 of its states at a time in one
// coalesced load, drops ZERO blocks and dead k-blocks before any pool read,
// loads each live MIXED block's slot id itself (no scalar prefetch), and a
// ballot walks the live blocks in order.  The k loop stays in the warp, so
// nothing crosses blocks.
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_ops.cuh"

namespace {

using namespace tdr_lane;

constexpr int kWarpsPerBlock = 4;
constexpr int kPerLane = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOne = 1;
constexpr int kMixed = 2;

template <typename T, int OP>
__global__ void block_sparse_lane_kernel(
    const uint8_t* __restrict__ states, const int32_t* __restrict__ slots,
    const uint32_t* __restrict__ pool, const int32_t* __restrict__ x_any,
    const T* __restrict__ col_r, const T* __restrict__ x,
    T* __restrict__ out, int mb, int kb, int br, int bw, int w, int tw,
    uint32_t cap) {
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
  for (int t = 0; t < kPerLane; ++t) acc[t] = identity<T, OP>();

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
          if (o < n_out)
            acc[t] = fold<OP>(acc[t], col_r[kk * w + w0 + o % tcols], cap);
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
                a_acc = fold<OP>(a_acc, x[(krow + b) * w + c], cap);
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
      out[(bi * br + o / tcols) * w + w0 + o % tcols] =
          static_cast<T>(acc[t]);
    }
  }
}

template <typename T>
int launch_op(const void* states, const void* slots, const void* pool,
              const void* x_any, const void* col_r, const void* x, void* out,
              int mb, int kb, int br, int bw, int w, int tw, int op,
              uint32_t cap, cudaStream_t stream) {
  const dim3 grid((mb + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (w + tw - 1) / tw);
  const dim3 block(32 * kWarpsPerBlock);
#define TDR_LAUNCH(OPC)                                                      \
  block_sparse_lane_kernel<T, OPC><<<grid, block, 0, stream>>>(              \
      (const uint8_t*)states, (const int32_t*)slots, (const uint32_t*)pool, \
      (const int32_t*)x_any, (const T*)col_r, (const T*)x, (T*)out, mb, kb, \
      br, bw, w, tw, cap)
  switch (op) {
    case kOr: TDR_LAUNCH(kOr); break;
    case kMin: TDR_LAUNCH(kMin); break;
    case kSum: TDR_LAUNCH(kSum); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef TDR_LAUNCH
  return 0;
}

}  // namespace

// tw must satisfy br * tw <= 32 * kPerLane (the wrapper picks it);
// lane_bytes 1, 2 or 4; op 0 or, 1 min, 2 sum.
extern "C" int tdr_block_sparse_lane_matmul(
    const void* states, const void* slots, const void* pool,
    const void* x_any, const void* col_r, const void* x, void* out, int mb,
    int kb, int br, int bw, int w, int tw, int lane_bytes, int op,
    unsigned cap, void* stream) {
  if (mb > 0 && w > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    int rc;
    switch (lane_bytes) {
      case 1:
        rc = launch_op<uint8_t>(states, slots, pool, x_any, col_r, x, out,
                                mb, kb, br, bw, w, tw, op, cap, s);
        break;
      case 2:
        rc = launch_op<uint16_t>(states, slots, pool, x_any, col_r, x, out,
                                 mb, kb, br, bw, w, tw, op, cap, s);
        break;
      case 4:
        rc = launch_op<uint32_t>(states, slots, pool, x_any, col_r, x, out,
                                 mb, kb, br, bw, w, tw, op, cap, s);
        break;
      default:
        rc = (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
