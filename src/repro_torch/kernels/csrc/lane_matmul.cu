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
// Bound on this card: reading A.  On the main path A is one label class of
// the packed adjacency, whose words are >99.9% zero, so the M*Kw*4 bytes of
// A (128 MiB at V = 32768) dwarf the X rows its set bits select and the
// output (8 MiB of uint16 lanes at W = 128); about 43 us at 3.35 TB/s.
//
// Design: bitset_matmul.cu's.  One warp per row of A streams the row in
// coalesced 128-byte loads, four in flight per lane; a ballot finds the
// non-zero words and a shuffle broadcasts each; for each set bit j the
// lanes fold row j of X into their output columns (lane + 32 t, kPerLane
// columns a lane, W > 32 * kPerLane loops over passes).  Accumulators are
// 32-bit registers, written back at the lane width.  Ragged M, Kw and W are
// masked here; the kernel allocates nothing and runs on the caller's
// stream.
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_ops.cuh"

namespace {

using namespace tdr_lane;

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr int kPerLane = 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int OP>
__global__ void lane_matmul_kernel(const uint32_t* __restrict__ a,
                                   const T* __restrict__ x,
                                   T* __restrict__ out, int m, int kw, int w,
                                   uint32_t cap) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // warp-uniform: the shuffles below stay full-warp
  const uint32_t* arow = a + row * (long long)kw;
  for (int w0 = 0; w0 < w; w0 += 32 * kPerLane) {
    uint32_t acc[kPerLane];
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) acc[t] = identity<T, OP>();
    for (int base = 0; base < kw; base += 32 * kUnroll) {
      uint32_t words[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int col = base + u * 32 + lane;
        words[u] = col < kw ? __ldg(arow + col) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        unsigned live = __ballot_sync(kFull, words[u] != 0u);
        while (live) {
          const int src = __ffs(live) - 1;
          live &= live - 1;
          uint32_t bits = __shfl_sync(kFull, words[u], src);
          const long long k0 = (long long)(base + u * 32 + src) * 32;
          while (bits) {
            const int b = __ffs(bits) - 1;
            bits &= bits - 1;
            const T* xrow = x + (k0 + b) * w;
#pragma unroll
            for (int t = 0; t < kPerLane; ++t) {
              const int c = w0 + lane + 32 * t;
              if (c < w) acc[t] = fold<OP>(acc[t], __ldg(xrow + c), cap);
            }
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int c = w0 + lane + 32 * t;
      if (c < w) out[row * (long long)w + c] = static_cast<T>(acc[t]);
    }
  }
}

template <typename T>
int launch_op(const void* a, const void* x, void* out, int m, int kw, int w,
              int op, uint32_t cap, cudaStream_t stream) {
  const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid(blocks), block(32 * kWarpsPerBlock);
  const uint32_t* ap = (const uint32_t*)a;
  const T* xp = (const T*)x;
  T* op_out = (T*)out;
  switch (op) {
    case kOr:
      lane_matmul_kernel<T, kOr><<<grid, block, 0, stream>>>(
          ap, xp, op_out, m, kw, w, cap);
      break;
    case kMin:
      lane_matmul_kernel<T, kMin><<<grid, block, 0, stream>>>(
          ap, xp, op_out, m, kw, w, cap);
      break;
    case kSum:
      lane_matmul_kernel<T, kSum><<<grid, block, 0, stream>>>(
          ap, xp, op_out, m, kw, w, cap);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// lane_bytes: 1, 2 or 4 (uint8 / uint16 / uint32 lanes); op: 0 or, 1 min,
// 2 sum.  Returns cudaGetLastError() after the launch.
extern "C" int tdr_lane_matmul(const void* a, const void* x, void* out, int m,
                               int kw, int w, int lane_bytes, int op,
                               unsigned cap, void* stream) {
  if (m > 0 && w > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    int rc;
    switch (lane_bytes) {
      case 1: rc = launch_op<uint8_t>(a, x, out, m, kw, w, op, cap, s); break;
      case 2: rc = launch_op<uint16_t>(a, x, out, m, kw, w, op, cap, s); break;
      case 4: rc = launch_op<uint32_t>(a, x, out, m, kw, w, op, cap, s); break;
      default: rc = (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
