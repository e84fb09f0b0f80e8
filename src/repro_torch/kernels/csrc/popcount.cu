// Row popcount on Hopper (sm_90a):
//
//     out[i] = sum_c popcount(words[i, c])      words uint32 [N, W] -> int32 [N]
//
// Replaces: src/repro/kernels/popcount.py::popcount_rows (_kernel), a SWAR
// popcount per word summed over the trailing axis, one (TR, W) tile per
// grid step.
//
// Bound on this card: bytes.  A pure streaming reduce: N*W*4 bytes in and
// N*4 out, one __popc and one add per word.  At the main-path size (4 MiB)
// the bytes take about 1.3 us, under the card's ~5 us floor for one launch,
// so what counts is having every load in flight at once.
//
// Design: a group of g lanes per row, g the least power of two covering the
// row's chunks (at most 32), so a warp covers 32/g neighbouring rows and its
// loads of a narrow plane are one coalesced run.  A chunk is 16 bytes
// (uint4) when W % 4 == 0 and the words are 16-byte aligned, else one word.
// The grid is sized to fill the card once (cudaDevAttrMultiProcessorCount
// blocks-per-SM) and strides over rows; each warp loads kUnroll rows' chunks
// before it counts any, and lanes stride a wide row by g chunks.  An
// xor-shuffle sum inside the group leaves each row's count in the group's
// first lane.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;   // threads an SM holds
constexpr int kUnroll = 4;                      // rows a group has in flight
constexpr unsigned kFull = 0xffffffffu;

template <bool VEC>
__device__ __forceinline__ int popc_chunk(const uint32_t* row, int c) {
  if (VEC) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(row) + c);
    return __popc(q.x) + __popc(q.y) + __popc(q.z) + __popc(q.w);
  }
  return __popc(__ldg(row + c));
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) popcount_rows_kernel(
    const uint32_t* __restrict__ words, int32_t* __restrict__ out,
    long long n, int w, int group) {
  const int nch = VEC ? w / 4 : w;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (group - 1);
  const int per_warp = 32 / group;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long step = (long long)gridDim.x * (kThreads / 32) * per_warp
                         * kUnroll;
  // r0 is warp-uniform, so every lane reaches the shuffles
  for (long long r0 = warp * per_warp * kUnroll; r0 < n; r0 += step) {
    int s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r0 + u * per_warp + lane / group;
      s[u] = 0;
      if (row < n) {
        const uint32_t* p = words + row * w;
#pragma unroll 4
        for (int c = sub; c < nch; c += group) s[u] += popc_chunk<VEC>(p, c);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      for (int off = group >> 1; off > 0; off >>= 1)
        s[u] += __shfl_xor_sync(kFull, s[u], off);
      const long long row = r0 + u * per_warp + lane / group;
      if (row < n && sub == 0) out[row] = s[u];
    }
  }
}

}  // namespace

// vec is 1 only when w % 4 == 0 and words is 16-byte aligned.
extern "C" int tdr_popcount_rows(const void* words, void* out, int n, int w,
                                 int vec, void* stream) {
  if (n > 0) {
    const int nch = vec ? w / 4 : w;
    int group = 1;
    while (group < nch && group < 32) group <<= 1;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const long long rows_per_block = (long long)(kThreads / 32) * (32 / group)
                                     * kUnroll;
    const long long need = (n + rows_per_block - 1) / rows_per_block;
    const int blocks = (int)(need < (long long)sms * kBlocksPerSm
                                 ? need
                                 : (long long)sms * kBlocksPerSm);
    const cudaStream_t st = (cudaStream_t)stream;
    if (vec) {
      popcount_rows_kernel<true><<<blocks, kThreads, 0, st>>>(
          (const uint32_t*)words, (int32_t*)out, n, w, group);
    } else {
      popcount_rows_kernel<false><<<blocks, kThreads, 0, st>>>(
          (const uint32_t*)words, (int32_t*)out, n, w, group);
    }
  }
  return (int)cudaGetLastError();
}
