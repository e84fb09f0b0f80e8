// Row popcount on Hopper (sm_90a):
//
//     out[i] = sum_c popcount(words[i, c])      words uint32 [N, W] -> int32 [N]
//
// Replaces: src/repro/kernels/popcount.py::popcount_rows (_kernel), a SWAR
// popcount per word summed over the trailing axis, one (TR, W) tile per
// grid step.
//
// Bound on this card: bytes.  A pure streaming reduce: N*W*4 bytes in and
// N*4 out, one __popc and one add per word.
//
// Design: a group of g lanes per row, g the smallest power of two >= W
// (at most 32), so a warp covers 32/g neighbouring rows and its loads of a
// narrow plane are one coalesced run of words; lanes stride the row by g,
// __popc each word, and an xor-shuffle sum inside the group leaves the
// row's count in the group's first lane.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void popcount_rows_kernel(const uint32_t* __restrict__ words,
                                     int32_t* __restrict__ out, int n, int w,
                                     int group) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long row = warp * (32 / group) + lane / group;
  const int sub = lane & (group - 1);
  int s = 0;
  if (row < n) {
    const uint32_t* r = words + row * (long long)w;
    for (int c = sub; c < w; c += group) s += __popc(__ldg(r + c));
  }
  // every lane takes part in the shuffles (no early exit above)
  for (int off = group >> 1; off > 0; off >>= 1)
    s += __shfl_xor_sync(kFull, s, off);
  if (row < n && sub == 0) out[row] = s;
}

}  // namespace

extern "C" int tdr_popcount_rows(const void* words, void* out, int n, int w,
                                 void* stream) {
  if (n > 0) {
    int group = 1;
    while (group < w && group < 32) group <<= 1;
    const long long warps = (n + (32 / group) - 1) / (32 / group);
    const int blocks = (int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
    popcount_rows_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)words, (int32_t*)out, n, w, group);
  }
  return (int)cudaGetLastError();
}
