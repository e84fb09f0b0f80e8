// Boolean-OR bit-matrix product on Hopper (sm_90a):
//
//     out[i, w] = OR_j ( A[i, j] AND X[j, w] )
//
// A is a packed bit-matrix (uint32 [M, Kw], bit j of row i), X packed
// bitsets (uint32 [Kw*32, W]), out uint32 [M, W].
//
// Replaces: src/repro/kernels/bitset_matmul.py::bitset_matmul (_kernel), the
// TPU kernel that broadcasts every adjacency bit over a VMEM tile of X.
//
// Bound on this card: reading A.  On the main path A is a packed adjacency
// (or one label class of it) whose words are >99.9% zero, so the M*Kw*4
// bytes of A dwarf X and out (128 MiB per call at V = 32768, about 40 us at
// 3.35 TB/s); the X work is one W-word gather per set bit.
//
// Design: one warp per row of A.  The 32 lanes stream the row in coalesced
// 128-byte loads, four in flight per lane; a ballot finds the non-zero
// words, a shuffle broadcasts each, and its set bits (__ffs) pick the X rows
// that the lanes OR into their output word (lane = output word, W > 32
// loops over 32-word passes).  Every lane works on the bound part whatever
// W is (2, 8 or 32 on the main path): a narrow W idles lanes only on the
// few X loads of set bits.  Ragged edges (M, Kw, W) are masked here; the
// kernel allocates nothing and runs on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void bitset_matmul_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ x,
                                     uint32_t* __restrict__ out,
                                     int m, int kw, int w) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // warp-uniform: the shuffles below stay full-warp
  const uint32_t* arow = a + row * (long long)kw;
  for (int w0 = 0; w0 < w; w0 += 32) {
    const int wc = w0 + lane;
    const bool has_w = wc < w;
    uint32_t acc = 0u;
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
            if (has_w) acc |= __ldg(x + (k0 + b) * w + wc);
          }
        }
      }
    }
    if (has_w) out[row * (long long)w + wc] = acc;
  }
}

}  // namespace

extern "C" int tdr_bitset_matmul(const void* a, const void* x, void* out,
                                 int m, int kw, int w, void* stream) {
  if (m > 0 && w > 0) {
    const int blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
    bitset_matmul_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)x, (uint32_t*)out, m, kw, w);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
