// Lane combines shared by lane_matmul.cu and block_sparse_lane.cu.
//
// A lane is an unsigned 8-, 16- or 32-bit value (T); the kernels
// accumulate in 32-bit registers and store at T's width.
//
//   or : acc | v                        identity 0
//   min: min(acc, v)                    identity INF = T's maximum
//   sum: min(acc + v, cap), 64-bit add  identity 0
//
// The sum clamps at every step, which equals clamping the total because
// saturating add of non-negative values is associative; the 64-bit add
// keeps acc + v from wrapping whatever v is.
#pragma once
#include <cstdint>

namespace tdr_lane {

enum Op { kOr = 0, kMin = 1, kSum = 2 };

template <typename T>
__device__ __forceinline__ uint32_t lane_max() {
  return static_cast<uint32_t>(static_cast<T>(~static_cast<T>(0)));
}

template <typename T, int OP>
__device__ __forceinline__ uint32_t identity() {
  return OP == kMin ? lane_max<T>() : 0u;
}

template <int OP>
__device__ __forceinline__ uint32_t fold(uint32_t acc, uint32_t v,
                                         uint32_t cap) {
  if (OP == kOr) return acc | v;
  if (OP == kMin) return v < acc ? v : acc;
  const unsigned long long s = (unsigned long long)acc + v;
  return s > cap ? cap : (uint32_t)s;
}

}  // namespace tdr_lane
