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
//
// A chunk is the piece of a row of lanes one thread folds: 16 bytes of
// packed lanes (packed path: the row's bytes a multiple of 16 and the
// tensor 16-byte aligned; 16 / sizeof(T) lanes in four 32-bit words) or
// four lanes widened to 32 bits (scalar path).  The packed folds run on
// whole words (__vminu2 / __vminu4 for min, __vaddus2 / __vaddus4 then a
// min with cap for sum, | for or; a uint32 sum keeps the 64-bit add and
// clamp); the kernels take the scalar path when a sum's cap exceeds the
// lane maximum, since a packed lane cannot hold the total.
#pragma once
#include <cstdint>

namespace tdr_lane {

enum Op { kOr = 0, kMin = 1, kSum = 2 };

constexpr int kChunk = 4;   // 32-bit words of a thread's chunk of a row

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

// cap in every lane of a packed word
template <typename T>
__device__ __forceinline__ uint32_t replicate(uint32_t cap) {
  if (sizeof(T) == 1) return (cap & 0xffu) * 0x01010101u;
  if (sizeof(T) == 2) return (cap & 0xffffu) * 0x00010001u;
  return cap;
}

// The identity of one 32-bit word of a chunk: every packed lane at the
// identity, or one widened lane.
template <typename T, int OP, bool PACKED>
__device__ __forceinline__ uint32_t chunk_identity() {
  return PACKED ? (OP == kMin ? 0xffffffffu : 0u) : identity<T, OP>();
}

// (+) on a word of packed T lanes; cap is replicated.  The saturating add
// stops at the lane maximum >= cap, so the min with cap equals
// min(acc + v, cap) lane by lane.
template <typename T, int OP>
__device__ __forceinline__ uint32_t fold_packed(uint32_t a, uint32_t v,
                                                uint32_t cap) {
  if (OP == kOr) return a | v;
  if (sizeof(T) == 1)
    return OP == kMin ? __vminu4(a, v) : __vminu4(__vaddus4(a, v), cap);
  if (sizeof(T) == 2)
    return OP == kMin ? __vminu2(a, v) : __vminu2(__vaddus2(a, v), cap);
  return fold<OP>(a, v, cap);
}

template <typename T, int OP, bool PACKED>
__device__ __forceinline__ void fold_chunk(uint32_t* acc, const uint32_t* v,
                                           uint32_t cap) {
#pragma unroll
  for (int e = 0; e < kChunk; ++e)
    acc[e] = PACKED ? fold_packed<T, OP>(acc[e], v[e], cap)
                    : fold<OP>(acc[e], v[e], cap);
}

// The chunk of a row that starts at column c0 (n columns in the tile).
template <typename T, int OP, bool PACKED>
__device__ __forceinline__ void load_chunk(uint32_t* v, const T* row, int c0,
                                           int n) {
  if (PACKED) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + c0));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      v[e] = c0 + e < n ? (uint32_t)__ldg(row + c0 + e) : identity<T, OP>();
  }
}

template <typename T, bool PACKED>
__device__ __forceinline__ void store_chunk(T* row, int c0, int n,
                                            const uint32_t* acc) {
  if (PACKED) {
    *reinterpret_cast<uint4*>(row + c0) =
        make_uint4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      if (c0 + e < n) row[c0 + e] = static_cast<T>(acc[e]);
  }
}

}  // namespace tdr_lane
