// Block-sparse boolean-OR bit-matrix product on Hopper (sm_90a): the same
// out[i, w] = OR_j (A[i, j] AND X[j, w]) as bitset_matmul.cu, with A in the
// two-level block form of repro_torch.compressed.BlockCompressed, walked
// through its live lists (the state grid is not read):
//
//   mix_off int32 [MB+1]   row-block offsets into the MIXED list; an entry's
//                          position is its pool slot
//   mix_bj  int32 [P]      word-block (k-block) of each MIXED entry
//   pool    uint32 [P, br, bw]
//   one_off int32 [MB+1]   row-block offsets into one_bj
//   one_bj  int32 [n_one]  k-block of each ONE block
//   X       uint32 [V, W]  (V <= KB*bw*32; rows past V read as zero)
//   ->  out uint32 [M, W]
//
// Replaces: src/repro/kernels/block_sparse.py::block_sparse_matmul (_kernel,
// _block_sparse_call), which walks a (row-block, W tile, k-block) grid with
// the slot ids brought in by scalar prefetch and takes x_any/col_or from
// plain jnp outside the kernel.
//
// Bound on this card: bytes.  The call must read X once, the live lists,
// the pool blocks whose k-block is live, and write out; each set bit of a
// live block costs one X row gather and a handful of word operations.  On
// a sparse graph a row-block holds a few dozen MIXED blocks of one edge
// each, so the work is latency-bound gathers, not a contraction: the
// unpacked bf16 matmul of the same product takes far longer, so there is
// no tensor-core (wgmma) form worth having.  X (1 MiB at V = 32768, W = 8),
// col_or and the live lists fit in the 50 MB L2 across a closure's rounds,
// so there is nothing for TMA to stage either.
//
// Design: one launch per call on the caller's stream, two when the operand
// has ONE blocks.
//  1. col_or_kernel (only with ONE blocks): one block per (k-block, W tile)
//     ORs the k-block's X rows into col_or [KB, W].  Rows past V are not
//     read, so the caller pads nothing.
//  2. block_sparse_kernel: one warp per (row-block, W tile), four to a
//     block, so MB warps fit the card in one wave.  The warp's lanes take
//     the row-block's MIXED entries in parallel (a few dozen on a sparse
//     graph: one lane per entry at W <= 8, `lanes` lanes per entry at wider
//     W).  Each lane loads its pool block with 16-byte loads, visits only
//     the non-zero words and their set bits, gathers the X rows they select
//     (16-byte loads where W allows), ORs them per block row in registers
//     and then into the row-block's accumulator in shared memory with
//     shared atomicOr; the next entry's k-block id and pool words are
//     loaded while this one's rows are gathered.  ONE entries OR their
//     k-block's column-OR into one shared row that every output row takes.
//     Nothing carries between warps or launches.
//
// Departures from the TPU kernel, measured on the card: no x_any skip.  A
// dead k-block's X rows are zero and OR in nothing, so the skip only saves
// gathers that hit L2, while its flag load sat on every entry's dependent
// chain (one more load deep); and without it the MIXED-only operand of a
// sparse graph needs no pre-pass at all.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 128;
constexpr int kWarps = 4;           // row-blocks per block of the product
constexpr int kMaxTile = 128;       // W tile words (the wrapper's cap)
constexpr int kChunksPerLane = 2;   // X chunks of VEC words held per thread

__global__ void __launch_bounds__(kSumThreads) col_or_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ col_or, int v,
    int bk, int w, int tw) {
  __shared__ uint32_t s_col[kMaxTile];
  const int k = blockIdx.x;
  const int w0 = blockIdx.y * tw;
  const int tcols = min(tw, w - w0);
  for (int c = threadIdx.x; c < tcols; c += blockDim.x) s_col[c] = 0u;
  __syncthreads();
  const long long r0 = (long long)k * bk;
  const int rows = (int)max(0LL, min((long long)bk, (long long)v - r0));
  const uint32_t* src = x + r0 * w + w0;
  for (int i = threadIdx.x; i < rows * tcols; i += blockDim.x) {
    const int r = i / tcols;
    const int c = i - r * tcols;
    const uint32_t val = __ldg(src + (long long)r * w + c);
    if (val) atomicOr(&s_col[c], val);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < tcols; c += blockDim.x) {
    col_or[(long long)k * w + w0 + c] = s_col[c];
  }
}

template <int VEC>
__device__ __forceinline__ void or_row(uint32_t* racc, const uint32_t* xr,
                                       int gl, int lanes, int nch) {
#pragma unroll
  for (int t = 0; t < kChunksPerLane; ++t) {
    const int c = gl + t * lanes;
    if (c < nch) {
      if (VEC == 4) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(xr) + c);
        racc[4 * t] |= q.x;
        racc[4 * t + 1] |= q.y;
        racc[4 * t + 2] |= q.z;
        racc[4 * t + 3] |= q.w;
      } else {
        racc[t] |= __ldg(xr + c);
      }
    }
  }
}

template <int VEC>
__device__ __forceinline__ void flush_row(uint32_t* racc, uint32_t* acc_row,
                                          int gl, int lanes, int nch) {
#pragma unroll
  for (int t = 0; t < kChunksPerLane; ++t) {
    const int c = gl + t * lanes;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (c < nch && racc[VEC * t + e]) {
        atomicOr(&acc_row[VEC * c + e], racc[VEC * t + e]);
      }
      racc[VEC * t + e] = 0u;
    }
  }
}

// Pool words q0 .. q0+7 of entry `se` (zero past the block), with 16-byte
// loads when the block is a whole number of them.
__device__ __forceinline__ void load8(const uint32_t* __restrict__ pool,
                                      int bsz, int se, int q0, uint4& pa,
                                      uint4& pb) {
  const uint32_t* blk = pool + (long long)se * bsz + q0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if ((bsz & 3) == 0) {
    pa = __ldg(reinterpret_cast<const uint4*>(blk));
    pb = q0 + 4 < bsz ? __ldg(reinterpret_cast<const uint4*>(blk + 4)) : zero;
  } else {
    uint32_t t[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) t[e] = q0 + e < bsz ? __ldg(blk + e) : 0u;
    pa = make_uint4(t[0], t[1], t[2], t[3]);
    pb = make_uint4(t[4], t[5], t[6], t[7]);
  }
}

// One warp per (row-block, W tile), kWarps row-blocks to a block.  Dynamic
// shared memory: kWarps * (br + 1) * tw words (the wrapper keeps it small).
template <int VEC>
__global__ void __launch_bounds__(kWarps * 32) block_sparse_kernel(
    const int32_t* __restrict__ mix_off, const int32_t* __restrict__ mix_bj,
    const uint32_t* __restrict__ pool, const int32_t* __restrict__ one_off,
    const int32_t* __restrict__ one_bj, const uint32_t* __restrict__ col_or,
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int m, int v,
    int mb, int br, int bw, int w, int tw, int lanes) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bi = blockIdx.x * kWarps + warp;
  if (bi >= mb) return;              // warp-uniform; only __syncwarp below
  uint32_t* acc = smem + warp * (br + 1) * tw;   // [br, tw]
  uint32_t* one_acc = acc + br * tw;             // [tw]
  const int w0 = blockIdx.y * tw;
  const int tcols = min(tw, w - w0);
  const int s0 = __ldg(mix_off + bi);
  const int s1 = __ldg(mix_off + bi + 1);
  const int o0 = __ldg(one_off + bi);
  const int o1 = __ldg(one_off + bi + 1);
  for (int i = lane; i < (br + 1) * tw; i += 32) acc[i] = 0u;
  __syncwarp();

  const int bsz = br * bw;
  const long long bk = (long long)bw * 32;
  const int nch = tcols / VEC;       // tcols is a multiple of VEC
  const int gl = lane % lanes;
  // software pipeline: the next entry's k-block id and first eight pool
  // words are in flight while this entry's rows are gathered
  const int step = 32 / lanes;
  int s = s0 + lane / lanes;
  int k_n = 0;
  uint4 pa_n = make_uint4(0u, 0u, 0u, 0u), pb_n = pa_n;
  if (s < s1) {
    k_n = __ldg(mix_bj + s);
    load8(pool, bsz, s, 0, pa_n, pb_n);
  }
  for (; s < s1; s += step) {
    const int k = k_n;
    uint4 pa = pa_n, pb = pb_n;
    if (s + step < s1) {
      k_n = __ldg(mix_bj + s + step);
      load8(pool, bsz, s + step, 0, pa_n, pb_n);
    }
    const long long kbase = k * bk;
    uint32_t racc[kChunksPerLane * VEC];
#pragma unroll
    for (int t = 0; t < kChunksPerLane * VEC; ++t) racc[t] = 0u;
    int cur_r = -1;
    for (int q0 = 0; q0 < bsz; q0 += 8) {
      if (q0 > 0) load8(pool, bsz, s, q0, pa, pb);
      const uint32_t p[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      // visit only the non-zero words; rows come in order
      unsigned nz = 0u;
#pragma unroll
      for (int e = 0; e < 8; ++e) nz |= (unsigned)(p[e] != 0u) << e;
      while (nz) {
        const int e = __ffs(nz) - 1;
        nz &= nz - 1;
        const int q = q0 + e;
        const int r = q / bw;
        const int wk = q - r * bw;
        uint32_t bits = 0u;
#pragma unroll
        for (int f = 0; f < 8; ++f) bits = f == e ? p[f] : bits;
        if (r != cur_r) {
          if (cur_r >= 0) flush_row<VEC>(racc, acc + cur_r * tw, gl, lanes, nch);
          cur_r = r;
        }
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const long long row = kbase + wk * 32 + b;
          if (row >= v) break;       // ascending: the rest are past X too
          or_row<VEC>(racc, x + row * w + w0, gl, lanes, nch);
        }
      }
    }
    if (cur_r >= 0) flush_row<VEC>(racc, acc + cur_r * tw, gl, lanes, nch);
  }

  for (int i = lane; i < (o1 - o0) * tcols; i += 32) {
    const int e = i / tcols;
    const int c = i - e * tcols;
    const int k = __ldg(one_bj + o0 + e);
    const uint32_t val = __ldg(col_or + (long long)k * w + w0 + c);
    if (val) atomicOr(&one_acc[c], val);
  }
  __syncwarp();

  for (int i = lane; i < br * tcols; i += 32) {
    const int r = i / tcols;
    const int c = i - r * tcols;
    const long long row = (long long)bi * br + r;
    if (row < m) out[row * w + w0 + c] = acc[r * tw + c] | one_acc[c];
  }
}

}  // namespace

// col_or uint32 [kb, w] is scratch the wrapper allocates; it is computed
// only when the operand has ONE blocks (n_one > 0).  tw <= kMaxTile, a
// multiple of vec; vec is 4 only when w % 4 == 0 and x is 16-byte aligned;
// lanes is a power of two <= 32 with lanes * kChunksPerLane * vec >= tw;
// kWarps * (br + 1) * tw * 4 bytes <= 48 KB.
extern "C" int tdr_block_sparse_matmul(
    const void* mix_off, const void* mix_bj, const void* pool,
    const void* one_off, const void* one_bj, const void* x, void* col_or,
    void* out, int m, int v, int mb, int kb, int n_one, int br, int bw, int w,
    int tw, int vec, int lanes, void* stream) {
  if (mb <= 0 || w <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (w + tw - 1) / tw;
  if (n_one > 0 && kb > 0) {
    col_or_kernel<<<dim3(kb, tiles), kSumThreads, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)col_or, v, bw * 32, w, tw);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = (size_t)kWarps * (br + 1) * tw * sizeof(uint32_t);
  const dim3 grid((mb + kWarps - 1) / kWarps, tiles);
  if (vec == 4) {
    block_sparse_kernel<4><<<grid, kWarps * 32, smem, st>>>(
        (const int32_t*)mix_off, (const int32_t*)mix_bj, (const uint32_t*)pool,
        (const int32_t*)one_off, (const int32_t*)one_bj,
        (const uint32_t*)col_or, (const uint32_t*)x, (uint32_t*)out, m, v, mb,
        br, bw, w, tw, lanes);
  } else {
    block_sparse_kernel<1><<<grid, kWarps * 32, smem, st>>>(
        (const int32_t*)mix_off, (const int32_t*)mix_bj, (const uint32_t*)pool,
        (const int32_t*)one_off, (const int32_t*)one_bj,
        (const uint32_t*)col_or, (const uint32_t*)x, (uint32_t*)out, m, v, mb,
        br, bw, w, tw, lanes);
  }
  return (int)cudaGetLastError();
}
