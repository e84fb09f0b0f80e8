// Fused phase-1 way filter on Hopper (sm_90a): per (job j, way g), with
// a = u[j] and b = v[j] picking the index rows,
//
//   ok[j,g] =   vbits    ⊆ h_vtx[a,g]            (target bits present)
//             ∧ req[j]   ⊆ h_lab[a,g]            (required labels present)
//             ∧ ¬∃ l < k: blocked(l) ∧ ¬reached_before(l)
//
//   vbits      = vtx_packed[b]
//   blocked(l) = (v_lab[a,g,l] & ~forb[j] & ~null) == 0
//   reached(l) = vbits ⊆ v_vtx[a,g,l]
//
// All inputs uint32 words; u, v int64; out is uint8 [J, G] (read as bool).
// With u and v null the planes are already gathered per job (row j), which
// is the form of kernels.ops.filter_ways.
//
// Replaces: src/repro/kernels/pattern_filter.py::way_filter (_kernel) and
// the row gathers that feed it in src/repro/core/tdr_query.py's cascade.
//
// Bound on this card: bytes, and below that the time of one launch.  Each
// (job, way) reads (Wv + Wl)(1 + k) words of index rows plus Wv + 2 Wl words
// of per-job rows, with a handful of word operations on each, so a batch of
// a few thousand (job, way) pairs moves well under a megabyte.
//
// Design: one launch that gathers the rows itself (no [J, G, ...] copies),
// spread over the SMs: a group of 8 lanes takes one (job, way), 16 pairs to
// a 128-thread block.  The lanes split the (1 + k) vertex rows into chunks,
// 16-byte loads where Wv allows, and the (1 + k) label rows into words, so
// all loads of a pair are in flight at once instead of one thread walking
// 40 dependent words.  Each lane sets bits for what its chunks refute (a
// level not reached, a level with a real label, a missing target or
// required label), three xor-shuffles OR them across the group, and the
// group's first lane resolves the reached-before prefix from the two level
// masks and writes the byte.  Indices outside the planes give 0.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kReqMiss = 1u << 31;

template <int VEC>
__global__ void __launch_bounds__(kThreads) way_filter_kernel(
    const int64_t* __restrict__ u, const int64_t* __restrict__ v,
    const uint32_t* __restrict__ vtx, const uint32_t* __restrict__ hv,
    const uint32_t* __restrict__ hl, const uint32_t* __restrict__ vv,
    const uint32_t* __restrict__ vl, const uint32_t* __restrict__ req,
    const uint32_t* __restrict__ forb, const uint32_t* __restrict__ nullp,
    uint8_t* __restrict__ out, int j, int g, int k, int wv, int wl, int n_u,
    int n_v) {
  const long long pair =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  const int gl = threadIdx.x % kGroup;
  const bool active = pair < (long long)j * g;
  // bit 0: target bits missing from h_vtx; bit 1 + l: level l does not
  // reach the target; kReqMiss: a required label missing from h_lab
  uint32_t miss = 0u;
  uint32_t live = 0u;  // bit l: level l holds a real, allowed label
  bool valid = false;
  long long jj = 0;
  if (active) {
    jj = pair / g;
    const long long a = u ? __ldg(u + jj) : jj;
    const long long b = v ? __ldg(v + jj) : jj;
    valid = a >= 0 && a < n_u && b >= 0 && b < n_v;
    if (valid) {
      const long long way = a * g + (pair - jj * g);
      const uint32_t* vb = vtx + b * wv;
      const uint32_t* hvr = hv + way * wv;
      const uint32_t* vvr = vv + way * k * wv;
      const int nch = wv / VEC;
      for (int c = gl; c < (1 + k) * nch; c += kGroup) {
        const int row = c / nch;
        const int i = (c - row * nch) * VEC;
        const uint32_t* src = row == 0 ? hvr + i : vvr + (row - 1) * wv + i;
        bool contained;
        if (VEC == 4) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
          const uint4 t = __ldg(reinterpret_cast<const uint4*>(vb + i));
          contained = ((x.x & t.x) == t.x) && ((x.y & t.y) == t.y) &&
                      ((x.z & t.z) == t.z) && ((x.w & t.w) == t.w);
        } else {
          const uint32_t t = __ldg(vb + i);
          contained = (__ldg(src) & t) == t;
        }
        if (!contained) miss |= 1u << row;
      }
      const uint32_t* hlr = hl + way * wl;
      const uint32_t* vlr = vl + way * k * wl;
      for (int c = gl; c < (1 + k) * wl; c += kGroup) {
        const int row = c / wl;
        const int i = c - row * wl;
        if (row == 0) {
          const uint32_t r = __ldg(req + jj * wl + i);
          if ((__ldg(hlr + i) & r) != r) miss |= kReqMiss;
        } else if (__ldg(vlr + (row - 1) * wl + i) & ~__ldg(forb + jj * wl + i) &
                   ~__ldg(nullp + i)) {
          live |= 1u << (row - 1);
        }
      }
    }
  }
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    miss |= __shfl_xor_sync(kFull, miss, off);
    live |= __shfl_xor_sync(kFull, live, off);
  }
  if (active && gl == 0) {
    const uint32_t levels = (1u << k) - 1u;
    const uint32_t reached = ~(miss >> 1) & levels;
    const uint32_t blocked = ~live & levels;
    // levels up to and including the first that reached (all if none)
    const uint32_t upto = reached ? (reached ^ (reached - 1u)) : levels;
    const bool ok = valid && !(miss & 1u) && !(miss & kReqMiss) &&
                    !(blocked & upto);
    out[pair] = ok ? 1 : 0;
  }
}

}  // namespace

// u, v: int64 [J] or null (planes already gathered per job, n_u = n_v = J).
// vec is 4 only when wv % 4 == 0 and vtx, hv, vv are 16-byte aligned;
// k <= 30 (the level masks share a word with two flag bits).
extern "C" int tdr_way_filter(const void* u, const void* v, const void* vtx,
                              const void* hv, const void* hl, const void* vv,
                              const void* vl, const void* req,
                              const void* forb, const void* nullp, void* out,
                              int j, int g, int k, int wv, int wl, int n_u,
                              int n_v, int vec, void* stream) {
  const long long threads = (long long)j * g * kGroup;
  if (threads > 0) {
    const int blocks = (int)((threads + kThreads - 1) / kThreads);
    const cudaStream_t st = (cudaStream_t)stream;
    if (vec == 4) {
      way_filter_kernel<4><<<blocks, kThreads, 0, st>>>(
          (const int64_t*)u, (const int64_t*)v, (const uint32_t*)vtx,
          (const uint32_t*)hv, (const uint32_t*)hl, (const uint32_t*)vv,
          (const uint32_t*)vl, (const uint32_t*)req, (const uint32_t*)forb,
          (const uint32_t*)nullp, (uint8_t*)out, j, g, k, wv, wl, n_u, n_v);
    } else {
      way_filter_kernel<1><<<blocks, kThreads, 0, st>>>(
          (const int64_t*)u, (const int64_t*)v, (const uint32_t*)vtx,
          (const uint32_t*)hv, (const uint32_t*)hl, (const uint32_t*)vv,
          (const uint32_t*)vl, (const uint32_t*)req, (const uint32_t*)forb,
          (const uint32_t*)nullp, (uint8_t*)out, j, g, k, wv, wl, n_u, n_v);
    }
  }
  return (int)cudaGetLastError();
}
