// Fused phase-1 way filter on Hopper (sm_90a): per (job j, way g)
//
//   ok[j,g] =   vbits[j] ⊆ h_vtx[j,g]            (target bits present)
//             ∧ req[j]   ⊆ h_lab[j,g]            (required labels present)
//             ∧ ¬∃ l < k: blocked(j,g,l) ∧ ¬reached_before(j,g,l)
//
//   blocked(j,g,l) = (v_lab[j,g,l] & ~forb[j] & ~null) == 0
//   reached(j,g,l) = vbits[j] ⊆ v_vtx[j,g,l]
//
// All inputs uint32 words, already gathered per job; out is uint8 [J, G].
//
// Replaces: src/repro/kernels/pattern_filter.py::way_filter (_kernel).
//
// Bound on this card: bytes.  Each (job, way) reads (Wv + Wl)(1 + k) words
// once and does a handful of word operations on each, so the pass streams
// about J*G*(Wv+Wl)*(1+k)*4 bytes at well under one operation per byte.
//
// Design: one thread per (job, way), the same reached-before prefix as the
// TPU kernel, with an early exit once a way is refuted (later words are not
// read).  Neighbouring threads are neighbouring ways of one job, so the
// per-job rows (vbits, req, forb) are shared through L1.  Fusing the u-row
// gather that feeds it is left to a later change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void way_filter_kernel(
    const uint32_t* __restrict__ hv, const uint32_t* __restrict__ hl,
    const uint32_t* __restrict__ vv, const uint32_t* __restrict__ vl,
    const uint32_t* __restrict__ vbits, const uint32_t* __restrict__ req,
    const uint32_t* __restrict__ forb, const uint32_t* __restrict__ nullp,
    uint8_t* __restrict__ out, int j, int g, int k, int wv, int wl) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)j * g) return;
  const long long jj = t / g;
  const uint32_t* vb = vbits + jj * wv;
  const uint32_t* rq = req + jj * wl;
  const uint32_t* fb = forb + jj * wl;
  bool ok = true;
  for (int i = 0; i < wv && ok; ++i) ok = (hv[t * wv + i] & vb[i]) == vb[i];
  for (int i = 0; i < wl && ok; ++i) ok = (hl[t * wl + i] & rq[i]) == rq[i];
  bool reached_before = false;
  for (int l = 0; l < k && ok; ++l) {
    const uint32_t* lab = vl + (t * k + l) * wl;
    bool blocked = true;
    for (int i = 0; i < wl; ++i) {
      if (lab[i] & ~fb[i] & ~nullp[i]) { blocked = false; break; }
    }
    if (blocked && !reached_before) ok = false;
    const uint32_t* vtx = vv + (t * k + l) * wv;
    bool reached = true;
    for (int i = 0; i < wv; ++i) {
      if ((vtx[i] & vb[i]) != vb[i]) { reached = false; break; }
    }
    reached_before = reached_before || reached;
  }
  out[t] = ok ? 1 : 0;
}

}  // namespace

extern "C" int tdr_way_filter(const void* hv, const void* hl, const void* vv,
                              const void* vl, const void* vbits,
                              const void* req, const void* forb,
                              const void* nullp, void* out, int j, int g,
                              int k, int wv, int wl, void* stream) {
  const long long n = (long long)j * g;
  if (n > 0) {
    const int threads = 256;
    const int blocks = (int)((n + threads - 1) / threads);
    way_filter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)hv, (const uint32_t*)hl, (const uint32_t*)vv,
        (const uint32_t*)vl, (const uint32_t*)vbits, (const uint32_t*)req,
        (const uint32_t*)forb, (const uint32_t*)nullp, (uint8_t*)out, j, g,
        k, wv, wl);
  }
  return (int)cudaGetLastError();
}
