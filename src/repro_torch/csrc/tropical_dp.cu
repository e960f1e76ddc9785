// One chain-DP wavefront step (min-plus product with first-argmin parents),
// for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/tropical_dp/tropical_dp.py
// (`tropical_dp_step`, body `_dp_step_kernel`):
//
//   row[s] = min_a ( min_s0 ( dp[a, s0] + tr[a, s, s0] ) + ct[a, s] ),
//
// masked by ok[a, s] > 0, with the a = 0 candidate taken from the per-slot
// source row tr0 (parent s0 = 0), and first-argmin parents pa (= a) and
// ps (= s0 at that a).
//
// Bound: bytes.  Each output reads an L x (S+1) dp slab and tr slice; at
// the main path's B = 256, M = 4, L = 11, S = 8 a launch moves ~1.3 MB and
// does ~1.6 M adds and compares, so launch overhead sets its time.  The
// min-plus product has no tensor-core form.
//
// Design: one thread per output (b, m, s).  It loops a over L and s0 over
// S+1 in the reference's staged order: min over s0 of dp + tr first, then
// + ct, then the ok mask, then min over a.  Each scan starts from its first
// element and replaces it only on a strict improvement (NaN counts as
// smallest, as in jnp/torch argmin), so ties and all-inf rows give the
// first index, as argmin does: an all-inf row returns pa = ps = 0, which
// the backtrack reads.  Only adds: no FMA contraction can change a value.
#include <cuda_runtime.h>
#include <math.h>

namespace {

// first-argmin order: strictly smaller, or the first NaN
__device__ __forceinline__ bool before(float v, float best) {
  return v < best || (isnan(v) && !isnan(best));
}

__global__ void tropical_dp_step_kernel(
    const float* __restrict__ dp,   // [B, M, L, S+1] rows, stride dp_bm
    long long dp_bm,                // elements between (b, m) slabs
    const float* __restrict__ tr,   // [B, L, S, S+1]
    const float* __restrict__ tr0,  // [B, M, S]
    const float* __restrict__ ct,   // [L, S]
    const float* __restrict__ ok,   // [L, S]
    float* __restrict__ row,        // [B, M, S]
    int* __restrict__ pa,           // [B, M, S]
    int* __restrict__ ps,           // [B, M, S]
    int B, int M, int L, int S) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * M * S) return;
  const int s = (int)(idx % S);
  const long long bm = idx / S;
  const long long b = bm / M;
  const int S1 = S + 1;
  const float* d = dp + bm * dp_bm;                       // [L, S+1]
  const float* t = tr + (b * L * S + s) * S1;             // tr[b, 0, s, :]
  const long long t_a = (long long)S * S1;                // stride over a

  // a = 0: the source row; dp[0, 0] is its only finite predecessor
  float best = __fadd_rn(__fadd_rn(d[0], tr0[idx]), ct[s]);
  if (!(ok[s] > 0.0f)) best = INFINITY;
  int a_best = 0, s0_sel = 0;
  for (int a = 1; a < L; ++a) {
    const float* da = d + a * S1;
    const float* ta = t + a * t_a;
    float m = __fadd_rn(da[0], ta[0]);
    int s0b = 0;
    for (int s0 = 1; s0 < S1; ++s0) {
      const float v = __fadd_rn(da[s0], ta[s0]);
      if (before(v, m)) { m = v; s0b = s0; }
    }
    float c = __fadd_rn(m, ct[a * S + s]);
    if (!(ok[a * S + s] > 0.0f)) c = INFINITY;
    if (before(c, best)) { best = c; a_best = a; s0_sel = s0b; }
  }
  row[idx] = best;
  pa[idx] = a_best;
  ps[idx] = s0_sel;
}

}  // namespace

extern "C" int repro_tropical_dp_step(const void* dp, long long dp_bm,
                                      const void* tr, const void* tr0,
                                      const void* ct, const void* ok,
                                      void* row, void* pa, void* ps, int B,
                                      int M, int L, int S, void* stream) {
  const long long n = (long long)B * M * S;
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  tropical_dp_step_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)dp, dp_bm, (const float*)tr, (const float*)tr0,
      (const float*)ct, (const float*)ok, (float*)row, (int*)pa, (int*)ps,
      B, M, L, S);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
