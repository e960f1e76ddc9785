// Fused link geometry of the LLHR planning tick, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/link_geometry/link_geometry.py
// (`link_geometry`, body `_geometry_math`): pairwise distance -> eq. (4) gain
// (1 m clamp, optional gain_scale) -> eq. (7) threshold -> first-pass P1
// power (row max over feasible thresholds, clamped to p_max) -> eq. (5) rate.
// The gain is never stored.
//
// Bound: bytes.  Per (b, i) row it reads U positions and writes 3 U floats,
// with some 25 flops per link; at U = 8 a launch moves ~0.2 MB, so on an
// H100 the launch overhead, not memory, sets its time.
//
// Design: one warp per (b, row i), lanes over the U columns (a loop when
// U > 32).  Each lane computes dist, gain and threshold for its column in
// registers, a warp-shuffle max gives the row's first-pass power, and the
// lanes then write the rate.  Every operation is an explicitly rounded
// intrinsic in the reference's order (no FMA contraction), so dist and
// threshold equal the plain PyTorch version bit for bit and the discrete
// th <= p_max decision cannot flip.  log2f is the CUDA math library's, as
// PyTorch's own log2 uses.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float link_gain(float xi, float yi, float xk,
                                           float yk, const float* gs,
                                           float h0, float* dist_out) {
  float dx = __fsub_rn(xi, xk);
  float dy = __fsub_rn(yi, yk);
  float d = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  *dist_out = d;
  float dc = fmaxf(d, 1.0f);                        // d0 = 1 m clamp
  float g = __fdiv_rn(h0, __fmul_rn(dc, dc));       // eq. (4)
  if (gs != nullptr) g = __fmul_rn(g, *gs);
  return g;
}

__global__ void link_geometry_kernel(
    const float* __restrict__ pos,      // [B, U, 2]
    const float* __restrict__ active,   // [B, U] 0/1
    const float* __restrict__ gscale,   // [B, U, U] or null
    float* __restrict__ dist,           // [B, U, U]
    float* __restrict__ thr,            // [B, U, U]
    float* __restrict__ rate,           // [B, U, U]
    int B, int U, float h0, float noise, float p_max, float bandwidth,
    float expm1_spectral) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * U) return;     // uniform across the warp
  const int b = (int)(warp / U);
  const int i = (int)(warp % U);
  const float* pb = pos + (size_t)b * U * 2;
  const float* ab = active + (size_t)b * U;
  const float xi = pb[2 * i], yi = pb[2 * i + 1];
  const bool act_i = ab[i] > 0.0f;
  const size_t row = ((size_t)b * U + i) * U;

  // pass 1: dist, threshold, and the feasible-threshold row max
  float tmax = 0.0f;
  for (int k = lane; k < U; k += 32) {
    float d;
    float g = link_gain(xi, yi, pb[2 * k], pb[2 * k + 1],
                        gscale ? gscale + row + k : nullptr, h0, &d);
    float th = __fmul_rn(__fdiv_rn(noise, g), expm1_spectral);  // eq. (7)
    dist[row + k] = d;
    thr[row + k] = th;
    const bool eye = k == i;
    const float thz = eye ? 0.0f : th;
    const bool pair = act_i && ab[k] > 0.0f;
    const bool feas = (thz <= p_max) && (pair || eye);
    tmax = fmaxf(tmax, (feas && !eye) ? thz : 0.0f);
  }
  for (int off = 16; off > 0; off >>= 1)
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
  const float power = act_i ? fminf(tmax, p_max) : 0.0f;

  // pass 2: eq. (5) at the row's power; 0 on infeasible links, inf diagonal
  for (int k = lane; k < U; k += 32) {
    float d;
    float g = link_gain(xi, yi, pb[2 * k], pb[2 * k + 1],
                        gscale ? gscale + row + k : nullptr, h0, &d);
    float th = __fmul_rn(__fdiv_rn(noise, g), expm1_spectral);
    const bool eye = k == i;
    const float thz = eye ? 0.0f : th;
    const bool pair = act_i && ab[k] > 0.0f;
    const bool feas = (thz <= p_max) && (pair || eye);
    float p_rx = __fmul_rn(g, power);
    float r = __fmul_rn(bandwidth,
                        log2f(__fadd_rn(1.0f, __fdiv_rn(p_rx, noise))));
    r = feas ? r : 0.0f;
    rate[row + k] = eye ? INFINITY : r;
  }
}

}  // namespace

extern "C" int repro_link_geometry(const void* pos, const void* active,
                                   const void* gscale, void* dist, void* thr,
                                   void* rate, int B, int U, float h0,
                                   float noise, float p_max, float bandwidth,
                                   float expm1_spectral, void* stream) {
  const int threads = 128;                  // 4 rows per block
  const long long warps = (long long)B * U;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  if (B <= 0 || U <= 0) return (int)cudaSuccess;
  link_geometry_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)active, (const float*)gscale,
      (float*)dist, (float*)thr, (float*)rate, B, U, h0, noise, p_max,
      bandwidth, expm1_spectral);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
