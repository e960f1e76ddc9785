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
// Design (U <= 32, `link_geometry_lanes_kernel`): one thread per link
// (b, i, k).  A row takes W = next_pow2(U) lanes, so a warp holds 32 / W
// whole rows and, at U = 8, stores 32 consecutive floats of each output (one
// 128-byte transaction); lanes k >= U are padding.  A thread loads its two
// UAVs' positions and flags and its gain scale at once, straight from
// global memory, in one round trip; staging a block's positions in shared
// memory first would put a barrier behind that same round trip.  Each
// thread computes its link's dist, gain and threshold once and keeps them
// in registers through the row max, a segmented `__shfl_xor_sync` over the
// row's W lanes (padding and the tail contribute the max's identity 0.0),
// then writes all three outputs.
// For U > 32 (`link_geometry_rows_kernel`) a warp loops over a row, as the
// first port did, but still computes each gain once: pass 1 parks it in
// its own rate slot and pass 2 reads it back with the stored threshold.
//
// Every operation is an explicitly rounded intrinsic in the reference's
// order (no FMA contraction), so dist and threshold equal the plain
// PyTorch version bit for bit and the discrete th <= p_max decision cannot
// flip.  log2f is the CUDA math library's, as PyTorch's own log2 uses.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;                // 4 warps a block

struct Radio {
  float h0, noise, p_max, bandwidth, expm1_spectral;
};

// eq. (4) gain (1 m clamp, optional scale) and eq. (7) threshold of one
// link, with its distance
__device__ __forceinline__ void link_terms(float xi, float yi, float xk,
                                           float yk, bool scaled, float gs,
                                           const Radio& c, float* dist,
                                           float* gain, float* thr) {
  const float dx = __fsub_rn(xi, xk);
  const float dy = __fsub_rn(yi, yk);
  const float d =
      __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  const float dc = fmaxf(d, 1.0f);                     // d0 = 1 m clamp
  float g = __fdiv_rn(c.h0, __fmul_rn(dc, dc));        // eq. (4)
  if (scaled) g = __fmul_rn(g, gs);
  *dist = d;
  *gain = g;
  *thr = __fmul_rn(__fdiv_rn(c.noise, g), c.expm1_spectral);  // eq. (7)
}

// eq. (5) at the row's power; 0 on infeasible links, inf on the diagonal
__device__ __forceinline__ float link_rate(float g, float power, bool feas,
                                           bool eye, const Radio& c) {
  const float p_rx = __fmul_rn(g, power);
  float r = __fmul_rn(c.bandwidth,
                      log2f(__fadd_rn(1.0f, __fdiv_rn(p_rx, c.noise))));
  r = feas ? r : 0.0f;
  return eye ? INFINITY : r;
}

__global__ void __launch_bounds__(kThreads) link_geometry_lanes_kernel(
    const float* __restrict__ pos,      // [B, U, 2]
    const float* __restrict__ active,   // [B, U] 0/1
    const float* __restrict__ gscale,   // [B, U, U] or null
    float* __restrict__ dist,           // [B, U, U]
    float* __restrict__ thr,            // [B, U, U]
    float* __restrict__ rate,           // [B, U, U]
    int B, int U, int W, Radio c) {
  const long long rows = (long long)B * U;
  const long long row = (long long)blockIdx.x * (kThreads / W) +
                        threadIdx.x / W;                 // (b, i)
  const int k = threadIdx.x % W;
  const bool live = row < rows && k < U;
  const size_t at = live ? (size_t)row * U + k : 0;
  float d = 0.0f, g = 0.0f, th = 0.0f, tmax = 0.0f;
  bool feas = false, eye = false, act_i = false;
  if (live) {
    const int i = (int)(row % U);
    const float* pb = pos + (row / U) * U * 2;
    const float* ab = active + (row / U) * U;
    link_terms(pb[2 * i], pb[2 * i + 1], pb[2 * k], pb[2 * k + 1],
               gscale != nullptr, gscale != nullptr ? gscale[at] : 1.0f, c,
               &d, &g, &th);
    eye = k == i;
    act_i = ab[i] > 0.0f;
    const float thz = eye ? 0.0f : th;
    const bool pair = act_i && ab[k] > 0.0f;
    feas = (thz <= c.p_max) && (pair || eye);
    tmax = (feas && !eye) ? thz : 0.0f;
  }
  // row max over the row's W lanes (xor offsets below W stay in the row)
  for (int off = W >> 1; off > 0; off >>= 1)
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
  if (!live) return;
  const float power = act_i ? fminf(tmax, c.p_max) : 0.0f;
  dist[at] = d;
  thr[at] = th;
  rate[at] = link_rate(g, power, feas, eye, c);
}

__global__ void __launch_bounds__(kThreads) link_geometry_rows_kernel(
    const float* __restrict__ pos, const float* __restrict__ active,
    const float* __restrict__ gscale, float* __restrict__ dist,
    float* __restrict__ thr, float* __restrict__ rate, int B, int U,
    Radio c) {
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

  // pass 1: dist and threshold stored, the gain parked in its rate slot,
  // and the feasible-threshold row max
  float tmax = 0.0f;
  for (int k = lane; k < U; k += 32) {
    float d, g, th;
    link_terms(xi, yi, pb[2 * k], pb[2 * k + 1], gscale != nullptr,
               gscale ? gscale[row + k] : 1.0f, c, &d, &g, &th);
    dist[row + k] = d;
    thr[row + k] = th;
    rate[row + k] = g;
    const bool eye = k == i;
    const float thz = eye ? 0.0f : th;
    const bool feas = (thz <= c.p_max) && ((act_i && ab[k] > 0.0f) || eye);
    tmax = fmaxf(tmax, (feas && !eye) ? thz : 0.0f);
  }
  for (int off = 16; off > 0; off >>= 1)
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
  const float power = act_i ? fminf(tmax, c.p_max) : 0.0f;

  // pass 2: each lane rereads its own links' gain and threshold
  for (int k = lane; k < U; k += 32) {
    const bool eye = k == i;
    const float thz = eye ? 0.0f : thr[row + k];
    const bool feas = (thz <= c.p_max) && ((act_i && ab[k] > 0.0f) || eye);
    rate[row + k] = link_rate(rate[row + k], power, feas, eye, c);
  }
}

}  // namespace

extern "C" int repro_link_geometry(const void* pos, const void* active,
                                   const void* gscale, void* dist, void* thr,
                                   void* rate, int B, int U, float h0,
                                   float noise, float p_max, float bandwidth,
                                   float expm1_spectral, void* stream) {
  if (B <= 0 || U <= 0) return (int)cudaSuccess;
  const Radio c{h0, noise, p_max, bandwidth, expm1_spectral};
  const long long rows = (long long)B * U;
  if (U <= 32) {
    int W = 1;
    while (W < U) W <<= 1;
    const int rows_per_block = kThreads / W;
    const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
    link_geometry_lanes_kernel<<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const float*)pos, (const float*)active, (const float*)gscale,
        (float*)dist, (float*)thr, (float*)rate, B, U, W, c);
  } else {
    const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
    link_geometry_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const float*)pos, (const float*)active, (const float*)gscale,
        (float*)dist, (float*)thr, (float*)rate, B, U, c);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
