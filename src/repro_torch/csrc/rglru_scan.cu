// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/rglru_scan/rglru_scan.py
// (`rglru_scan`): over a, b [B, T, W] from h0 [B, W], elementwise in the
// channel w, sequential in t, float32 math; returns h [B, T, W] in a's
// dtype and the last state hT [B, W] in h0's dtype.  Each step is one
// float32 fused multiply-add a_t * h_{t-1} + b_t rounded once
// (__fmaf_rn, explicit, whatever the contraction flags): XLA contracts
// the Pallas kernel's `a * h + b` into an FMA (its interpret mode on the
// CPU matches an exact FMA bitwise), and the plain version computes an
// exact FMA too, so a launch equals both bitwise.
//
// Bound: bytes.  One read of a and b and one write of h: at
// recurrentgemma-9b's prefill (B 8, T 1536, W 4096, bfloat16) 302 MB,
// 90 us at 3.35 TB/s, against 2 flops per element.
//
// Design: one thread per (b, w) channel carries h in a register through
// the whole T loop (the Pallas grid's (batch, width) tiles with the time
// loop inside).  Neighbouring threads take neighbouring w, so every load
// and store of a step is coalesced.  The loads of a and b do not depend on
// h: each iteration issues a chunk of U steps' loads before it runs that
// chunk's dependent chain, so the latency of device memory is paid once a
// chunk, not once a step.  8 x 4096 channels make 256 blocks of 128
// threads on 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128, U = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename H>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const H* __restrict__ h0, T* __restrict__ h,
                  H* __restrict__ hT, int Tn, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long long bi = blockIdx.y;
  const long long base = bi * Tn * W + w;
  float hv = to_f(h0[bi * W + w]);
  for (int t0 = 0; t0 < Tn; t0 += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < Tn) {
        const long long off = base + (long long)(t0 + u) * W;
        av[u] = to_f(a[off]);
        bv[u] = to_f(b[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < Tn) {
        hv = __fmaf_rn(av[u], hv, bv[u]);
        store1(h + base + (long long)(t0 + u) * W, hv);
      }
    }
  }
  store1(hT + bi * W + w, hv);
}

template <typename T, typename H>
int launch(const void* a, const void* b, const void* h0, void* h, void* hT,
           int B, int Tn, int W, cudaStream_t stream) {
  const dim3 grid((unsigned)((W + THREADS - 1) / THREADS), (unsigned)B);
  rglru_scan_kernel<T, H><<<grid, THREADS, 0, stream>>>(
      (const T*)a, (const T*)b, (const H*)h0, (T*)h, (H*)hT, Tn, W);
  return (int)cudaGetLastError();
}

}  // namespace

// dtypes 0 = float32, 1 = bfloat16: ab_dtype for a, b and h, h_dtype for
// h0 and hT; a, b, h [B, T, W] and h0, hT [B, W] contiguous
extern "C" int repro_rglru_scan(const void* a, const void* b, const void* h0,
                                void* h, void* hT, int B, int Tn, int W,
                                int ab_dtype, int h_dtype, void* stream) {
  if (B <= 0 || B > 65535 || Tn < 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ab_dtype == 0 && h_dtype == 0)
    return launch<float, float>(a, b, h0, h, hT, B, Tn, W, s);
  if (ab_dtype == 0 && h_dtype == 1)
    return launch<float, __nv_bfloat16>(a, b, h0, h, hT, B, Tn, W, s);
  if (ab_dtype == 1 && h_dtype == 0)
    return launch<__nv_bfloat16, float>(a, b, h0, h, hT, B, Tn, W, s);
  if (ab_dtype == 1 && h_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, b, h0, h, hT, B, Tn, W, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
