// Backward of the RG-LRU linear recurrence (csrc/rglru_scan.cu), for
// sm_90a.
//
// No Pallas kernel computes it: the reference differentiates its
// jax.lax.associative_scan with XLA (src/repro/models/recurrent.py:64-77).
// For h_t = a_t h_{t-1} + b_t over t = 0 .. T-1 from h_{-1} = h0, with the
// gradients dh [B, T, W] of every h_t and dhT [B, W] of the last state
// (none: zeros), the adjoint runs the same recurrence backwards in time,
// per channel:
//
//   lambda_{T-1} = dh[T-1] + dhT
//   lambda_t     = fma(a[t+1], lambda_{t+1}, dh[t])   (rounded once)
//   db[t] = lambda_t,  da[t] = lambda_t h[t-1]  (h[-1] = h0),
//   dh0   = a[0] lambda_0                        (dhT when T = 0)
//
// float32 math from float32 or bfloat16 a, h and dh; da and db in a's
// dtype, dh0 in h0's.  Each step is __fmaf_rn, as the plain version's
// fma_f32 rounds it, and the order is the plain version's, so a launch
// equals rglru_bwd_ref bitwise, as the forward equals rglru_ref.
//
// Bound: bytes.  One read of a, h and dh and one write of da and db: at
// recurrentgemma-9b's training call (B 1, T 4,096, W 4,096, float32)
// 5 x 4 x 16.8 M = 335.5 MB, 0.100 ms at 3.35 TB/s, against 3 flops an
// element.
//
// Design: the forward's SIMT route run backwards.  One thread per (b, w)
// channel carries lambda in a register down the whole T loop;
// neighbouring threads take neighbouring w, so every load and store of a
// step is one coalesced 128-byte row a warp; each iteration issues a
// chunk of U steps' loads (a[t+1], dh[t], h[t-1]) before it runs that
// chunk's dependent chain.  Blocks of one warp spread a batch of one
// sequence over 128 SMs at W 4,096.  The forward's TMA ring run in
// reverse is a later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32, U = 32;

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
rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                 const H* __restrict__ h0, const T* __restrict__ dh,
                 const H* __restrict__ dhT, T* __restrict__ da,
                 T* __restrict__ db, H* __restrict__ dh0, int Tn, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long long bi = blockIdx.y;
  const long long base = bi * Tn * W + w;
  const float last = dhT ? to_f(dhT[bi * W + w]) : 0.0f;
  const float first = to_f(h0[bi * W + w]);
  float lam = 0.0f;
  for (int t1 = Tn - 1; t1 >= 0; t1 -= U) {
    float an[U], gv[U], hp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        const long long off = base + (long long)t * W;
        gv[u] = to_f(dh[off]);
        an[u] = t + 1 < Tn ? to_f(a[off + W]) : 0.0f;
        hp[u] = t > 0 ? to_f(h[off - W]) : first;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        const long long off = base + (long long)t * W;
        lam = t + 1 == Tn ? gv[u] + last : __fmaf_rn(an[u], lam, gv[u]);
        store1(db + off, lam);
        store1(da + off, __fmul_rn(lam, hp[u]));
      }
    }
  }
  store1(dh0 + bi * W + w,
         Tn > 0 ? __fmul_rn(to_f(a[base]), lam) : last);
}

template <typename T, typename H>
int launch(const void* a, const void* h, const void* h0, const void* dh,
           const void* dhT, void* da, void* db, void* dh0, int B, int Tn,
           int W, cudaStream_t stream) {
  const dim3 grid((unsigned)((W + THREADS - 1) / THREADS), (unsigned)B);
  rglru_bwd_kernel<T, H><<<grid, THREADS, 0, stream>>>(
      (const T*)a, (const T*)h, (const H*)h0, (const T*)dh, (const H*)dhT,
      (T*)da, (T*)db, (H*)dh0, Tn, W);
  return (int)cudaGetLastError();
}

}  // namespace

// dtypes 0 = float32, 1 = bfloat16: ab_dtype for a, h, dh, da and db,
// h_dtype for h0, dhT and dh0; a, h, dh, da, db [B, T, W] and h0, dhT,
// dh0 [B, W] contiguous; dhT may be null (zeros).  *route is set to the
// route launched: 0 = simt.
extern "C" int repro_rglru_scan_bwd(const void* a, const void* h,
                                    const void* h0, const void* dh,
                                    const void* dhT, void* da, void* db,
                                    void* dh0, int B, int Tn, int W,
                                    int ab_dtype, int h_dtype, void* stream,
                                    int* route) {
  if (B <= 0 || B > 65535 || Tn < 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  *route = 0;
  if (ab_dtype == 0 && h_dtype == 0)
    return launch<float, float>(a, h, h0, dh, dhT, da, db, dh0, B, Tn, W, s);
  if (ab_dtype == 0 && h_dtype == 1)
    return launch<float, __nv_bfloat16>(a, h, h0, dh, dhT, da, db, dh0, B,
                                        Tn, W, s);
  if (ab_dtype == 1 && h_dtype == 0)
    return launch<__nv_bfloat16, float>(a, h, h0, dh, dhT, da, db, dh0, B,
                                        Tn, W, s);
  if (ab_dtype == 1 && h_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, h, h0, dh, dhT, da, db,
                                                dh0, B, Tn, W, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
