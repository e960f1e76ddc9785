// Grouped expert GEMM of the MoE layer, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/moe_matmul/moe_matmul.py
// (`moe_matmul`): y[e] = x[e] @ w[e] for the capacity-dispatched buffer
// x [E, C, D] against the per-expert weights w [E, D, F], y [E, C, F];
// float32 or bfloat16 operands, float32 accumulation, the output in the
// operands' dtype (the reference's moe_matmul_ref: an fp32 einsum cast
// back).
//
// Bound: at olmoe-1b-7b's prefill (E 64, C = 8 sequences x 240 slots,
// D 2048, F 1024) operations: 2 E C D F = 515 GFLOP on ~1 GB; at its
// decode (C = 8 rows, one slot per sequence) bytes: the weights, 268 MB
// in bfloat16 per GEMM, against 17 GFLOP.
//
// Design: a shared-memory tiled SIMT GEMM, conv2d.cu's tile with a third
// grid axis over the experts.  Each block owns a BM x BN output tile of
// one expert and walks the whole D axis itself in steps of BK (the Pallas
// grid's sequential contraction axis with its VMEM accumulator becomes a
// register accumulator); each thread holds a TM x TN register tile.
// Operands are widened to float32 as they are stored into shared memory
// (the x tile transposed, k-major, so both are read along the tile edge),
// and every product is an fp32 fmaf: no tensor cores, no TF32.  Two tile
// shapes, chosen by the launcher from C:
//   * C > 16 (prefill): 64 x 64 tiles, BK 16, 4 x 4 per thread;
//   * C <= 16 (decode): 16 x 64 tiles, BK 64, 4 x 1 per thread, so one
//     row of blocks covers all C rows and each weight is read from device
//     memory once; the tile's wasted rows cost arithmetic, not bytes.
// Ragged C, D and F are masked: out-of-range loads put 0 into shared
// memory, out-of-range outputs are not stored, so no padded copy is made.
// The D reduction has one fixed order and no split-K, so a launch is
// deterministic.  wgmma/TMA come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int APAD = 4;              // keeps the x tile's rows 16-byte aligned
constexpr int SKINNY_MAX_C = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
moe_matmul_kernel(const T* __restrict__ x,    // [E, C, D]
                  const T* __restrict__ w,    // [E, D, F]
                  T* __restrict__ y,          // [E, C, F]
                  int C, int D, int F) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  static_assert(BM * BK % THREADS == 0 && BK * BN % THREADS == 0,
                "tile loads must split evenly over the block");
  __shared__ __align__(16) float As[BK][BM + APAD];   // x tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);      // column group: TN outputs
  const int ty = tid / (BN / TN);      // row group: TM outputs
  const long long e = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const T* xe = x + e * C * D;
  const T* we = w + e * D * F;
  T* ye = y + e * C * F;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    // x tile [BM, BK]: neighbouring threads read neighbouring k of a row
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < C && gk < D) ? to_f(xe[(long long)gm * D + gk]) : 0.0f;
    }
    // w tile [BK, BN]: neighbouring threads read neighbouring n of a row
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < D && gn < F) ? to_f(we[(long long)gk * F + gn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < F) store1(ye + (long long)gm * F + gn, acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const void* x, const void* w, void* y, int E, int C, int D, int F,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((C + BM - 1) / BM), (unsigned)((F + BN - 1) / BN),
                  (unsigned)E);
  moe_matmul_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          (const T*)x, (const T*)w, (T*)y, C, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_c(const void* x, const void* w, void* y, int E, int C, int D,
               int F, cudaStream_t s) {
  if (C <= SKINNY_MAX_C) return launch<T, 16, 64, 64, 4, 1>(x, w, y, E, C, D, F, s);
  return launch<T, 64, 64, 16, 4, 4>(x, w, y, E, C, D, F, s);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; x [E, C, D], w [E, D, F] and y [E, C, F]
// contiguous, all of one dtype
extern "C" int repro_moe_matmul(const void* x, const void* w, void* y, int E,
                                int C, int D, int F, int dtype, void* stream) {
  if (E <= 0 || C <= 0 || D < 0 || F <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_c<float>(x, w, y, E, C, D, F, s);
  if (dtype == 1) return dispatch_c<__nv_bfloat16>(x, w, y, E, C, D, F, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
