// GEMM with fused bias and ReLU, the compute of one im2col convolution
// layer, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/conv2d/conv2d.py
// (`matmul_bias_act`): y = x[M, K] @ w[K, N] + b[N], then max(y, 0) when
// relu, with float32 operands and float32 accumulation.  The convolution
// wrapper (repro_torch/kernels/conv2d/ops.py) lays the patches out as x
// in (KH, KW, C) feature order and reshapes the HWIO filter to w.
//
// Bound: operations.  At the CNN path's shapes (AlexNet's five conv
// layers at a batch of 32) a layer does 2 M N K = 6.8 to 28.7 GFLOP on
// 20 to 250 MB, some 100 flops per byte; at the H100's 67 TFLOP/s of
// float32 outside the tensor cores and 3.35 TB/s the operations take four
// to six times as long as the bytes.
//
// Design: a shared-memory tiled SIMT GEMM.  Each 256-thread block owns a
// 64 x 64 output tile and walks the whole K axis itself in steps of 16
// (the Pallas grid's sequential k axis with its VMEM accumulator becomes a
// register accumulator); each thread holds a 4 x 4 register tile.  The x
// tile is stored transposed in shared memory (k-major, rows padded by 4
// floats) so that both operands are read as float4 along the tile edge.
// Ragged edges are masked: out-of-range loads put 0 into shared memory and
// out-of-range outputs are not stored, so no padded copy is made.  The K
// reduction has one fixed order and no split-K, so a launch is
// deterministic.  No tensor cores and no TF32: every product is an fp32
// fmaf, as the reference multiplies in float32.  wgmma/TMA come later.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int APAD = 4;                          // keeps float4 alignment

__global__ void __launch_bounds__(THREADS)
matmul_bias_act_kernel(const float* __restrict__ x,   // [M, K]
                       const float* __restrict__ w,   // [K, N]
                       const float* __restrict__ b,   // [N]
                       float* __restrict__ y,         // [M, N]
                       int M, int N, int K, int relu) {
  __shared__ __align__(16) float As[BK][BM + APAD];   // x tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);       // column group: 4 outputs
  const int ty = tid / (BN / TN);       // row group: 4 outputs
  const long long m0 = (long long)blockIdx.x * BM;
  const long long n0 = (long long)blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile [BM, BK]: neighbouring threads read neighbouring k of a row
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK, c = idx % BK;
      const long long gm = m0 + r;
      const int gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[gm * K + gk] : 0.0f;
    }
    // w tile [BK, BN]: neighbouring threads read neighbouring n of a row
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r;
      const long long gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? w[(long long)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 v = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: bias, then ReLU, in the reference's order
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long gn = n0 + tx * TN + j;
      if (gn >= N) continue;
      float v = __fadd_rn(acc[i][j], b[gn]);
      if (relu && v < 0.0f) v = 0.0f;              // NaN passes, as max
      y[gm * N + gn] = v;
    }
  }
}

}  // namespace

extern "C" int repro_matmul_bias_act(const void* x, const void* w,
                                     const void* b, void* y, int M, int N,
                                     int K, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const unsigned gm = (unsigned)((M + BM - 1) / BM);
  const unsigned gn = (unsigned)((N + BN - 1) / BN);
  matmul_bias_act_kernel<<<dim3(gm, gn), THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)y, M, N, K,
      relu);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
