// Backward of the grouped expert GEMM (csrc/moe_matmul.cu), for sm_90a.
//
// No Pallas kernel computes it: the reference differentiates its
// jnp.einsum("becd,edf->becf") with XLA (src/repro/models/moe.py:82-86),
// which transposes the operands into two more batched products.  For
// y[e] = x[e] @ w[e] (x [E, C, D], w [E, D, F], y [E, C, F]) and the
// output's gradient dy [E, C, F]:
//
// * dX (repro_moe_matmul_dx): dx[e] = dy[e] @ w[e]^T, [E, C, D], a
//   reduction over F, with w read in place (its rows are the reduction
//   axis: no transposed copy);
// * dW (repro_moe_matmul_dw): dw[e] = x[e]^T @ dy[e], [E, D, F], a
//   reduction over the C slots of the dispatch buffer (B x cap: 1,280 a
//   4,096-token sequence at granite-moe-1b-a400m's top 8 of 32 and
//   capacity factor 1.25).
//
// float32 or bfloat16 operands, float32 accumulation, the output in the
// operands' dtype (the reference's f32 einsum cast back).
//
// Bound: bytes.  At granite-moe's training shape (E 32, C 1,280, D 1,024,
// F 512, bf16) either product reads two operands and writes one, 159.4 MB
// at 3.35 TB/s: 47.6 us, against 2 E C D F = 42.9 GFLOP, 43.4 us at 989
// TFLOP/s.
//
// Routes, chosen by the launcher and reported to the wrapper, by the
// forward's rule (moe_gemm::wgmma_takes):
//
// * wgmma (bfloat16 with D and F multiples of 8: TMA's strides must be
//   multiples of 16 bytes; the wrapper refuses such operands whose data
//   is not 16-byte aligned).  The forward's tile (csrc/moe_gemm.cuh: an
//   output tile of one expert a block, a producer warp feeding a TMA
//   ring, two consumer warpgroups on wgmma, fp32 accumulators, bf16
//   stores masked at M and N) with other operand majorness, so each
//   operand is read by TMA in the layout the forward left it in: dX =
//   dY W^T is tile_kernel<0, 0> (dY [C, F] and W [D, F] both K-major: F
//   contiguous), dW = X^T dY is tile_kernel<1, 1> (X [C, D] and dY
//   [C, F] both MN-major: C is the reduction axis, each read in [64 c,
//   64] boxes).  Out-of-bounds rows and columns read as zeros: ragged C,
//   D and F need no padded copy.  Both take the header's Wide tile: 128
//   x 256 outputs through a 4-stage ring of 48 KB, stored by TMA from
//   the freed ring.
// * simt (float32, and bfloat16 with D or F not a multiple of 8).  The
//   forward's SIMT route (a shared-memory tiled GEMM, one block a 64 x 64
//   output tile of one expert, the grid's z axis over the experts, fp32
//   fmaf products) with the operands' majorness a template parameter.  A
//   tile of A (m, k) comes from a [M, K] array (dY for dX: k runs along a
//   row) or a [K, M] array (X for dW: m runs along a row); a tile of B
//   (k, n) from a [K, N] array (dY for dW) or a [N, K] array (W for dX).
//   Neighbouring threads read neighbouring elements of a row either way,
//   and a tile that comes in transposed lands in a padded shared array.
//
// Both routes: every output element sums its K products in one fixed
// order, with no atomics and no split-K, so every launch is bitwise the
// last, and K = 0 (C 0 for dW) writes zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "moe_gemm.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);
constexpr int PAD = 4;       // breaks the bank pattern of transposed stores

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// out[e] (M x N, row-major) = A[e] (M x K) @ B[e] (K x N).  A_KMAJOR: A is
// held as [M, K] (else [K, M]); B_KMAJOR: B is held as [N, K] (else
// [K, N]).
template <typename T, bool A_KMAJOR, bool B_KMAJOR>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ out, int M, int N, int K) {
  static_assert(BM * BK % THREADS == 0 && BK * BN % THREADS == 0,
                "tile loads must split evenly over the block");
  __shared__ __align__(16) float As[BK][BM + PAD];   // k-major
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const long long e = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const T* ae = a + e * M * K;
  const T* be = b + e * K * N;
  T* oe = out + e * M * N;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      if (A_KMAJOR) {                  // [M, K]: neighbours walk k
        const int r = idx / BK, c = idx % BK;
        const int gm = m0 + r, gk = k0 + c;
        As[c][r] = (gm < M && gk < K) ? to_f(ae[(long long)gm * K + gk])
                                      : 0.0f;
      } else {                         // [K, M]: neighbours walk m
        const int r = idx / BM, c = idx % BM;
        const int gk = k0 + r, gm = m0 + c;
        As[r][c] = (gm < M && gk < K) ? to_f(ae[(long long)gk * M + gm])
                                      : 0.0f;
      }
    }
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      if (B_KMAJOR) {                  // [N, K]: neighbours walk k
        const int r = idx / BK, c = idx % BK;
        const int gn = n0 + r, gk = k0 + c;
        Bs[c][r] = (gn < N && gk < K) ? to_f(be[(long long)gn * K + gk])
                                      : 0.0f;
      } else {                         // [K, N]: neighbours walk n
        const int r = idx / BN, c = idx % BN;
        const int gk = k0 + r, gn = n0 + c;
        Bs[r][c] = (gn < N && gk < K) ? to_f(be[(long long)gk * N + gn])
                                      : 0.0f;
      }
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
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) store1(oe + (long long)gm * N + gn, acc[i][j]);
    }
  }
}

template <typename T, bool A_KMAJOR, bool B_KMAJOR>
int launch(const void* a, const void* b, void* out, int E, int M, int N,
           int K, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                  (unsigned)E);
  grouped_gemm_kernel<T, A_KMAJOR, B_KMAJOR><<<grid, THREADS, 0, stream>>>(
      (const T*)a, (const T*)b, (T*)out, M, N, K);
  return (int)cudaGetLastError();
}

bool bad_shape(int E, int C, int D, int F, int dtype) {
  return E <= 0 || E > 65535 || C < 0 || D < 0 || F < 0 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dx [E, C, D] = dy [E, C, F] @ w [E, D, F]^T.  dtype 0 = float32,
// 1 = bfloat16; every array contiguous and of that dtype.  *route is set
// to the route launched: 1 = wgmma, 0 = simt.
extern "C" int repro_moe_matmul_dx(const void* dy, const void* w, void* dx,
                                   int E, int C, int D, int F, int dtype,
                                   void* stream, int* route) {
  if (bad_shape(E, C, D, F, dtype) || C == 0 || D == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  *route = 0;
  // M = C, N = D, K = F: dy is [M, K], w is [N, K]
  if (dtype == 0) return launch<float, true, true>(dy, w, dx, E, C, D, F, s);
  if (!moe_gemm::wgmma_takes(D, F))
    return launch<__nv_bfloat16, true, true>(dy, w, dx, E, C, D, F, s);
  *route = 1;
  return moe_gemm::launch<0, 0, moe_gemm::Wide>(
      dy, w, (__nv_bfloat16*)dx, E, C, D, F, s);
}

// dw [E, D, F] = x [E, C, D]^T @ dy [E, C, F]; C may be 0 (zeros).
extern "C" int repro_moe_matmul_dw(const void* x, const void* dy, void* dw,
                                   int E, int C, int D, int F, int dtype,
                                   void* stream, int* route) {
  if (bad_shape(E, C, D, F, dtype) || D == 0 || F == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  *route = 0;
  // M = D, N = F, K = C: x is [K, M], dy is [K, N]
  if (dtype == 0) return launch<float, false, false>(x, dy, dw, E, D, F, C, s);
  if (!moe_gemm::wgmma_takes(D, F))
    return launch<__nv_bfloat16, false, false>(x, dy, dw, E, D, F, C, s);
  *route = 1;
  return moe_gemm::launch<1, 1, moe_gemm::Wide>(
      x, dy, (__nv_bfloat16*)dw, E, D, F, C, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
