// Grouped expert GEMM of the MoE layer, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/moe_matmul/moe_matmul.py
// (`moe_matmul`): y[e] = x[e] @ w[e] for the capacity-dispatched buffer
// x [E, C, D] against the per-expert weights w [E, D, F], y [E, C, F];
// float32 or bfloat16 operands, float32 accumulation, the output in the
// operands' dtype (the reference's moe_matmul_ref: an fp32 einsum cast
// back).
//
// Bound: at olmoe-1b-7b's prefill (E 64, C 1144 slots, D 2048, F 1024)
// operations: 2 E C D F = 307 GFLOP on 0.72 GB; at its decode (C = 8
// rows, one slot per sequence) bytes: the weights, 268 MB in bfloat16 per
// GEMM, against 2 GFLOP.
//
// Routes, chosen by the launcher and reported to the wrapper:
//
// * wgmma (bfloat16 with D and F multiples of 8: TMA's strides must be
//   multiples of 16 bytes; the wrapper refuses such operands whose data
//   is not 16-byte aligned).  Operands
//   come in by TMA through 3D tensor maps over x [E, C, D] and w [E, D, F]
//   with 128-byte swizzle; out-of-bounds rows and columns of a box read as
//   zeros, so ragged C, D and F need no padded copy and a box never spills
//   into the next expert.  One producer thread keeps a ring of stages
//   full (an mbarrier pair per stage); consumer warpgroups multiply with
//   wgmma into fp32 registers, each wgmma group overlapping the next
//   stage's wait, and store bf16 outputs masked at C and F.  The D
//   reduction has one fixed order and no split-K, so two launches are
//   bitwise equal.  Two tile shapes, chosen from C:
//     - C > 16 (prefill): csrc/moe_gemm.cuh's Narrow tile (the template
//       the backward instantiates too): a 128 x 128 output tile of one
//       expert per block, two consumer warpgroups of 64 rows each, K steps
//       of 64 through a 5-stage ring (x box [1, 128, 64] K-major, w box
//       [1, 64, 64] twice, MN-major: F is w's contiguous axis and wgmma
//       transposes bf16 B);
//     - C <= 16 (decode): y[e]^T = w[e]^T x[e]^T, so F is wgmma's M (64 a
//       block) and C its N (8 or 16): every MMA row is real and the
//       weights stream through an 8-stage ring, 2 blocks an SM, ~160 KB
//       of loads in flight per SM against the weight-byte bound.
// * simt (float32, and bfloat16 with D or F not a multiple of 8).  The first
//   port's kernel, unchanged: a shared-memory tiled SIMT GEMM with a grid axis
//   over the experts, each block walking the whole D axis for a BM x BN
//   tile, fp32 fmaf products (wgmma has no fp32 input, and TF32 would
//   break the float32 tolerance), 64 x 64 tiles for C > 16 and 16 x 64
//   for C <= 16 (each weight read once), masked ragged edges, one fixed
//   D order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "moe_gemm.cuh"

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

// ---------------------------------------------------------------------------
// wgmma route (bfloat16)
// ---------------------------------------------------------------------------

using hopper::desc;
using moe_gemm::BOX_BYTES;
using moe_gemm::KSTEP;
using moe_gemm::ROW_BYTES;

// decode tile: y[e]^T [64 f, CN c] = w[e]^T x[e]^T, one consumer
// warpgroup, one producer warp
constexpr int DF = 64, D_STAGES = 8;
constexpr int D_THREADS = 128 + 32;
constexpr int DW_BYTES = BOX_BYTES;                  // w box [64 d, 64 f]
constexpr int D_STAGE = DW_BYTES + 16 * ROW_BYTES;   // + x box [<=16 c, 64 d]
constexpr int D_SMEM = 1024 + D_STAGES * D_STAGE + 2 * D_STAGES * 8;

template <int CN>
__global__ void __launch_bounds__(D_THREADS, 2)
moe_decode_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  __nv_bfloat16* __restrict__ y, int C, int D, int F) {
  static_assert(CN == 8 || CN == 16, "decode N is 8 or 16");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + D_STAGES * D_STAGE);
  uint64_t* empty = full + D_STAGES;

  const int f0 = blockIdx.x * DF, e = blockIdx.y;
  const int nk = (D + KSTEP - 1) / KSTEP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr uint32_t STAGE_TX = DW_BYTES + CN * ROW_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {                           // producer
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % D_STAGES;
        uint8_t* st = ring + s * D_STAGE;
        hopper::mbar_wait(&empty[s], ((kt / D_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], STAGE_TX);
        hopper::tma_load_3d(st, &tw, &full[s], f0, kt * KSTEP, e);
        hopper::tma_load_3d(st + DW_BYTES, &tx, &full[s], kt * KSTEP, 0, e);
      }
    }
    return;
  }

  float acc[CN / 2];
#pragma unroll
  for (int i = 0; i < CN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % D_STAGES;
    const uint8_t* st = ring + s * D_STAGE;
    hopper::mbar_wait(&full[s], (kt / D_STAGES) & 1);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEP / 16; ++kk)
      hopper::wgmma_ss<1, 0>(acc,
                             desc<128>(st + kk * 16 * ROW_BYTES, BOX_BYTES,
                                       1024),
                             desc<128>(st + DW_BYTES + kk * 32, 16, 1024),
                             1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (kt > 0 && threadIdx.x == 0)
      hopper::mbar_arrive(&empty[(kt - 1) % D_STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // acc element (row f, column c) is y[e][c][f]
  const int f = f0 + 16 * warp + lane / 4;
  __nv_bfloat16* ye = y + (long long)e * C * F;
#pragma unroll
  for (int j = 0; j < CN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 8 * j + 2 * (lane % 4) + (i & 1);
      const int fr = f + 8 * (i >> 1);
      if (c < C && fr < F)
        ye[(long long)c * F + fr] = __float2bfloat16_rn(acc[4 * j + i]);
    }
}

int launch_wgmma(const void* x, const void* w, void* y, int E, int C, int D,
                 int F, cudaStream_t stream) {
  __nv_bfloat16* out = (__nv_bfloat16*)y;
  // prefill: the shared tile, y = x w with x K-major and w MN-major
  if (C > SKINNY_MAX_C)
    return moe_gemm::launch<0, 1, moe_gemm::Narrow>(x, w, out, E, C, F, D,
                                                    stream);
  const int CN = C <= 8 ? 8 : 16;
  // x [E, C, D] and w [E, D, F], innermost first
  const uint64_t xd[3] = {(uint64_t)D, (uint64_t)C, (uint64_t)E};
  const uint64_t xs[2] = {(uint64_t)D * 2, (uint64_t)C * D * 2};
  const uint64_t wd[3] = {(uint64_t)F, (uint64_t)D, (uint64_t)E};
  const uint64_t ws[2] = {(uint64_t)F * 2, (uint64_t)D * F * 2};
  const uint32_t xbox[3] = {KSTEP, (uint32_t)CN, 1};
  const uint32_t wbox[3] = {64, KSTEP, 1};
  CUtensorMap tx, tw;
  int err = hopper::encode_bf16(&tx, 3, x, xd, xs, xbox, 128);
  if (!err) err = hopper::encode_bf16(&tw, 3, w, wd, ws, wbox, 128);
  if (err) return err;
  auto kern = CN == 8 ? moe_decode_kernel<8> : moe_decode_kernel<16>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, D_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((F + DF - 1) / DF), (unsigned)E);
  kern<<<grid, D_THREADS, D_SMEM, stream>>>(tx, tw, out, C, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; x [E, C, D], w [E, D, F] and y [E, C, F]
// contiguous, all of one dtype.  *route is set to the route launched:
// 1 = wgmma, 0 = simt.
extern "C" int repro_moe_matmul(const void* x, const void* w, void* y, int E,
                                int C, int D, int F, int dtype, void* stream,
                                int* route) {
  if (E <= 0 || C <= 0 || D < 0 || F <= 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  *route = 0;
  if (dtype == 0) return dispatch_c<float>(x, w, y, E, C, D, F, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!moe_gemm::wgmma_takes(D, F))
    return dispatch_c<__nv_bfloat16>(x, w, y, E, C, D, F, s);
  *route = 1;
  return launch_wgmma(x, w, y, E, C, D, F, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
