// GEMM with fused bias and ReLU, the compute of one im2col convolution
// layer, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/conv2d/conv2d.py
// (`matmul_bias_act`): y = x[M, K] @ w[K, N] + b[N], then max(y, 0) when
// relu, with float32 operands and float32-accurate products.  The
// convolution wrapper (repro_torch/kernels/conv2d/ops.py) lays the patches
// out as x in (KH, KW, C) feature order, padded with zero features to a
// multiple of 4, and reshapes the HWIO filter to w.
//
// Bound: operations.  At the CNN path's shapes (AlexNet's five conv
// layers at a batch of 32) a layer does 2 M N K = 6.8 to 28.7 GFLOP on
// 20 to 250 MB, some 100 flops per byte.  In fp32 outside the tensor cores
// (67 TFLOP/s) conv2 takes at least 427.8 us; as 3xTF32 on the tensor
// cores (3 products at 495 TFLOP/s dense TF32) at least 173.8 us.
//
// Routes, chosen by the wrapper from the shape and passed in:
//
// * wgmma (K a multiple of 4, so TMA's row stride is a multiple of 16
//   bytes; the wrapper refuses an x whose data is off 16 bytes): 3xTF32.
//   A float32 value a is split into a_hi = tf32(a) (cvt.rna) and a_lo =
//   tf32(a - a_hi); a b = a_lo b_hi + a_hi b_lo + a_hi b_hi (the lo lo term
//   is below float32's rounding) is accumulated in float32 registers by
//   `wgmma m64nNk8.f32.tf32.tf32`, which reads both operands K-major.
//   - A pre-pass kernel (split_w_kernel) writes w^T split into w_hi and
//     w_lo [N, K] into scratch the wrapper allocates.
//   - The main kernel (wgmma_gemm_kernel) takes a 128 x NT output tile
//     (NT 64, 96 or 128: the wrapper's `conv_tile_n`); one producer warp
//     keeps a 4-stage ring full by TMA (x box [128 rows, 32 floats],
//     w_hi and w_lo boxes [NT rows, 32 floats], 128-byte swizzle; zero
//     fill past M, N and K, so ragged shapes need no padded copy); two
//     consumer warpgroups of 64 rows each.
//   - x is split by the consumers in shared memory: each warpgroup reads
//     its 64 rows of the stage, writes a_hi over them in place and a_lo
//     into its own buffer (two per warpgroup, alternating by stage) at the
//     same byte offsets, so the swizzled layout carries over unchanged;
//     fence.proxy.async and a warpgroup barrier hand both to wgmma.  Per
//     k8 step the three products are issued lo.hi, hi.lo, then hi.hi; a
//     stage's wgmma group overlaps the next stage's wait and split.
//   - The epilogue adds the bias, then applies ReLU, in the reference's
//     order (NaN passes, as max).  Tiles are ordered N fastest, so the
//     tiles sharing an x row block run together and x streams from HBM
//     about once.
// * simt (K not a multiple of 4): the first port's kernel.  A
//   shared-memory tiled SIMT GEMM: each 256-thread block owns a 64 x 64
//   output tile and walks the whole K axis itself in steps of 16 (the
//   Pallas grid's sequential k axis with its VMEM accumulator becomes a
//   register accumulator); each thread holds a 4 x 4 register tile of
//   fp32 fmaf products.  The x tile is stored transposed in shared memory
//   (k-major, rows padded by 4 floats) so both operands are read as float4
//   along the tile edge; ragged edges are masked.
//
// Neither route splits K: each has one fixed K order, so a launch is
// deterministic.  Measured on an H100 SXM (PERF.md section 6): conv2 at
// 32 images in about 0.28 ms on the wgmma route, 1.6x its 3xTF32 bound
// and 2.4x faster than torch.addmm's float32, from 1.28 ms on the SIMT
// route.
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// wgmma route: 3xTF32
// ---------------------------------------------------------------------------

using hopper::desc;

// w [K, N] -> w_hi, w_lo [N, K] (tf32 patterns), through a 32 x 32 tile
__global__ void __launch_bounds__(256)
split_w_kernel(const float* __restrict__ w, float* __restrict__ w_hi,
               float* __restrict__ w_lo, int K, int N) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    t[i][tx] = (k < K && n < N) ? w[(long long)k * N + n] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n < N && k < K) {
      const float a = t[tx][i];
      const uint32_t hi = hopper::tf32_rna(a);
      w_hi[(long long)n * K + k] = __uint_as_float(hi);
      w_lo[(long long)n * K + k] =
          __uint_as_float(hopper::tf32_rna(a - __uint_as_float(hi)));
    }
  }
}

constexpr int KS = 32;                       // floats of K a stage: 128 B
constexpr int ROW_BYTES = KS * 4;
constexpr int GM_ROWS = 128, G_STAGES = 4;
constexpr int G_THREADS = 2 * 128 + 32;
constexpr int A_BYTES = GM_ROWS * ROW_BYTES;        // x box [128, 32]
constexpr int WG_BYTES = 64 * ROW_BYTES;            // a warpgroup's rows

template <int NT>
struct GemmTile {
  static constexpr int B_BYTES = NT * ROW_BYTES;    // w box [NT, 32]
  static constexpr int STAGE = A_BYTES + 2 * B_BYTES;
  static constexpr int LO = G_STAGES * STAGE;       // offset of a_lo buffers
  static constexpr int SMEM = 1024 + LO + 2 * 2 * WG_BYTES +
                              2 * G_STAGES * 8;
};

template <int NT>
__global__ void __launch_bounds__(G_THREADS, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap twh,
                   const __grid_constant__ CUtensorMap twl,
                   const float* __restrict__ b, float* __restrict__ y, int M,
                   int N, int K, int relu) {
  using Tl = GemmTile<NT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tl::LO +
                                               2 * 2 * WG_BYTES);
  uint64_t* empty = full + G_STAGES;

  const int tiles_n = (N + NT - 1) / NT;
  const int n0 = (blockIdx.x % tiles_n) * NT;
  const int m0 = (blockIdx.x / tiles_n) * GM_ROWS;
  const int nk = (K + KS - 1) / KS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);       // one arrival per warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {                           // producer
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % G_STAGES;
        uint8_t* st = ring + s * Tl::STAGE;
        hopper::mbar_wait(&empty[s], ((kt / G_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], Tl::STAGE);
        hopper::tma_load_2d(st, &tx, &full[s], kt * KS, m0);
        hopper::tma_load_2d(st + A_BYTES, &twh, &full[s], kt * KS, n0);
        hopper::tma_load_2d(st + A_BYTES + Tl::B_BYTES, &twl, &full[s],
                            kt * KS, n0);
      }
    }
    return;
  }

  const int wg = warp / 4, t128 = threadIdx.x % 128;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % G_STAGES;
    uint8_t* st = ring + s * Tl::STAGE;
    uint8_t* a_hi = st + wg * WG_BYTES;
    uint8_t* a_lo = ring + Tl::LO + (wg * 2 + (kt & 1)) * WG_BYTES;
    hopper::mbar_wait(&full[s], (kt / G_STAGES) & 1);
    // split this warpgroup's rows: hi in place, lo beside (the lo buffer
    // was last read by stage kt - 2's products, finished below)
#pragma unroll
    for (int i = 0; i < WG_BYTES / 16 / 128; ++i) {
      float4* src = reinterpret_cast<float4*>(a_hi) + t128 + 128 * i;
      const float4 v = *src;
      const float a[4] = {v.x, v.y, v.z, v.w};
      float h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = __uint_as_float(hopper::tf32_rna(a[e]));
        l[e] = __uint_as_float(hopper::tf32_rna(a[e] - h[e]));
      }
      *src = make_float4(h[0], h[1], h[2], h[3]);
      reinterpret_cast<float4*>(a_lo)[t128 + 128 * i] =
          make_float4(l[0], l[1], l[2], l[3]);
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
    const uint8_t* bh = st + A_BYTES;
    const uint8_t* bl = bh + Tl::B_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS / 8; ++kk) {
      const uint64_t dah = desc<128>(a_hi + kk * 32, 16, 1024);
      const uint64_t dal = desc<128>(a_lo + kk * 32, 16, 1024);
      const uint64_t dbh = desc<128>(bh + kk * 32, 16, 1024);
      const uint64_t dbl = desc<128>(bl + kk * 32, 16, 1024);
      hopper::wgmma_tf32<NT>(acc, dal, dbh);
      hopper::wgmma_tf32<NT>(acc, dah, dbl);
      hopper::wgmma_tf32<NT>(acc, dah, dbh);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();                 // stage kt - 1 has finished
    hopper::fence_regs(acc);
    if (kt > 0 && t128 == 0)
      hopper::mbar_arrive(&empty[(kt - 1) % G_STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // epilogue: bias, then ReLU, in the reference's order
  const int r = m0 + wg * 64 + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * j + 2 * (lane % 4) + e;
      if (col >= N) continue;
      const float bias = b[col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        if (row >= M) continue;
        float v = __fadd_rn(acc[4 * j + 2 * h + e], bias);
        if (relu && v < 0.0f) v = 0.0f;            // NaN passes, as max
        y[(long long)row * N + col] = v;
      }
    }
  }
}

template <int NT>
int launch_3xtf32(const float* x, const float* w, const float* b, float* y,
                  int M, int N, int K, int relu, float* w_hi, float* w_lo,
                  cudaStream_t stream) {
  split_w_kernel<<<dim3((unsigned)((K + 31) / 32), (unsigned)((N + 31) / 32)),
                   256, 0, stream>>>(w, w_hi, w_lo, K, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // x [M, K], w_hi / w_lo [N, K], innermost first
  const uint64_t xd[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t wd[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t rs[1] = {(uint64_t)K * 4};
  const uint32_t xbox[2] = {KS, GM_ROWS};
  const uint32_t wbox[2] = {KS, NT};
  CUtensorMap tx, twh, twl;
  int err = hopper::encode_f32(&tx, 2, x, xd, rs, xbox, 128);
  if (!err) err = hopper::encode_f32(&twh, 2, w_hi, wd, rs, wbox, 128);
  if (!err) err = hopper::encode_f32(&twl, 2, w_lo, wd, rs, wbox, 128);
  if (err) return err;
  auto kern = wgmma_gemm_kernel<NT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           GemmTile<NT>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((N + NT - 1) / NT) *
                          ((M + GM_ROWS - 1) / GM_ROWS);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)tiles, G_THREADS, GemmTile<NT>::SMEM, stream>>>(
      tx, twh, twl, b, y, M, N, K, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K], w [K, N], b [N], y [M, N] contiguous float32.  route 1 =
// wgmma (K % 4 == 0, x 16-byte aligned; tile_n 64, 96 or 128; w_hi and
// w_lo scratch of N K floats each; two launches), 0 = simt (one launch).
extern "C" int repro_matmul_bias_act(const void* x, const void* w,
                                     const void* b, void* y, int M, int N,
                                     int K, int relu, int route, int tile_n,
                                     void* w_hi, void* w_lo, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (K == 0 || K % 4) return (int)cudaErrorInvalidValue;
    const float *xf = (const float*)x, *wf = (const float*)w;
    const float* bf = (const float*)b;
    float *yf = (float*)y, *wh = (float*)w_hi, *wl = (float*)w_lo;
    switch (tile_n) {
      case 64: return launch_3xtf32<64>(xf, wf, bf, yf, M, N, K, relu, wh, wl, s);
      case 96: return launch_3xtf32<96>(xf, wf, bf, yf, M, N, K, relu, wh, wl, s);
      case 128: return launch_3xtf32<128>(xf, wf, bf, yf, M, N, K, relu, wh, wl, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  const unsigned gm = (unsigned)((M + BM - 1) / BM);
  const unsigned gn = (unsigned)((N + BN - 1) / BN);
  matmul_bias_act_kernel<<<dim3(gm, gn), THREADS, 0, s>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)y, M, N, K,
      relu);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
