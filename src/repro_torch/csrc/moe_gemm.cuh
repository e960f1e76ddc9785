// The bf16 wgmma + TMA tile of the grouped expert GEMM, shared by its
// forward (csrc/moe_matmul.cu) and backward (csrc/moe_matmul_bwd.cu), for
// sm_90a.
//
// out[e] [M, N] = A[e] [M, K] @ B[e] [K, N] for every expert e, bf16
// operands, fp32 accumulation in wgmma registers, bf16 outputs, in tiles
// of 128 x BN.  Each operand is read in the layout its caller holds it
// in; the template arguments TA, TB are wgmma's transpose flags:
//
//   TA = 0: A held [E, M, K] (K contiguous, K-major): one TMA box
//           [128 m, 64 k] a stage (the forward's x, dX's dY);
//   TA = 1: A held [E, K, M] (M contiguous, MN-major): two boxes
//           [64 k, 64 m] a stage, one a warpgroup (dW's X);
//   TB = 0: B held [E, N, K] (K contiguous, K-major): one box
//           [BN n, 64 k] (dX's W);
//   TB = 1: B held [E, K, N] (N contiguous, MN-major): BN / 64 boxes
//           [64 k, 64 n], LBO the stride between them (the forward's w,
//           dW's dY).
//
// So the forward is <0, 1> (y = x w), dX <0, 0> (dx = dy w^T) and dW
// <1, 1> (dw = x^T dy), each without a transposed copy.
//
// Design.  A block computes one 128 x BN output tile of one expert (the
// grid's z axis over the experts): two consumer warpgroups of 64 rows
// each and one producer warp whose lane 0 keeps a ring of K steps of 64
// (one 128-byte swizzle row) full by TMA, a full and an empty mbarrier a
// stage, one empty arrival a warpgroup.  The tensor maps are 3D over
// [E, ., .], so a box never spills into the next expert, and
// out-of-bounds rows and columns read as zeros: ragged M, N and K need no
// padded copy.  Each wgmma group overlaps the next stage's wait.  Every
// output sums its K in one fixed order (no split-K, no atomics), so two
// launches are bitwise equal, whatever the tile; K = 0 runs no ring step
// and writes zeros (its operands' tensor maps are never read and not
// encoded).  Two tile shapes:
//
//   Narrow (the forward): BN 128, 5 stages of 32 KB; each thread stores
//     its outputs as bf16 pairs, masked at M and N.
//   Wide (the backward): BN 256, 4 stages of 48 KB.  m64n256k16 reads A
//     once for twice the products of n128, and there are half as many
//     tiles to fill and drain.  The epilogue stages the tile in the freed
//     ring, 128-byte swizzled (conflict-free bf16-pair writes), and one
//     thread stores it by TMA, which clips rows and columns out of bounds:
//     at granite-moe's training shapes the threads' own stores took as
//     long as the mainloop (8,760-10,450 cycles a tile against 3,290-3,440
//     staged; scripts/probe_moe_gemm_tiles.py on an H100).
//
// TMA needs row strides that are multiples of 16 bytes and wgmma has no
// fp32 input, hence the route rule `wgmma_takes`: bf16 with D and F
// multiples of 8; the wrappers refuse such operands whose data is off 16
// bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace moe_gemm {

using hopper::desc;

constexpr int KSTEP = 64;                   // bf16 elements: one 128 B row
constexpr int ROW_BYTES = KSTEP * 2;
constexpr int BOX_BYTES = 64 * ROW_BYTES;   // a 64 x 64 bf16 box

constexpr int TM = 128;
constexpr int THREADS = 2 * 128 + 32;
constexpr int A_BYTES = TM * ROW_BYTES;     // [128 m, 64 k] or 2 x [64, 64]

// a tile shape: N width, ring depth, and whether the epilogue stages the
// tile in shared memory for a TMA store
template <int BN_, int STAGES_, bool STAGED_>
struct Tile {
  static constexpr int BN = BN_, STAGES = STAGES_;
  static constexpr bool STAGED = STAGED_;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int SMEM =
      1024 + STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8;
  static_assert(!STAGED || TM * BN * 2 <= STAGES * (A_BYTES + B_BYTES),
                "the staged tile fits in the ring");
};
using Narrow = Tile<128, 5, false>;
using Wide = Tile<256, 4, true>;

// the wgmma route takes bf16 with D, F multiples of 8 (TMA strides)
inline bool wgmma_takes(int D, int F) {
  return D > 0 && D % 8 == 0 && F % 8 == 0;
}

// wgmma descriptor of k16 step `kk` of an operand tile at `t`: K-major
// rows of 128 B advance 32 B; MN-major tiles advance 16 K-rows, their
// 64-wide column blocks BOX_BYTES apart
template <int T>
__device__ __forceinline__ uint64_t step_desc(const uint8_t* t, int kk) {
  return T ? desc<128>(t + kk * 16 * ROW_BYTES, BOX_BYTES, 1024)
           : desc<128>(t + kk * 32, 16, 1024);
}

// one stage's operand tile of width W (rows of M or N): a [W, 64 k] box
// (K-major) or W / 64 boxes [64 k, 64] side by side (MN-major), at tile
// row / column r0 and K step kt
template <int T, int W>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* m,
                                          uint64_t* bar, int r0, int kt,
                                          int e) {
  if (T) {
#pragma unroll
    for (int j = 0; j < W / 64; ++j)
      hopper::tma_load_3d(dst + j * BOX_BYTES, m, bar, r0 + 64 * j,
                          kt * KSTEP, e);
  } else {
    hopper::tma_load_3d(dst, m, bar, kt * KSTEP, r0, e);
  }
}

template <int TA, int TB, class Cfg>
__global__ void __launch_bounds__(THREADS, 1)
tile_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tc,
            __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  constexpr int BN = Cfg::BN, STAGES = Cfg::STAGES, B_BYTES = Cfg::B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = hopper::align1024(smem_raw);
  uint8_t* Bs = As + STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * B_BYTES);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int nk = (K + KSTEP - 1) / KSTEP;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);       // one arrival per warpgroup
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {                           // producer
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        hopper::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], A_BYTES + B_BYTES);
        load_tile<TA, TM>(As + s * A_BYTES, &ta, &full[s], m0, kt, e);
        load_tile<TB, BN>(Bs + s * B_BYTES, &tb, &full[s], n0, kt, e);
      }
    }
    return;
  }

  // warpgroup wg: rows 64 wg .. 64 wg + 63, the K-major box's rows or the
  // MN-major A's box wg (64 rows x 128 B either way)
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    hopper::mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint8_t* a = As + s * A_BYTES + wg * BOX_BYTES;
    const uint8_t* b = Bs + s * B_BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEP / 16; ++kk)
      hopper::wgmma_ss<TA, TB>(acc, step_desc<TA>(a, kk),
                               step_desc<TB>(b, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();                 // step kt - 1 has finished
    hopper::fence_regs(acc);
    if (kt > 0 && threadIdx.x % 128 == 0)
      hopper::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // this thread's outputs: tile row r (and r + 8), columns 8 j + 2 (lane
  // % 4) and the next
  const int w4 = warp % 4;
  const int r = wg * 64 + 16 * w4 + lane / 4;
  if (Cfg::STAGED) {
    // the ring is free once both warpgroups' products are done; the tile
    // goes in as BN / 64 blocks [128 rows, 128 B], swizzled as TMA reads
    // them
    hopper::named_barrier(1, 256);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t o =
            (r + 8 * h) * 128 + (8 * j + 2 * (lane % 4)) % 64 * 2;
        *reinterpret_cast<__nv_bfloat162*>(As + j / 8 * (TM * 128) +
                                           hopper::swizzle<128>(o)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    hopper::fence_proxy_async();
    hopper::named_barrier(1, 256);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        hopper::tma_store_3d(&tc, As + c * (TM * 128), n0 + 64 * c, m0, e);
      hopper::bulk_commit();
      hopper::bulk_wait_read();
    }
    return;
  }
  __nv_bfloat16* oe = out + (long long)e * M * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r + 8 * h;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(oe + (long long)row * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// The tensor map of `p` [E, rows, cols] (cols contiguous), read or written
// in boxes [box_rows, 64 cols] with the 128-byte swizzle.
inline int encode_3d(CUtensorMap* map, const void* p, int E, int rows,
                     int cols, int box_rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)E};
  const uint64_t strides[2] = {(uint64_t)cols * 2,
                               (uint64_t)rows * cols * 2};
  const uint32_t box[3] = {KSTEP, (uint32_t)box_rows, 1};
  return hopper::encode_bf16(map, 3, p, dims, strides, box, 128);
}

// An operand's map for transpose flag T and tile width W: a K-major
// operand is [E, MN, K], read in [W, 64] boxes; an MN-major one [E, K, MN],
// in [64, 64] boxes.
inline int encode_operand(CUtensorMap* map, const void* p, int T, int W,
                          int E, int mn, int K) {
  return T ? encode_3d(map, p, E, K, mn, 64) : encode_3d(map, p, E, mn, K, W);
}

// out [E, M, N] = a @ b per expert, a and b laid out as TA / TB say, in
// Cfg's tiles; M, N > 0 and N even; K >= 0.  Returns 0 or a cudaError_t.
template <int TA, int TB, class Cfg>
int launch(const void* a, const void* b, __nv_bfloat16* out, int E, int M,
           int N, int K, cudaStream_t stream) {
  CUtensorMap ta{}, tb{}, tc{};
  int err = 0;
  if (K > 0) {
    err = encode_operand(&ta, a, TA, TM, E, M, K);
    if (!err) err = encode_operand(&tb, b, TB, Cfg::BN, E, N, K);
  }
  if (!err && Cfg::STAGED) err = encode_3d(&tc, out, E, M, N, TM);
  if (err) return err;
  auto kern = tile_kernel<TA, TB, Cfg>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((M + TM - 1) / TM),
                  (unsigned)((N + Cfg::BN - 1) / Cfg::BN), (unsigned)E);
  kern<<<grid, THREADS, Cfg::SMEM, stream>>>(ta, tb, tc, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace moe_gemm
