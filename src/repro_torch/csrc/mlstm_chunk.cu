// Chunkwise mLSTM cell, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/mlstm_chunk/mlstm_chunk.py
// (`mlstm_chunk`): the stabilised mLSTM recurrence over q, k, v
// [B, S, H, D] (q unscaled, `scale` applied as the reference's
// `mlstm_chunk_math` applies it) and the gate pre-activations i, f
// [B, S, H] float32, cut into chunks, each chunk two masked [L, L]
// products plus the carried state.  Two differences from the Pallas
// kernel, both for serving: it starts from a given state (C0 [B, H, D, D],
// n0 [B, H, D], m0 [B, H], float32) and returns the final one (C1, n1,
// m1), so decode is a launch on a one-step chunk; and it takes any S >= 1,
// the last chunk ragged (masked), where the Pallas kernel asks
// S % chunk == 0.  h [B, S, H, D] is written in q's dtype.
//
// Math per chunk, in `mlstm_chunk_math`'s order (float32, expf / log1pf,
// no fast-math intrinsics): log f = -softplus(-f); b = cumsum log f; a =
// i - b; mx = max(m0, cummax a); sw[t, s] = (q_t . k_s) * scale *
// exp(a_s - mx_t) for s <= t; h_t = (q_t C * (scale exp(m0 - mx_t)) +
// sum_s sw[t, s] v_s) / max(|rowsum sw + (q_t . n) scale exp(m0 - mx_t)|,
// exp(-(b_t + mx_t))); then C <- exp(m0 - mx_L) C + sum_s exp(a_s - mx_L)
// k_s v_s^T, n likewise, m <- b_L + mx_L.
//
// Bound.  Prefill: operations.  Per (b, h) and token the two D x D
// products (q C and the rank-one C update) and the chunk's [L, L] work.
// At xlstm-350m's prefill (B 8, S 910, H 4, D 256, bf16) that is 76.7 MB
// of reads and writes (22.9 us at 3.35 TB/s) against 8.15 GFLOP at chunks
// of 32 on fp32 SIMT lanes (121.7 us at the H100 SXM's 67 TFLOP/s); on the
// tensor cores, with the split products below counted twice, 16.7 GFLOP
// (16.9 us at 989 TFLOP/s bf16), so the wgmma route is bound by its bytes.
// Decode (S 1): bytes, reading and writing C, 2 B H D^2 4 B = 16.8 MB at
// B 8 (5.0 us).  chip_smoke.py's `mlstm_work` counts both per route.
//
// Three routes, chosen by the wrapper from the dtype and S:
//
// * wgmma (bfloat16, S > 1): chunks of L = 64 steps, one wgmma M tile.
//   A block owns one (b, h) and a value tile of DV = min(D, 64) columns,
//   grid (B H, D / DV): 128 blocks at xlstm's 32 sequences on 132 SMs, one
//   an SM (211,552 B of shared memory at D 256).  Every product is a wgmma
//   with fp32 accumulators:
//     S = q k^T                  A q, B k, both from the TMA tiles (exact);
//     P = q C  as h^T = C^T q^T  A = C^T from the accumulator registers as a
//                                bf16 hi + lo pair, B q (K-major);
//     h^T += V^T sw^T            A = V^T (exact bf16, by ldmatrix.trans),
//                                B = sw as a bf16 hi + lo pair in shared
//                                memory;
//     C^T <- carry C^T + (dec o V)^T k
//                                A = exp(a_s - mx_L) v_s as hi + lo pair
//                                (registers), B k (MN-major).
//   One rounding of the fp32 operands (C, sw, the decayed values) to bf16
//   breaks the bf16 tolerance (the CPU emulation in
//   tests/test_torch_mlstm_route.py); the hi + lo pair carries them to
//   ~2^-16 relative, as the float32 products do.  The decay is applied to
//   the value tile [64 x DV] rather than the key tile [64 x D]: the same
//   product, a quarter of the split work at D 256.  n, q.n and sw's row
//   sums stay on fp32 SIMT lanes (a few thousand FMAs a chunk each).
//   Three roles, one chunk's work split so that only the recurrence is
//   serial:
//   - the state warpgroups (two at D >= 128, splitting C^T's d columns,
//     64 registers a thread at D 256; one below) hold C^T in registers for
//     the whole sequence (never written back between chunks) and run the
//     chain C -> q C, q.n -> C update, n update; warpgroup 0 also adds the
//     other's q C partial (through shared memory), forms the denominators
//     and h^T += V^T sw^T, and stages h; the other stores h's rows with
//     16-byte stores while warpgroup 0 updates its C;
//   - the score warpgroup forms S and sw one chunk ahead (sw and its row
//     sums double-buffered, with full / empty mbarriers): S and sw do not
//     depend on the state;
//   - within the score warpgroup, lane 0 of warp 0 keeps a 2-stage ring of
//     the chunks' q, k (D / EC boxes each) and v tiles full by TMA, with
//     4-D tensor maps over [B, S, H, D] (rows past S read as zeros), and
//     warp 1 (the gate warp) carries m and takes each chunk's gate
//     cumulatives by warp scans (log f's cumsum, a's cummax) and their
//     exponentials into the stage.
//   Each (b, h) has D / DV blocks that each recompute q k^T and the gates:
//   1.0 M of 5.8 M multiply-adds a chunk at D 256, on a warpgroup that
//   works ahead of the chain; sharing it would put a cluster barrier on
//   the chain every chunk.  The chain sets the time: SIMT work, barriers
//   and wgmma latency on one SM a chunk, whatever the grid (84.3 us at
//   xlstm's prefill on an NVIDIA H100 80GB HBM3 at 700 W, 3.7x the bytes
//   bound; PERF.md section 6).
// * decode (S = 1, float32 or bfloat16): the update is rank one and the
//   launch is bound by reading and writing C.  Grid (B H, D / 16): a block
//   owns a 16-column strip of C, streams it with 16-byte loads and stores
//   (256 threads, each 16 B a row on D / 64 rows, all issued before any
//   use), and reduces q C over the strip by warp shuffles and one pass
//   through shared memory in a fixed order.  Its key-block mode
//   (repro_mlstm_decode_block) holds DK of the D key rows of C and n, as
//   a position of a mesh whose model axis splits the key dimension does,
//   and writes the block's partial numerator and raw denominator in
//   float32 in place of h: the caller sums them over the blocks (a psum)
//   and divides.
// * simt (float32, S > 1): the first port's kernel, unchanged (wgmma has no
//   float32 input).  Chunks of LC = 32 steps; grid (B H, D / DV), each
//   block holding C[:, v-tile] (DV = 64: 64 KB) and n, m in shared memory
//   for the whole sequence; SIMT fmaf products; warp 0 takes the gate
//   cumulatives one lane a step in step order.
//
// Every sum has one fixed order on every route, so two launches are
// bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A launch's operands, as the C entry takes them.
struct Args {
  const void *q, *k, *v;
  const float *ig, *fg, *C0, *n0, *m0;
  void* h;
  float *C1, *n1, *m1;
  int B, S, H;
  float scale;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// simt route (float32, S > 1)
// ---------------------------------------------------------------------------

namespace simt {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int LC = 32;             // chunk length: one lane per key step

template <int D>
struct Tile {
  static constexpr int DV = D < 64 ? D : 64;    // value columns a block holds
  static constexpr int LDQ = D + 1;             // padded q, k rows
  static constexpr int LDS = LC + 1;            // padded rows of sw
  static constexpr int RSTEP = THREADS / DV;    // thread rows over a tile
  static constexpr int HR = LC / RSTEP;         // output rows per thread
  static constexpr int CR = D / RSTEP;          // state rows per thread
  static constexpr int FLOATS =
      D * DV + D + 2 * LC * LDQ + LC * DV + LC * LDS + 7 * LC;
  static_assert(LC % RSTEP == 0 && D % RSTEP == 0, "tile");
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, const float* __restrict__ C0,
                   const float* __restrict__ n0, const float* __restrict__ m0,
                   T* __restrict__ h, float* __restrict__ C1,
                   float* __restrict__ n1, float* __restrict__ m1, int S,
                   int H, float scale) {
  using TL = Tile<D>;
  constexpr int DV = TL::DV, LDQ = TL::LDQ, LDS = TL::LDS;
  constexpr int RSTEP = TL::RSTEP, HR = TL::HR, CR = TL::CR;
  extern __shared__ float smem[];
  float* Cs = smem;                  // [D][DV] this block's value tile of C
  float* ns = Cs + D * DV;           // [D]
  float* qs = ns + D;                // [LC][LDQ]
  float* ks = qs + LC * LDQ;         // [LC][LDQ], then k_s exp(a_s - mx_L)
  float* vs = ks + LC * LDQ;         // [LC][DV]
  float* sw = vs + LC * DV;          // [LC][LDS]
  float* g_a = sw + LC * LDS;        // a = i - b
  float* g_b = g_a + LC;             // b = cumsum log f
  float* g_mx = g_b + LC;            // max(m0, cummax a)
  float* g_is = g_mx + LC;           // exp(m0 - mx)
  float* g_dec = g_is + LC;          // exp(a - mx_L)
  float* g_den = g_dec + LC;         // denominators
  float* g_mt = g_den + LC;          // log f, then m_t = b + mx

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.x;   // b * H + head
  const long long bi = bh / H, hi = bh % H;
  const int v0 = blockIdx.y * DV;
  const long long row = (long long)H * D;   // step stride of q, k, v, h
  const int c = tid % DV, r0 = tid / DV;

  for (int e = tid; e < D * DV; e += THREADS)
    Cs[e] = C0[(bh * D + e / DV) * D + v0 + e % DV];
  for (int d = tid; d < D; d += THREADS) ns[d] = n0[bh * D + d];
  float m = m0[bh];

  for (int c0 = 0; c0 < S; c0 += LC) {
    const int l = min(LC, S - c0);
    const long long base = (bi * S + c0) * row + hi * D;
    for (int e = tid; e < LC * D; e += THREADS) {
      const int t = e / D, d = e % D;
      float qv = 0.f, kv = 0.f;
      if (t < l) {
        qv = to_f(q[base + t * row + d]);
        kv = to_f(k[base + t * row + d]);
      }
      qs[t * LDQ + d] = qv;
      ks[t * LDQ + d] = kv;
    }
    for (int e = tid; e < LC * DV; e += THREADS) {
      const int t = e / DV;
      vs[e] = t < l ? to_f(v[base + t * row + v0 + e % DV]) : 0.f;
    }
    if (warp == 0) {
      // gate cumulatives, lane t for step t, sums and maxima in step order
      const long long go = (bi * S + c0) * H + hi;
      float ip = 0.f, lf = 0.f;
      if (lane < l) {
        ip = ig[go + (long long)lane * H];
        const float y = -fg[go + (long long)lane * H];
        lf = -(fmaxf(y, 0.f) + log1pf(expf(-fabsf(y))));
      }
      g_mt[lane] = lf;
      __syncwarp();
      float b = g_mt[0];
      for (int s = 1; s <= lane && s < l; ++s) b += g_mt[s];
      const float a = ip - b;
      g_b[lane] = b;
      g_a[lane] = a;
      __syncwarp();
      float M = g_a[0];
      for (int s = 1; s <= lane && s < l; ++s) M = fmaxf(M, g_a[s]);
      const float mx = fmaxf(m, M);
      g_mx[lane] = mx;
      g_is[lane] = expf(m - mx);
      g_mt[lane] = b + mx;
      __syncwarp();
      g_dec[lane] = lane < l ? expf(a - g_mx[l - 1]) : 0.f;
    }
    __syncthreads();

    // sw[t, s]: warp w takes rows w, w + 8, ...; lane s the key step
    for (int t = warp; t < l; t += WARPS) {
      float acc = 0.f;
      if (lane <= t) {
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          acc = fmaf(qs[t * LDQ + d], ks[lane * LDQ + d], acc);
        acc = acc * scale * expf(g_a[lane] - g_mx[t]);
      }
      sw[t * LDS + lane] = acc;
    }
    __syncthreads();

    // denominators; k scaled by its decay for the state update
    for (int t = warp; t < l; t += WARPS) {
      float qn = 0.f;
      for (int d = lane; d < D; d += 32) qn = fmaf(qs[t * LDQ + d], ns[d], qn);
      float rs = sw[t * LDS + lane];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        qn += __shfl_xor_sync(0xffffffffu, qn, o);
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      }
      if (lane == 0)
        g_den[t] = fmaxf(fabsf(rs + qn * scale * g_is[t]), expf(-g_mt[t]));
    }
    for (int e = tid; e < l * D; e += THREADS) {
      const int s = e / D;
      ks[s * LDQ + e % D] *= g_dec[s];
    }
    __syncthreads();

    // h[t, v0 + c] = (q_t C[:, c] scale exp(m0 - mx_t) + sw[t] v[:, c]) / den
    {
      float inter[HR], intra[HR];
#pragma unroll
      for (int r = 0; r < HR; ++r) inter[r] = intra[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float cv = Cs[d * DV + c];
#pragma unroll
        for (int r = 0; r < HR; ++r)
          inter[r] = fmaf(qs[(r0 + r * RSTEP) * LDQ + d], cv, inter[r]);
      }
      for (int s = 0; s < l; ++s) {
        const float vv = vs[s * DV + c];
#pragma unroll
        for (int r = 0; r < HR; ++r)
          intra[r] = fmaf(sw[(r0 + r * RSTEP) * LDS + s], vv, intra[r]);
      }
#pragma unroll
      for (int r = 0; r < HR; ++r) {
        const int t = r0 + r * RSTEP;
        if (t < l)
          store1(h + base + t * row + v0 + c,
                 (inter[r] * (scale * g_is[t]) + intra[r]) / g_den[t]);
      }
    }
    __syncthreads();               // C is read above, written below

    // C <- exp(m0 - mx_L) C + sum_s (k_s exp(a_s - mx_L)) v_s^T; n, m alike
    {
      const float mx_e = g_mx[l - 1];
      const float carry = expf(m - mx_e);
      float acc[CR];
#pragma unroll
      for (int r = 0; r < CR; ++r) acc[r] = 0.f;
      for (int s = 0; s < l; ++s) {
        const float vv = vs[s * DV + c];
#pragma unroll
        for (int r = 0; r < CR; ++r)
          acc[r] = fmaf(ks[s * LDQ + r0 + r * RSTEP], vv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < CR; ++r) {
        float* p = Cs + (r0 + r * RSTEP) * DV + c;
        *p = carry * *p + acc[r];
      }
      for (int d = tid; d < D; d += THREADS) {
        float sn = 0.f;
        for (int s = 0; s < l; ++s) sn += ks[s * LDQ + d];
        ns[d] = carry * ns[d] + sn;
      }
      m = g_b[l - 1] + mx_e;
    }
    __syncthreads();
  }

  for (int e = tid; e < D * DV; e += THREADS)
    C1[(bh * D + e / DV) * D + v0 + e % DV] = Cs[e];
  if (blockIdx.y == 0) {
    for (int d = tid; d < D; d += THREADS) n1[bh * D + d] = ns[d];
    if (tid == 0) m1[bh] = m;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* ig,
           const float* fg, const float* C0, const float* n0,
           const float* m0, void* h, float* C1, float* n1, float* m1, int B,
           int S, int H, float scale, cudaStream_t stream) {
  using TL = Tile<D>;
  const int smem = (int)(sizeof(float) * TL::FLOATS);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)(D / TL::DV));
  mlstm_chunk_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, ig, fg, C0, n0, m0, (T*)h, C1,
      n1, m1, S, H, scale);
  return (int)cudaGetLastError();
}
}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma route (bfloat16, S > 1)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int L = 64;              // chunk length: one wgmma M tile of steps
constexpr int STAGES = 2;          // chunks of q, k, v in flight

// One chunk's gate terms, written into the stage by the gate warp.
struct Gates {
  float a[L];                      // i - b, b = cumsum log f
  float mx[L];                     // max(m0, cummax a)
  float isc[L];                    // scale exp(m0 - mx); 0 past the end
  float eml[L];                    // exp(-(b + mx)), the denominators' floor
  float dec[L];                    // exp(a - mx_L); 0 past the end
  float carry, pad[3];             // exp(m0 - mx_L)
};
constexpr int GATE_FLOATS = (int)(sizeof(Gates) / 4);

// Per head dim: q and k chunks of NB boxes [L rows][EC columns] (SW-byte
// rows, swizzled), the value tile one such box; NWG state warpgroups
// splitting C^T's d columns, NW each, and one score warpgroup; per stage
// sw's hi and lo parts [L][L] bf16 (128-byte swizzle), sw's row sums and
// the gates; h's staging rows [L][HP] bf16; the other state warpgroup's
// q C partial; n, q.n and the denominators' reciprocals; the mbarriers.
template <int D>
struct Tile {
  static constexpr int EC = D < 64 ? D : 64;
  static constexpr int SW = 2 * EC;
  static constexpr int NB = D / EC;
  static constexpr int DV = EC;
  static constexpr int NWG = D >= 128 ? 2 : 1;
  static constexpr int NW = D / NWG;
  static constexpr int NC = NWG * 128;
  static constexpr int THREADS = NC + 128;      // + the score warpgroup
  static constexpr int QK_BYTES = L * D * 2;
  static constexpr int V_BYTES = L * DV * 2;
  static constexpr int STAGE_BYTES = 2 * QK_BYTES + V_BYTES;
  static constexpr int SW_BYTES = L * L * 2;
  static constexpr int HP = DV + 8;             // pitch of h's staging rows
  static constexpr int H_BYTES = L * HP * 2;
  static constexpr int PART_FLOATS = NWG > 1 ? 32 * 128 : 0;
  static constexpr int SMEM =
      1024 + STAGES * (STAGE_BYTES + 2 * SW_BYTES) + H_BYTES +
      (PART_FLOATS + STAGES * (GATE_FLOATS + L) + D + 2 * L) * 4 +
      4 * STAGES * 8;
  static_assert(NW % 16 == 0 && NC % L == 0, "tile");
};

// arrive on named barrier `id` of `count` threads without waiting (the
// threads that wait use hopper::named_barrier)
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// x0, x1 as a bf16 pair and the bf16 rounding of what it leaves
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// V^T [v][s] as the A operands of 4 k16 steps over the chunk's steps, in
// the accumulator layout (hopper.cuh: a[0] row vr, columns s, s + 1 with
// s = 16 kc + cq; a[1] row vr + 8; a[2], a[3] columns s + 8, s + 9), by
// ldmatrix.trans from the [s][v] value tile: matrix i of a k16 step is
// v + 8 (i & 1), s + 8 (i >> 1), lane 8 i + r giving row s + r.  Rows v
// >= DV are zeros.  Exact: v is bf16.
template <int DV>
__device__ __forceinline__ void load_vt(const uint8_t* vs, int w4, int lane,
                                        uint32_t (&va)[4][4]) {
  constexpr int SWV = 2 * DV;
  if (16 * w4 >= DV) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int u = 0; u < 4; ++u) va[kc][u] = 0;
    return;
  }
  const int mi = lane / 8;
  const int v = 16 * w4 + 8 * (mi & 1);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int s = 16 * kc + 8 * (mi >> 1) + lane % 8;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(va[kc][0]), "=r"(va[kc][1]), "=r"(va[kc][2]),
          "=r"(va[kc][3])
        : "r"(hopper::smem_u32(vs + hopper::swizzle<SWV>(s * SWV + v * 2))));
  }
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
mlstm_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ ig, const float* __restrict__ fg,
                   const float* __restrict__ C0, const float* __restrict__ n0,
                   const float* __restrict__ m0,
                   __nv_bfloat16* __restrict__ h, float* __restrict__ C1,
                   float* __restrict__ n1, float* __restrict__ m1, int S,
                   int H, float scale) {
  using TL = Tile<D>;
  constexpr int EC = TL::EC, SW = TL::SW, DV = TL::DV, NWG = TL::NWG;
  constexpr int NW = TL::NW, NC = TL::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = hopper::align1024(smem_raw);
  uint8_t* sws = stages + STAGES * TL::STAGE_BYTES;  // [stage] sw hi, lo
  __nv_bfloat16* hst =
      reinterpret_cast<__nv_bfloat16*>(sws + STAGES * 2 * TL::SW_BYTES);
  float* part = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(hst) + TL::H_BYTES);
  Gates* gates = reinterpret_cast<Gates*>(part + TL::PART_FLOATS);
  float* rsum = reinterpret_cast<float*>(gates + STAGES);  // [stage][L]
  float* ns = rsum + STAGES * L;                         // [D]
  float* qn = ns + D;                                    // [L]
  float* rden = qn + L;                                  // 1 / den, [L]
  uint64_t* full = reinterpret_cast<uint64_t*>(rden + L);
  uint64_t* empty = full + STAGES;       // the stage is free again
  uint64_t* sfull = empty + STAGES;      // sw and its row sums are in
  uint64_t* sempty = sfull + STAGES;     // sw's buffer is free again

  const long long bh = blockIdx.x;                 // b * H + head
  const int bi = (int)(bh / H), hh = (int)(bh % H);
  const int v0 = blockIdx.y * DV;
  const int nchunks = (S + L - 1) / L;
  // warpgroup index, warp-uniform for the compiler
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32, w4 = (threadIdx.x / 32) % 4;
  const int vr = 16 * w4 + lane / 4;   // accumulator rows vr, vr + 8
  const int cq = 2 * (lane % 4);       // columns cq, cq + 1 of an n8 block

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);   // the TMA thread, the gate warp
      hopper::mbar_init(&empty[s], NC);      // every state thread
      hopper::mbar_init(&sfull[s], 128);     // the score warpgroup
      hopper::mbar_init(&sempty[s], 128);    // state warpgroup 0
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == NWG) {
    // The score warpgroup.  Warp 0's lane 0 issues each chunk's q, k, v
    // loads; warp 1 (the gate warp) carries m and takes each chunk's
    // gate cumulatives into its stage, lane l steps 2 l and 2 l + 1;
    // then the whole warpgroup forms S = q k^T and sw for that chunk, one
    // chunk ahead of the state warpgroups (sw is double-buffered).
    float m = m0[bh];
    float ip[2], fv[2];              // the gate warp's next gate inputs
    auto load_gates = [&](int n) {
      const int c0 = n * L, l = min(L, S - c0);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = 2 * lane + u;
        const long long go = ((long long)bi * S + c0 + t) * H + hh;
        ip[u] = t < l ? ig[go] : 0.f;
        fv[u] = t < l ? fg[go] : 0.f;
      }
    };
    // chunk n's loads and gates into its stage
    auto produce = [&](int n) {
      const int st = n % STAGES, c0 = n * L, l = min(L, S - c0);
      if (w4 == 0) {
        if (lane == 0) {
          uint8_t* sb = stages + st * TL::STAGE_BYTES;
          hopper::mbar_wait(&empty[st], ((n / STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[st], TL::STAGE_BYTES);
          for (int cb = 0; cb < TL::NB; ++cb) {
            hopper::tma_load_4d(sb + cb * L * SW, &tq, &full[st], cb * EC,
                                hh, c0, bi);
            hopper::tma_load_4d(sb + TL::QK_BYTES + cb * L * SW, &tk,
                                &full[st], cb * EC, hh, c0, bi);
          }
          hopper::tma_load_4d(sb + 2 * TL::QK_BYTES, &tv, &full[st], v0, hh,
                              c0, bi);
        }
        __syncwarp();
      } else if (w4 == 1) {
        float lf[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float y = -fv[u];
          lf[u] = 2 * lane + u < l
                      ? -(fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)))) : 0.f;
        }
        // b = cumsum log f: the lane's pair, then a scan of pair sums
        const float pair = lf[0] + lf[1];
        float inc = pair;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += y;
        }
        float ex = __shfl_up_sync(0xffffffffu, inc, 1);
        if (lane == 0) ex = 0.f;
        const float b[2] = {ex + lf[0], ex + pair};
        float a[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          a[u] = 2 * lane + u < l ? ip[u] - b[u] : -INFINITY;
        // cummax a, the same way (exact in any order)
        const float pm = fmaxf(a[0], a[1]);
        float incm = pm;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, incm, o);
          if (lane >= o) incm = fmaxf(incm, y);
        }
        float exm = __shfl_up_sync(0xffffffffu, incm, 1);
        if (lane == 0) exm = -INFINITY;
        const float mx[2] = {fmaxf(m, fmaxf(exm, a[0])),
                             fmaxf(m, fmaxf(exm, pm))};
        const int tl = l - 1;
        const float mx_l =
            __shfl_sync(0xffffffffu, (tl & 1) ? mx[1] : mx[0], tl >> 1);
        const float b_l =
            __shfl_sync(0xffffffffu, (tl & 1) ? b[1] : b[0], tl >> 1);
        hopper::mbar_wait(&empty[st], ((n / STAGES) & 1) ^ 1);
        Gates& g = gates[st];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = 2 * lane + u;
          const bool in = t < l;
          g.a[t] = a[u];
          g.mx[t] = mx[u];
          g.isc[t] = in ? scale * expf(m - mx[u]) : 0.f;
          g.eml[t] = expf(-(b[u] + mx[u]));
          g.dec[t] = in ? expf(a[u] - mx_l) : 0.f;
        }
        if (lane == 0) g.carry = expf(m - mx_l);
        m = b_l + mx_l;
        hopper::mbar_arrive(&full[st]);
      }
    };

    if (w4 == 1) load_gates(0);
    produce(0);
    for (int c = 0; c < nchunks; ++c) {
      const int st = c % STAGES, l = min(L, S - c * L);
      if (w4 == 1 && c + 1 < nchunks) load_gates(c + 1);  // in flight now
      const uint8_t* Qs = stages + st * TL::STAGE_BYTES;
      const uint8_t* Ks = Qs + TL::QK_BYTES;
      uint8_t* sw_hi = sws + st * 2 * TL::SW_BYTES;
      uint8_t* sw_lo = sw_hi + TL::SW_BYTES;
      const Gates& g = gates[st];
      hopper::mbar_wait(&full[st], (c / STAGES) & 1);
      hopper::mbar_wait(&sempty[st], ((c / STAGES) & 1) ^ 1);
      hopper::named_barrier(3, 128);   // the warpgroup together into wgmma
      const uint64_t dq = hopper::opaque(hopper::desc<SW>(Qs, 16, 8 * SW));
      const uint64_t dk = hopper::opaque(hopper::desc<SW>(Ks, 16, 8 * SW));
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = ((16 * kk / EC) * L * SW + (16 * kk % EC) * 2) >> 4;
        hopper::wgmma_ss<0, 0>(sc, dq + off, dk + off, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      // sw = S scale exp(a_s - mx_t) for s <= t < l (a_s - mx_t <= 0
      // there), its row sums; branch-free
      float rs[2] = {0.f, 0.f};
      const float mxt[2] = {g.mx[vr], g.mx[vr + 8]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 a2 = *reinterpret_cast<const float2*>(&g.a[8 * j + cq]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = vr + 8 * (i >> 1), s = 8 * j + cq + (i & 1);
          const float e =
              expf(fminf((i & 1 ? a2.y : a2.x) - mxt[i >> 1], 0.f));
          const float x = s <= t && t < l ? sc[4 * j + i] * scale * e : 0.f;
          sc[4 * j + i] = x;
          rs[i >> 1] += x;
        }
      }
      // sw [t][s] as bf16 hi and lo tiles, 128-byte rows, swizzled
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int t = vr + 8 * hr, s = 8 * j + cq;
          uint32_t hi, lo;
          split2(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1], hi, lo);
          const uint32_t o = hopper::swizzle<128>(t * 128 + s * 2);
          *reinterpret_cast<uint32_t*>(sw_hi + o) = hi;
          *reinterpret_cast<uint32_t*>(sw_lo + o) = lo;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
        rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
        if (lane % 4 == 0) rsum[st * L + vr + 8 * hr] = rs[hr];
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&sfull[st]);
      if (c + 1 < nchunks) produce(c + 1);
    }
    if (w4 == 1 && lane == 0 && blockIdx.y == 0) m1[bh] = m;
    return;
  }

  // the state warpgroups
  const int ct = threadIdx.x;
  const bool lead = wgi == 0;      // forms the denominators and h
  const int d0 = wgi * NW;         // this warpgroup's columns of C^T

  // C^T [v][d0 .. d0 + NW) in the accumulator layout
  float C[NW / 2];
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = vr + 8 * (i >> 1), d = d0 + 8 * j + cq + (i & 1);
      C[4 * j + i] = v < DV ? C0[(bh * D + d) * D + v0 + v] : 0.f;
    }
  for (int d = ct; d < D; d += NC) ns[d] = n0[bh * D + d];
  hopper::named_barrier(1, NC);

  for (int c = 0; c < nchunks; ++c) {
    const int st = c % STAGES, c0 = c * L, l = min(L, S - c0);
    const uint8_t* Qs = stages + st * TL::STAGE_BYTES;
    const uint8_t* Ks = Qs + TL::QK_BYTES;
    const uint8_t* Vs = Ks + TL::QK_BYTES;
    const Gates& g = gates[st];
    // the staged rows t < l of h out with 16-byte stores, 128 threads
    auto store_h = [&](int i0) {
      for (int e = i0; e < L * (DV / 8); e += 128) {
        const int t = e / (DV / 8), c8 = 8 * (e % (DV / 8));
        if (t < l)
          *reinterpret_cast<uint4*>(
              h + (((long long)bi * S + c0 + t) * H + hh) * D + v0 + c8) =
              *reinterpret_cast<const uint4*>(hst + t * TL::HP + c8);
      }
    };
    hopper::mbar_wait(&full[st], (c / STAGES) & 1);

    // q_t . n with the state before this chunk: TPR threads a row, each
    // a 16-byte chunk of the row (8 columns) at a time
    {
      constexpr int TPR = NC / L, CH = D / 8;
      const int t = ct / TPR;
      float acc = 0.f, acc2 = 0.f;     // even and odd columns
#pragma unroll
      for (int e = ct % TPR; e < CH; e += TPR) {
        const int col = 8 * e;
        const uint4 qq = *reinterpret_cast<const uint4*>(
            Qs + (col / EC) * (L * SW) +
            hopper::swizzle<SW>(t * SW + (col % EC) * 2));
        const __nv_bfloat162* q2 =
            reinterpret_cast<const __nv_bfloat162*>(&qq);
        const float4 na = *reinterpret_cast<const float4*>(ns + col);
        const float4 nb = *reinterpret_cast<const float4*>(ns + col + 4);
        const float nn[8] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc = fmaf(__low2float(q2[u]), nn[2 * u], acc);
          acc2 = fmaf(__high2float(q2[u]), nn[2 * u + 1], acc2);
        }
      }
      acc += acc2;
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (ct % TPR == 0) qn[t] = acc;
    }

    // P = C^T q^T over this warpgroup's d columns, C^T as bf16 hi + lo
    // A operands, in two halves (each half's operands live until its wait)
    const uint64_t dq = hopper::opaque(hopper::desc<SW>(Qs, 16, 8 * SW));
    constexpr int NH = NW >= 32 ? 2 : 1;     // halves
    constexpr int KH = NW / (16 * NH);       // k16 steps a half
    float P[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) P[i] = 0.f;
#pragma unroll
    for (int half = 0; half < NH; ++half) {
      uint32_t ca[KH][2][4];
#pragma unroll
      for (int kc = 0; kc < KH; ++kc)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 8 * (half * KH + kc) + 2 * u;
          split2(C[e], C[e + 1], ca[kc][0][u], ca[kc][1][u]);
        }
      hopper::fence_regs(P);
#pragma unroll
      for (int kc = 0; kc < KH; ++kc) {
        hopper::fence_regs(ca[kc][0]);
        hopper::fence_regs(ca[kc][1]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KH; ++kc) {
        const int dd = d0 + 16 * (half * KH + kc);
        const int off = ((dd / EC) * L * SW + (dd % EC) * 2) >> 4;
        hopper::wgmma_rs<0>(P, ca[kc][0], dq + off, half + kc > 0);
        hopper::wgmma_rs<0>(P, ca[kc][1], dq + off, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(P);
#pragma unroll
      for (int kc = 0; kc < KH; ++kc) {
        hopper::fence_regs(ca[kc][0]);
        hopper::fence_regs(ca[kc][1]);
      }
    }
    if constexpr (NWG > 1) {
      if (!lead)
#pragma unroll
        for (int i = 0; i < 32; ++i) part[i * 128 + ct % 128] = P[i];
    }
    hopper::named_barrier(1, NC);  // q.n and the other partial are in

    uint32_t va[4][4];
    load_vt<DV>(Vs, w4, lane, va);
    if (lead) {
      const uint8_t* sw_hi = sws + st * 2 * TL::SW_BYTES;
      hopper::mbar_wait(&sfull[st], (c / STAGES) & 1);
      if (ct < l)
        rden[ct] = 1.f / fmaxf(
            fabsf(rsum[st * L + ct] + qn[ct] * g.isc[ct]), g.eml[ct]);
      if constexpr (NWG > 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) P[i] += part[i * 128 + ct];
      }
      // h^T = (q C)^T scale exp(m0 - mx_t) + V^T sw^T, sw as hi + lo
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 f = *reinterpret_cast<const float2*>(&g.isc[8 * j + cq]);
#pragma unroll
        for (int i = 0; i < 4; ++i) P[4 * j + i] *= i & 1 ? f.y : f.x;
      }
      const uint64_t dsh = hopper::opaque(hopper::desc<128>(sw_hi, 16, 1024));
      const uint64_t dsl = dsh + (TL::SW_BYTES >> 4);
      hopper::fence_regs(P);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) hopper::fence_regs(va[kc]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        hopper::wgmma_rs<0>(P, va[kc], dsh + 2 * kc, 1);
        hopper::wgmma_rs<0>(P, va[kc], dsl + 2 * kc, 1);
      }
      hopper::wgmma_commit();
      hopper::named_barrier(2, 128);   // the denominators are in
      hopper::wgmma_wait<0>();
      hopper::fence_regs(P);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) hopper::fence_regs(va[kc]);
      hopper::mbar_arrive(&sempty[st]);
      // h = h^T / den (times its reciprocal: one division a row, not a
      // slow-path division an element) as [t][v] rows in shared memory;
      // the other state warpgroup stores them (below), or this one
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 r = *reinterpret_cast<const float2*>(&rden[8 * j + cq]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 8 * j + cq + (i & 1), v = vr + 8 * (i >> 1);
          if (t < l && v < DV)
            hst[t * TL::HP + v] =
                __float2bfloat16_rn(P[4 * j + i] * (i & 1 ? r.y : r.x));
        }
      }
      if constexpr (NWG > 1) {
        named_arrive(4, NC);           // h's rows are staged
      } else {
        hopper::named_barrier(2, 128);
        store_h(ct);
      }
    }

    // C^T <- carry C^T + (dec o V)^T k over this warpgroup's d columns,
    // dec o V as bf16 hi + lo A operands, k MN-major from the stage
    {
      uint32_t da[4][2][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = 16 * kc + cq + 8 * (u >> 1);
          const __nv_bfloat162 vv =
              *reinterpret_cast<const __nv_bfloat162*>(&va[kc][u]);
          const float2 dd = *reinterpret_cast<const float2*>(&g.dec[s]);
          split2(dd.x * __low2float(vv), dd.y * __high2float(vv),
                 da[kc][0][u], da[kc][1][u]);
        }
      const float carry = g.carry;
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) C[i] *= carry;
      const uint64_t dkb = hopper::opaque(
          hopper::desc<SW>(Ks + (d0 / EC) * L * SW, L * SW, 8 * SW));
      hopper::fence_regs(C);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        hopper::fence_regs(da[kc][0]);
        hopper::fence_regs(da[kc][1]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint64_t kb = dkb + ((kc * 16 * SW) >> 4);
        hopper::wgmma_rs<1>(C, da[kc][0], kb, 1);
        hopper::wgmma_rs<1>(C, da[kc][1], kb, 1);
      }
      hopper::wgmma_commit();
      // meanwhile n <- carry n + sum_s k_s exp(a_s - mx_L) over the same
      // d: a column pair to lanes l and l + 16 of a warp, each a half of
      // the steps in step order, the halves then added (past the chunk's
      // end k reads as zeros and dec is 0)
      const int half = lane / 16;
      for (int p0 = 16 * w4; p0 < NW / 2; p0 += 64) {   // warp-uniform
        const int pr = p0 + lane % 16, d = d0 + 2 * pr;
        float s0 = 0.f, s1 = 0.f;
        if (pr < NW / 2) {
#pragma unroll 8
          for (int s = half * L / 2; s < (half + 1) * L / 2; ++s) {
            const __nv_bfloat162 kk =
                *reinterpret_cast<const __nv_bfloat162*>(
                    Ks + (d / EC) * (L * SW) +
                    hopper::swizzle<SW>(s * SW + (d % EC) * 2));
            s0 = fmaf(__low2float(kk), g.dec[s], s0);
            s1 = fmaf(__high2float(kk), g.dec[s], s1);
          }
        }
        const float o0 = __shfl_xor_sync(0xffffffffu, s0, 16);
        const float o1 = __shfl_xor_sync(0xffffffffu, s1, 16);
        if (pr < NW / 2 && half == 0) {
          ns[d] = g.carry * ns[d] + (s0 + o0);
          ns[d + 1] = g.carry * ns[d + 1] + (s1 + o1);
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(C);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        hopper::fence_regs(da[kc][0]);
        hopper::fence_regs(da[kc][1]);
      }
    }
    if constexpr (NWG > 1) {
      if (!lead) {
        hopper::named_barrier(4, NC);  // h's rows are staged
        store_h(ct % 128);
      }
    }
    hopper::mbar_arrive(&empty[st]);
    hopper::named_barrier(1, NC);  // n is in; part, qn, sw, h's rows free
  }

#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int v = vr + 8 * (i >> 1), d = d0 + 8 * j + cq + (i & 1);
      if (v < DV) C1[(bh * D + d) * D + v0 + v] = C[4 * j + i];
    }
  if (blockIdx.y == 0)
    for (int d = ct; d < D; d += NC) n1[bh * D + d] = ns[d];
}

template <int D>
int launch(const Args& x) {
  using TL = Tile<D>;
  // [B, S, H, D] bf16, innermost first; boxes [L rows][EC columns] of one
  // head; rows past S read as zeros
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)x.H, (uint64_t)x.S,
                            (uint64_t)x.B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)x.H * D * 2,
                               (uint64_t)x.S * x.H * D * 2};
  const uint32_t box[4] = {(uint32_t)TL::EC, 1, (uint32_t)L, 1};
  CUtensorMap maps[3];
  const void* base[3] = {x.q, x.k, x.v};
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::encode_bf16(&maps[i], 4, base[i], dims, strides,
                                        box, TL::SW);
    if (err) return err;
  }
  auto kern = mlstm_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(x.B * x.H), (unsigned)(D / TL::DV));
  kern<<<grid, TL::THREADS, TL::SMEM, x.stream>>>(
      maps[0], maps[1], maps[2], x.ig, x.fg, x.C0, x.n0, x.m0,
      (__nv_bfloat16*)x.h, x.C1, x.n1, x.m1, x.S, x.H, x.scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// decode route (S = 1)
// ---------------------------------------------------------------------------

namespace dec {

constexpr int THREADS = 256;
constexpr int VS = 16;             // C columns a block owns: 64 B a row
constexpr int TPR = VS / 4;        // threads a row, 16 B each
constexpr int RG = THREADS / TPR;  // row groups
constexpr int WARPS = THREADS / 32;

// BLOCK: the key-block mode.  The launch holds DK of the D key rows
// (q, k, C's rows and n of those rows; v, the gates and m whole) and
// writes, in place of h, the block's partial numerator num [B, H, D] and
// raw denominator den [B, H] in float32, undivided: their sums over the
// key blocks are the step's q C (scale carry) + sw v and rowsum sw +
// (q . n) scale carry, and h = num / max(|den|, exp(-m1)).
template <typename T, int D, bool BLOCK>
__global__ void __launch_bounds__(THREADS)
mlstm_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ ig,
                    const float* __restrict__ fg,
                    const float* __restrict__ C0,
                    const float* __restrict__ n0,
                    const float* __restrict__ m0, T* __restrict__ h,
                    float* __restrict__ C1, float* __restrict__ n1,
                    float* __restrict__ m1, float scale,
                    float* __restrict__ num, float* __restrict__ den,
                    int DK) {
  constexpr int RPT = (D + RG - 1) / RG;     // C rows a thread, at most
  const int dk = BLOCK ? DK : D;             // key rows this launch holds
  __shared__ float qs[D], ks[D];
  __shared__ float red[WARPS][VS];
  __shared__ float dots[2];
  const long long bh = blockIdx.x;           // b * H + head; S = 1
  const int v0 = blockIdx.y * VS, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int rg = tid / TPR, c4 = (tid % TPR) * 4;

  // every load in flight before any use: the strip of C, then q, k, v,
  // n and the gates
  float4 cv[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int d = rg + r * RG;
    cv[r] = d < dk ? *reinterpret_cast<const float4*>(
                         C0 + (bh * dk + d) * D + v0 + c4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  constexpr int QPT = (D + THREADS - 1) / THREADS;
  float qv[QPT], kv[QPT];
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int d = tid + r * THREADS;
    qv[r] = d < dk ? to_f(q[bh * dk + d]) : 0.f;
    kv[r] = d < dk ? to_f(k[bh * dk + d]) : 0.f;
  }
  constexpr int NPL = (D + 31) / 32;     // n a lane of warp 1
  float nv[NPL];
#pragma unroll
  for (int r = 0; r < NPL; ++r) {
    const int d = lane + 32 * r;
    nv[r] = warp == 1 && d < dk ? n0[bh * dk + d] : 0.f;
  }
  float vv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) vv[j] = to_f(v[bh * D + v0 + c4 + j]);
  const float ip = ig[bh], y = -fg[bh], m = m0[bh];
  const float vt = tid < VS ? to_f(v[bh * D + v0 + tid]) : 0.f;
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int d = tid + r * THREADS;
    if (d < dk) {
      qs[d] = qv[r];
      ks[d] = kv[r];
    }
  }
  __syncthreads();
  if (warp < 2) {                  // q . k (warp 0) and q . n (warp 1)
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < NPL; ++r) {
      const int d = lane + 32 * r;
      if (d < dk) acc = fmaf(qs[d], warp == 0 ? ks[d] : nv[r], acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) dots[warp] = acc;
  }
  // q C over this thread's rows, then over the warp's row groups
  float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const float qd = rg + r * RG < dk ? qs[rg + r * RG] : 0.f;
    p[0] = fmaf(qd, cv[r].x, p[0]);
    p[1] = fmaf(qd, cv[r].y, p[1]);
    p[2] = fmaf(qd, cv[r].z, p[2]);
    p[3] = fmaf(qd, cv[r].w, p[3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = TPR; o < 32; o <<= 1)
      p[j] += __shfl_xor_sync(0xffffffffu, p[j], o);
  if (lane < TPR)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][c4 + j] = p[j];

  // the one-step chunk's gates (every thread alike)
  const float lf = -(fmaxf(y, 0.f) + log1pf(expf(-fabsf(y))));
  const float a = ip - lf, mx = fmaxf(m, a);
  const float carry = expf(m - mx), dkey = expf(a - mx);
  // C <- carry C + (k exp(a - mx)) v^T, n and m alike
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int d = rg + r * RG;
    if (d < dk) {
      const float kd = ks[d] * dkey;
      const float4 o = make_float4(fmaf(carry, cv[r].x, kd * vv[0]),
                                   fmaf(carry, cv[r].y, kd * vv[1]),
                                   fmaf(carry, cv[r].z, kd * vv[2]),
                                   fmaf(carry, cv[r].w, kd * vv[3]));
      *reinterpret_cast<float4*>(C1 + (bh * dk + d) * D + v0 + c4) = o;
    }
  }
  __syncthreads();
  if (tid < VS) {
    float inter = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) inter += red[w][tid];
    const float sw = dots[0] * scale * dkey;
    const float den_raw = sw + dots[1] * scale * carry;
    const float part = inter * (scale * carry) + sw * vt;
    if constexpr (BLOCK) {
      num[bh * D + v0 + tid] = part;
      if (blockIdx.y == 0 && tid == 0) den[bh] = den_raw;
    } else {
      store1(h + bh * D + v0 + tid,
             part / fmaxf(fabsf(den_raw), expf(-(lf + mx))));
    }
  }
  if (blockIdx.y == 0) {
    for (int d = tid; d < dk; d += THREADS)
      n1[bh * dk + d] = carry * n0[bh * dk + d] + ks[d] * dkey;
    if (tid == 0) m1[bh] = lf + mx;
  }
}

template <typename T, int D>
int launch(const Args& x) {
  const dim3 grid((unsigned)(x.B * x.H), (unsigned)(D / VS));
  mlstm_decode_kernel<T, D, false><<<grid, THREADS, 0, x.stream>>>(
      (const T*)x.q, (const T*)x.k, (const T*)x.v, x.ig, x.fg, x.C0, x.n0,
      x.m0, (T*)x.h, x.C1, x.n1, x.m1, x.scale, nullptr, nullptr, D);
  return (int)cudaGetLastError();
}

// the key-block mode: DK of the D key rows, num and den in place of h
template <typename T, int D>
int launch_block(const Args& x, float* num, float* den, int DK) {
  if (DK < 1 || DK > D) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(x.B * x.H), (unsigned)(D / VS));
  mlstm_decode_kernel<T, D, true><<<grid, THREADS, 0, x.stream>>>(
      (const T*)x.q, (const T*)x.k, (const T*)x.v, x.ig, x.fg, x.C0, x.n0,
      x.m0, nullptr, x.C1, x.n1, x.m1, x.scale, num, den, DK);
  return (int)cudaGetLastError();
}

}  // namespace dec

// route 0 = simt, 1 = wgmma (bfloat16 only), 2 = decode (S = 1)
template <typename T, int D>
int by_route(int route, const Args& x) {
  if (route == 0)
    return simt::launch<T, D>(x.q, x.k, x.v, x.ig, x.fg, x.C0, x.n0, x.m0,
                              x.h, x.C1, x.n1, x.m1, x.B, x.S, x.H, x.scale,
                              x.stream);
  if (route == 2) {
    if (x.S != 1) return (int)cudaErrorInvalidValue;
    return dec::launch<T, D>(x);
  }
  if constexpr (sizeof(T) == 2) {
    if (route == 1) return wg::launch<D>(x);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_dim(int D, int route, const Args& x) {
  switch (D) {
    case 16: return by_route<T, 16>(route, x);
    case 32: return by_route<T, 32>(route, x);
    case 64: return by_route<T, 64>(route, x);
    case 128: return by_route<T, 128>(route, x);
    case 256: return by_route<T, 256>(route, x);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 for q, k, v and h; q, k, v, h
// [B, S, H, D] and gates [B, S, H] contiguous; the state float32
// contiguous; D one of 16, 32, 64, 128, 256; route 0 = simt, 1 = wgmma
// (bfloat16; q, k, v 16-byte aligned), 2 = decode (S = 1)
extern "C" int repro_mlstm_chunk(const void* q, const void* k, const void* v,
                                 const void* ig, const void* fg,
                                 const void* C0, const void* n0,
                                 const void* m0, void* h, void* C1, void* n1,
                                 void* m1, int B, int S, int H, int D,
                                 int dtype, int route, float scale,
                                 void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Args x{q, k, v, (const float*)ig, (const float*)fg,
               (const float*)C0, (const float*)n0, (const float*)m0, h,
               (float*)C1, (float*)n1, (float*)m1, B, S, H, scale,
               (cudaStream_t)stream};
  if (dtype == 0) return by_dim<float>(D, route, x);
  if (dtype == 1) return by_dim<__nv_bfloat16>(D, route, x);
  return (int)cudaErrorInvalidValue;
}

// The decode route's key-block mode (S = 1): q, k [B, 1, H, DK] (a block
// of DK key rows), v [B, 1, H, D], gates [B, 1, H], C0 [B, H, DK, D], n0
// [B, H, DK], m0 [B, H] -> num [B, H, D] and den [B, H] float32 (the
// block's partial numerator and raw denominator, undivided), C1, n1 of
// the block and m1; dtype and D as repro_mlstm_chunk, 1 <= DK <= D.
extern "C" int repro_mlstm_decode_block(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* C0, const void* n0, const void* m0,
    void* num, void* den, void* C1, void* n1, void* m1, int B, int H,
    int DK, int D, int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const Args x{q, k, v, (const float*)ig, (const float*)fg,
               (const float*)C0, (const float*)n0, (const float*)m0,
               nullptr, (float*)C1, (float*)n1, (float*)m1, B, 1, H, scale,
               (cudaStream_t)stream};
  float *nm = (float*)num, *dn = (float*)den;
#define REPRO_BLOCK(T)                                          \
  switch (D) {                                                  \
    case 16: return dec::launch_block<T, 16>(x, nm, dn, DK);    \
    case 32: return dec::launch_block<T, 32>(x, nm, dn, DK);    \
    case 64: return dec::launch_block<T, 64>(x, nm, dn, DK);    \
    case 128: return dec::launch_block<T, 128>(x, nm, dn, DK);  \
    case 256: return dec::launch_block<T, 256>(x, nm, dn, DK);  \
  }
  if (dtype == 0) { REPRO_BLOCK(float) }
  if (dtype == 1) { REPRO_BLOCK(__nv_bfloat16) }
#undef REPRO_BLOCK
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
