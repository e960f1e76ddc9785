// One decode step's attention: one query token per sequence against the KV
// cache, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention/
// decode_attention.py (`decode_attention`): for each (b, kv head) and each
// of its G query heads, o[g] = softmax_s(mask(cap(q[g] . k[s] * scale)))
// @ v over the cache slots s, where slot s of sequence b is valid iff
// s <= pos[b]; masked logits are -1e30 and the sum is clamped at 1e-30,
// as in the TPU kernel.  float32 math from float32 or bfloat16 inputs;
// the output has the inputs' dtype.
//
// Bound: bytes.  Each valid cache row of K and V is read once and used for
// G dot products and G axpys: about 2 G flops per byte in bfloat16, far
// below the H100's ~20 fp32 flops per byte of HBM.  At gemma2-9b's decode
// (B 8, KV 8, G 2, D 256, 4096 slots) the full cache is 268 MB a layer;
// at recurrentgemma-9b's (B 8, KV 1, G 16, 2048 slots) 16.8 MB.
//
// Design: split-KV ("flash decoding"); a call makes two CUDA launches.
//
// 1. The split kernel, grid (B * KV) x NSPLIT.  Block (bkv, j) reads slots
//    [j L, min((j + 1) L, pos[b] + 1)); NSPLIT and L come from the wrapper
//    (`decode_splits`: at least two waves of blocks on the card's SMs,
//    whole rounds of resident blocks, no split shorter than 32 slots;
//    shapes only, never pos, so no host sync and a CUDA graph can hold
//    the call).  A producer warp streams the block's K and V rows through
//    a 3-stage shared-memory ring by bulk (TMA) copies, one per cache row,
//    on full / empty mbarriers; eight consumer warps never meet at a block
//    barrier inside the loop.  The block merges its warps' states once at
//    the end and writes a float32 partial: acc [G, D] and (m, l) per head.
//    A block whose range starts at or past pos[b] + 1 writes the empty
//    partial (m = -1e30, l = 0, acc = 0) and returns.
//    - decode_split_kernel (float32; bfloat16 at G <= 8 or D < 64): a
//      warp takes GH = 2 query heads (1 at G = 1) with q in registers
//      and, per row group of D / 8 lanes (8 columns a lane), its own
//      batches of 4 slots with its own online softmax and accumulators
//      (16 floats a lane): dot products reduced by xor shuffles, one
//      rescale a batch.  Wider groups split the heads over warps.  94-96
//      registers (the two-head build spills 24-40 bytes of stack): two
//      blocks (18 warps) an SM, where the first design's per-lane K/V and
//      G x 8 accumulator tiles took 200-254 registers and one block.
//    - decode_mma_kernel (bfloat16, 8 < G <= 16, D >= 64: recurrentgemma's
//      16 heads over one kv head): the heads are the M = 16 rows of
//      mma.sync m16n8k16.  S = q k^T for 16 slots a warp on the tensor
//      cores (bf16 products are exact in fp32), the online softmax on the
//      fragments, O += P V with P as a bf16 high and low part (two
//      products, so P keeps ~16 bits and the output stays within one bf16
//      rounding of the float32 reference).  Warp w takes 16 of each tile's
//      32 slots and D / 4 output columns.
// 2. decode_merge_kernel, a block per (b, kv head, query head): merges the
//    NSPLIT partials in split order (m = max m_j; l and acc summed with
//    weights exp(m_j - m); out = acc / max(l, 1e-30)), so two launches are
//    bitwise equal.  An empty partial carries weight exp(-1e30 - m) = 0.
//    Given an lse pointer (float32 [B, KV, G]) it also stores the row's
//    log-sum-exp m + log(l) of its masked logits, or -inf where l = 0 (no
//    valid slot: pos[b] < 0, which a block of a cache split over a mesh's
//    `model` axis gets when it lies wholly past the position; out is 0
//    there), and out is float32 whatever the inputs' dtype: the blocks'
//    (out, lse) then merge across `model` in float32, each block's output
//    unrounded (a bf16 output a block adds a rounding the whole cache's
//    call does not make).  Serving passes a null pointer and stores
//    nothing more.
//
// The workspace (partials) is allocated by the wrapper (torch.empty),
// sized from S.  Measured on an H100 SXM (PERF.md section 6): gemma2's
// decode at parity with SDPA, recurrentgemma's at 1.8x SDPA, from 2.8x
// and 45x for the first design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8;               // consumer warps; one more produces
constexpr int THREADS = 32 * (WARPS + 1);
constexpr int VEC = 8, STAGES = 3;
constexpr int RB = 4;                  // slots a row group takes at once
constexpr int MIN_BLOCKS = 2;          // blocks an SM holds (launch bounds)
constexpr int GMAX = 16;               // query heads per kv head, at most
constexpr int MAX_SPLITS = 4096;       // the merge's weights: 32 KB
constexpr float NEG_INF = -1e30f;

// tile geometry for head dimension D (16 ... 256): a cache row is read by
// LPR lanes, 8 columns each; a warp holds RPW row groups; a tile is RB
// slots for every row group of the block (8192 elements of K: 16 KB in
// bfloat16)
template <int D>
struct Geo {
  static constexpr int LPR = D / VEC;
  static constexpr int RPW = 32 / LPR;
  static constexpr int TS = RB * WARPS * RPW;
};

constexpr int BAR_BYTES = 128;         // the ring's mbarriers, ahead of it

template <typename T, int D>
__host__ __device__ constexpr int smem_bytes() {
  return BAR_BYTES + STAGES * 2 * Geo<D>::TS * D * (int)sizeof(T);
}

struct Row8 {
  float x[VEC];
};

__device__ __forceinline__ Row8 widen(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  return Row8{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}
__device__ __forceinline__ Row8 widen(const __nv_bfloat16* p) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  Row8 o;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o.x[2 * i] = f.x;
    o.x[2 * i + 1] = f.y;
  }
  return o;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the partial of a block whose slot range is empty: weight 0 in the merge
__device__ __forceinline__ void empty_partial(float* pacc, float* pml, int G,
                                              int D, int tid) {
  for (int i = tid; i < G * D; i += THREADS) pacc[i] = 0.f;
  for (int g = tid; g < G; g += THREADS) {
    pml[g] = NEG_INF;
    pml[G + g] = 0.f;
  }
}

// The producer warp: tile it's valid rows (a row past s_end is never
// read) into stage it % STAGES of the K and V rings, one bulk copy a row
// (RS elements apart), completing on the stage's full mbarrier once the
// consumers have released it on its empty one.
template <typename T, int D, int TS, int RS>
__device__ __forceinline__ void produce(T* ring, uint64_t* full,
                                        uint64_t* empty, const T* kb,
                                        const T* vb, long long kss,
                                        long long vss, int s_begin,
                                        int s_end, int lane) {
  constexpr uint32_t ROW = D * sizeof(T);
  const int ntiles = (s_end - s_begin + TS - 1) / TS;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES;
    T* kt = ring + st * 2 * TS * RS;
    T* vt = kt + TS * RS;
    const int s0 = s_begin + it * TS;
    const int tv = min(TS, s_end - s0);
    hopper::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
    if (lane == 0) hopper::mbar_arrive_expect_tx(&full[st], 2 * tv * ROW);
    __syncwarp();
    for (int t = lane; t < tv; t += 32) {
      hopper::bulk_load(kt + t * RS, kb + (long long)(s0 + t) * kss, ROW,
                        &full[st]);
      hopper::bulk_load(vt + t * RS, vb + (long long)(s0 + t) * vss, ROW,
                        &full[st]);
    }
  }
}

// part_acc [B KV, NSPLIT, G, D] and part_ml [B KV, NSPLIT, 2, G] (m, l).
// GH query heads a warp; HGRP head groups of warps (HGRP GH >= G, HGRP a
// power of two up to WARPS), the other WARPS / HGRP warps split the slots.
template <typename T, int D, int GH>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int KV, int G, int HGRP,
                    int S, int L, int NSPLIT, long long ksb, long long ksh,
                    long long kss, long long vsb, long long vsh,
                    long long vss, float scale, float cap) {
  using Gm = Geo<D>;
  constexpr int TS = Gm::TS, LPR = Gm::LPR, RPW = Gm::RPW;
  constexpr int TILE = TS * D;                     // elements of a K tile
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [STAGES]
  uint64_t* empty = full + STAGES;                      // [STAGES]
  T* ring = reinterpret_cast<T*>(smem + BAR_BYTES);  // [STAGES][K, V][TS][D]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / KV, kvh = bkv % KV;
  const int n_valid = min(pos[b] + 1, S);
  const int s_begin = split * L;
  const int s_end = min(s_begin + L, n_valid);
  const long long part = (long long)bkv * NSPLIT + split;
  float* pacc = part_acc + part * G * D;
  float* pml = part_ml + part * 2 * G;
  if (s_begin >= s_end) {
    empty_partial(pacc, pml, G, D, tid);
    return;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int ntiles = (s_end - s_begin + TS - 1) / TS;

  if (warp == WARPS) {
    produce<T, D, TS, D>(ring, full, empty, k + b * ksb + kvh * ksh,
                         v + b * vsb + kvh * vsh, kss, vss, s_begin, s_end,
                         lane);
    return;
  }

  // consumer lane: head group hg (heads hg GH ..), slot group sg (of NSG),
  // columns d0 .. d0 + 7
  const int hg = warp % HGRP, li = lane % LPR, d0 = li * VEC;
  const int NSG = (WARPS / HGRP) * RPW;
  const int sg = (warp / HGRP) * RPW + lane / LPR;
  Row8 qf[GH];
  float m[GH], l[GH], acc[GH][VEC];
#pragma unroll
  for (int h = 0; h < GH; ++h) {
    const int g = hg * GH + h;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qf[h].x[e] = g < G ? to_f(q[((long long)bkv * G + g) * D + d0 + e])
                         : 0.f;
      acc[h][e] = 0.f;
    }
    m[h] = NEG_INF;
    l[h] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES;
    const T* kt = ring + st * 2 * TILE;
    const T* vt = kt + TILE;
    const int tv = min(TS, s_end - (s_begin + it * TS));
    hopper::mbar_wait(&full[st], (it / STAGES) & 1);
    // the row group's batches of RB slots: bi = sg, sg + NSG, ...
    for (int bi = sg; bi < TS / RB; bi += NSG) {
      Row8 kf[RB];
      bool ok[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int t = bi * RB + r;
        ok[r] = t < tv;
        if (ok[r]) {
          kf[r] = widen(kt + t * D + d0);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[r].x[e] = 0.f;
        }
      }
      float sc[GH][RB];
#pragma unroll
      for (int h = 0; h < GH; ++h)
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) x = fmaf(qf[h].x[e], kf[r].x[e], x);
          sc[h][r] = x;
        }
      // each dot product summed over its row's lanes (all 32 lanes run)
#pragma unroll
      for (int off = LPR / 2; off >= 1; off >>= 1)
#pragma unroll
        for (int h = 0; h < GH; ++h)
#pragma unroll
          for (int r = 0; r < RB; ++r)
            sc[h][r] += __shfl_xor_sync(0xffffffffu, sc[h][r], off);
      Row8 vf[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (ok[r]) {
          vf[r] = widen(vt + (bi * RB + r) * D + d0);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) vf[r].x[e] = 0.f;
        }
      }
      // online softmax over the batch, then acc = acc a + sum_r p_r v_r
#pragma unroll
      for (int h = 0; h < GH; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float x = sc[h][r] * scale;
          if (cap != 0.f) x = tanhf(x / cap) * cap;
          sc[h][r] = ok[r] ? x : NEG_INF;
          mx = fmaxf(mx, sc[h][r]);
        }
        const float m_new = fmaxf(m[h], mx);
        const float a = expf(m[h] - m_new);
        float p[RB], sum = 0.f;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          p[r] = ok[r] ? expf(sc[h][r] - m_new) : 0.f;
          sum += p[r];
        }
        l[h] = a * l[h] + sum;
        m[h] = m_new;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float x = acc[h][e] * a;
#pragma unroll
          for (int r = 0; r < RB; ++r) x = fmaf(p[r], vf[r].x[e], x);
          acc[h][e] = x;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // merge the slot groups in a fixed order through shared memory (the
  // ring is idle: every copy issued has been consumed)
  hopper::named_barrier(1, 32 * WARPS);
  float* sm_acc = reinterpret_cast<float*>(ring);  // [NSG][G][D]
  float* sm_ml = sm_acc + NSG * G * D;             // [NSG][G][m, l]
#pragma unroll
  for (int h = 0; h < GH; ++h) {
    const int g = hg * GH + h;
    if (g >= G) continue;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sm_acc[((long long)sg * G + g) * D + d0 + e] = acc[h][e];
    if (li == 0) {
      sm_ml[(sg * G + g) * 2] = m[h];
      sm_ml[(sg * G + g) * 2 + 1] = l[h];
    }
  }
  hopper::named_barrier(1, 32 * WARPS);
  for (int idx = tid; idx < G * D; idx += 32 * WARPS) {
    const int g = idx / D;
    float mt = NEG_INF;
    for (int i = 0; i < NSG; ++i) mt = fmaxf(mt, sm_ml[(i * G + g) * 2]);
    float lt = 0.f, at = 0.f;
    for (int i = 0; i < NSG; ++i) {
      const float f = expf(sm_ml[(i * G + g) * 2] - mt);
      lt += sm_ml[(i * G + g) * 2 + 1] * f;
      at += sm_acc[(long long)i * G * D + idx] * f;
    }
    pacc[idx] = at;
    if (idx % D == 0) {
      pml[g] = mt;
      pml[G + g] = lt;
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core route: bfloat16, 8 < G <= 16, D 64 ... 256
// ---------------------------------------------------------------------------

constexpr int MT = 32;                 // slots a tile: two groups of 16

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p)));
}

// d += a b, m16n8k16, bf16 in, f32 accumulate; fragments as in the PTX
// ISA (lane = 4 g + t): a {row g, row g + 8} x {k 2t, 2t + 8}, b k 2t and
// 2t + 8 of column g, d row g cols 2t, 2t + 1 then row g + 8
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return BAR_BYTES + (STAGES * 2 * MT + 16) * (D + 8) * 2;
}

// As decode_split_kernel, for bfloat16 and 8 < G <= 16: the G query heads
// (padded to 16) are the M = 16 rows of mma.sync m16n8k16.  Warp w takes
// slot group w / 4 (16 slots of each 32-slot tile) and columns D / 4 (w %
// 4) ..: it forms S = q k^T for its 16 slots (every column warp forms the
// same S, which costs less than sharing it), the online softmax on the
// fragments (a quad holds a head's 16 slots), and O += P V with P as a
// bfloat16 high and low part (two products: P keeps ~16 bits).  Rows are
// padded by 16 bytes in shared memory so ldmatrix reads are conflict-free.
template <int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ pos, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int KV, int G, int S, int L,
                  int NSPLIT, long long ksb, long long ksh, long long kss,
                  long long vsb, long long vsh, long long vss, float scale,
                  float cap) {
  constexpr int RS = D + 8;                        // padded row (elements)
  constexpr int CW = D / 4, NT = CW / 8;           // a warp's columns
  static_assert(D % 64 == 0, "D of 64, 128 or 256");
  using bf = __nv_bfloat16;
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  bf* ring = reinterpret_cast<bf*>(smem + BAR_BYTES);  // [STAGES][K, V][MT][RS]
  bf* qs = ring + STAGES * 2 * MT * RS;                // [16][RS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / KV, kvh = bkv % KV;
  const int n_valid = min(pos[b] + 1, S);
  const int s_begin = split * L;
  const int s_end = min(s_begin + L, n_valid);
  const long long part = (long long)bkv * NSPLIT + split;
  float* pacc = part_acc + part * G * D;
  float* pml = part_ml + part * 2 * G;
  if (s_begin >= s_end) {
    empty_partial(pacc, pml, G, D, tid);
    return;
  }
  // zeros in every ring row (a row past s_end is never copied and meets
  // p = 0 in P V), q as 16 padded rows
  for (int i = tid; i < STAGES * 2 * MT * RS / 8; i += THREADS)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < 16 * D; i += THREADS) {
    const int h = i / D, d = i % D;
    qs[h * RS + d] = h < G ? q[((long long)bkv * G + h) * D + d]
                           : __float2bfloat16_rn(0.f);
  }
  hopper::fence_proxy_async();           // the zeros before the copies
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int ntiles = (s_end - s_begin + MT - 1) / MT;

  if (warp == WARPS) {
    produce<bf, D, MT, RS>(ring, full, empty, k + b * ksb + kvh * ksh,
                           v + b * vsb + kvh * vsh, kss, vss, s_begin,
                           s_end, lane);
    return;
  }

  const int g = lane / 4, t4 = lane % 4;
  const int cb = warp % 4, sgp = warp / 4, c0 = 16 * sgp;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // heads g, g + 8

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % STAGES;
    const bf* kt = ring + st * 2 * MT * RS;
    const bf* vt = kt + MT * RS;
    const int tv = min(MT, s_end - (s_begin + it * MT));
    hopper::mbar_wait(&full[st], (it / STAGES) & 1);

    // S [16 heads, 16 slots] as two n8 tiles, over D in k16 steps
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kp = 0; kp < D / 32; ++kp) {
      uint32_t a0[4], a1[4], bk[2][4];
      const int qr = lane % 8 + 8 * ((lane / 8) % 2);
      ldsm_x4(a0, qs + qr * RS + 32 * kp + 8 * (lane / 16));
      ldsm_x4(a1, qs + qr * RS + 32 * kp + 16 + 8 * (lane / 16));
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4(bk[j], kt + (c0 + 8 * j + lane % 8) * RS + 32 * kp +
                           8 * (lane / 8));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma16816(sc[j], a0, bk[j][0], bk[j][1]);
        mma16816(sc[j], a1, bk[j][2], bk[j][3]);
      }
    }
    // online softmax: element (j, e) is head g + 8 (e / 2), slot c0 + 8 j
    // + 2 t4 + e % 2; a quad holds a head's 16 slots
    float alpha[2], p[2][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          float x = sc[j][e] * scale;
          if (cap != 0.f) x = tanhf(x / cap) * cap;
          const bool ok = c0 + 8 * j + 2 * t4 + e % 2 < tv;
          sc[j][e] = ok ? x : NEG_INF;
          mx = fmaxf(mx, sc[j][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      alpha[hh] = expf(m[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const bool ok = c0 + 8 * j + 2 * t4 + e % 2 < tv;
          p[j][e] = ok ? expf(sc[j][e] - m_new) : 0.f;
          sum += p[j][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hh] = alpha[hh] * l[hh] + sum;
      m[hh] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // P as the A operand (16 x k16 slots), a bf16 high and low part
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i / 2, e = 2 * (i % 2);        // a0 a1 a2 a3
      ph[i] = pack_bf16(p[j][e], p[j][e + 1]);
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&ph[i]);
      pl[i] = pack_bf16(p[j][e] - __low2float(h), p[j][e + 1] - __high2float(h));
    }
    // O [16 heads, CW columns] += P V, V's k16 x n8 tiles by ldmatrix.trans
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vt + (c0 + lane % 8 + 8 * ((lane / 8) % 2)) * RS +
                        cb * CW + 16 * np + 8 * (lane / 16));
      mma16816(acc[2 * np], pl, bv[0], bv[1]);
      mma16816(acc[2 * np], ph, bv[0], bv[1]);
      mma16816(acc[2 * np + 1], pl, bv[2], bv[3]);
      mma16816(acc[2 * np + 1], ph, bv[2], bv[3]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // merge the two slot groups in a fixed order through shared memory
  hopper::named_barrier(1, 32 * WARPS);
  float* sm_acc = reinterpret_cast<float*>(ring);  // [2][G][D]
  float* sm_ml = sm_acc + 2 * G * D;               // [2][G][m, l]
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = g + 8 * (e / 2), col = cb * CW + 8 * n + 2 * t4 + e % 2;
      if (h < G) sm_acc[(sgp * G + h) * D + col] = acc[n][e];
    }
  if (cb == 0 && t4 == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int h = g + 8 * hh;
      if (h < G) {
        sm_ml[(sgp * G + h) * 2] = m[hh];
        sm_ml[(sgp * G + h) * 2 + 1] = l[hh];
      }
    }
  hopper::named_barrier(1, 32 * WARPS);
  for (int idx = tid; idx < G * D; idx += 32 * WARPS) {
    const int h = idx / D;
    const float m0 = sm_ml[h * 2], m1 = sm_ml[(G + h) * 2];
    const float mt = fmaxf(m0, m1);
    const float f0 = expf(m0 - mt), f1 = expf(m1 - mt);
    pacc[idx] = sm_acc[idx] * f0 + sm_acc[G * D + idx] * f1;
    if (idx % D == 0) {
      pml[h] = mt;
      pml[G + h] = sm_ml[h * 2 + 1] * f0 + sm_ml[(G + h) * 2 + 1] * f1;
    }
  }
}

// merges the NSPLIT partials of one (b, kv head, query head) in a fixed
// order: block (bkv, g), one thread a column (D, at least one warp).  The
// split weights exp(m_j - m) and the total l are formed once, in shared
// memory (2 NSPLIT floats), by warp 0: each lane sums its splits in
// order, then a fixed xor tree.
template <typename T>
__global__ void __launch_bounds__(256)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, T* __restrict__ out,
                    float* __restrict__ lse, int G, int D, int NSPLIT) {
  extern __shared__ float wts[];                   // [NSPLIT] m, then w
  float* ls = wts + NSPLIT;                        // [NSPLIT] l
  __shared__ float tot[2];                         // m, l
  const long long bkv = blockIdx.x;
  const int g = blockIdx.y, tid = threadIdx.x;
  const float* pml = part_ml + bkv * NSPLIT * 2 * G;
  for (int j = tid; j < NSPLIT; j += blockDim.x) {
    wts[j] = pml[j * 2 * G + g];
    ls[j] = pml[j * 2 * G + G + g];
  }
  __syncthreads();
  if (tid < 32) {
    float m = NEG_INF;
    for (int j = tid; j < NSPLIT; j += 32) m = fmaxf(m, wts[j]);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = tid; j < NSPLIT; j += 32) {
      wts[j] = expf(wts[j] - m);
      l += ls[j] * wts[j];
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (tid == 0) {
      tot[0] = m;
      tot[1] = l;
    }
  }
  __syncthreads();
  if (lse != nullptr && tid == 0)
    lse[bkv * G + g] = tot[1] > 0.f ? tot[0] + logf(tot[1])
                                    : __int_as_float(0xff800000);
  const float den = fmaxf(tot[1], 1e-30f);
  const float* pacc = part_acc + (bkv * NSPLIT * G + g) * D;
  for (int d = tid; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 8
    for (int j = 0; j < NSPLIT; ++j)
      a += pacc[(long long)j * G * D + d] * wts[j];
    store1(out + (bkv * G + g) * D + d, a / den);
  }
}

struct Args {
  const void *q, *k, *v, *pos;
  void* out;
  float* lse;
  float *part_acc, *part_ml;
  int B, KV, G, S, L, NSPLIT;
  long long st[6];
  float scale, cap;
  cudaStream_t stream;
};

// the merge into out of the inputs' dtype T, or, with an lse, float32
template <typename T, int D>
int merge(const Args& a) {
  constexpr unsigned threads = D < 32 ? 32 : D;
  const dim3 grid((unsigned)(a.B * a.KV), (unsigned)a.G);
  const size_t smem = 2 * a.NSPLIT * sizeof(float);
  if (a.lse != nullptr)
    decode_merge_kernel<float><<<grid, threads, smem, a.stream>>>(
        a.part_acc, a.part_ml, (float*)a.out, a.lse, a.G, D, a.NSPLIT);
  else
    decode_merge_kernel<T><<<grid, threads, smem, a.stream>>>(
        a.part_acc, a.part_ml, (T*)a.out, nullptr, a.G, D, a.NSPLIT);
  return (int)cudaGetLastError();
}

template <typename T, int D, int GH>
int launch_g(const Args& a) {
  constexpr int bytes = smem_bytes<T, D>();
  int hgrp = 1;                          // head groups: hgrp GH >= G
  while (hgrp * GH < a.G) hgrp *= 2;
  if (hgrp > WARPS) return (int)cudaErrorInvalidValue;
  auto kern = decode_split_kernel<T, D, GH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((unsigned)(a.B * a.KV), (unsigned)a.NSPLIT), THREADS, bytes,
         a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.pos,
      a.part_acc, a.part_ml, a.KV, a.G, hgrp, a.S, a.L, a.NSPLIT, a.st[0],
      a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.scale, a.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge<T, D>(a);
}

template <int D>
int launch_mma(const Args& a) {
  constexpr int bytes = mma_smem_bytes<D>();
  auto kern = decode_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((unsigned)(a.B * a.KV), (unsigned)a.NSPLIT), THREADS, bytes,
         a.stream>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
      (const __nv_bfloat16*)a.v, (const int*)a.pos, a.part_acc, a.part_ml,
      a.KV, a.G, a.S, a.L, a.NSPLIT, a.st[0], a.st[1], a.st[2], a.st[3],
      a.st[4], a.st[5], a.scale, a.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge<__nv_bfloat16, D>(a);
}

template <typename T, int D>
int launch(const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D >= 64)
    if (a.G > 8) return launch_mma<D>(a);
  return a.G == 1 ? launch_g<T, D, 1>(a) : launch_g<T, D, 2>(a);
}

template <typename T>
int dispatch_d(int D, const Args& a) {
  switch (D) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    case 256: return launch<T, 256>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; q and out are [B, KV, G, D]
// contiguous (out float32 when lse is given, else of the dtype); k/v strides in elements over (b, kv head, slot), the head
// dimension contiguous, rows 16-byte aligned; pos is [B] int32 (a
// negative entry: no valid slot); lse is null or float32 [B, KV, G].  Splits
// NSPLIT of L slots (NSPLIT L >= S); part_acc holds B KV NSPLIT G D
// floats and part_ml B KV NSPLIT 2 G.  Two launches on `stream`.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* lse, void* part_acc, void* part_ml, int B, int KV, int G, int S, int D,
    int L, int NSPLIT, int dtype, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    float scale, float cap, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || G > GMAX || S <= 0 || L <= 0 ||
      NSPLIT <= 0 || NSPLIT > MAX_SPLITS || (long long)NSPLIT * L < S)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, pos, out, (float*)lse, (float*)part_acc,
               (float*)part_ml,
               B, KV, G, S, L, NSPLIT, {ksb, ksh, kss, vsb, vsh, vss},
               scale, cap, (cudaStream_t)stream};
  if (dtype == 0) return dispatch_d<float>(D, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, a);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
