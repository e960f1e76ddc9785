// Flash-attention backward (causal, sliding window, tanh softcap, GQA; keys
// of a length of their own without a mask) for sm_90a.
//
// No Pallas kernel has a backward: the reference trains through XLA's
// gradient of its query-chunked jnp attention (src/repro/models/
// attention.py, `attention` and `_sdpa`, under `jax.value_and_grad` in
// src/repro/runtime/train_loop.py).  This is that gradient, written from
// the math for the forward of flash_attention.cu, FA2's way: from q, k, v,
// the forward's output o, its per-row log-sum-exp lse (natural log, float32
// [B, H, Sq]) and dO, with raw = q . k * scale, z = cap tanh(raw / cap) (or
// raw), P = exp(z - lse) on the unmasked (q, k) and 0 elsewhere:
//
//   delta[q] = sum_d dO[q, d] o[q, d]                 (pre-pass)
//   dV[k]    = sum over the group's heads and q of P[q, k] dO[q]
//   dS[q, k] = P (dO[q] . v[k] - delta[q]) (1 - tanh^2) scale
//   dK[k]    = sum over the group's heads and q of dS[q, k] q[q]
//   dQ[q]    = sum_k dS[q, k] k[k]
//
// (the factor 1 - tanh^2 only under a softcap).  The mask is the
// forward's: k < Sk, q >= k when causal, q - k < window with a window,
// query row q at position qoff + q under a query offset (a row block of a
// sequence split over a mesh's `model` axis, the forward's qoff): the key
// and query ranges below shift by it, and keys that no query of the launch
// reads get dK = dV = 0, written (they go into a reduce-scatter).
// Inputs float32 or bfloat16 (any strides over (b, head, s) with the head
// dimension contiguous), all math in float32 accumulators, dq [B, H, Sq,
// D] and dk, dv [B, KV, Sk, D] contiguous in the inputs' dtype.
//
// Bound: operations.  Five products of 2 Sq Sk D flops a head (Q K^T and
// dO V^T recomputed, P^T dO, dS^T Q, dS K), halved under the causal mask:
// at minicpm-2b's training shape (H 36, S 4,096, D 64) 1.9e11 flops on
// ~95 MB, about 2,000 flops a byte: only the tensor cores can approach it
// (SIMT fp32 at 67 TFLOP/s would take 3 ms for five products).
//
// Three launches on one stream, counted as one call, on two routes by
// dtype; each sum has one fixed order and no atomics touch a sum, so two
// launches are bitwise equal; rows past Sq or Sk are masked out of P
// explicitly (a zero-filled row must not get the zero logit's weight).
//
// * wgmma (bfloat16, every head dim 16 ... 256).  The pre-pass writes
//   delta and lse log2(e) into rows padded to a multiple of 128 queries
//   (+inf and 0 past Sq).  Logits in log2 units, exp and tanh from
//   ex2.approx as in the forward; Q K^T and dO V^T of bf16 operands are
//   exact products summed in fp32; P and dS enter their products as a
//   bf16 high + low pair (hopper::split_hi_lo), carrying them to ~2^-16 as
//   the forward carries P: one bf16 rounding breaks the bf16 gate
//   (tests/test_torch_flash_bwd_route.py).
//   - dK / dV: a block per (128 keys, kv head, b), two warpgroups of 64
//     keys, 256 threads and no producer warp, so 255 registers a thread:
//     a ninth warp would cap them at 168 (three warps on one of the SM's
//     four register banks), where dK and dV of D 128 spilled.  K and V
//     come in once by TMA; Q and dO tiles of 64 queries with their lse
//     and delta rows stream through a 4-stage ring (2 at D 256) over the
//     group's heads and their live query tiles; thread 0 fills the first
//     stages and the second warpgroup to hand a stage back refills it.
//     Transposed, so that nothing goes back through shared memory: S^T =
//     K Q^T and dP^T = V dO^T (wgmma, both K-major), P^T and dS^T on the
//     fragment (lse and delta per column, from the stage), then dV += P^T
//     dO and dK += dS^T Q with P^T, dS^T the register A and dO, Q MN-major
//     B.  dK and dV stay in registers to the end.  At D 256 dK and dV
//     together are 256 registers a thread: the two warpgroups share 64
//     keys, one accumulating dV and the other dK (S^T computed by both;
//     ptxas -v: 250 registers, no spill).
//   - dQ: a block per (128 queries, head, b), heaviest first, two consumer
//     warpgroups and a producer warp as the forward (one consumer at D
//     256: 252 registers, no spill): Q, dO once by TMA, K and V tiles of
//     64 keys through a 4-stage ring (2 at D 256) over the key tiles the
//     forward visits; S = Q K^T, dP = dO V^T, dS on the fragment, dQ += dS
//     K with K as the MN-major B.
// * simt (float32): the first backward's kernels, unchanged (wgmma has
//   no float32 input, and TF32 would break the float32 tolerance).  SIMT
//   fp32 (`fmaf`) products over float32 tiles in shared memory, 256
//   threads a block as 16 x 16:
//   - dK / dV: a block per (key tile of BK rows, kv head, b).  It keeps
//     its K and V tiles in shared memory and dK, dV in registers, and
//     walks the group's G heads in order and, for each, the query tiles
//     of BQ rows that hold an unmasked query for some key of the tile, in
//     order: S and dO V^T in registers, P and dS through shared memory
//     into dV += P^T dO and dK += dS^T Q.
//   - dQ: a block per (query tile, head, b), heaviest first, holding Q,
//     dO, lse and delta; it walks the key tiles the forward visits and
//     adds dS K.
//   Tiles: BQ = BK = 64 up to D 128 (170 KB of shared memory at D 128), 32
//   at D 256 (143 KB), so dK and dV stay at 64 registers a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256, PAD = 4;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int BQ = D <= 128 ? 64 : 32;
  static constexpr int BK = D <= 128 ? 64 : 32;
  static constexpr int PD = D + PAD;        // row pitch of a [*, D] tile
  static constexpr int PK = BK + PAD;       // row pitch of a [BQ, BK] tile
  static constexpr int CG = D / 4;          // float4 column groups
  static constexpr int NJ = (CG + 15) / 16;  // column groups a thread
  // K, V, Q, dO tiles; P and dS tiles; lse and delta of BQ rows
  static constexpr int DKDV_FLOATS =
      2 * BK * PD + 2 * BQ * PD + 2 * BQ * PK + 2 * BQ;
  // Q, dO, K, V tiles; dS; lse and delta
  static constexpr int DQ_FLOATS = 2 * BQ * PD + 2 * BK * PD + BQ * PK + 2 * BQ;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// rows [r0, r0 + ROWS) of a [*, S, D] operand (row stride `ss`) into a
// float32 shared tile of pitch D + PAD; rows at or past S are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          long long ss, int r0, int S) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * V4; idx += THREADS) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = load4(src + (long long)(r0 + r) * ss + c);
    store4(dst + r * (D + PAD) + c, x);
  }
}

// lse and delta of query rows [q0, q0 + BQ) (0 past Sq)
template <int BQ>
__device__ __forceinline__ void load_rows(float* ls, float* ds,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int q0, int Sq) {
  for (int t = threadIdx.x; t < BQ; t += THREADS) {
    const bool in = q0 + t < Sq;
    ls[t] = in ? lse[q0 + t] : 0.f;
    ds[t] = in ? delta[q0 + t] : 0.f;
  }
}

// acc[i][j] += A[ty SI + i] . B[tx + 16 j] over K columns (A B^T), both
// float32 tiles of pitch `pitch`
template <int SI, int SJ, int K>
__device__ __forceinline__ void mm_nt(float (&acc)[SI][SJ],
                                      const float* A, const float* B,
                                      int pitch) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int d = 0; d < K; d += 4) {
    float4 a[SI], b[SJ];
#pragma unroll
    for (int i = 0; i < SI; ++i) a[i] = load4(A + (ty * SI + i) * pitch + d);
#pragma unroll
    for (int j = 0; j < SJ; ++j) b[j] = load4(B + (tx + 16 * j) * pitch + d);
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][j][e] += sum_{r < NR} A[r][ty RI + i] B[r][4 (tx + 16 j) + e]
// (A^T B): A a [NR, *] tile of pitch pa, B a [NR, D] tile of pitch pb
template <int RI, int NJ, int D>
__device__ __forceinline__ void mm_tn(float (&acc)[RI][NJ][4],
                                      const float* A, int pa,
                                      const float* B, int pb, int NR) {
  constexpr int CG = D / 4;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 2
  for (int r = 0; r < NR; ++r) {
    float a[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[r * pa + ty * RI + i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int g = tx + 16 * j;
      if (g >= CG) continue;
      const float4 b = load4(B + r * pb + 4 * g);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        acc[i][j][0] = fmaf(a[i], b.x, acc[i][j][0]);
        acc[i][j][1] = fmaf(a[i], b.y, acc[i][j][1]);
        acc[i][j][2] = fmaf(a[i], b.z, acc[i][j][2]);
        acc[i][j][3] = fmaf(a[i], b.w, acc[i][j][3]);
      }
    }
  }
}

// acc[i][j][e] += sum_{c < NC} A[ty RI + i][c] B[c][4 (tx + 16 j) + e]
// (A B): A a [*, NC] tile of pitch pa, B a [NC, D] tile of pitch pb
template <int RI, int NJ, int D, int NC>
__device__ __forceinline__ void mm_nn(float (&acc)[RI][NJ][4],
                                      const float* A, int pa,
                                      const float* B, int pb) {
  constexpr int CG = D / 4;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 2
  for (int c = 0; c < NC; c += 4) {
    float4 a[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = load4(A + (ty * RI + i) * pa + c);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int g = tx + 16 * j;
      if (g >= CG) continue;
      const float4 b0 = load4(B + (c + 0) * pb + 4 * g);
      const float4 b1 = load4(B + (c + 1) * pb + 4 * g);
      const float4 b2 = load4(B + (c + 2) * pb + 4 * g);
      const float4 b3 = load4(B + (c + 3) * pb + 4 * g);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
        const float4 bv[4] = {b0, b1, b2, b3};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[i][j][0] = fmaf(av[t], bv[t].x, acc[i][j][0]);
          acc[i][j][1] = fmaf(av[t], bv[t].y, acc[i][j][1]);
          acc[i][j][2] = fmaf(av[t], bv[t].z, acc[i][j][2]);
          acc[i][j][3] = fmaf(av[t], bv[t].w, acc[i][j][3]);
        }
      }
    }
  }
}

// the pairs the forward keeps: qp a query row of the launch (at position
// qoff + qp), kp a key
struct Mask {
  int Sq, Sk, causal, window, qoff;
  __device__ __forceinline__ bool operator()(int qp, int kp) const {
    bool ok = qp < Sq && kp < Sk;
    if (causal) ok = ok && qoff + qp >= kp;
    if (window) ok = ok && qoff + qp - kp < window;
    return ok;
  }
};

// From the logits s = Q K^T and dp = dO V^T of a [BQ, BK] tile (rows
// q0 + ty SI + i, keys k0 + tx + 16 j): P and dS (the gradient of the dot
// product q . k, scale included) into the shared tiles (P only if given)
template <int SI, int SJ, int PK>
__device__ __forceinline__ void p_and_ds(const float (&s)[SI][SJ],
                                         const float (&dp)[SI][SJ],
                                         const float* ls, const float* ds,
                                         float* Ps, float* dSs, int q0,
                                         int k0, const Mask& mask,
                                         float scale, float cap) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < SI; ++i) {
    const int r = ty * SI + i;
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const int c = tx + 16 * j;
      const float raw = s[i][j] * scale;
      float z = raw, t = 0.f;
      if (cap != 0.f) {
        t = tanhf(raw / cap);
        z = t * cap;
      }
      const float p = mask(q0 + r, k0 + c) ? expf(z - ls[r]) : 0.f;
      float g = p * (dp[i][j] - ds[r]);
      if (cap != 0.f) g *= 1.f - t * t;
      if (Ps != nullptr) Ps[r * PK + c] = p;
      dSs[r * PK + c] = g * scale;
    }
  }
}

// delta[row] = dO . o over the rows of [B, H, Sp] (Sp >= Sq); rows at or
// past Sq get delta 0 and, with lse2, lse2 = +inf (P = 2^(z - inf) = 0);
// with lse2 (the wgmma route) also lse2 = lse log2(e)
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ lse2,
                       int H, int Sq, int Sp, int D,
                       long long osb, long long osh, long long oss,
                       long long dsb, long long dsh, long long dss,
                       long long rows) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long s = row % Sp, bh = row / Sp;
  if (s >= Sq) {
    if (lane == 0) {
      delta[row] = 0.f;
      lse2[row] = __int_as_float(0x7f800000);
    }
    return;
  }
  const long long h = bh % H, b = bh / H;
  const T* orow = o + b * osb + h * osh + s * oss;
  const T* drow = dout + b * dsb + h * dsh + s * dss;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    if (lse2 != nullptr) lse2[row] = lse[bh * Sq + s] * LOG2E;
  }
}

struct Strides {
  long long q[3], k[3], v[3], o[3], d[3];   // (b, head, s) of each operand
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int KV, int Sq, int Sk,
                      Strides st, Mask mask, float scale, float cap) {
  using C = Tiles<D>;
  constexpr int BQ = C::BQ, BK = C::BK, PD = C::PD, PK = C::PK;
  constexpr int SI = BQ / 16, SJ = BK / 16, RI = BK / 16, NJ = C::NJ;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                      // [BK][PD]
  float* Vs = Ks + BK * PD;              // [BK][PD]
  float* Qs = Vs + BK * PD;              // [BQ][PD]
  float* dOs = Qs + BQ * PD;             // [BQ][PD]
  float* Ps = dOs + BQ * PD;             // [BQ][PK]
  float* dSs = Ps + BQ * PK;             // [BQ][PK]
  float* Ls = dSs + BQ * PK;             // [BQ]
  float* Ds = Ls + BQ;                   // [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const int k0 = kt * BK, k_last = min(k0 + BK, Sk) - 1;
  load_tile<T, D, BK>(Ks, k + b * st.k[0] + kvh * st.k[1], st.k[2], k0, Sk);
  load_tile<T, D, BK>(Vs, v + b * st.v[0] + kvh * st.v[1], st.v[2], k0, Sk);

  // query tiles holding an unmasked query for some key of this tile
  const int q_lo = mask.causal ? max(0, k0 - mask.qoff) : 0;
  const int q_hi = mask.window
                       ? min(Sq - 1, k_last + mask.window - 1 - mask.qoff)
                       : Sq - 1;
  const int qt_lo = q_lo / BQ, qt_hi = q_lo <= q_hi ? q_hi / BQ : -1;

  float dka[RI][NJ][4], dva[RI][NJ][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][j][e] = dva[i][j][e] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qb = q + b * st.q[0] + h * st.q[1];
    const T* db = dout + b * st.d[0] + h * st.d[1];
    const float* lb = lse + ((long long)b * H + h) * Sq;
    const float* eb = delta + ((long long)b * H + h) * Sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                   // the last tile's readers are done
      load_tile<T, D, BQ>(Qs, qb, st.q[2], q0, Sq);
      load_tile<T, D, BQ>(dOs, db, st.d[2], q0, Sq);
      load_rows<BQ>(Ls, Ds, lb, eb, q0, Sq);
      __syncthreads();
      float s[SI][SJ], dp[SI][SJ];
#pragma unroll
      for (int i = 0; i < SI; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) s[i][j] = dp[i][j] = 0.f;
      mm_nt<SI, SJ, D>(s, Qs, Ks, PD);
      mm_nt<SI, SJ, D>(dp, dOs, Vs, PD);
      p_and_ds<SI, SJ, PK>(s, dp, Ls, Ds, Ps, dSs, q0, k0, mask, scale, cap);
      __syncthreads();
      mm_tn<RI, NJ, D>(dva, Ps, PK, dOs, PD, BQ);
      mm_tn<RI, NJ, D>(dka, dSs, PK, Qs, PD, BQ);
    }
  }

  // rows past Sk not stored
  const long long base = ((long long)b * KV + kvh) * Sk;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kp = k0 + ty * RI + i;
    if (kp >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int gc = tx + 16 * j;
      if (gc >= C::CG) continue;
      const long long off = (base + kp) * D + 4 * gc;
      store4(dk + off, make_float4(dka[i][j][0], dka[i][j][1], dka[i][j][2],
                                   dka[i][j][3]));
      store4(dv + off, make_float4(dva[i][j][0], dva[i][j][1], dva[i][j][2],
                                   dva[i][j][3]));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int KV, int Sq, int Sk, Strides st, Mask mask,
                    float scale, float cap) {
  using C = Tiles<D>;
  constexpr int BQ = C::BQ, BK = C::BK, PD = C::PD, PK = C::PK;
  constexpr int SI = BQ / 16, SJ = BK / 16, RI = BQ / 16, NJ = C::NJ;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [BQ][PD]
  float* dOs = Qs + BQ * PD;             // [BQ][PD]
  float* Ks = dOs + BQ * PD;             // [BK][PD]
  float* Vs = Ks + BK * PD;              // [BK][PD]
  float* dSs = Vs + BK * PD;             // [BQ][PK]
  float* Ls = dSs + BQ * PK;             // [BQ]
  float* Ds = Ls + BQ;                   // [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest blocks first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = qt * BQ, q_last = min(q0 + BQ, Sq) - 1;
  load_tile<T, D, BQ>(Qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, Sq);
  load_tile<T, D, BQ>(dOs, dout + b * st.d[0] + h * st.d[1], st.d[2], q0,
                      Sq);
  load_rows<BQ>(Ls, Ds, lse + ((long long)b * H + h) * Sq,
                delta + ((long long)b * H + h) * Sq, q0, Sq);
  const T* kb = k + b * st.k[0] + kvh * st.k[1];
  const T* vb = v + b * st.v[0] + kvh * st.v[1];

  // the key tiles the forward visits for these rows
  const int k_hi = mask.causal ? min(mask.qoff + q_last, Sk - 1) : Sk - 1;
  const int k_lo = mask.window ? max(0, mask.qoff + q0 - mask.window + 1)
                               : 0;

  float acc[RI][NJ][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                     // the last tile's readers are done
    load_tile<T, D, BK>(Ks, kb, st.k[2], k0, Sk);
    load_tile<T, D, BK>(Vs, vb, st.v[2], k0, Sk);
    __syncthreads();
    float s[SI][SJ], dp[SI][SJ];
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_nt<SI, SJ, D>(s, Qs, Ks, PD);
    mm_nt<SI, SJ, D>(dp, dOs, Vs, PD);
    p_and_ds<SI, SJ, PK>(s, dp, Ls, Ds, nullptr, dSs, q0, k0, mask, scale,
                         cap);
    __syncthreads();
    mm_nn<RI, NJ, D, BK>(acc, dSs, PK, Ks, PD);
  }

  // rows past Sq not stored
  const long long base = ((long long)b * H + h) * Sq;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty * RI + i;
    if (qp >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int gc = tx + 16 * j;
      if (gc >= C::CG) continue;
      store4(dq + (base + qp) * D + 4 * gc,
             make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                         acc[i][j][3]));
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, H, KV, Sq, Sk;
  Strides st;
  Mask mask;
  float scale, cap;
};

// delta (and, given lse2, the padded lse in log2 units) over B H Sp rows
template <typename T>
int launch_delta(const Args& a, int D, int Sp, float* lse2,
                 cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * Sp;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), THREADS, 0,
                              stream>>>(
      (const T*)a.o, (const T*)a.dout, a.lse, a.delta, lse2, a.H, a.Sq, Sp,
      D, a.st.o[0], a.st.o[1], a.st.o[2], a.st.d[0], a.st.d[1], a.st.d[2],
      rows);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  using C = Tiles<D>;
  cudaError_t err = (cudaError_t)launch_delta<T>(a, D, a.Sq, nullptr, stream);
  if (err != cudaSuccess) return (int)err;

  constexpr int dkdv_bytes = C::DKDV_FLOATS * (int)sizeof(float);
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 g1((unsigned)((a.Sk + C::BK - 1) / C::BK), (unsigned)a.KV,
                (unsigned)a.B);
  dkdv<<<g1, THREADS, dkdv_bytes, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dk, (T*)a.dv, a.H, a.KV, a.Sq, a.Sk, a.st, a.mask,
      a.scale, a.cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int dq_bytes = C::DQ_FLOATS * (int)sizeof(float);
  auto dqk = flash_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((unsigned)((a.Sq + C::BQ - 1) / C::BQ), (unsigned)a.H,
                (unsigned)a.B);
  dqk<<<g2, THREADS, dq_bytes, stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
      a.delta, (T*)a.dq, a.H, a.KV, a.Sq, a.Sk, a.st, a.mask, a.scale, a.cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, s);
    case 32: return launch<T, 32>(a, s);
    case 64: return launch<T, 64>(a, s);
    case 128: return launch<T, 128>(a, s);
    case 256: return launch<T, 256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// wgmma route (bfloat16)
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;    // rows a consumer warpgroup owns
constexpr int BT = 64;         // rows of a streamed tile

// Shared-memory tiles as the forward's wgmma route lays them out: D / EC
// column blocks of EC = min(D, 64) elements (SW = 2 EC bytes a row, the
// TMA swizzle), each block rows x SW bytes.
template <int D>
struct WTile {
  static constexpr int EC = D < 64 ? D : 64;
  static constexpr int SW = 2 * EC;
  static constexpr int NB = D / EC;
  static constexpr int STR = BT * D * 2;    // a streamed tile's bytes
};

// dK / dV: two warpgroups, 256 threads, so 255 registers a thread (a
// ninth warp, a producer's, puts three warps on one of the SM's four
// register banks and caps every thread at 168; setmaxnreg does not raise
// the compiler's budget).  Up to D 128 each warpgroup owns 64 keys (128 a
// block) and both their gradients, D accumulator registers a thread; at D
// 256 that would be 256, so the two share 64 keys, one accumulating dV
// and the other dK (SPLIT).  Resident K and V of KEYS rows; a ring of Q
// and dO tiles of BT queries with their lse (log2 units) and delta.
template <int D>
struct DkdvTile : WTile<D> {
  static constexpr bool SPLIT = D == 256;
  static constexpr int KEYS = SPLIT ? WG_ROWS : 2 * WG_ROWS;
  static constexpr int THREADS = 2 * 128;
  static constexpr int STAGES = D < 256 ? 4 : 2;   // as shared memory allows
  static constexpr int RES = KEYS * D * 2;
  static constexpr int SMEM = 1024 + 2 * RES +
                              STAGES * (2 * WTile<D>::STR + 2 * BT * 4) +
                              (STAGES + 1) * 8 + STAGES * 4;
};

// dQ: NWG consumer warpgroups of 64 query rows and a producer warp, as
// the forward's (one consumer at D 256, where two would spill).  Resident
// Q and dO of ROWS rows; a ring of K and V tiles of BT keys.
template <int D>
struct DqTile : WTile<D> {
  static constexpr int NWG = D < 256 ? 2 : 1;
  static constexpr int ROWS = NWG * WG_ROWS;
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr int STAGES = D < 256 ? 4 : 2;   // as shared memory allows
  static constexpr int RES = ROWS * D * 2;
  static constexpr int SMEM = 1024 + 2 * RES + STAGES * 2 * WTile<D>::STR +
                              (2 * STAGES + 1) * 8;
};

// P and dS of one raw score s = q . k (a product's fp32 sum), in log2
// units: u = s scale log2(e), or under a softcap t = tanh(s scale / cap)
// and z = cap log2(e) t
struct Bwd {
  float to_u, cap2, scale;
  int capped;

  // P = 2^(z - L) where ok (L the query's lse in log2 units), else 0;
  // d = 1 - t^2 under a softcap, else 1
  __device__ __forceinline__ float p(float s, float L, bool ok,
                                     float& d) const {
    float z = s * to_u;
    d = 1.f;
    if (capped) {
      const float t = hopper::tanh_ex2(z);
      z = cap2 * t;
      d = fmaf(-t, t, 1.f);
    }
    return ok ? hopper::ex2(z - L) : 0.f;
  }

  // dS = P (dP - delta) (1 - t^2) scale
  __device__ __forceinline__ float ds(float p, float dp, float E,
                                      float d) const {
    return p * (dp - E) * (d * scale);
  }
};

// The dK / dV kernel's ring of streamed tiles: tile t (head kvh group +
// t / nq, query tile qt_lo + t % nq) into stage t % STAGES, Q and dO by
// TMA, their padded lse and delta rows by bulk copies, all completing on
// the stage's full barrier.
template <int D>
struct DkdvFeed {
  const CUtensorMap *tq, *tdo;
  const float *lse2, *delta;
  uint8_t *Qs, *dOs;
  float *Ls, *Es;
  uint64_t* full;
  int H, Sp, group, nq, qt_lo, kvh, b;

  __device__ __forceinline__ void load(int t) const {
    using T = DkdvTile<D>;
    constexpr int SW = T::SW, EC = T::EC, STR = T::STR, STAGES = T::STAGES;
    const int s = t % STAGES, h = kvh * group + t / nq;
    const int q0 = (qt_lo + t % nq) * BT;
    hopper::mbar_arrive_expect_tx(&full[s], 2 * STR + 2 * BT * 4);
#pragma unroll
    for (int c = 0; c < T::NB; ++c) {
      hopper::tma_load_4d(Qs + s * STR + c * BT * SW, tq, &full[s], c * EC,
                          q0, h, b);
      hopper::tma_load_4d(dOs + s * STR + c * BT * SW, tdo, &full[s],
                          c * EC, q0, h, b);
    }
    const long long row = ((long long)b * H + h) * Sp + q0;
    hopper::bulk_load(Ls + s * BT, lse2 + row, BT * 4, &full[s]);
    hopper::bulk_load(Es + s * BT, delta + row, BT * 4, &full[s]);
  }
};

// One warpgroup of the dK / dV kernel: ROLE bit 0 accumulates dV, bit 1
// dK, for keys k0w .. k0w + 63 (sub-tile `sub` of K and V).  Works
// transposed, keys as rows: S^T = K Q^T and dP^T = V dO^T (K-major A and
// B), then P^T and dS^T on the accumulator fragment (a thread's columns,
// queries 8 j + 2 (lane % 4) + {0, 1}, read their lse and delta from the
// stage), then dV += P^T dO and dK += dS^T Q with P^T and dS^T as bf16 hi
// + lo register A operands and dO, Q MN-major B.  Every streamed tile is
// waited on and handed back, those that hold no unmasked pair for these
// keys without products; the second warpgroup to hand a stage back
// refills it with the tile STAGES on (no producer warp, no waiting).
template <int D, int ROLE>
__device__ __forceinline__ void dkdv_consumer(
    const DkdvFeed<D>& feed, const uint8_t* Ks, const uint8_t* Vs,
    uint64_t* kvbar, uint32_t* handed, int sub, int k0w, int nt,
    const Mask& mask, const Bwd& bwd, __nv_bfloat16* dk, __nv_bfloat16* dv,
    long long row0) {
  using T = DkdvTile<D>;
  constexpr bool DV = ROLE & 1, DK = ROLE & 2;
  constexpr int NA = DV + DK;                 // accumulators, dV first
  constexpr int SW = T::SW, EC = T::EC, KEYS = T::KEYS, STR = T::STR;
  constexpr int STAGES = T::STAGES;
  const uint8_t *Qs = feed.Qs, *dOs = feed.dOs;
  const float *Ls = feed.Ls, *Es = feed.Es;
  const int lane = threadIdx.x % 32, w4 = (threadIdx.x / 32) % 4;
  const int r = k0w + 16 * w4 + lane / 4;     // this thread's keys r, r + 8
  const int cq = 2 * (lane % 4);
  const bool leader = threadIdx.x % 128 == 0;
  const int Sq = mask.Sq, Sk = mask.Sk;
  const int kmax = min(k0w + WG_ROWS, Sk) - 1;

  float acc[NA][D / 2];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[n][i] = 0.f;
  auto pin_acc = [&]() {
#pragma unroll
    for (int n = 0; n < NA; ++n) hopper::fence_regs(acc[n]);
  };

  hopper::mbar_wait(kvbar, 0);
  for (int t = 0; t < nt; ++t) {
    const int s = t % STAGES;
    const int q0 = (feed.qt_lo + t % feed.nq) * BT;
    const int qa = mask.qoff + q0;             // the tile's first position
    const bool live = k0w < Sk && (!mask.causal || qa + BT - 1 >= k0w) &&
                      (!mask.window || qa - kmax < mask.window);
    hopper::mbar_wait(&feed.full[s], (t / STAGES) & 1);
    if (live) {
      // a tile with a masked pair: queries past Sq or keys past Sk (TMA's
      // zero rows), above the diagonal, outside the window
      const bool edge = q0 + BT > Sq || k0w + WG_ROWS > Sk ||
                        (mask.causal && qa < k0w + WG_ROWS - 1) ||
                        (mask.window && qa + BT - 1 - k0w >= mask.window);
      const uint64_t ak = hopper::opaque(
          hopper::desc<SW>(Ks + sub * WG_ROWS * SW, 16, 8 * SW));
      const uint64_t av = hopper::opaque(
          hopper::desc<SW>(Vs + sub * WG_ROWS * SW, 16, 8 * SW));
      const uint64_t bq = hopper::opaque(
          hopper::desc<SW>(Qs + s * STR, 16, 8 * SW));
      const uint64_t bo = hopper::opaque(
          hopper::desc<SW>(dOs + s * STR, 16, 8 * SW));
      // the first k16 step overwrites them (scale-d 0)
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      pin_acc();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = 16 * kk / EC, off = (16 * kk % EC) * 2;
        hopper::wgmma_ss<0, 0>(st, ak + ((c * KEYS * SW + off) >> 4),
                               bq + ((c * BT * SW + off) >> 4), kk > 0);
      }
      if constexpr (DK) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = 16 * kk / EC, off = (16 * kk % EC) * 2;
          hopper::wgmma_ss<0, 0>(dpt, av + ((c * KEYS * SW + off) >> 4),
                                 bo + ((c * BT * SW + off) >> 4), kk > 0);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      // P^T and dS^T: st[4 j + i] is key r + 8 (i / 2), query q0 + 8 j +
      // cq + i % 2
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 L = *reinterpret_cast<const float2*>(
            Ls + s * BT + 8 * j + cq);
        const float2 E = *reinterpret_cast<const float2*>(
            Es + s * BT + 8 * j + cq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = !edge || mask(q0 + 8 * j + cq + (i & 1),
                                        r + 8 * (i >> 1));
          float d;
          const float p = bwd.p(st[4 * j + i], (i & 1) ? L.y : L.x, ok, d);
          st[4 * j + i] = p;
          if constexpr (DK)
            dpt[4 * j + i] = bwd.ds(p, dpt[4 * j + i], (i & 1) ? E.y : E.x,
                                    d);
        }
      }
      uint32_t ahi[NA][4][4], alo[NA][4][4];   // P^T (dV), dS^T (dK)
      if constexpr (DV) hopper::split_hi_lo(st, ahi[0], alo[0]);
      if constexpr (DK) hopper::split_hi_lo(dpt, ahi[NA - 1], alo[NA - 1]);
      const uint64_t bo_mn = hopper::opaque(
          hopper::desc<SW>(dOs + s * STR, BT * SW, 8 * SW));
      const uint64_t bq_mn = hopper::opaque(
          hopper::desc<SW>(Qs + s * STR, BT * SW, 8 * SW));
      auto pin = [&]() {
        pin_acc();
#pragma unroll
        for (int n = 0; n < NA; ++n)
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            hopper::fence_regs(ahi[n][kc]);
            hopper::fence_regs(alo[n][kc]);
          }
      };
      pin();
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if constexpr (DV) {
          hopper::wgmma_rs<1>(acc[0], ahi[0][kc],
                              bo_mn + ((kc * 16 * SW) >> 4), 1);
          hopper::wgmma_rs<1>(acc[0], alo[0][kc],
                              bo_mn + ((kc * 16 * SW) >> 4), 1);
        }
        if constexpr (DK) {
          hopper::wgmma_rs<1>(acc[NA - 1], ahi[NA - 1][kc],
                              bq_mn + ((kc * 16 * SW) >> 4), 1);
          hopper::wgmma_rs<1>(acc[NA - 1], alo[NA - 1][kc],
                              bq_mn + ((kc * 16 * SW) >> 4), 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      pin();
    }
    // every thread of the warpgroup is past its reads of the stage (the
    // products that read it are in, and they started only once all four
    // warps had read their lse and delta): hand it back; the second
    // warpgroup to do so refills it
    if (leader) {
      __threadfence_block();
      if ((atomicAdd(&handed[s], 1u) & 1u) && t + STAGES < nt)
        feed.load(t + STAGES);
    }
  }

  // keys past Sk not stored
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kp = r + 8 * hr;
    if (kp >= Sk) continue;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      __nv_bfloat16* out = (DV && n == 0 ? dv : dk) + (row0 + kp) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + cq) =
            __floats2bfloat162_rn(acc[n][4 * j + 2 * hr],
                                  acc[n][4 * j + 2 * hr + 1]);
    }
  }
}

// A block per (KEYS keys, kv head, b): K and V once by TMA, then the
// group's heads in order and, for each, the query tiles that hold an
// unmasked query for some key of the block, through a STAGES-deep ring
// (`DkdvFeed`; thread 0 fills the first stages, then the warpgroups refill
// them).  The sum over the group's heads and query tiles is the loop: no
// atomics on the sums, one order.
template <int D>
__global__ void __launch_bounds__(DkdvTile<D>::THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse2,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int H, int KV,
                            int Sp, Mask mask, Bwd bwd) {
  using T = DkdvTile<D>;
  constexpr int SW = T::SW, EC = T::EC, KEYS = T::KEYS, STR = T::STR;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = hopper::align1024(smem_raw);
  uint8_t* Vs = Ks + T::RES;
  uint8_t* Qs = Vs + T::RES;                       // [stage] Q tiles
  uint8_t* dOs = Qs + STAGES * STR;                // [stage] dO tiles
  float* Ls = reinterpret_cast<float*>(dOs + STAGES * STR);  // [stage][BT]
  float* Es = Ls + STAGES * BT;                    // [stage][BT]
  uint64_t* full = reinterpret_cast<uint64_t*>(Es + STAGES * BT);
  uint64_t* kvbar = full + STAGES;
  uint32_t* handed = reinterpret_cast<uint32_t*>(kvbar + 1);  // [stage]

  const int Sq = mask.Sq, Sk = mask.Sk;
  const int kvh = blockIdx.y, b = blockIdx.z, group = H / KV;
  const int k0 = blockIdx.x * KEYS, k_last = min(k0 + KEYS, Sk) - 1;
  // a head's query tiles holding an unmasked query for some key here (none:
  // zeros are stored)
  const int q_lo = mask.causal ? max(0, k0 - mask.qoff) : 0;
  const int q_hi = mask.window
                       ? min(Sq - 1, k_last + mask.window - 1 - mask.qoff)
                       : Sq - 1;
  const int qt_lo = q_lo / BT;
  const int nq = q_lo <= q_hi ? q_hi / BT - qt_lo + 1 : 0;
  const int nt = group * nq;
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const DkdvFeed<D> feed{&tq, &tdo, lse2, delta, Qs, dOs, Ls, Es, full,
                         H, Sp, group, nq, qt_lo, kvh, b};

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      handed[s] = 0;
    }
    hopper::mbar_init(kvbar, 1);
    hopper::fence_barrier_init();
    hopper::mbar_arrive_expect_tx(kvbar, 2 * T::RES);
#pragma unroll
    for (int c = 0; c < T::NB; ++c) {
      hopper::tma_load_4d(Ks + c * KEYS * SW, &tk, kvbar, c * EC, k0, kvh, b);
      hopper::tma_load_4d(Vs + c * KEYS * SW, &tv, kvbar, c * EC, k0, kvh, b);
    }
    for (int t = 0; t < STAGES && t < nt; ++t) feed.load(t);
  }
  __syncthreads();

  const int sub = T::SPLIT ? 0 : wgi;
  const long long row0 = ((long long)b * KV + kvh) * Sk;
  if constexpr (T::SPLIT) {
    if (wgi == 0)
      dkdv_consumer<D, 1>(feed, Ks, Vs, kvbar, handed, sub, k0, nt, mask,
                          bwd, dk, dv, row0);
    else
      dkdv_consumer<D, 2>(feed, Ks, Vs, kvbar, handed, sub, k0, nt, mask,
                          bwd, dk, dv, row0);
  } else {
    dkdv_consumer<D, 3>(feed, Ks, Vs, kvbar, handed, sub,
                        k0 + sub * WG_ROWS, nt, mask, bwd, dk, dv, row0);
  }
}

// A block per (ROWS queries, head, b), heaviest first: Q and dO once by
// TMA, then the key tiles the forward visits through a ring of K and V
// tiles.  Per tile a warpgroup computes S = Q K^T and dP = dO V^T (K-major
// A and B), P and dS on the fragment (its rows' lse and delta in
// registers), then dQ += dS K with dS as a bf16 hi + lo register A operand
// and K as an MN-major B.  The sum over key tiles is the loop.
template <int D>
__global__ void __launch_bounds__(DqTile<D>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int H, int KV,
                          int Sp, Mask mask, Bwd bwd) {
  using T = DqTile<D>;
  constexpr int SW = T::SW, EC = T::EC, NWG = T::NWG, ROWS = T::ROWS;
  constexpr int STR = T::STR, STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = hopper::align1024(smem_raw);
  uint8_t* dOs = Qs + T::RES;
  uint8_t* Ks = dOs + T::RES;                      // [stage] K tiles
  uint8_t* Vs = Ks + STAGES * STR;                 // [stage] V tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * STR);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int Sq = mask.Sq, Sk = mask.Sk;
  const int qt = gridDim.x - 1 - blockIdx.x;       // heaviest blocks first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = qt * ROWS, q_last = min(q0 + ROWS, Sq) - 1;
  // the key tiles the forward visits for these rows
  const int k_hi = mask.causal ? min(mask.qoff + q_last, Sk - 1) : Sk - 1;
  const int k_lo = mask.window ? max(0, mask.qoff + q0 - mask.window + 1)
                               : 0;
  const int kt_lo = k_lo / BT, nt = k_hi / BT - kt_lo + 1;
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NWG);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == NWG) {                      // producer warp: one thread
    if (threadIdx.x == NWG * 128) {
      hopper::mbar_arrive_expect_tx(qbar, 2 * T::RES);
#pragma unroll
      for (int c = 0; c < T::NB; ++c) {
        hopper::tma_load_4d(Qs + c * ROWS * SW, &tq, qbar, c * EC, q0, h, b);
        hopper::tma_load_4d(dOs + c * ROWS * SW, &tdo, qbar, c * EC, q0, h,
                            b);
      }
      for (int t = 0; t < nt; ++t) {
        const int s = t % STAGES, k0 = (kt_lo + t) * BT;
        hopper::mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * STR);
#pragma unroll
        for (int c = 0; c < T::NB; ++c) {
          hopper::tma_load_4d(Ks + s * STR + c * BT * SW, &tk, &full[s],
                              c * EC, k0, kvh, b);
          hopper::tma_load_4d(Vs + s * STR + c * BT * SW, &tv, &full[s],
                              c * EC, k0, kvh, b);
        }
      }
    }
  } else {                               // consumer warpgroups
    const int lane = threadIdx.x % 32, w4 = (threadIdx.x / 32) % 4;
    const bool leader = threadIdx.x % 128 == 0;
    const int wr0 = q0 + wgi * WG_ROWS;    // this warpgroup's first row
    const int r = wr0 + 16 * w4 + lane / 4;  // this thread's rows r, r + 8
    const int cq = 2 * (lane % 4);
    const long long rows = ((long long)b * H + h) * Sp;
    // padded to Sp >= q0 + ROWS: rows past Sq read lse +inf, delta 0
    const float L[2] = {lse2[rows + r], lse2[rows + r + 8]};
    const float E[2] = {delta[rows + r], delta[rows + r + 8]};
    // this warpgroup's live tiles [t0, t1], as the forward's
    const int wa = mask.qoff + wr0;        // its first row's position
    const int wk_lo = mask.window ? max(0, wa - mask.window + 1) : 0;
    const int wk_hi = mask.causal ? min(wa + WG_ROWS - 1, k_hi) : k_hi;
    const int t0 = max(wk_lo / BT - kt_lo, 0);
    const int t1 = min(wk_hi / BT - kt_lo, nt - 1);
    const uint8_t* qw = Qs + wgi * WG_ROWS * SW;
    const uint8_t* ow = dOs + wgi * WG_ROWS * SW;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    hopper::mbar_wait(qbar, 0);
    for (int t = 0; t < nt; ++t) {
      const int s = t % STAGES, k0 = (kt_lo + t) * BT;
      hopper::mbar_wait(&full[s], (t / STAGES) & 1);
      if (t >= t0 && t <= t1) {
        // a tile with a masked pair: keys past Sk (TMA's zero rows),
        // rows past Sq, above the diagonal, outside the window
        const bool edge = k0 + BT > Sk || wr0 + WG_ROWS > Sq ||
                          (mask.causal && k0 + BT - 1 > wa) ||
                          (mask.window &&
                           wa + WG_ROWS - 1 - k0 >= mask.window);
        const uint64_t aq = hopper::opaque(hopper::desc<SW>(qw, 16, 8 * SW));
        const uint64_t ao = hopper::opaque(hopper::desc<SW>(ow, 16, 8 * SW));
        const uint64_t bk = hopper::opaque(
            hopper::desc<SW>(Ks + s * STR, 16, 8 * SW));
        const uint64_t bv = hopper::opaque(
            hopper::desc<SW>(Vs + s * STR, 16, 8 * SW));
        // the first k16 step overwrites them (scale-d 0)
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = 16 * kk / EC, off = (16 * kk % EC) * 2;
          hopper::wgmma_ss<0, 0>(sc, aq + ((c * ROWS * SW + off) >> 4),
                                 bk + ((c * BT * SW + off) >> 4), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = 16 * kk / EC, off = (16 * kk % EC) * 2;
          hopper::wgmma_ss<0, 0>(dp, ao + ((c * ROWS * SW + off) >> 4),
                                 bv + ((c * BT * SW + off) >> 4), kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        // sc[4 j + i] is row r + 8 (i / 2), key k0 + 8 j + cq + i % 2
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool ok = !edge || mask(r + 8 * (i >> 1),
                                          k0 + 8 * j + cq + (i & 1));
            float d;
            const float p = bwd.p(sc[4 * j + i], L[i >> 1], ok, d);
            sc[4 * j + i] = bwd.ds(p, dp[4 * j + i], E[i >> 1], d);
          }
        uint32_t hi[4][4], lo[4][4];
        hopper::split_hi_lo(sc, hi, lo);
        auto pin = [&]() {
          hopper::fence_regs(acc);
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            hopper::fence_regs(hi[kc]);
            hopper::fence_regs(lo[kc]);
          }
        };
        const uint64_t bk_mn = hopper::opaque(
            hopper::desc<SW>(Ks + s * STR, BT * SW, 8 * SW));
        pin();
        hopper::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          hopper::wgmma_rs<1>(acc, hi[kc], bk_mn + ((kc * 16 * SW) >> 4), 1);
          hopper::wgmma_rs<1>(acc, lo[kc], bk_mn + ((kc * 16 * SW) >> 4), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        pin();
      }
      if (leader) hopper::mbar_arrive(&empty[s]);
    }

    // rows past Sq not stored
    __nv_bfloat16* out = dq + rows / Sp * Sq * (long long)D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qp = r + 8 * hr;
      if (qp >= Sq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)qp * D + 8 * j +
                                           cq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hr],
                                  acc[4 * j + 2 * hr + 1]);
    }
  }
}

// a [B, heads, rows, D] bf16 operand over strides st (b, head, s; in
// elements) as a 4D tensor map with boxes of EC columns x box_rows rows
template <int D>
int encode_operand(CUtensorMap* map, const void* base, const long long* st,
                   int B, int heads, int rows, int box_rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)rows, (uint64_t)heads,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)st[2] * 2, (uint64_t)st[1] * 2,
                               (uint64_t)st[0] * 2};
  const uint32_t box[4] = {(uint32_t)WTile<D>::EC, (uint32_t)box_rows, 1, 1};
  return hopper::encode_bf16(map, 4, base, dims, strides, box, WTile<D>::SW);
}

template <int D>
int launch_wgmma(const Args& a, int Sp, float* lse2, cudaStream_t stream) {
  using K1 = DkdvTile<D>;
  using K2 = DqTile<D>;
  int err = launch_delta<__nv_bfloat16>(a, D, Sp, lse2, stream);
  if (err) return err;
  const Bwd bwd{a.cap != 0.f ? a.scale / a.cap : a.scale * LOG2E,
                a.cap * LOG2E, a.scale, a.cap != 0.f};

  // dK / dV: Q and dO in tiles of BT rows, K and V of KEYS
  CUtensorMap m1[4];
  if ((err = encode_operand<D>(&m1[0], a.q, a.st.q, a.B, a.H, a.Sq, BT)) ||
      (err = encode_operand<D>(&m1[1], a.k, a.st.k, a.B, a.KV, a.Sk,
                               K1::KEYS)) ||
      (err = encode_operand<D>(&m1[2], a.v, a.st.v, a.B, a.KV, a.Sk,
                               K1::KEYS)) ||
      (err = encode_operand<D>(&m1[3], a.dout, a.st.d, a.B, a.H, a.Sq, BT)))
    return err;
  auto k1 = flash_bwd_dkdv_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, K1::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 g1((unsigned)((a.Sk + K1::KEYS - 1) / K1::KEYS), (unsigned)a.KV,
                (unsigned)a.B);
  k1<<<g1, K1::THREADS, K1::SMEM, stream>>>(
      m1[0], m1[1], m1[2], m1[3], lse2, a.delta, (__nv_bfloat16*)a.dk,
      (__nv_bfloat16*)a.dv, a.H, a.KV, Sp, a.mask, bwd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // dQ: Q and dO in tiles of ROWS rows, K and V of BT
  CUtensorMap m2[4];
  if ((err = encode_operand<D>(&m2[0], a.q, a.st.q, a.B, a.H, a.Sq,
                               K2::ROWS)) ||
      (err = encode_operand<D>(&m2[1], a.k, a.st.k, a.B, a.KV, a.Sk, BT)) ||
      (err = encode_operand<D>(&m2[2], a.v, a.st.v, a.B, a.KV, a.Sk, BT)) ||
      (err = encode_operand<D>(&m2[3], a.dout, a.st.d, a.B, a.H, a.Sq,
                               K2::ROWS)))
    return err;
  auto k2 = flash_bwd_dq_wgmma_kernel<D>;
  e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           K2::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 g2((unsigned)((a.Sq + K2::ROWS - 1) / K2::ROWS), (unsigned)a.H,
                (unsigned)a.B);
  k2<<<g2, K2::THREADS, K2::SMEM, stream>>>(
      m2[0], m2[1], m2[2], m2[3], lse2, a.delta, (__nv_bfloat16*)a.dq, a.H,
      a.KV, Sp, a.mask, bwd);
  return (int)cudaGetLastError();
}

int dispatch_wgmma(int D, const Args& a, int Sp, float* lse2,
                   cudaStream_t s) {
  switch (D) {
    case 16: return launch_wgmma<16>(a, Sp, lse2, s);
    case 32: return launch_wgmma<32>(a, Sp, lse2, s);
    case 64: return launch_wgmma<64>(a, Sp, lse2, s);
    case 128: return launch_wgmma<128>(a, Sp, lse2, s);
    case 256: return launch_wgmma<256>(a, Sp, lse2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The padded row count of the wgmma route's scratch rows (a multiple of
// every block's query rows).
constexpr int ROW_PAD = 128;

// dtype 0 = float32 (simt route), 1 = bfloat16 (wgmma route: q, k, v and
// dout 16-byte aligned with strides multiples of 8, read by TMA); `st`
// holds 15 strides in elements, (b, head, s) for each of q, k, v, o and
// dout, the head dimension contiguous (rows 8-byte aligned in bf16,
// 16-byte in float32); lse is float32 [B, H, Sq]; `scratch` float32 of 2 B
// H Sp floats, Sp = Sq rounded up to a multiple of 128 (delta, and the
// wgmma route's padded lse); dq [B, H, Sq, D], dk and dv [B, KV, Sk, D]
// contiguous; qoff (>= 0, only under a mask, Sk >= qoff + Sq) places
// query row q at position qoff + q.  Three kernels on `stream`; returns
// the first launch error.
// *route is set to the route launched: 1 = wgmma, 0 = simt.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int H, int KV, int Sq, int Sk, int D, int dtype,
    const long long* st, int causal, int window, int qoff, float scale,
    float cap, void* stream, int* route) {
  if (B <= 0 || H <= 0 || KV <= 0 || Sq <= 0 || Sk <= 0 || H % KV != 0 ||
      qoff < 0 || (qoff > 0 && ((!causal && !window) || Sk < qoff + Sq)))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, (const float*)lse, (float*)scratch, dq, dk, dv,
         B, H, KV, Sq, Sk, {}, Mask{Sq, Sk, causal, window, qoff}, scale,
         cap};
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = st[i];
    a.st.k[i] = st[3 + i];
    a.st.v[i] = st[6 + i];
    a.st.o[i] = st[9 + i];
    a.st.d[i] = st[12 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  *route = dtype == 1;
  if (dtype == 0) return dispatch_d<float>(D, a, s);
  if (dtype == 1) {
    const int Sp = (Sq + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
    return dispatch_wgmma(D, a, Sp, (float*)scratch + (long long)B * H * Sp,
                          s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
