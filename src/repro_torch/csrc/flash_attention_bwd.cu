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
// forward's: k < Sk, q >= k when causal, q - k < window with a window.
// Inputs float32 or bfloat16 (any strides over (b, head, s) with the head
// dimension contiguous), all math in float32, dq [B, H, Sq, D] and dk, dv
// [B, KV, Sk, D] contiguous in the inputs' dtype.
//
// Bound: operations.  Five products of 2 Sq Sk D flops a head (Q K^T and
// dO V^T recomputed, P^T dO, dS^T Q, dS K), halved under the causal mask:
// at minicpm-2b's training shape (H 36, S 4,096, D 64) 1.9e11 flops on
// ~95 MB, about 2,000 flops a byte.
//
// Design: three launches on one stream, counted as one call, SIMT fp32
// (`fmaf`) products over float32 tiles in shared memory, 256 threads a
// block as 16 x 16:
//
// * delta: one warp a row of dO and o.
// * dK / dV: a block per (key tile of BK rows, kv head, b).  It keeps its
//   K and V tiles in shared memory and dK, dV in registers, and walks the
//   group's G heads in order and, for each, the query tiles of BQ rows that
//   hold an unmasked query for some key of the tile, in order: S and dO V^T
//   in registers, P and dS through shared memory into dV += P^T dO and
//   dK += dS^T Q.  The sum over the group is the loop, not atomics.
// * dQ: a block per (query tile, head, b), heaviest first, holding Q, dO,
//   lse and delta; it walks the key tiles the forward visits and adds
//   dS K.
//
// Every sum has one fixed order and no atomics are used, so two launches
// are bitwise equal.  Rows past Sq or Sk are zero in shared memory and
// masked out of P (a zero key row must not get the zero logit's weight).
// Tiles: BQ = BK = 64 up to D 128 (170 KB of shared memory at D 128), 32 at
// D 256 (143 KB), so dK and dV stay at 64 registers a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, PAD = 4;

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

struct Mask {
  int Sq, Sk, causal, window;
  __device__ __forceinline__ bool operator()(int qp, int kp) const {
    bool ok = qp < Sq && kp < Sk;
    if (causal) ok = ok && qp >= kp;
    if (window) ok = ok && qp - kp < window;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int H, int Sq, int D,
                       long long osb, long long osh, long long oss,
                       long long dsb, long long dsh, long long dss,
                       long long rows) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long s = row % Sq, bh = row / Sq;
  const long long h = bh % H, b = bh / H;
  const T* orow = o + b * osb + h * osh + s * oss;
  const T* drow = dout + b * dsb + h * dsh + s * dss;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
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
  const int q_lo = mask.causal ? k0 : 0;
  const int q_hi = mask.window ? min(Sq - 1, k_last + mask.window - 1)
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
  const int k_hi = mask.causal ? min(q_last, Sk - 1) : Sk - 1;
  const int k_lo = mask.window ? max(0, q0 - mask.window + 1) : 0;

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

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  using C = Tiles<D>;
  const long long rows = (long long)a.B * a.H * a.Sq;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), THREADS, 0,
                              stream>>>(
      (const T*)a.o, (const T*)a.dout, a.delta, a.H, a.Sq, D, a.st.o[0],
      a.st.o[1], a.st.o[2], a.st.d[0], a.st.d[1], a.st.d[2], rows);
  cudaError_t err = cudaGetLastError();
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

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (all of q, k, v, o, dout, dq, dk, dv);
// `st` holds 15 strides in elements, (b, head, s) for each of q, k, v, o
// and dout, the head dimension contiguous (rows 8-byte aligned in bf16,
// 16-byte in float32); lse and delta (scratch) are float32 [B, H, Sq]; dq
// [B, H, Sq, D], dk and dv [B, KV, Sk, D] contiguous.  Three kernels on
// `stream`; returns the first launch error.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int KV, int Sq, int Sk, int D, int dtype,
    const long long* st, int causal, int window, float scale, float cap,
    void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || Sq <= 0 || Sk <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, (const float*)lse, (float*)delta, dq, dk, dv,
         B, H, KV, Sq, Sk, {}, Mask{Sq, Sk, causal, window}, scale, cap};
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = st[i];
    a.st.k[i] = st[3 + i];
    a.st.v[i] = st[6 + i];
    a.st.o[i] = st[9 + i];
    a.st.d[i] = st[12 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(D, a, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
