// Chunkwise mLSTM cell, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/mlstm_chunk/mlstm_chunk.py
// (`mlstm_chunk`): the stabilised mLSTM recurrence over q, k, v
// [B, S, H, D] (q unscaled, `scale` applied as the reference's
// `mlstm_chunk_math` applies it) and the gate pre-activations i, f
// [B, S, H] float32, cut into chunks of LC steps, each chunk two masked
// [L, L] products plus the carried state.  Two differences from the Pallas
// kernel, both for serving: it starts from a given state (C0 [B, H, D, D],
// n0 [B, H, D], m0 [B, H], float32) and returns the final one (C1, n1,
// m1), so decode is the same launch on a one-step chunk; and it takes any
// S >= 1, the last chunk ragged (masked), where the Pallas kernel asks
// S % chunk == 0.  h [B, S, H, D] is written in q's dtype.
//
// Math per chunk, in `mlstm_chunk_math`'s order (float32, expf / log1pf,
// no fast-math intrinsics): log f = -softplus(-f); b = cumsum log f; a =
// i - b; mx = max(m0, cummax a); sw[t, s] = (q_t . k_s) * scale *
// exp(a_s - mx_t) for s <= t; h_t = (q_t C * (scale exp(m0 - mx_t)) +
// sum_s sw[t, s] v_s) / max(|rowsum sw + (q_t . n) scale exp(m0 - mx_t)|,
// exp(-(b_t + mx_t))); then C <- exp(m0 - mx_L) C + sum_s exp(a_s - mx_L)
// k_s v_s^T, n likewise, m <- b_L + mx_L.  The gate cumulatives are taken
// inside the block, one lane a step, each sum and max in step order.
//
// Bound: operations.  Per (b, h) and token the two D x D products (q C and
// the rank-one C update) and the chunk's [L, L] work: S (4 D^2 + 4 L D)
// flops; at xlstm-350m's prefill (B 8, S 1024, H 4, D 256) 9.7 GFLOP, 144
// us at the H100 SXM's 67 TFLOP/s fp32 outside the tensor cores (9.8 us at
// 989 TFLOP/s bf16), against 84 MB of reads and writes (25 us at 3.35
// TB/s).  Decode (S 1) is bound by bytes: reading and writing C, 2 B H D^2
// 4 B = 16.8 MB at B 8.
//
// Design: one head's C is 256 KB of float32 at D = 256, more than a block's
// 227 KB of shared memory, so the value dimension is split: grid (B H,
// D / DV), each block holds C[:, v-tile] (DV = 64: 64 KB) and the whole n
// and m in shared memory for the whole sequence, and walks the chunks in a
// loop (the Pallas grid's sequential chunk axis).  Every value-tile block
// of a head recomputes the chunk's q k^T, gate cumulatives and
// denominators (4x redundant at D = 256); only tile 0 writes n1 and m1.
// q and k rows are padded by one float in shared memory so the lanes of a
// warp that take neighbouring key steps read distinct banks.  A simple
// SIMT kernel: wgmma and TMA are a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int LC = 32;             // chunk length: one lane per key step

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

template <typename T>
int by_dim(const void* q, const void* k, const void* v, const float* ig,
           const float* fg, const float* C0, const float* n0,
           const float* m0, void* h, float* C1, float* n1, float* m1, int B,
           int S, int H, int D, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, ig, fg, C0, n0, m0, h, C1, n1, m1,
                                  B, S, H, scale, s);
    case 32: return launch<T, 32>(q, k, v, ig, fg, C0, n0, m0, h, C1, n1, m1,
                                  B, S, H, scale, s);
    case 64: return launch<T, 64>(q, k, v, ig, fg, C0, n0, m0, h, C1, n1, m1,
                                  B, S, H, scale, s);
    case 128: return launch<T, 128>(q, k, v, ig, fg, C0, n0, m0, h, C1, n1,
                                    m1, B, S, H, scale, s);
    case 256: return launch<T, 256>(q, k, v, ig, fg, C0, n0, m0, h, C1, n1,
                                    m1, B, S, H, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 for q, k, v and h; q, k, v, h
// [B, S, H, D] and gates [B, S, H] contiguous; the state float32
// contiguous; D one of 16, 32, 64, 128, 256
extern "C" int repro_mlstm_chunk(const void* q, const void* k, const void* v,
                                 const void* ig, const void* fg,
                                 const void* C0, const void* n0,
                                 const void* m0, void* h, void* C1, void* n1,
                                 void* m1, int B, int S, int H, int D,
                                 int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *fi = (const float*)ig, *ff = (const float*)fg,
              *c0 = (const float*)C0, *nn = (const float*)n0,
              *mm = (const float*)m0;
  float *c1 = (float*)C1, *n1f = (float*)n1, *m1f = (float*)m1;
  if (dtype == 0)
    return by_dim<float>(q, k, v, fi, ff, c0, nn, mm, h, c1, n1f, m1f, B, S,
                         H, D, scale, s);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(q, k, v, fi, ff, c0, nn, mm, h, c1, n1f, m1f,
                                 B, S, H, D, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
