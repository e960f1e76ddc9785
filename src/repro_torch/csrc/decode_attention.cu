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
// (B 8, KV 8, G 2, D 256, 4096 slots) the full cache is 268 MB a layer.
//
// Design: one 256-thread block per (b, kv head), as the Pallas grid's
// (batch, kv_head) axes; its sequential kv-block axis becomes a loop.  A
// cache row of D elements is read by D / 8 lanes, 16 bytes (8 bf16) or 32
// bytes (8 floats) a lane, so a warp reads 32 / (D / 8) rows at once and
// the block 8 times that (one "row group" per D / 8 lanes).  Each row
// group walks its own slots in tiles of TS (all 2 TS K and V loads of a
// tile are issued before they are used), reduces the TS dot products over
// its lanes with xor shuffles and keeps its own online-softmax state (m, l,
// and 8 columns of acc per query head in registers).  Only slots up to
// pos[b] are read: a later slot carries exactly zero weight (its logit is
// -1e30; once a group has a finite max, exp(-1e30 - m) is 0, and a group
// that never saw a valid slot is weighted exp(-1e30 - m) = 0 in the
// merge).  At the end the row groups are merged through shared memory in
// a fixed order (m = max, each group's l and acc scaled by exp(m_i - m)),
// so a launch is deterministic.  The query heads sit in shared memory.  The
// grid is B x KV blocks (64 at gemma2's batch of 8 on 132 SMs); split-KV
// across blocks comes later.
//
// Group sizes: the per-thread state is sized at compile time for GM query
// heads.  G <= 8 (gemma2's 2) takes the GM = 8 build with tiles of TS = 4
// slots; 8 < G <= 16 (recurrentgemma's 16 heads over 1 kv head) takes a
// GM = 16 build with tiles of TS = 2 slots, which halves the per-tile
// logits and loads held beside the 16 heads' accumulators (16 x 8 floats
// a lane).  Each launch still reads every valid cache row once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32, VEC = 8;
constexpr int GMAX = 16;           // query heads per kv head, at most
constexpr float NEG_INF = -1e30f;

struct Row8 {
  float x[VEC];
};

template <typename T>
struct Raw;
template <>
struct Raw<float> {
  float4 a, b;
};
template <>
struct Raw<__nv_bfloat16> {
  uint4 a;
};

__device__ __forceinline__ void load_raw(Raw<float>& r, const float* p) {
  r.a = *reinterpret_cast<const float4*>(p);
  r.b = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void load_raw(Raw<__nv_bfloat16>& r,
                                         const __nv_bfloat16* p) {
  r.a = *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ Row8 widen(const Raw<float>& r) {
  return Row8{{r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w}};
}
__device__ __forceinline__ Row8 widen(const Raw<__nv_bfloat16>& r) {
  Row8 o;
  const uint32_t w[4] = {r.a.x, r.a.y, r.a.z, r.a.w};
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

template <int D>
__host__ __device__ constexpr int n_groups() {
  return WARPS * (32 / (D / VEC));
}

// shared floats: q [G][D], acc [groups][G][D], m and l [groups][G]
template <int D>
__host__ __device__ constexpr int smem_floats(int G) {
  return G * D + n_groups<D>() * G * D + 2 * n_groups<D>() * G;
}

// GM: query heads the thread state holds; TS: slots per tile of a row group
template <typename T, int D, int GM, int TS>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int KV, int G, int S, long long ksb, long long ksh,
                        long long kss, long long vsb, long long vsh,
                        long long vss, float scale, float cap) {
  constexpr int LPR = D / VEC;               // lanes per cache row
  constexpr int NG = n_groups<D>();          // row groups in the block
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [G][D]
  float* accs = qs + G * D;                  // [NG][G][D]
  float* ms = accs + NG * G * D;             // [NG][G]
  float* ls = ms + NG * G;                   // [NG][G]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = warp * (32 / LPR) + lane / LPR;
  const int li = lane % LPR, d0 = li * VEC;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const long long qoff = ((long long)b * KV + kvh) * G * D;

  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f(q[qoff + i]);
  __syncthreads();

  // slots 0 .. n_valid - 1 carry weight
  const int n_valid = min(pos[b] + 1, S);
  const T* kb = k + b * ksb + kvh * ksh + d0;
  const T* vb = v + b * vsb + kvh * vsh + d0;

  float m[GM], l[GM], acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // the loop bound is the warp's first group's, so every lane of a warp
  // runs every iteration (the shuffles below need all 32)
  const int warp_s0 = warp * (32 / LPR) * TS;
  for (int it = 0; warp_s0 + it < n_valid; it += NG * TS) {
    const int s0 = grp * TS + it;
    Raw<T> kr[TS]{}, vr[TS]{};
#pragma unroll
    for (int t = 0; t < TS; ++t) {
      if (s0 + t < n_valid) {
        load_raw(kr[t], kb + (long long)(s0 + t) * kss);
        load_raw(vr[t], vb + (long long)(s0 + t) * vss);
      }
    }
    float sc[GM][TS];
#pragma unroll
    for (int t = 0; t < TS; ++t) {
      const Row8 kf = widen(kr[t]);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        const float4 qa = *reinterpret_cast<const float4*>(qs + g * D + d0);
        const float4 qb = *reinterpret_cast<const float4*>(qs + g * D + d0 + 4);
        float x = 0.f;
        x = fmaf(qa.x, kf.x[0], x);
        x = fmaf(qa.y, kf.x[1], x);
        x = fmaf(qa.z, kf.x[2], x);
        x = fmaf(qa.w, kf.x[3], x);
        x = fmaf(qb.x, kf.x[4], x);
        x = fmaf(qb.y, kf.x[5], x);
        x = fmaf(qb.z, kf.x[6], x);
        x = fmaf(qb.w, kf.x[7], x);
        sc[g][t] = x;
      }
    }
    // sum each dot product over the row's lanes (same bits in every lane)
#pragma unroll
    for (int off = LPR / 2; off >= 1; off >>= 1)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int t = 0; t < TS; ++t)
          sc[g][t] += __shfl_xor_sync(0xffffffffu, sc[g][t], off);
      }
    Row8 vf[TS];                 // zeros for slots not loaded
#pragma unroll
    for (int t = 0; t < TS; ++t) vf[t] = widen(vr[t]);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float mx = NEG_INF;
#pragma unroll
      for (int t = 0; t < TS; ++t) {
        float x = sc[g][t] * scale;
        if (cap != 0.f) x = tanhf(x / cap) * cap;
        sc[g][t] = (s0 + t < n_valid) ? x : NEG_INF;
        mx = fmaxf(mx, sc[g][t]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float p[TS], sum = 0.f;
#pragma unroll
      for (int t = 0; t < TS; ++t) {
        p[t] = expf(sc[g][t] - m_new);
        sum += p[t];
      }
      l[g] = alpha * l[g] + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int t = 0; t < TS; ++t) a = fmaf(p[t], vf[t].x[e], a);
        acc[g][e] = a;
      }
    }
  }

  // merge the row groups in a fixed order
  if (li == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      ms[grp * G + g] = m[g];
      ls[grp * G + g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    float mt = NEG_INF;
    for (int i = 0; i < NG; ++i) mt = fmaxf(mt, ms[i * G + g]);
    const float f = expf(m[g] - mt);
    float* dst = accs + ((long long)grp * G + g) * D + d0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = acc[g][e] * f;
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D;
    float mt = NEG_INF;
    for (int i = 0; i < NG; ++i) mt = fmaxf(mt, ms[i * G + g]);
    float sum = 0.f, lt = 0.f;
    for (int i = 0; i < NG; ++i) {
      sum += accs[(long long)i * G * D + idx];
      lt += ls[i * G + g] * expf(ms[i * G + g] - mt);
    }
    store1(out + qoff + idx, sum / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int D, int GM, int TS>
int launch_g(const void* q, const void* k, const void* v, const void* pos,
             void* out, int B, int KV, int G, int S, const long long* st,
             float scale, float cap, cudaStream_t stream) {
  const int bytes = smem_floats<D>(G) * (int)sizeof(float);
  auto kern = decode_attention_kernel<T, D, GM, TS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)(B * KV), THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)pos, (T*)out, KV, G,
      S, st[0], st[1], st[2], st[3], st[4], st[5], scale, cap);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, int B, int KV, int G, int S, const long long* st,
           float scale, float cap, cudaStream_t stream) {
  if (G <= 8)
    return launch_g<T, D, 8, 4>(q, k, v, pos, out, B, KV, G, S, st, scale,
                                cap, stream);
  return launch_g<T, D, 16, 2>(q, k, v, pos, out, B, KV, G, S, st, scale,
                               cap, stream);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const void* pos, void* out, int B, int KV, int G, int S,
               const long long* st, float scale, float cap,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, pos, out, B, KV, G, S, st, scale, cap, s);
    case 32: return launch<T, 32>(q, k, v, pos, out, B, KV, G, S, st, scale, cap, s);
    case 64: return launch<T, 64>(q, k, v, pos, out, B, KV, G, S, st, scale, cap, s);
    case 128: return launch<T, 128>(q, k, v, pos, out, B, KV, G, S, st, scale, cap, s);
    case 256: return launch<T, 256>(q, k, v, pos, out, B, KV, G, S, st, scale, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; q and out are [B, KV, G, D]
// contiguous; k/v strides in elements over (b, kv head, slot), the head
// dimension contiguous; pos is [B] int32
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    int B, int KV, int G, int S, int D, int dtype, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, float scale, float cap, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || G > GMAX || S <= 0)
    return (int)cudaErrorInvalidValue;
  const long long st[6] = {ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, pos, out, B, KV, G, S, st, scale,
                             cap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, pos, out, B, KV, G, S, st,
                                     scale, cap, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
