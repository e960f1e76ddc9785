// Online-softmax prefill attention (causal, sliding window, tanh softcap,
// GQA) for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/
// flash_attention.py (`flash_attention`): for each (b, h) and query row q,
// o[q] = softmax_k(mask(cap(q . k * scale))) @ v over the kv head h / group,
// with mask = k < S, and q >= k when causal, and q - k < window when a
// window is set (positions are indices); masked logits are -1e30 and the
// running sum is clamped at 1e-30, as in the TPU kernel.  float32 math
// from float32 or bfloat16 inputs; the output has the inputs' dtype.
//
// Bound: operations.  At gemma2-9b's prefill (B 8, H 16, D 256, S in the
// thousands) a causal launch does 2 B H S^2 D flops (QK^T and PV, half of
// the square each) on a few hundred MB, thousands of flops per byte, far
// above the H100's ~20 fp32 flops per byte of HBM.
//
// Design: a SIMT flash loop.  One 256-thread block owns 64 query rows of
// one (b, h) and walks the kv tiles of 64 rows itself (the Pallas grid's
// sequential kv axis with its VMEM (m, l, acc) scratch becomes a loop with
// m and l in registers and acc, 64 rows x D, spread over the block's
// registers, 4 rows x D/16 columns a thread).  Q, K and V tiles are
// converted to float32 into dynamic shared memory (216 KB at D = 256,
// one block per SM); Q and K rows are padded by 4 floats so the float4
// reads of the QK^T product are free of bank conflicts.  Each thread
// computes a 4 x 4 block of the 64 x 64 logit tile with fmaf (no tensor
// cores, no TF32), the row max and sum reduce over the 16 threads of a
// row with xor shuffles (every lane gets the same bits), and the
// probabilities go through shared memory into the PV product.  Only the
// kv tiles that hold an unmasked key for some row of the block are
// visited: a tile wholly above the diagonal or wholly before the window
// would add exactly zero (after a finite max, exp(-1e30 - m) is 0; before
// one, alpha = exp(-1e30 - m) zeroes what it added).  Query blocks are
// issued heaviest first.  Every sum has one fixed order, so a launch is
// deterministic.  Ragged S is masked: rows and keys past S load zeros,
// keys past S are masked, rows past S are not stored.  wgmma, TMA and a
// pipelined K/V ring come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256, PAD = 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// rows [r0, r0 + ROWS) of a [*, S, D] operand (row stride `ss`) into a
// float32 shared tile with row pitch `pitch`; rows at or past S are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const T* __restrict__ src,
                                          long long ss, int r0, int S) {
  constexpr int V4 = D / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * V4; idx += THREADS) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = load4(src + (long long)(r0 + r) * ss + c);
    *reinterpret_cast<float4*>(dst + r * pitch + c) = x;
  }
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + PAD) + BK * (D + PAD) + BK * D + BQ * (BK + PAD);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int H, int group, int S,
                       long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss,
                       int causal, int window, float scale, float cap) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [BQ][D + PAD]
  float* Ks = Qs + BQ * (D + PAD);           // [BK][D + PAD]
  float* Vs = Ks + BK * (D + PAD);           // [BK][D]
  float* Ps = Vs + BK * D;                   // [BQ][BK + PAD]

  constexpr int CG = D / 4;                  // float4 column groups
  constexpr int NJ = (CG + 15) / 16;         // column groups per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest blocks first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, S) - 1;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  load_tile<T, D, BQ>(Qs, D + PAD, qb, qss, q0, S);

  // kv tiles holding an unmasked key for some row of this block
  const int k_hi = causal ? q_last : S - 1;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int kt_lo = k_lo / BK, kt_hi = k_hi / BK;

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                         // last tile's readers are done
    load_tile<T, D, BK>(Ks, D + PAD, kb, kss, k0, S);
    load_tile<T, D, BK>(Vs, D, vb, vss, k0, S);
    __syncthreads();

    // s = Q K^T for rows ty*4 + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * (D + PAD) + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * (D + PAD) + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // scale, softcap, mask, then the online-softmax update per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (cap != 0.f) x = tanhf(x / cap) * cap;
        bool ok = kp < S;
        if (causal) ok = ok && qp >= kp;
        if (window) ok = ok && qp - kp < window;
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * (BK + PAD) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty*4 + i, columns 4 (tx + 16 j) .. + 3
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * (BK + PAD) + kk);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int g = tx + 16 * j;
        if (g >= CG) continue;
        const float4 v0 = *reinterpret_cast<const float4*>(Vs + (kk + 0) * D + 4 * g);
        const float4 v1 = *reinterpret_cast<const float4*>(Vs + (kk + 1) * D + 4 * g);
        const float4 v2 = *reinterpret_cast<const float4*>(Vs + (kk + 2) * D + 4 * g);
        const float4 v3 = *reinterpret_cast<const float4*>(Vs + (kk + 3) * D + 4 * g);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv[4] = {pa[i].x, pa[i].y, pa[i].z, pa[i].w};
          const float4 vv[4] = {v0, v1, v2, v3};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            acc[i][j][0] = fmaf(pv[t], vv[t].x, acc[i][j][0]);
            acc[i][j][1] = fmaf(pv[t], vv[t].y, acc[i][j][1]);
            acc[i][j][2] = fmaf(pv[t], vv[t].z, acc[i][j][2]);
            acc[i][j][3] = fmaf(pv[t], vv[t].w, acc[i][j][3]);
          }
        }
      }
    }
  }

  // o = acc / max(l, 1e-30), rows past S not stored
  T* ob = out + ((long long)b * H + h) * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int g = tx + 16 * j;
      if (g >= CG) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store1(ob + (long long)qp * D + 4 * g + e, acc[i][j][e] / lc);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, const long long* st, int causal,
           int window, float scale, float cap, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, H / KV, S, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               void* out, int B, int H, int KV, int S, const long long* st,
               int causal, int window, float scale, float cap,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, KV, S, st, causal, window, scale, cap, s);
    case 32: return launch<T, 32>(q, k, v, out, B, H, KV, S, st, causal, window, scale, cap, s);
    case 64: return launch<T, 64>(q, k, v, out, B, H, KV, S, st, causal, window, scale, cap, s);
    case 128: return launch<T, 128>(q, k, v, out, B, H, KV, S, st, causal, window, scale, cap, s);
    case 256: return launch<T, 256>(q, k, v, out, B, H, KV, S, st, causal, window, scale, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16; strides in elements, (b, head, s) for
// each of q, k, v, the head dimension contiguous; out is [B, H, S, D]
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KV, int S, int D, int dtype, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, int causal, int window,
    float scale, float cap, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, B, H, KV, S, st, causal,
                             window, scale, cap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, H, KV, S, st,
                                     causal, window, scale, cap, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
