// Online-softmax prefill attention (causal, sliding window, tanh softcap,
// GQA) for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/
// flash_attention.py (`flash_attention`): for each (b, h) and query row q
// < Sq, o[q] = softmax_k(mask(cap(q . k * scale))) @ v over the keys k < Sk
// of kv head h / group, with mask = k < Sk, and q >= k when causal, and
// q - k < window when a window is set (positions are indices); masked
// logits are -1e30 and the running sum is clamped at 1e-30, as in the TPU
// kernel.  float32 math from float32 or bfloat16 inputs; the output has
// the inputs' dtype.  The TPU kernel takes one S; here the keys have a
// length of their own, Sk, for cross-attention (whisper's decoder over its
// encoder's frames: Sq the prompt, Sk 1,500), which the wrapper allows
// only without a causal mask or a window (Sk = Sq otherwise).
//
// Query offset: under a mask, query row q may stand at position qoff + q
// (a row block of a sequence split over a mesh's `model` axis, against
// the sequence's first Sk >= qoff + Sq keys); every key range and mask
// below compares qoff + q with the key index.  At qoff = 0 every range and
// mask is the launch's without an offset, so its output is that launch's
// bit for bit.
//
// Bound: operations.  At gemma2-9b's prefill (B 8, H 16, D 256, S in the
// thousands) a causal launch does 2 B H S^2 D flops (QK^T and PV, half of
// the square each) on a few hundred MB, hundreds of flops per byte.
//
// Two routes, by dtype:
//
// * wgmma (bfloat16, every head dim 16 ... 256).  A block owns 64 query
//   rows per consumer warpgroup of one (b, h): two consumer warpgroups up
//   to D 128 (232 registers a thread each, taken from the producer
//   warpgroup by setmaxnreg), one at D 256, where the accumulator alone
//   is 128 registers a thread and two would spill.  One producer thread
//   brings Q in once and streams K and V tiles of 64 keys through two
//   2-stage TMA rings (an mbarrier pair per stage), by 4D tensor maps over
//   the (b, head, s, d) strides (boxes of min(D, 64) columns, swizzled
//   32/64/128 B; rows past Sq or Sk read as zeros).  Per kv tile a warpgroup
//   computes S = Q K^T with wgmma m64n64k16 over D (K is K-major), then
//   scale, softcap, mask and the online-softmax update on the accumulator
//   fragment in registers (row max and sum over the 4 lanes that share a
//   row; exp and tanh from ex2.approx, within ~3e-7 of the exact values),
//   then O += P V with P as the register A operand and V as a transposed
//   (MN-major) B.  The loop is software-pipelined: tile t's Q K^T is
//   issued together with tile t - 1's P V, and tile t's softmax runs
//   while that P V finishes.  P is split into a bf16 high part and a bf16
//   low part (p - hi), two PV products: P V then carries fp32 weights to
//   ~2^-16 relative, as the reference's fp32 P does; a single bf16 P
//   moves outputs by up to ~2^-9 of a weight, which broke the bf16
//   tolerance at most of the checked shapes.  Q K^T of bf16 operands is
//   exact products summed in fp32, as the reference's fp32 dot.
// * simt (float32).  The first port's kernel, unchanged: wgmma has no
//   fp32 input, and TF32 would break the float32 tolerance.  One 256-thread
//   block owns 64 query rows and walks the kv tiles of 64 rows itself, Q,
//   K and V converted to float32 in shared memory, a 4 x 4 block of logits
//   a thread with fmaf, the row max and sum over 16 lanes with xor
//   shuffles, the probabilities through shared memory into the PV product.
//
// Both: only the kv tiles that hold an unmasked key for some row of the
// block are visited: a tile wholly above the diagonal or wholly before the
// window would add exactly zero (after a finite max, exp(-1e30 - m) is 0;
// before one, alpha = exp(-1e30 - m) zeroes what it added).  Query blocks
// are issued heaviest first.  Every sum has one fixed order, so a launch
// is deterministic.  Ragged lengths are masked: keys past Sk are masked in
// the logits (-1e30, not the zero logit that TMA's zero rows would give:
// the last kv tile of a non-causal launch at Sk 1,500 = 23 x 64 + 28 holds
// 36 such rows), rows past Sq are not stored.
//
// Training: given an `lse` pointer (float32 [B, H, Sq]), both routes also
// store each row's log-sum-exp of its masked logits in natural-log units,
// lse = m + log(max(l, 1e-30)) (the wgmma route's running max is in log2
// units and is converted), which the backward pass (flash_attention_bwd.cu)
// reads to recompute P = exp(logit - lse).  Serving passes a null pointer
// and stores nothing more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256, PAD = 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

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
                       float* __restrict__ lse, int H, int group, int Sq,
                       int Sk,
                       long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss,
                       int causal, int window, int qoff, float scale,
                       float cap) {
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
  const int q_last = min(q0 + BQ, Sq) - 1;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  load_tile<T, D, BQ>(Qs, D + PAD, qb, qss, q0, Sq);

  // kv tiles holding an unmasked key for some row of this block
  const int k_hi = causal ? min(qoff + q_last, Sk - 1) : Sk - 1;
  const int k_lo = window ? max(0, qoff + q0 - window + 1) : 0;
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
    load_tile<T, D, BK>(Ks, D + PAD, kb, kss, k0, Sk);
    load_tile<T, D, BK>(Vs, D, vb, vss, k0, Sk);
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
      const int qp = qoff + q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (cap != 0.f) x = tanhf(x / cap) * cap;
        bool ok = kp < Sk;
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

  // o = acc / max(l, 1e-30), rows past Sq not stored; the row's lse
  // from one lane of the 16 that hold it
  T* ob = out + ((long long)b * H + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + qp] = m[i] + logf(lc);
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
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int KV, int Sq, int Sk,
           const long long* st, int causal, int window, int qoff,
           float scale, float cap, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, H, H / KV, Sq, Sk,
      st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      qoff, scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               void* out, float* lse, int B, int H, int KV, int Sq, int Sk,
               const long long* st, int causal, int window, int qoff,
               float scale, float cap, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, lse, B, H, KV, Sq, Sk, st, causal, window, qoff, scale, cap, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, B, H, KV, Sq, Sk, st, causal, window, qoff, scale, cap, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, H, KV, Sq, Sk, st, causal, window, qoff, scale, cap, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, H, KV, Sq, Sk, st, causal, window, qoff, scale, cap, s);
    case 256: return launch<T, 256>(q, k, v, out, lse, B, H, KV, Sq, Sk, st, causal, window, qoff, scale, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// wgmma route (bfloat16)
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;
constexpr int KV_STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Per head dim: NWG consumer warpgroups of 64 query rows (WQ rows a
// block) and a producer warpgroup.  Up to D 128 two consumers, which
// take 232 registers a thread from the producer's (setmaxnreg).  At D 256
// the accumulator alone is 128 registers a thread, and the accumulator,
// S and P in flight together do not fit two consumers' budget: one
// consumer, whose 255 registers hold them, with the same overlap.
// Shared-memory tiles: D / EC column blocks of EC = min(D, 64) elements
// (SW = 2 EC bytes a row), each block rows x SW bytes, as the TMA boxes
// land; Q holds WQ rows, K and V BK rows.
template <int D>
struct Tile {
  static constexpr int NWG = D < 256 ? 2 : 1;
  static constexpr int WQ = NWG * WG_ROWS;
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int EC = D < 64 ? D : 64;
  static constexpr int SW = 2 * EC;
  static constexpr int NB = D / EC;
  static constexpr int Q_BYTES = WQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int SMEM = 1024 + Q_BYTES + KV_STAGES * 2 * KV_BYTES +
                              (4 * KV_STAGES + 1) * 8;
};

// Scale, softcap and mask one 64 x 64 logit tile in registers (sc[4j + i]
// is row r + 8 (i / 2), key k0 + 8 j + 2 (lane % 4) + i % 2), then the
// online-softmax update of the rows' max m and sum l: sc becomes P (fp32).
// Returns each row's rescale factor alpha of the accumulator.  Logits are kept in log2
// units: z = cap tanh(s scale / cap) log2(e), or s scale log2(e).
struct Softmax {
  float to_u, cap2, cap;
  int Sk, causal, window, qoff;

  __device__ __forceinline__ void operator()(
      float (&sc)[32], int r, int k0, bool edge, float (&m)[2],
      float (&l)[2], float (&alpha)[2]) const {
    const int lane = threadIdx.x % 32;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float z = sc[4 * j + i] * to_u;
        if (cap != 0.f) z = cap2 * hopper::tanh_ex2(z);
        if (edge) {
          const int qp = qoff + r + 8 * (i >> 1);
          const int kp = k0 + 8 * j + 2 * (lane % 4) + (i & 1);
          bool ok = kp < Sk;
          if (causal) ok = ok && qp >= kp;
          if (window) ok = ok && qp - kp < window;
          z = ok ? z : NEG_INF;
        }
        sc[4 * j + i] = z;
        mx[i >> 1] = fmaxf(mx[i >> 1], z);
      }
    // a row's 64 keys sit on 4 lanes
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = hopper::ex2(m[hr] - m_new);
      m[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = hopper::ex2(sc[4 * j + i] - m[i >> 1]);
        sc[4 * j + i] = p;
        sum[i >> 1] += p;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
      l[hr] = alpha[hr] * l[hr] + sum[hr];
    }
  }
};

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   int H, int group, int Sq, int Sk, int causal, int window,
                   int qoff, float scale, float cap) {
  using T = Tile<D>;
  constexpr int SW = T::SW, EC = T::EC, NWG = T::NWG, WQ = T::WQ;
  constexpr int KV_TILE = T::KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = hopper::align1024(smem_raw);
  uint8_t* Ks = Qs + T::Q_BYTES;                   // [stage] K tiles
  uint8_t* Vs = Ks + KV_STAGES * KV_TILE;          // [stage] V tiles
  // full / empty barriers of the K ring, then of the V ring, then Q's
  uint64_t* kfull = reinterpret_cast<uint64_t*>(Vs + KV_STAGES * KV_TILE);
  uint64_t* kempty = kfull + KV_STAGES;
  uint64_t* vfull = kempty + KV_STAGES;
  uint64_t* vempty = vfull + KV_STAGES;
  uint64_t* qbar = vempty + KV_STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;       // heaviest blocks first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int q0 = qt * WQ;
  const int q_last = min(q0 + WQ, Sq) - 1;
  // kv tiles holding an unmasked key for some row of this block
  const int k_hi = causal ? min(qoff + q_last, Sk - 1) : Sk - 1;
  const int k_lo = window ? max(0, qoff + q0 - window + 1) : 0;
  const int kt_lo = k_lo / BK, nt = k_hi / BK - kt_lo + 1;
  // warpgroup index, warp-uniform for the compiler
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&kempty[s], NWG);  // one arrival per warpgroup
      hopper::mbar_init(&vempty[s], NWG);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == NWG) {                        // producer warpgroup: one thread
    if constexpr (NWG == 2) hopper::reg_dealloc<40>();
    if (threadIdx.x == NWG * 128) {
      hopper::mbar_arrive_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::NB; ++c)
        hopper::tma_load_4d(Qs + c * WQ * SW, &tq, qbar, c * EC, q0, h, b);
      for (int t = 0; t < nt; ++t) {
        const int s = t % KV_STAGES, k0 = (kt_lo + t) * BK;
        const uint32_t ph = ((t / KV_STAGES) & 1) ^ 1;
        hopper::mbar_wait(&kempty[s], ph);
        hopper::mbar_arrive_expect_tx(&kfull[s], KV_TILE);
#pragma unroll
        for (int c = 0; c < T::NB; ++c)
          hopper::tma_load_4d(Ks + s * KV_TILE + c * BK * SW, &tk, &kfull[s],
                              c * EC, k0, kvh, b);
        hopper::mbar_wait(&vempty[s], ph);
        hopper::mbar_arrive_expect_tx(&vfull[s], KV_TILE);
#pragma unroll
        for (int c = 0; c < T::NB; ++c)
          hopper::tma_load_4d(Vs + s * KV_TILE + c * BK * SW, &tv, &vfull[s],
                              c * EC, k0, kvh, b);
      }
    }
  } else {                                 // consumer warpgroups
    if constexpr (NWG == 2) hopper::reg_alloc<232>();
    const int lane = threadIdx.x % 32, w4 = (threadIdx.x / 32) % 4;
    const bool leader = threadIdx.x % 128 == 0;
    const int wr0 = q0 + wgi * WG_ROWS;    // this warpgroup's first row
    const int r = wr0 + 16 * w4 + lane / 4;  // this thread's rows r, r + 8
    const uint8_t* qw = Qs + wgi * WG_ROWS * SW;
    const Softmax softmax{cap != 0.f ? scale / cap : scale * LOG2E,
                          cap * LOG2E, cap, Sk, causal, window, qoff};
    // this warpgroup's live tiles [t0, t1]: the others hold no unmasked
    // key for its rows and would add exactly nothing (see the header)
    const int wk_lo = window ? max(0, qoff + wr0 - window + 1) : 0;
    const int wk_hi = causal ? min(qoff + wr0 + WG_ROWS - 1, k_hi) : k_hi;
    const int t0 = max(wk_lo / BK - kt_lo, 0);
    const int t1 = min(wk_hi / BK - kt_lo, nt - 1);

    auto stage = [](int t) { return t % KV_STAGES; };
    auto parity = [](int t) { return (uint32_t)((t / KV_STAGES) & 1); };
    // a tile that needs the per-element mask: one reaching past Sk (TMA
    // reads those keys as zeros, whose zero logits the mask must remove)
    auto edge = [&](int k0) {
      return k0 + BK > Sk || (causal && k0 + BK - 1 > qoff + wr0) ||
             (window && qoff + wr0 + WG_ROWS - 1 - k0 >= window);
    };
    // S = Q K^T over D in k16 steps: A = Q (K-major), B = K (K-major)
    auto qk = [&](float (&sc)[32], int t) {
      const uint64_t dq = hopper::opaque(hopper::desc<SW>(qw, 16, 8 * SW));
      const uint64_t dk = hopper::opaque(
          hopper::desc<SW>(Ks + stage(t) * KV_TILE, 16, 8 * SW));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = 16 * kk / EC, off = (16 * kk % EC) * 2;
        hopper::wgmma_ss<0, 0>(sc, dq + ((c * WQ * SW + off) >> 4),
                               dk + ((c * BK * SW + off) >> 4), kk > 0);
      }
      hopper::wgmma_commit();
    };
    // O += P V: B = V (MN-major), 16 keys a step, P's high and low parts
    float o[D / 2];
    auto pv = [&](const uint32_t (&phi)[4][4], const uint32_t (&plo)[4][4],
                  int t) {
      const uint64_t dv = hopper::opaque(
          hopper::desc<SW>(Vs + stage(t) * KV_TILE, BK * SW, 8 * SW));
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        hopper::wgmma_rs<1>(o, phi[kc], dv + ((kc * 16 * SW) >> 4), 1);
        hopper::wgmma_rs<1>(o, plo[kc], dv + ((kc * 16 * SW) >> 4), 1);
      }
      hopper::wgmma_commit();
    };
    // pins the registers a wgmma group reads or writes: before the group
    // (no other instruction may define them inside it) and after its wait
    auto pin = [&](float (&sc)[32], uint32_t (&phi)[4][4],
                   uint32_t (&plo)[4][4]) {
      hopper::fence_regs(sc);
      hopper::fence_regs(o);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        hopper::fence_regs(phi[kc]);
        hopper::fence_regs(plo[kc]);
      }
    };
    auto release = [&](uint64_t* bars, int t) {
      if (leader) hopper::mbar_arrive(&bars[stage(t)]);
    };
    // a tile outside [t0, t1]: wait for it (a later wait on the stage
    // must not see this phase) and hand it back
    auto skip = [&](int t) {
      hopper::mbar_wait(&kfull[stage(t)], parity(t));
      release(kempty, t);
      hopper::mbar_wait(&vfull[stage(t)], parity(t));
      release(vempty, t);
    };

#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    hopper::mbar_wait(qbar, 0);
    for (int t = 0; t < t0 && t < nt; ++t) skip(t);

    if (t0 <= t1) {
      // Software pipeline over the live tiles: tile t's Q K^T is issued
      // with tile t - 1's P V, and tile t's softmax runs beside the tail
      // of that P V; the accumulator is rescaled once P V is in.

      float sc[32];
      uint32_t phi[4][4], plo[4][4];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      hopper::mbar_wait(&kfull[stage(t0)], parity(t0));
      pin(sc, phi, plo);
      hopper::wgmma_fence();
      qk(sc, t0);
      hopper::wgmma_wait<0>();
      pin(sc, phi, plo);
      release(kempty, t0);
      softmax(sc, r, (kt_lo + t0) * BK, edge((kt_lo + t0) * BK), m, l, alpha);
      hopper::split_hi_lo(sc, phi, plo);
      for (int t = t0 + 1; t <= t1; ++t) {
        const int k0 = (kt_lo + t) * BK;
        hopper::mbar_wait(&kfull[stage(t)], parity(t));
        hopper::mbar_wait(&vfull[stage(t - 1)], parity(t - 1));
        pin(sc, phi, plo);
        hopper::wgmma_fence();
        qk(sc, t);
        pv(phi, plo, t - 1);
        hopper::wgmma_wait<1>();           // Q K^T of tile t is in
        hopper::fence_regs(sc);
        release(kempty, t);
        softmax(sc, r, k0, edge(k0), m, l, alpha);
        hopper::wgmma_wait<0>();           // P V of tile t - 1 is in
        pin(sc, phi, plo);
        release(vempty, t - 1);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[4 * j + i] *= alpha[i >> 1];
        hopper::split_hi_lo(sc, phi, plo);
      }
      hopper::mbar_wait(&vfull[stage(t1)], parity(t1));
      pin(sc, phi, plo);
      hopper::wgmma_fence();
      pv(phi, plo, t1);
      hopper::wgmma_wait<0>();
      pin(sc, phi, plo);
      release(vempty, t1);
    }
    for (int t = max(t1 + 1, t0); t < nt; ++t) skip(t);

    // o / max(l, 1e-30) as one reciprocal a row (a division an element
    // would be 128 slow-path calls a thread at D 256), rows past Sq not
    // stored; the row's lse (m in log2 units) from one of its 4 lanes
    __nv_bfloat16* ob = out + ((long long)b * H + h) * Sq * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qp = r + 8 * hr;
      if (qp >= Sq) continue;
      const float inv = 1.f / fmaxf(l[hr], 1e-30f);
      if (lse != nullptr && lane % 4 == 0)
        lse[((long long)b * H + h) * Sq + qp] =
            m[hr] * LN2 + logf(fmaxf(l[hr], 1e-30f));
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)qp * D + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * hr] * inv,
                                  o[4 * j + 2 * hr + 1] * inv);
      }
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int H, int KV, int Sq, int Sk,
                 const long long* st,
                 int causal, int window, int qoff, float scale, float cap,
                 cudaStream_t stream) {
  using T = Tile<D>;
  constexpr int WQ = T::WQ;
  // [B, heads, S, D] over the given strides, innermost first: q spans Sq
  // rows, k and v Sk (TMA reads rows past either as zeros)
  CUtensorMap maps[3];
  const void* base[3] = {q, k, v};
  const int heads[3] = {H, KV, KV};
  const int rows[3] = {Sq, Sk, Sk};
  for (int i = 0; i < 3; ++i) {
    const uint64_t dims[4] = {(uint64_t)D, (uint64_t)rows[i],
                              (uint64_t)heads[i], (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)st[3 * i + 2] * 2,
                                 (uint64_t)st[3 * i + 1] * 2,
                                 (uint64_t)st[3 * i] * 2};
    const uint32_t box[4] = {(uint32_t)T::EC, (uint32_t)(i ? BK : WQ), 1, 1};
    const int err = hopper::encode_bf16(&maps[i], 4, base[i], dims, strides,
                                        box, T::SW);
    if (err) return err;
  }
  constexpr int bytes = T::SMEM;
  auto kern = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + WQ - 1) / WQ), (unsigned)H, (unsigned)B);
  kern<<<grid, T::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)out, lse, H, H / KV, Sq, Sk,
      causal, window, qoff, scale, cap);
  return (int)cudaGetLastError();
}

int dispatch_wgmma(int D, const void* q, const void* k, const void* v,
                   void* out, float* lse, int B, int H, int KV, int Sq,
                   int Sk,
                   const long long* st, int causal, int window, int qoff,
                   float scale, float cap, cudaStream_t s) {
  switch (D) {
    case 16: return launch_wgmma<16>(q, k, v, out, lse, B, H, KV, Sq, Sk, st, causal, window, qoff, scale, cap, s);
    case 32: return launch_wgmma<32>(q, k, v, out, lse, B, H, KV, Sq, Sk, st, causal, window, qoff, scale, cap, s);
    case 64: return launch_wgmma<64>(q, k, v, out, lse, B, H, KV, Sq, Sk, st, causal, window, qoff, scale, cap, s);
    case 128: return launch_wgmma<128>(q, k, v, out, lse, B, H, KV, Sq, Sk, st, causal, window, qoff, scale, cap, s);
    case 256: return launch_wgmma<256>(q, k, v, out, lse, B, H, KV, Sq, Sk, st, causal, window, qoff, scale, cap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 = float32 (simt route), 1 = bfloat16 (wgmma route: pointers
// 16-byte aligned, strides multiples of 8); strides in elements, (b, head,
// s) for each of q (Sq rows), k and v (Sk rows), the head dimension
// contiguous; out is [B, H, Sq, D]; lse is null or float32 [B, H, Sq];
// qoff (>= 0, only under a mask, Sk >= qoff + Sq) places query row q at
// position qoff + q.
// *route is set to the route launched: 1 = wgmma, 0 = simt.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int H,
    int KV, int Sq, int Sk, int D, int dtype, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, int causal, int window,
    int qoff, float scale, float cap, void* stream, int* route) {
  if (B <= 0 || H <= 0 || KV <= 0 || Sq <= 0 || Sk <= 0 || H % KV != 0 ||
      qoff < 0 || (qoff > 0 && ((!causal && !window) || Sk < qoff + Sq)))
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = (cudaStream_t)stream;
  *route = dtype == 1;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, out, (float*)lse, B, H, KV, Sq, Sk,
                             st, causal, window, qoff, scale, cap, s);
  if (dtype == 1)
    return dispatch_wgmma(D, q, k, v, out, (float*)lse, B, H, KV, Sq, Sk,
                          st, causal, window, qoff, scale, cap, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
