// Backward of the RG-LRU linear recurrence (csrc/rglru_scan.cu), for
// sm_90a.
//
// No Pallas kernel computes it: the reference differentiates its
// jax.lax.associative_scan with XLA (src/repro/models/recurrent.py:64-77).
// For h_t = a_t h_{t-1} + b_t over t = 0 .. T-1 from h_{-1} = h0, with the
// gradients dh [B, T, W] of every h_t and dhT [B, W] of the last state
// (none: zeros), the adjoint runs the same recurrence backwards in time,
// per channel:
//
//   lambda_{T-1} = dh[T-1] + dhT
//   lambda_t     = fma(a[t+1], lambda_{t+1}, dh[t])   (rounded once)
//   db[t] = lambda_t,  da[t] = lambda_t h[t-1]  (h[-1] = h0),
//   dh0   = a[0] lambda_0                        (dhT when T = 0)
//
// float32 math from float32 or bfloat16 a, h and dh; da and db in a's
// dtype, dh0 in h0's.  Each step is __fmaf_rn, as the plain version's
// fma_f32 rounds it, and the order is the plain version's, so a launch
// equals rglru_bwd_ref bitwise on either route, as the forward equals
// rglru_ref.
//
// Bound: bytes.  One read of a, h and dh and one write of da and db: at
// recurrentgemma-9b's training call (B 1, T 4,096, W 4,096, float32)
// 5 x 4 x 16.8 M = 335.5 MB, 0.100 ms at 3.35 TB/s, against 3 flops an
// element.  Streaming at that rate needs some 20 KB in flight on every SM
// all the time (csrc/rglru_scan.cu).
//
// Design: two routes, chosen by the wrapper by the forward's rule (it
// refuses a, h or dh off 16 bytes on tma):
//
// * tma (W x element bytes a multiple of 16, T > 0): the forward's TMA
//   ring run backwards in time.  A block owns one (b, 32-channel) strip:
//   128 blocks at B 1 x W 4,096, one an SM (the forward's 64-channel strip
//   would leave half the SMs idle at B 1).  A producer thread keeps a
//   4-stage ring of three [TT 64 steps x 32 channels] boxes a stage (8 KB
//   each in float32, 96 KB a block in flight; 4 KB and 48 KB in
//   bfloat16; scripts/probe_rglru_bwd.py chose TT, the strip and the
//   depth on the card), walked from the last box to the first: for the
//   box of steps [t0, t0 + TT) it loads dh at t0, a at t0 + 1 (the box
//   holds a[t+1]) and h at t0 - 1 (the box holds h[t-1]); TMA zero-fills
//   coordinates
//   outside [0, T), the negative one at t0 = 0 too, so a[T] reads 0
//   (unused) and h[-1] reads 0 (h0 is taken instead).  Channels past W
//   read as zeros and are clipped on store.  One consumer warp, a thread
//   a channel, carries lambda through each box in descending t; the first
//   step starts from lambda = dhT with a[T] taken as 1, and fma(1, dhT,
//   dh) rounds as dh + dhT does, so no select sits on the chain.  db and
//   da are staged in shared memory (two box pairs, alternating) and one
//   thread stores each pair by TMA (fence_proxy_async, a named barrier,
//   tma_store_3d, bulk_commit; bulk_wait_read before a pair is written
//   again), so the chain's warp issues no global store of da or db.
// * simt (any other shape: T 0, W 100 in bfloat16): the first port's
//   kernel.  One thread per (b, w) channel carries lambda in a register
//   down the whole T loop; neighbouring threads take neighbouring w, so
//   every load and store of a step is one coalesced row a warp; each
//   iteration issues a chunk of U steps' loads (a[t+1], dh[t], h[t-1])
//   before it runs that chunk's dependent chain.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 32, U = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename H>
__global__ void __launch_bounds__(THREADS)
rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                 const H* __restrict__ h0, const T* __restrict__ dh,
                 const H* __restrict__ dhT, T* __restrict__ da,
                 T* __restrict__ db, H* __restrict__ dh0, int Tn, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long long bi = blockIdx.y;
  const long long base = bi * Tn * W + w;
  const float last = dhT ? to_f(dhT[bi * W + w]) : 0.0f;
  const float first = to_f(h0[bi * W + w]);
  float lam = 0.0f;
  for (int t1 = Tn - 1; t1 >= 0; t1 -= U) {
    float an[U], gv[U], hp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        const long long off = base + (long long)t * W;
        gv[u] = to_f(dh[off]);
        an[u] = t + 1 < Tn ? to_f(a[off + W]) : 0.0f;
        hp[u] = t > 0 ? to_f(h[off - W]) : first;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t1 - u;
      if (t >= 0) {
        const long long off = base + (long long)t * W;
        lam = t + 1 == Tn ? gv[u] + last : __fmaf_rn(an[u], lam, gv[u]);
        store1(db + off, lam);
        store1(da + off, __fmul_rn(lam, hp[u]));
      }
    }
  }
  store1(dh0 + bi * W + w,
         Tn > 0 ? __fmul_rn(to_f(a[base]), lam) : last);
}

template <typename T, typename H>
int launch(const void* a, const void* h, const void* h0, const void* dh,
           const void* dhT, void* da, void* db, void* dh0, int B, int Tn,
           int W, cudaStream_t stream) {
  const dim3 grid((unsigned)((W + THREADS - 1) / THREADS), (unsigned)B);
  rglru_bwd_kernel<T, H><<<grid, THREADS, 0, stream>>>(
      (const T*)a, (const T*)h, (const H*)h0, (const T*)dh, (const H*)dhT,
      (T*)da, (T*)db, (H*)dh0, Tn, W);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tma route
// ---------------------------------------------------------------------------

namespace ring {

constexpr int WT = 32;                  // channels a block owns
constexpr int TT = 64;                  // steps a box
constexpr int STAGES = 4;               // stages of (a, h, dh) boxes
constexpr int CONS = (WT + 31) / 32 * 32;   // consumer threads
constexpr int THREADS = CONS + 32;          // + the producer warp
constexpr int E = TT * WT;                  // elements a box

template <typename T>
struct Box {
  static constexpr int BYTES = E * (int)sizeof(T);
  // the ring, two staged (db, da) pairs, the full / empty barriers
  static constexpr int SMEM =
      128 + (3 * STAGES + 4) * BYTES + 2 * STAGES * 8;
};

template <typename T, typename H>
__global__ void __launch_bounds__(THREADS)
rglru_bwd_tma_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap th,
                     const __grid_constant__ CUtensorMap tdh,
                     const __grid_constant__ CUtensorMap tda,
                     const __grid_constant__ CUtensorMap tdb,
                     const T* __restrict__ a, const H* __restrict__ h0,
                     const H* __restrict__ dhT, H* __restrict__ dh0,
                     int Tn, int W) {
  extern __shared__ uint8_t smem_raw[];
  // TMA boxes sit on 128-byte aligned addresses
  uint8_t* base =
      smem_raw + ((128u - (hopper::smem_u32(smem_raw) & 127u)) & 127u);
  T* ring = reinterpret_cast<T*>(base);     // [STAGES][a, h, dh][TT][WT]
  T* outs = ring + 3 * STAGES * E;          // [2][db, da][TT][WT]
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 4 * E);
  uint64_t* empty = full + STAGES;
  const int w0 = blockIdx.x * WT, bi = blockIdx.y, tid = threadIdx.x;
  const int nt = (Tn + TT - 1) / TT;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONS);   // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONS) {                        // the producer warp
    if (tid == CONS)
      for (int k = 0; k < nt; ++k) {        // box nt - 1 first
        const int st = k % STAGES, t0 = (nt - 1 - k) * TT;
        T* s = ring + st * 3 * E;
        hopper::mbar_wait(&empty[st], ((k / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], 3 * Box<T>::BYTES);
        hopper::tma_load_3d(s, &ta, &full[st], w0, t0 + 1, bi);
        hopper::tma_load_3d(s + E, &th, &full[st], w0, t0 - 1, bi);
        hopper::tma_load_3d(s + 2 * E, &tdh, &full[st], w0, t0, bi);
      }
    return;
  }

  const int w = w0 + tid;
  const bool mine = tid < WT && w < W;
  const long long cw = (long long)bi * W + w;
  const float first = mine ? to_f(h0[cw]) : 0.f;
  // lambda_{T-1} = fma(1, dhT, dh[T-1]), which rounds as dh + dhT
  float lam = mine && dhT ? to_f(dhT[cw]) : 0.f;
  for (int k = 0; k < nt; ++k) {
    const int st = k % STAGES, t0 = (nt - 1 - k) * TT;
    const int n = min(TT, Tn - t0);       // < TT only in the first box
    const T* s = ring + st * 3 * E + tid;
    T* o = outs + (k & 1) * 2 * E + tid;
    hopper::mbar_wait(&full[st], (k / STAGES) & 1);
    if (tid < WT) {
      auto step = [&](int u) {
        const int t = t0 + u;
        const float an = t + 1 < Tn ? to_f(s[u * WT]) : 1.f;
        const float hp = t > 0 ? to_f(s[E + u * WT]) : first;
        lam = __fmaf_rn(an, lam, to_f(s[2 * E + u * WT]));
        store1(o + u * WT, lam);
        store1(o + E + u * WT, __fmul_rn(lam, hp));
      };
      if (n == TT) {
#pragma unroll 32
        for (int u = TT - 1; u >= 0; --u) step(u);
      } else {
        for (int u = n - 1; u >= 0; --u) step(u);
      }
    }
    hopper::mbar_arrive(&empty[st]);
    // the stores of box k - 2 read this pair: wait for them (the only
    // group of this thread's still reading is box k - 1's) before the
    // barrier, past which the next box writes there
    if (tid == 0) hopper::bulk_wait_read();
    hopper::fence_proxy_async();
    hopper::named_barrier(1, CONS);         // the pair is staged
    if (tid == 0) {
      const T* p = outs + (k & 1) * 2 * E;
      hopper::tma_store_3d(&tdb, p, w0, t0, bi);
      hopper::tma_store_3d(&tda, p + E, w0, t0, bi);
      hopper::bulk_commit();
    }
  }
  if (tid == 0) hopper::bulk_wait_read();
  if (mine)
    store1(dh0 + cw, __fmul_rn(to_f(a[(long long)bi * Tn * W + w]), lam));
}

template <typename T, typename H>
int launch(const void* a, const void* h, const void* h0, const void* dh,
           const void* dhT, void* da, void* db, void* dh0, int B, int Tn,
           int W, cudaStream_t stream) {
  // [B, T, W] innermost first; boxes [TT steps][WT channels], unswizzled;
  // loads outside the tensor read as zeros, stores there are dropped
  const uint64_t dims[3] = {(uint64_t)W, (uint64_t)Tn, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)W * sizeof(T),
                               (uint64_t)Tn * W * sizeof(T)};
  const uint32_t box[3] = {(uint32_t)WT, (uint32_t)TT, 1};
  const CUtensorMapDataType type = sizeof(T) == 4
      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[5];
  const void* base[5] = {a, h, dh, da, db};
  for (int i = 0; i < 5; ++i) {
    const int err = hopper::encode(&maps[i], type, 3, base[i], dims, strides,
                                   box, 0);
    if (err) return err;
  }
  auto kern = rglru_bwd_tma_kernel<T, H>;
  constexpr int bytes = Box<T>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + WT - 1) / WT), (unsigned)B);
  kern<<<grid, THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], (const T*)a,
      (const H*)h0, (const H*)dhT, (H*)dh0, Tn, W);
  return (int)cudaGetLastError();
}

}  // namespace ring

template <typename T, typename H>
int by_route(int route, const void* a, const void* h, const void* h0,
             const void* dh, const void* dhT, void* da, void* db, void* dh0,
             int B, int Tn, int W, cudaStream_t s) {
  if (route == 1)
    return ring::launch<T, H>(a, h, h0, dh, dhT, da, db, dh0, B, Tn, W, s);
  return launch<T, H>(a, h, h0, dh, dhT, da, db, dh0, B, Tn, W, s);
}

}  // namespace

// dtypes 0 = float32, 1 = bfloat16: ab_dtype for a, h, dh, da and db,
// h_dtype for h0, dhT and dh0; a, h, dh, da, db [B, T, W] and h0, dhT,
// dh0 [B, W] contiguous; dhT may be null (zeros); route 0 = simt (any
// shape), 1 = tma (W x element bytes a multiple of 16, T > 0, a, h, dh,
// da and db 16-byte aligned)
extern "C" int repro_rglru_scan_bwd(const void* a, const void* h,
                                    const void* h0, const void* dh,
                                    const void* dhT, void* da, void* db,
                                    void* dh0, int B, int Tn, int W,
                                    int ab_dtype, int h_dtype, int route,
                                    void* stream) {
  const bool rows16 = ((long long)W * (ab_dtype ? 2 : 4)) % 16 == 0;
  const uintptr_t ptrs = (uintptr_t)a | (uintptr_t)h | (uintptr_t)dh |
                         (uintptr_t)da | (uintptr_t)db;
  if (B <= 0 || B > 65535 || Tn < 0 || W <= 0 || route < 0 || route > 1 ||
      (route == 1 && (Tn == 0 || !rows16 || (ptrs & 15u))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ab_dtype == 0 && h_dtype == 0)
    return by_route<float, float>(route, a, h, h0, dh, dhT, da, db, dh0, B,
                                  Tn, W, s);
  if (ab_dtype == 0 && h_dtype == 1)
    return by_route<float, __nv_bfloat16>(route, a, h, h0, dh, dhT, da, db,
                                          dh0, B, Tn, W, s);
  if (ab_dtype == 1 && h_dtype == 0)
    return by_route<__nv_bfloat16, float>(route, a, h, h0, dh, dhT, da, db,
                                          dh0, B, Tn, W, s);
  if (ab_dtype == 1 && h_dtype == 1)
    return by_route<__nv_bfloat16, __nv_bfloat16>(route, a, h, h0, dh, dhT,
                                                  da, db, dh0, B, Tn, W, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
