// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/rglru_scan/rglru_scan.py
// (`rglru_scan`): over a, b [B, T, W] from h0 [B, W], elementwise in the
// channel w, sequential in t, float32 math; returns h [B, T, W] in a's
// dtype and the last state hT [B, W] in h0's dtype.  Each step is one
// float32 fused multiply-add a_t * h_{t-1} + b_t rounded once
// (__fmaf_rn, explicit, whatever the contraction flags): XLA contracts
// the Pallas kernel's `a * h + b` into an FMA (its interpret mode on the
// CPU matches an exact FMA bitwise), and the plain version computes an
// exact FMA too, so a launch equals both bitwise, on either route.  A
// parallel scan over t would round otherwise, so the time axis stays a
// chain and the only lever is memory.
//
// Bound: bytes.  One read of a and b and one write of h: at
// recurrentgemma-9b's served prefill (B 8, T 1345, W 4096, bfloat16)
// 264.6 MB, 79.0 us at 3.35 TB/s, against 2 flops per element.  Streaming
// at that rate needs some 16-20 KB in flight on every SM all the time
// (3.35 TB/s x ~0.7 us of latency over 132 SMs).
//
// Two routes, chosen by the wrapper from the shape and dtype:
//
// * tma (W x element bytes a multiple of 16, T > 0; the wrapper refuses a
//   or b off 16 bytes): a block owns one (b, 64-channel) strip, 512
//   blocks at B 8 x W 4096, all resident (up to 5 an SM by shared
//   memory, about 4 on each of 132 SMs).  A producer warp keeps a
//   4-stage ring of [TT steps x 64 channels] boxes of a and b (4 KB each:
//   TT 32 in bf16, 16 in float32) in flight by TMA, full / empty mbarriers
//   from hopper.cuh, so up to 24 KB a block and ~100 KB an SM are in
//   flight while the chain runs, and the loads never wait for it.  Two
//   consumer warps, one thread a channel, walk their column through each
//   box in step order and stage h in shared memory (two boxes,
//   alternating); after each box the 64 threads store it with 16-byte
//   stores, rows contiguous.  No swizzle: neighbouring threads read
//   neighbouring channels of a row.
// * simt (any other shape, such as W 100 in bf16): the first port's
//   kernel.  One thread per (b, w) channel carries h in a register through
//   the whole T loop; neighbouring threads take neighbouring w, so every
//   load and store of a step is coalesced; each iteration issues a chunk
//   of U steps' loads before it runs that chunk's dependent chain.  8 x
//   4096 channels make 256 blocks of 128 threads, ~2 KB in flight a warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 128, U = 16;

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
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const H* __restrict__ h0, T* __restrict__ h,
                  H* __restrict__ hT, int Tn, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const long long bi = blockIdx.y;
  const long long base = bi * Tn * W + w;
  float hv = to_f(h0[bi * W + w]);
  for (int t0 = 0; t0 < Tn; t0 += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < Tn) {
        const long long off = base + (long long)(t0 + u) * W;
        av[u] = to_f(a[off]);
        bv[u] = to_f(b[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < Tn) {
        hv = __fmaf_rn(av[u], hv, bv[u]);
        store1(h + base + (long long)(t0 + u) * W, hv);
      }
    }
  }
  store1(hT + bi * W + w, hv);
}

template <typename T, typename H>
int launch(const void* a, const void* b, const void* h0, void* h, void* hT,
           int B, int Tn, int W, cudaStream_t stream) {
  const dim3 grid((unsigned)((W + THREADS - 1) / THREADS), (unsigned)B);
  rglru_scan_kernel<T, H><<<grid, THREADS, 0, stream>>>(
      (const T*)a, (const T*)b, (const H*)h0, (T*)h, (H*)hT, Tn, W);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tma route
// ---------------------------------------------------------------------------

namespace ring {

constexpr int WT = 64;                  // channels a block owns
constexpr int STAGES = 4;               // boxes of a and b in flight
constexpr int THREADS = WT + 32;        // a thread a channel + the producer
constexpr int BOX_BYTES = 4096;         // one box of a or of b

template <typename T>
struct Box {
  static constexpr int TT = BOX_BYTES / (WT * (int)sizeof(T));  // steps
  static constexpr int VEC = 16 / (int)sizeof(T);      // elements a store
  static constexpr int SMEM =
      128 + STAGES * 2 * BOX_BYTES + 2 * BOX_BYTES + 2 * STAGES * 8;
};

template <typename T, typename H>
__global__ void __launch_bounds__(THREADS)
rglru_tma_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const H* __restrict__ h0, T* __restrict__ h,
                 H* __restrict__ hT, int Tn, int W) {
  constexpr int TT = Box<T>::TT, VEC = Box<T>::VEC;
  extern __shared__ uint8_t smem_raw[];
  // TMA boxes land on 128-byte aligned addresses
  uint8_t* base =
      smem_raw + ((128u - (hopper::smem_u32(smem_raw) & 127u)) & 127u);
  T* as = reinterpret_cast<T*>(base);              // [STAGES][TT][WT]
  T* bs = as + STAGES * TT * WT;                   // [STAGES][TT][WT]
  T* hs = bs + STAGES * TT * WT;                   // [2][TT][WT]
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + 2 * TT * WT);
  uint64_t* empty = full + STAGES;
  const int w0 = blockIdx.x * WT, bi = blockIdx.y, tid = threadIdx.x;
  const int nt = (Tn + TT - 1) / TT;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], WT);   // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= WT) {                        // the producer warp
    if (tid == WT)
      for (int it = 0; it < nt; ++it) {
        const int st = it % STAGES;
        hopper::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * BOX_BYTES);
        hopper::tma_load_3d(as + st * TT * WT, &ta, &full[st], w0, it * TT,
                            bi);
        hopper::tma_load_3d(bs + st * TT * WT, &tb, &full[st], w0, it * TT,
                            bi);
      }
    return;
  }

  const int w = w0 + tid;
  float hv = w < W ? to_f(h0[(long long)bi * W + w]) : 0.f;
  for (int it = 0; it < nt; ++it) {
    const int st = it % STAGES, n = min(TT, Tn - it * TT);
    const T* ap = as + st * TT * WT + tid;
    const T* bp = bs + st * TT * WT + tid;
    T* hp = hs + (it & 1) * TT * WT;
    hopper::mbar_wait(&full[st], (it / STAGES) & 1);
#pragma unroll
    for (int u = 0; u < TT; ++u)
      if (u < n) {
        hv = __fmaf_rn(to_f(ap[u * WT]), hv, to_f(bp[u * WT]));
        store1(hp + u * WT + tid, hv);
      }
    hopper::mbar_arrive(&empty[st]);
    hopper::named_barrier(1, WT);         // the box of h is staged
    // rows of the box to h with 16-byte stores; the other staging box is
    // written next, and this one again only after the next barrier
    T* hb = h + ((long long)bi * Tn + (long long)it * TT) * W + w0;
    for (int e = tid; e < TT * (WT / VEC); e += WT) {
      const int u = e / (WT / VEC), c = (e % (WT / VEC)) * VEC;
      if (u < n && w0 + c < W)
        *reinterpret_cast<uint4*>(hb + (long long)u * W + c) =
            *reinterpret_cast<const uint4*>(hp + u * WT + c);
    }
  }
  if (w < W) store1(hT + (long long)bi * W + w, hv);
}

template <typename T, typename H>
int launch(const void* a, const void* b, const void* h0, void* h, void* hT,
           int B, int Tn, int W, cudaStream_t stream) {
  // [B, T, W] innermost first; boxes [TT steps][WT channels], unswizzled;
  // channels past W and steps past T read as zeros
  const uint64_t dims[3] = {(uint64_t)W, (uint64_t)Tn, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)W * sizeof(T),
                               (uint64_t)Tn * W * sizeof(T)};
  const uint32_t box[3] = {(uint32_t)WT, (uint32_t)Box<T>::TT, 1};
  const CUtensorMapDataType type = sizeof(T) == 4
      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[2];
  const void* base[2] = {a, b};
  for (int i = 0; i < 2; ++i) {
    const int err = hopper::encode(&maps[i], type, 3, base[i], dims, strides,
                                   box, 0);
    if (err) return err;
  }
  auto kern = rglru_tma_kernel<T, H>;
  constexpr int bytes = Box<T>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + WT - 1) / WT), (unsigned)B);
  kern<<<grid, THREADS, bytes, stream>>>(maps[0], maps[1], (const H*)h0,
                                         (T*)h, (H*)hT, Tn, W);
  return (int)cudaGetLastError();
}

}  // namespace ring

template <typename T, typename H>
int by_route(int route, const void* a, const void* b, const void* h0,
             void* h, void* hT, int B, int Tn, int W, cudaStream_t s) {
  if (route == 1) return ring::launch<T, H>(a, b, h0, h, hT, B, Tn, W, s);
  return launch<T, H>(a, b, h0, h, hT, B, Tn, W, s);
}

}  // namespace

// dtypes 0 = float32, 1 = bfloat16: ab_dtype for a, b and h, h_dtype for
// h0 and hT; a, b, h [B, T, W] and h0, hT [B, W] contiguous; route 0 =
// simt, 1 = tma (W x element bytes a multiple of 16, T > 0, a and b
// 16-byte aligned)
extern "C" int repro_rglru_scan(const void* a, const void* b, const void* h0,
                                void* h, void* hT, int B, int Tn, int W,
                                int ab_dtype, int h_dtype, int route,
                                void* stream) {
  if (B <= 0 || B > 65535 || Tn < 0 || W <= 0 || route < 0 || route > 1 ||
      (route == 1 && (Tn == 0 || (W * (ab_dtype ? 2 : 4)) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ab_dtype == 0 && h_dtype == 0)
    return by_route<float, float>(route, a, b, h0, h, hT, B, Tn, W, s);
  if (ab_dtype == 0 && h_dtype == 1)
    return by_route<float, __nv_bfloat16>(route, a, b, h0, h, hT, B, Tn, W,
                                          s);
  if (ab_dtype == 1 && h_dtype == 0)
    return by_route<__nv_bfloat16, float>(route, a, b, h0, h, hT, B, Tn, W,
                                          s);
  if (ab_dtype == 1 && h_dtype == 1)
    return by_route<__nv_bfloat16, __nv_bfloat16>(route, a, b, h0, h, hT, B,
                                                  Tn, W, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
