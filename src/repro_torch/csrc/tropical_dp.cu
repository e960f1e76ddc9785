// The chain DP of the LLHR planner (P3) for sm_90a: the whole solve in one
// launch (`repro_tropical_dp_chain`, the `fused` route), and one wavefront
// step (`repro_tropical_dp_step`, the `step` route for shapes whose tables
// do not fit in one block's shared memory).
//
// Replaces the Pallas kernel src/repro/kernels/tropical_dp/tropical_dp.py
// (`tropical_dp_step`, body `_dp_step_kernel`) and, in the fused kernel, the
// reference's loop around it (src/repro/core/batch.py,
// `_chain_dp_solve_kernelized`: the transfer-tensor build, the forward
// `lax.scan` over the L steps, the reverse-scan backtrack and the
// isfinite(latency) mask).  One step is
//
//   row[s] = min_a ( min_s0 ( dp[a, s0] + tr[a, s, s0] ) + ct[a, s] ),
//
// masked by ok[a, s] > 0, with the a = 0 candidate taken from the per-slot
// source row tr0 (parent s0 = 0), and first-argmin parents pa (= a) and
// ps (= s0 at that a).
//
// Rounding and ties: every sum is one `__fadd_rn` in the reference's staged
// order (dp + tr, then + ct, then the ok mask); only adds, mins and one
// division a transfer entry, so no FMA contraction can change a value.
// Each scan replaces its best only on a strict improvement (NaN counts as
// smallest, as in jnp/torch argmin), so ties and all-inf rows give the
// first index, as argmin does: an all-inf row returns pa = ps = 0, which
// the backtrack reads.
//
// Bound: bytes, and at the planner's shapes latency.  The step kernel moves
// ~1.3 MB a launch at B = 256, M = 4, L = 11, S = 8; the fused kernel reads
// the rates once and writes the placements (~0.13 MB) with ~3.3 M adds,
// compares and divisions, a bound of ~0.05 us.  What sets its time is the
// chain: L dependent steps, each two short scans behind a barrier, on one
// block a scenario.  The min-plus product has no tensor-core form.
//
// Fused design: a block per scenario b and tile of MT source slots, Q = 4
// lanes of a warp per output (slot, state s); at S <= 8 a slot is one warp
// and its steps sync the warp alone (S = 8, the 8-UAV swarms, is compiled
// as a constant).  The block first stages every operand it reads (the
// scenario's rates and flags, the order's tables, ct and ok) in shared
// memory with cp.async, all copies in flight at once: on the card a
// dependent global load costs about a microsecond, so the solve reads
// global memory in one round trip.  There it builds the slot-invariant
// transfer tensor tr [S][L][S+1] once a block, a thread a link (s0, s)
// with its L - 1 divisions, and each slot's dp [L+1][S+1] table and 8-bit
// parent tables.  The step's inner min over s0 depends on the block start
// a alone (dp row a is final once step a has run), so it is taken once a
// row, not once a step: after step j the slot forms mn[j][s] = min_s0
// (dp[j, s0] + tr[j, s, s0]) with its first-argmin s0, and step j scans
// only a < j of mn[a][s] + ct (masked).  Each scan is split over the
// output's Q lanes (indices q, q + Q, ...) and their first argmins merged
// by shuffles, ties to the smaller index.  The values, their rounding and
// the ties are the step kernel's; the work of a solve falls from
// L^2 (S+1) / 2 to L (S+1 + L / 2) per output.  One thread per slot then
// runs the reference's backtrack and writes the placement through
// `order`.
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

// first-argmin order: strictly smaller, or the first NaN.  As written,
// v < best || (isnan(v) && !isnan(best)); this form, !(v >= best) with best
// a number, is the same predicate in two compares and no branch.
__device__ __forceinline__ bool before(float v, float best) {
  return !(v >= best) & (best == best);
}

// (v, i) replaces (best, i_best) in first-argmin order over the index i:
// strictly before it, or equivalent (equal, or both NaN) at a smaller i
__device__ __forceinline__ bool takes(float v, int i, float best,
                                      int i_best) {
  return before(v, best) | (!before(best, v) & (i < i_best));
}

// Q lanes of a warp share one output's scans (each takes every Q-th index
// and a shuffle merges their first argmins); Q divides 32
constexpr int Q = 4;

__device__ __forceinline__ void merge_lanes(float& best, int& i_best) {
  for (int o = Q / 2; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, o);
    const int i = __shfl_xor_sync(0xffffffffu, i_best, o);
    const bool t = takes(v, i, best, i_best);
    best = t ? v : best;
    i_best = t ? i : i_best;
  }
}

// stage n 4-byte words into shared memory by cp.async: 16-byte copies
// where both ends are 16-byte aligned, else 4-byte ones
__device__ __forceinline__ void stage(void* dst, const void* src, int n,
                                      int tid, int nt) {
  char* d = static_cast<char*>(dst);
  const char* g = static_cast<const char*>(src);
  int done = 0;
  if (((hopper::smem_u32(d) | (unsigned)(size_t)g) & 15u) == 0) {
    done = n / 4 * 4;
    for (int i = tid; i < n / 4; i += nt)
      hopper::cp_async<16>(d + 16 * i, g + 16 * i);
  }
  for (int i = done + tid; i < n; i += nt)
    hopper::cp_async<4>(d + 4 * i, g + 4 * i);
}

__global__ void tropical_dp_step_kernel(
    const float* __restrict__ dp,   // [B, M, L, S+1] rows, stride dp_bm
    long long dp_bm,                // elements between (b, m) slabs
    const float* __restrict__ tr,   // [B, L, S, S+1]
    const float* __restrict__ tr0,  // [B, M, S]
    const float* __restrict__ ct,   // [L, S]
    const float* __restrict__ ok,   // [L, S]
    float* __restrict__ row,        // [B, M, S]
    int* __restrict__ pa,           // [B, M, S]
    int* __restrict__ ps,           // [B, M, S]
    int B, int M, int L, int S) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * M * S) return;
  const int s = (int)(idx % S);
  const long long bm = idx / S;
  const long long b = bm / M;
  const int S1 = S + 1;
  const float* d = dp + bm * dp_bm;                       // [L, S+1]
  const float* t = tr + (b * L * S + s) * S1;             // tr[b, 0, s, :]
  const long long t_a = (long long)S * S1;                // stride over a

  // a = 0: the source row; dp[0, 0] is its only finite predecessor
  float best = __fadd_rn(__fadd_rn(d[0], tr0[idx]), ct[s]);
  if (!(ok[s] > 0.0f)) best = INFINITY;
  int a_best = 0, s0_sel = 0;
  for (int a = 1; a < L; ++a) {
    const float* da = d + a * S1;
    const float* ta = t + a * t_a;
    float m = __fadd_rn(da[0], ta[0]);
    int s0b = 0;
    for (int s0 = 1; s0 < S1; ++s0) {
      const float v = __fadd_rn(da[s0], ta[s0]);
      if (before(v, m)) { m = v; s0b = s0; }
    }
    float c = __fadd_rn(m, ct[a * S + s]);
    if (!(ok[a * S + s] > 0.0f)) c = INFINITY;
    if (before(c, best)) { best = c; a_best = a; s0_sel = s0b; }
  }
  row[idx] = best;
  pa[idx] = a_best;
  ps[idx] = s0_sel;
}

// Byte offsets of the fused kernel's shared-memory sections for one block
// of MT slots, each 16-byte aligned, and their total; tr is at 0.  The one
// definition of the layout: the launcher computes it from the shapes, and
// the wrapper's own total (`chain_smem_bytes`, from which it picks the
// route and the slots a block) must equal `bytes` or the launch is refused.
struct ChainSmem {
  int ct, ok, rate, bits, order, prev, src, act, dp, mn, s0b, pa, ps;
  long long bytes;
};

ChainSmem chain_smem(int L, int S, int U, int MT) {
  const long long l = L, s = S, s1 = S + 1, mt = MT;
  long long end = 0;
  // the section of n bytes after the last, 16-byte aligned
  auto next = [&end](long long n) {
    const long long at = end;
    end += (n + 15) / 16 * 16;
    return (int)at;
  };
  next(4 * s * l * s1);                      // tr [S][L][S+1] float32
  ChainSmem m;
  m.ct = next(4 * l * l * s);                // [L][L][S] float32
  m.ok = next(4 * l * l * s);                // [L][L][S] float32
  m.rate = next(4LL * U * U);                // [U][U] float32
  m.bits = next(4 * (l + 1));                // bits_in [L], input_bits
  m.order = next(8 * s);                     // [S] int64
  m.prev = next(8 * s1);                     // [S+1] int64
  m.src = next(8 * mt);                      // [MT] int64
  m.act = next(U);                           // [U] uint8
  m.dp = next(4 * mt * (l + 1) * s1);        // [MT][L+1][S+1] float32
  m.mn = next(4 * mt * l * s);               // [MT][L][S] float32
  m.s0b = next(mt * l * s);                  // [MT][L][S] uint8
  m.pa = next(mt * l * s1);                  // [MT][L][S+1] uint8
  m.ps = next(mt * l * s1);                  // [MT][L][S+1] uint8
  m.bytes = end;
  return m;
}

// kS > 0 fixes the state count at compile time (the planner's 8-UAV
// swarms), so the scans unroll; kS = 0 takes any S.
template <int kS>
__global__ void tropical_dp_chain_kernel(
    const float* __restrict__ rate,          // [B, U, U]
    const long long* __restrict__ sources,   // [B, M], strides src_b/src_m
    long long src_b, long long src_m,
    const unsigned char* __restrict__ active,  // [B, U] bool
    const long long* __restrict__ order,     // [S]
    const long long* __restrict__ prev_dev,  // [S+1]
    const float* __restrict__ bits_in,       // [L]
    const float* __restrict__ input_bits,    // [1]
    const float* __restrict__ ct,            // [L(step), L(a), S]
    const float* __restrict__ ok,            // [L(step), L(a), S]
    int* __restrict__ assign,                // [B, M, L]
    float* __restrict__ latency,             // [B, M]
    int U, int M, int L, int S_arg, int MT, ChainSmem off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = kS > 0 ? kS : S_arg;
  const int S1 = S + 1;
  float* tr = reinterpret_cast<float*>(smem);               // [S][L][S+1]
  float* ct_s = reinterpret_cast<float*>(smem + off.ct);    // [L][L][S]
  float* ok_s = reinterpret_cast<float*>(smem + off.ok);    // [L][L][S]
  float* rate_s = reinterpret_cast<float*>(smem + off.rate);  // [U][U]
  float* bits_s = reinterpret_cast<float*>(smem + off.bits);  // [L] + input
  long long* order_s = reinterpret_cast<long long*>(smem + off.order);
  long long* prev_s = reinterpret_cast<long long*>(smem + off.prev);
  long long* src_s = reinterpret_cast<long long*>(smem + off.src);  // [MT]
  unsigned char* act_s = smem + off.act;                    // [U]
  float* dp = reinterpret_cast<float*>(smem + off.dp);      // [MT][L+1][S+1]
  float* mn = reinterpret_cast<float*>(smem + off.mn);      // [MT][L][S]
  unsigned char* s0b = smem + off.s0b;                      // [MT][L][S]
  unsigned char* pa = smem + off.pa;                        // [MT][L][S+1]
  unsigned char* ps = smem + off.ps;                        // [MT][L][S+1]
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long b = blockIdx.x;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);

  // Stage every operand the block reads in one round trip: each thread
  // starts all its copies before waiting on any (the active flags, bytes,
  // by plain loads in flight beside them).
  stage(rate_s, rate + b * U * U, U * U, tid, nt);
  stage(ct_s, ct, L * L * S, tid, nt);
  stage(ok_s, ok, L * L * S, tid, nt);
  stage(bits_s, bits_in, L, tid, nt);
  if (tid == 0) hopper::cp_async<4>(bits_s + L, input_bits);
  for (int i = tid; i < S; i += nt)
    hopper::cp_async<8>(order_s + i, order + i);
  for (int i = tid; i <= S; i += nt)
    hopper::cp_async<8>(prev_s + i, prev_dev + i);
  for (int i = tid; i < mt; i += nt)
    hopper::cp_async<8>(src_s + i, sources + b * src_b + (m0 + i) * src_m);
  // dp tables: 0 at (row 0, state 0), inf elsewhere; parents 0 (state 0's
  // column is never written, and the backtrack may read it)
  const int dp_m = (L + 1) * S1;
  for (int i = tid; i < mt * dp_m; i += nt)
    dp[i] = (i % dp_m == 0) ? 0.0f : INFINITY;
  for (int i = tid; i < mt * L * S1; i += nt) pa[i] = ps[i] = 0;
  for (int i = tid; i < U; i += nt) act_s[i] = active[b * U + i];
  hopper::cp_async_wait_all();
  __syncthreads();

  // transfer tensor, slot-invariant: bits_in[a] / rate into state s from
  // state s0 <= s, inf on a dead link, a dead target or s0 > s.  A thread
  // takes one (s, s0) link and its independent divisions over a; the
  // a = 0 row is dead (block starts at a = 0 take the per-slot source row
  // instead) and is not built.
  for (int i = tid; i < S * S1; i += nt) {
    const int s = i / S1, s0 = i - s * S1;
    const int os = (int)order_s[s];
    const float r = rate_s[prev_s[s0] * U + os];
    const bool keep = s0 <= s && act_s[os] && r > 0.0f;
    float* col = tr + s * L * S1 + s0;            // tr[s][a][s0]
    for (int a = 1; a < L; ++a)
      col[a * S1] = keep ? __fdiv_rn(bits_s[a], r) : INFINITY;
  }
  // Q lanes own output s of slot m, lane q the indices q, q + Q, ...  Where
  // a slot's outputs fit in a warp (S Q <= 32), slot m is warp m and the
  // steps sync the warp alone; else the outputs run on consecutive lanes
  // and the steps sync the block (the plan gives every output its lanes).
  const bool warp_slots = S * Q <= 32;
  const int q = tid % Q;
  int m, o;
  bool owner;
  if (warp_slots) {
    m = tid / 32;
    o = (tid % 32) / Q;
    owner = m < mt && o < S;
  } else {
    owner = tid < Q * mt * S;
    m = owner ? tid / Q / S : 0;
    o = owner ? tid / Q - m * S : 0;
  }
  if (!owner) m = o = 0;
  const int s = o;
  // Block start a = 0: the per-slot source row, masked like the transfer
  // tensor; dp[0, 0] is its only finite predecessor (s0 = 0).
  float* mn_m = mn + m * L * S + s;                 // mn[m][a][s], stride S
  unsigned char* s0b_m = s0b + m * L * S + s;
  float* d_m = dp + m * dp_m;
  if (owner && q == 0) {
    const int os = (int)order_s[s];
    const float r = rate_s[src_s[m] * U + os];
    const float v = r > 0.0f ? __fdiv_rn(bits_s[L], r) : INFINITY;
    mn_m[0] = __fadd_rn(d_m[0], act_s[os] ? v : INFINITY);
    s0b_m[0] = 0;
  }
  __syncthreads();

  // forward wavefront: table row j from rows 0 .. j-1, then row j's mins.
  // Every thread runs the merges, so the shuffles see full warps.
  for (int j = 1; j <= L; ++j) {
    const float* ctj = ct_s + (j - 1) * L * S + s;
    const float* okj = ok_s + (j - 1) * L * S + s;
    // Rows a >= j never win: chain_dp_tables' ok is 0 for a >= step, and a
    // masked candidate (inf) replaces no earlier one, not even an all-inf
    // a = 0 (the first argmin stays a = 0, s0 = 0).  So a stops at j - 1,
    // exactly.
    float best = INFINITY;
    int a_best = L;                          // no candidate yet
    for (int a = q; a < j && owner; a += Q) {
      float c = __fadd_rn(mn_m[a * S], ctj[a * S]);
      c = okj[a * S] > 0.0f ? c : INFINITY;
      const bool t = takes(c, a, best, a_best);
      best = t ? c : best;
      a_best = t ? a : a_best;
    }
    merge_lanes(best, a_best);
    if (owner && q == 0) {                   // a = 0 always took part
      const int at = (m * L + j - 1) * S1 + s + 1;
      d_m[j * S1 + s + 1] = best;
      pa[at] = (unsigned char)a_best;
      ps[at] = s0b_m[a_best * S];
    }
    if (warp_slots) __syncwarp(); else __syncthreads();
    if (j == L) break;
    // block start a = j: the min over s0 of dp[j, s0] + tr[j, s, s0]
    const float* d = d_m + j * S1;
    const float* t = tr + (s * L + j) * S1;
    best = INFINITY;
    int s0_best = S1;                        // no candidate yet
#pragma unroll
    for (int s0 = q; s0 < S1 && owner; s0 += Q) {
      const float v = __fadd_rn(d[s0], t[s0]);
      const bool take = takes(v, s0, best, s0_best);
      best = take ? v : best;
      s0_best = take ? s0 : s0_best;
    }
    merge_lanes(best, s0_best);
    if (owner && q == 0) {
      mn_m[j * S] = best;
      s0b_m[j * S] = (unsigned char)s0_best;
    }
    if (warp_slots) __syncwarp(); else __syncthreads();
  }
  __syncthreads();

  // backtrack, one thread per slot: the reference's reverse scan verbatim
  for (int q = tid; q < mt; q += nt) {
    const float* fin = dp + q * dp_m + L * S1;
    float lat = fin[0];
    int st = 0;
    for (int k = 1; k < S1; ++k) {
      const bool t = before(fin[k], lat);
      lat = t ? fin[k] : lat;
      st = t ? k : st;
    }
    const bool feasible = isfinite(lat);
    int* out = assign + (b * M + m0 + q) * L;
    int bcur = L;
    for (int j = L - 1; j >= 0; --j) {
      out[j] = feasible ? (int)order_s[max(st - 1, 0)] : -1;
      const int bi = min(max(bcur - 1, 0), L - 1);
      const int at = (q * L + bi) * S1 + st;
      const int a = pa[at];
      const int s0 = ps[at];
      if (a == j) { bcur = a; st = s0; }   // layer j opens the block
    }
    latency[b * M + m0 + q] = lat;
  }
}

}  // namespace

extern "C" int repro_tropical_dp_step(const void* dp, long long dp_bm,
                                      const void* tr, const void* tr0,
                                      const void* ct, const void* ok,
                                      void* row, void* pa, void* ps, int B,
                                      int M, int L, int S, void* stream) {
  const long long n = (long long)B * M * S;
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  tropical_dp_step_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)dp, dp_bm, (const float*)tr, (const float*)tr0,
      (const float*)ct, (const float*)ok, (float*)row, (int*)pa, (int*)ps,
      B, M, L, S);
  return (int)cudaGetLastError();
}

// The fused solve.  The wrapper chooses MT (slots a block) and the block's
// threads from the shapes (`chain_plan`) and passes its shared-memory total,
// which must be the layout's.
extern "C" int repro_tropical_dp_chain(
    const void* rate, const void* sources, long long src_b, long long src_m,
    const void* active, const void* order, const void* prev_dev,
    const void* bits_in, const void* input_bits, const void* ct,
    const void* ok, void* assign, void* latency, int B, int U, int M, int L,
    int S, int MT, int threads, int smem_bytes, void* stream) {
  if (B <= 0 || M <= 0) return (int)cudaSuccess;
  const ChainSmem off = chain_smem(L, S, U, MT);
  if (off.bytes != smem_bytes) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)((M + MT - 1) / MT));
  auto kern =
      S == 8 ? tropical_dp_chain_kernel<8> : tropical_dp_chain_kernel<0>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)rate, (const long long*)sources, src_b, src_m,
      (const unsigned char*)active, (const long long*)order,
      (const long long*)prev_dev, (const float*)bits_in,
      (const float*)input_bits, (const float*)ct, (const float*)ok,
      (int*)assign, (float*)latency, U, M, L, S, MT, off);
  return (int)cudaGetLastError();
}

// The fused kernel's shared-memory bytes for one block of MT slots.
extern "C" long long repro_tropical_dp_chain_smem_bytes(int L, int S, int U,
                                                        int MT) {
  return chain_smem(L, S, U, MT).bytes;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
