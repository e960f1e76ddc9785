// Backward of the chunkwise mLSTM cell (csrc/mlstm_chunk.cu), for sm_90a.
//
// No Pallas kernel computes it: it is XLA's gradient of the reference's
// src/repro/models/recurrent.py:216 `mlstm_chunk_math` under :262
// `mlstm_seq`, which the reference takes through its lax.scan over chunks.
// Given the forward's operands (q, k, v [B, S, H, D] in float32 or
// bfloat16, q unscaled; the gate pre-activations i, f [B, S, H] and the
// initial state C0 [B, H, D, D], n0 [B, H, D], m0 [B, H], float32), the
// gradient dh of h (q's dtype) and the final state's dC1, dn1, dm1 (each
// may be null: zeros), it writes dq, dk, dv (q's dtype), di, df [B, S, H]
// and dC0, dn0, dm0 (float32).  Chunks of L = 64 steps, the last ragged.
//
// The math, per chunk in the forward's notation (ref.py's
// `chunk_bwd_math` computes the same in torch):
//   b = cumsum log sigmoid(f), a = i - b, mx = max(m0, cummax a),
//   w[t, s] = exp(a_s - mx_t) (s <= t), inter_t = exp(m0 - mx_t),
//   m_t = b_t + mx_t, S = scale q k^T, sw = S o w,
//   num = sw V + scale inter q C0, den_raw = rowsum sw + scale inter q.n0,
//   den = max(|den_raw|, exp(-m_t)), h = num / den,
//   decay_s = exp(a_s - mx_L), carry = exp(m0 - mx_L),
//   C1 = carry C0 + sum_s decay_s k_s v_s^T (n1 likewise), m1 = b_L + mx_L.
// * Only mx is a stabiliser: each h_t and the state's represented value
//   C e^m are exactly invariant to it, so mx is held constant (no gradient
//   through cummax or max) but for one term.  m is not: dm1 adds to db_L,
//   and dm0 goes back to the previous chunk.  The one term: the final
//   state (C1, n1, m1) moves with mx_L as (-C1, -n1, 1), so mx_L's
//   gradient is r = dm1 - <dC1, C1> - <dn1, n1>, zero for a downstream
//   that reads only the represented value (training's, and each chunk's
//   for the next).  r goes to mx_L = max(m0, max_s a_s)'s argmax: to dm0
//   where m0 holds the max (m0 >= max_s a_s; the previous chunk's r is
//   then this one), else to da at the first s* with a_s* = mx_L (the
//   previous chunk's r is 0).  So the gradient is exact for any seeds.
// * dnum_t = dh_t / den_t; dden_t = -dh_t . h_t / den_t.  Where |den_raw|
//   wins, dden_raw_t = sign(den_raw_t) dden_t; where exp(-m_t) wins (the
//   common case at random init), dden_raw_t = 0 and db_t gains
//   -exp(-m_t) dden_t = dh_t . h_t.
// * dsw = (dnum V^T + dden_raw 1^T) masked to s <= t;
//   dq = scale (dsw o w) K + scale inter (C0 dnum + dden_raw n0);
//   dk = scale (dsw o w)^T Q + decay (dC1 v + dn1);
//   dv = sw^T dnum + decay dC1^T k;
//   da_s = sum_t (dsw o sw)[t, s] + decay_s k_s . (dC1 v_s + dn1).
// * di = da (+ r at s*); db = [exp branch] dh.h - di (+ dm1 at the last
//   step);
//   dlog_f = reverse cumsum of db; df = dlog_f sigmoid(-f);
//   dC0 = carry dC1 + scale sum_t inter_t q_t dnum_t^T,
//   dn0 = carry dn1 + scale sum_t inter_t dden_raw_t q_t,
//   dm0 = sum_t inter_t (scale q_t^T C0 dnum_t + scale q_t.n0 dden_raw_t)
//         + carry (<dC1, C0> + <dn1, n0>).
//
// Bound.  At xlstm-350m's training call (B 1, S 4,096, H 4, D 256, bf16)
// q, k, v and dh in and dq, dk, dv out are 58.7 MB, 61.1 MB with the gates
// and the state (18.24 us at 3.35 TB/s).  The products are about 6 L^2 D +
// 6 L D^2 multiply-adds a chunk and head, 16.1 GFLOP in all: 16.3 us at the
// bf16 tensor-core peak, 240 us at the fp32 SIMT peak.  So the least time
// is the bytes'.  A design that hands the chunk-start states C_c and their
// gradients dC_{c+1} from pass to pass through device memory has a floor of
// its own: the wgmma route writes both once (67.1 MB each at the training
// call, as bf16 hi + lo planes) and reads C_c twice and dC_{c+1} once,
// 396.6 MB with the inputs and outputs, 118.4 us.
//
// Two routes (the wrapper's `mlstm_bwd_route`: bfloat16 wgmma, float32
// simt), five kernels on the stream each, counted as one launch; every sum
// in one fixed order, no atomics, so a launch is bitwise equal to the next.
// A workspace the wrapper allocates carries what they hand on: the wrapper
// sizes it by its own copy of `carve`'s layout (`bwd_workspace_bytes`),
// and a launch refuses a workspace of any other size.
//
// Both routes start with the gates: a block per (b, h), warps over the
// chunks in parallel (pair scans of log f's cumsum and a's cummax), then
// thread 0 carries m from chunk to chunk; mx_t, b_t and each m_c.
//
// simt (float32; the first port's kernels):
//  1. gates, as above.
//  2. states: a block per (b, h, 32 x 32 tile of C) carries its tile of C
//     in registers over the chunks (C never lives whole in one block: at
//     D 256 it is 256 KB), writing each chunk's starting C_c (and n_c);
//     given dC1 or dn1, on to the final state and its tile's share of
//     <dC1, C1> + <dn1, n1>.
//  3. local: a block per (b, h, chunk) forms sw, den_raw, den and
//     dh_t . h_t (q C_c and sw V over value slabs of 32), and writes den,
//     dden_raw, the exp branch's db and the chunk's share of dm.
//  4. reverse: a block per (b, h, tile) carries its tile of dC (and dn)
//     backwards over the chunks: writes dC_{c+1} (the chunk's output-state
//     gradient) and its tile's <dC_{c+1}, C_c> + <dn_{c+1}, n_c>, then
//     dC_c = carry dC_{c+1} + scale sum_t inter_t q_t dnum_t^T; the last is
//     dC0.
//  5. grad: a block per (b, h, chunk), parallel over chunks: sw, dsw, then
//     dq, dk, dv over output slabs of 32 columns (the D x D products with
//     C_c and dC_{c+1} over slabs of 32), da, and the gates' reverse cumsum
//     for di and df; the block of chunk 0 writes dm0, summing the tiles'
//     partials in tile order.  Each block's thread 0 forms r from the
//     final state's partials (in tile order) and walks the later chunks to
//     see whether it reaches this one.
//
// wgmma (bfloat16; namespace wg below): the same passes with every product
// on the tensor cores, in 64 x 64 tiles (D padded to DP, a multiple of 64:
// TMA reads columns past D and steps past S as zeros).  Six operands are
// float32 and go in as a bf16 high part plus the bf16 rounding of what it
// leaves (one rounding breaks the card's gate; tests/test_torch_mlstm_bwd_
// route.py): C_c and dC_{c+1} (stored so), exp(a_s - mx_L) k_s in the
// state recompute, scale inter_t / den_t q_t in the gradient walk, ds, and
// sw / den.  Row scalings of exact products go on the accumulators.
//  1. gates, as above.
//  2. states: a block per (64 x 64 tile (i, j) of C, b, h), 64 blocks at
//     the training call; warpgroup 0 holds the tile in accumulators, a
//     producer warp keeps a 4-stage TMA ring of k_i, v_j, q_i, dh_j, two
//     more put the chunk's decays in and sum n's increment.  A chunk: C_c
//     out by TMA (staged as hi + lo), P = q_i C_c and the tile's partial
//     of dh_t . q_t C_c, C <- carry C + (dec o k_i)^T v_j.
//  3. local: a block per (chunk, b, h): S = q k^T and G = dh v^T on wgmma,
//     den, dden_raw, the exp branch's db and dm's inter share, dh . h from
//     sum_s sw G and the walk's partials (C_c is not read here).
//  4. reverse: the states walk's shape backwards: dC_{c+1} out by TMA,
//     <dC_{c+1}, C_c> (C_c's tile by TMA) as the tile's partial, dC <-
//     carry dC + (coef / den o q_i)^T dh_j.
//  5. grad: a block per (chunk, b, h), 384 threads: q, k, v, dh by TMA, the
//     planes' tiles through a 3-stage ring; warpgroup 1 forms S^T, G^T,
//     ds^T and sw^T / den and accumulates dv = decay (k dC) + (sw / den)^T
//     dh and da, warpgroup 0 dq and dk a row of tiles at a time; the gates
//     as on simt.
// The chains (2, 4) walk 64 chunks in turn on 64 SMs: each chunk's SIMT
// work (the fragments' scaling, the staging, the partials) and its
// products' latency set their time, not the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int L = 64;           // chunk length
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TS = 32;          // slab and tile width
constexpr int LD = TS + 1;      // padded slab row
constexpr int LDL = L + 1;      // padded [L, L] row
constexpr int DMAX = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// -softplus(-x) in softplus's max(y, 0) + log1p(exp(-|y|)) form
__device__ __forceinline__ float log_sigmoid(float x) {
  const float y = -x;
  return -(fmaxf(y, 0.f) + log1pf(expf(-fabsf(y))));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The workspace.  BH = B H, NC chunks, NT tiles a side (32 x 32 tiles on
// the simt route, 64 x 64 on wgmma).  Float32 but for wgmma's state planes.
struct Work {
  float *gb, *gmx, *gm;            // b_t, mx_t [BH, S]; m_c [BH, NC]
  float *den, *ddr, *dbm;          // den_t, dden_raw_t, exp-branch db [BH, S]
  float *dmi, *dmp;                // dm's inter share [BH, NC]; tile
                                   // partials [BH, NC, NT^2]
  float* dmf;                      // <dC1, C1> + <dn1, n1>, tile partials
                                   // [BH, NT^2]
  float *nw, *dnw;                 // n_c, dn_{c+1} [BH, NC, D]
  float *Cw, *dCw;                 // simt: C_c, dC_{c+1} [BH, NC, D, D]
  float* e;                        // wgmma: dh_t . q_t C_c, tile partials
                                   // [BH, NC, NT^2, 64]
  float *cb, *cM;                  // each chunk's b_L and max_s a_s [BH, NC]
  __nv_bfloat16 *Ch, *Cl, *dCh, *dCl;  // wgmma: C_c, dC_{c+1} as bf16 hi
                                       // and lo planes [BH, NC, DP, DP]
};

struct Dims {
  int B, S, H, D, NC, NT, route;
  size_t BH() const { return (size_t)B * H; }
  int DP() const { return NT * 64; }     // wgmma: D padded to its tiles
};

size_t carve(float* base, const Dims& d, Work* w) {
  const size_t bh = d.BH(), S = d.S, NC = d.NC, D = d.D, NT = d.NT;
  const bool wg = d.route == 1;
  const size_t plane = wg ? bh * NC * d.DP() * d.DP() / 2 : 0;  // floats
  size_t off = 0;
  auto take = [&](size_t n) {          // n floats, each slot on 16 bytes
    float* p = base && n ? base + off : nullptr;
    off += (n + 3) / 4 * 4;
    return p;
  };
  auto bf = [](float* p) { return reinterpret_cast<__nv_bfloat16*>(p); };
  w->gb = take(bh * S);
  w->gmx = take(bh * S);
  w->gm = take(bh * NC);
  w->den = take(bh * S);
  w->ddr = take(bh * S);
  w->dbm = take(bh * S);
  w->dmi = take(bh * NC);
  w->dmp = take(bh * NC * NT * NT);
  w->dmf = take(bh * NT * NT);
  w->nw = take(bh * NC * D);
  w->dnw = take(bh * NC * D);
  w->Cw = take(wg ? 0 : bh * NC * D * D);
  w->dCw = take(wg ? 0 : bh * NC * D * D);
  w->e = take(wg ? bh * NC * NT * NT * 64 : 0);
  w->cb = take(bh * NC);
  w->cM = take(bh * NC);
  w->Ch = bf(take(plane));
  w->Cl = bf(take(plane));
  w->dCh = bf(take(plane));
  w->dCl = bf(take(plane));
  return off * sizeof(float);
}

template <typename T>
struct Args {
  const T *q, *k, *v, *dh;
  const float *ig, *fg, *C0, *n0, *m0, *dC1, *dn1, *dm1;
  T *dq, *dk, *dv;
  float *di, *df, *dC0, *dn0, *dm0;
  Work w;
  int B, S, H, D, NC, NT;
  float scale;
};

// Row t0 of a [B, S, H, D] operand at (b, h), column d0.
template <typename T>
__device__ __forceinline__ const T* at(const Args<T>& x, const T* p, int b,
                                       int h, int t0, int d0) {
  return p + (((size_t)b * x.S + t0) * x.H + h) * x.D + d0;
}

// dst[r][c] = src[r * stride + c] as float (divided by div[r] when given),
// zeros outside rows x cols.
template <int R, typename T>
__device__ __forceinline__ void load_rows(float (*dst)[LD], const T* src,
                                          size_t stride, int rows, int cols,
                                          const float* div = nullptr) {
  for (int e = threadIdx.x; e < R * TS; e += THREADS) {
    const int r = e / TS, c = e % TS;
    float v = 0.f;
    if (r < rows && c < cols) {
      v = to_f(src[r * stride + c]);
      if (div) v = v / div[r];
    }
    dst[r][c] = v;
  }
}

// dst[c][r] = src[r * stride + c] (a transposed 32 x 32 tile), zeros
// outside rows x cols.
__device__ __forceinline__ void load_cols(float (*dst)[LD], const float* src,
                                          size_t stride, int rows, int cols) {
  for (int e = threadIdx.x; e < TS * TS; e += THREADS) {
    const int r = e / TS, c = e % TS;
    dst[c][r] = (r < rows && c < cols) ? src[r * stride + c] : 0.f;
  }
}

// Chunk c's a_t, mx_t and b_t (lc steps; past them a = -inf, so every
// weight and decay of a padded step is 0).
template <typename T>
__device__ void load_gates(const Args<T>& x, int bh, int c, int lc,
                           float* sa, float* smx, float* sb) {
  const int b = bh / x.H, h = bh % x.H;
  for (int t = threadIdx.x; t < L; t += THREADS) {
    if (t < lc) {
      const size_t tt = (size_t)c * L + t;
      const float bt = x.w.gb[(size_t)bh * x.S + tt];
      sb[t] = bt;
      smx[t] = x.w.gmx[(size_t)bh * x.S + tt];
      sa[t] = x.ig[((size_t)b * x.S + tt) * x.H + h] - bt;
    } else {
      sb[t] = 0.f;
      smx[t] = 0.f;
      sa[t] = -INFINITY;
    }
  }
}

__device__ __forceinline__ int chunk_len(int S, int c) {
  return min(L, S - c * L);
}

// ---------------------------------------------------------------------------
// 1. gate cumulatives, a block per (b, h) (both routes)
// ---------------------------------------------------------------------------

// Warps take the chunks in parallel: a lane takes steps 2 l and 2 l + 1,
// b = cumsum log sigmoid(f) and the chunk-local cummax of a by warp scans
// of the pairs; each chunk's b_L and max a go to the workspace.  Thread 0
// then carries m over the chunks (m_{c+1} = b_L + max(m_c, max a)), and
// every thread forms mx_t = max(m_c, cummax a).
template <typename T>
__global__ void __launch_bounds__(256) gates_kernel(Args<T> x) {
  const int bh = blockIdx.x, b = bh / x.H, h = bh % x.H;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t g0 = (size_t)bh * x.S, c0 = (size_t)bh * x.NC;
  for (int c = warp; c < x.NC; c += 8) {
    const int lc = chunk_len(x.S, c);
    float lf[2], ip[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = 2 * lane + u;
      const size_t g = ((size_t)b * x.S + (size_t)c * L + t) * x.H + h;
      lf[u] = t < lc ? log_sigmoid(x.fg[g]) : 0.f;
      ip[u] = t < lc ? x.ig[g] : 0.f;
    }
    const float pair = lf[0] + lf[1];
    float inc = pair;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += y;
    }
    float ex = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) ex = 0.f;
    const float bt[2] = {ex + lf[0], ex + pair};
    float a[2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      a[u] = 2 * lane + u < lc ? ip[u] - bt[u] : -INFINITY;
    const float pm = fmaxf(a[0], a[1]);
    float incm = pm;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incm, o);
      if (lane >= o) incm = fmaxf(incm, y);
    }
    float exm = __shfl_up_sync(0xffffffffu, incm, 1);
    if (lane == 0) exm = -INFINITY;
    const float M[2] = {fmaxf(exm, a[0]), fmaxf(exm, pm)};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = 2 * lane + u;
      if (t < lc) {
        x.w.gb[g0 + (size_t)c * L + t] = bt[u];
        x.w.gmx[g0 + (size_t)c * L + t] = M[u];   // local until below
      }
      if (t == lc - 1) {
        x.w.cb[c0 + c] = bt[u];
        x.w.cM[c0 + c] = M[u];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = x.m0[bh];
    for (int c = 0; c < x.NC; ++c) {
      x.w.gm[c0 + c] = m;
      m = x.w.cb[c0 + c] + fmaxf(m, x.w.cM[c0 + c]);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < x.S; t += 256)
    x.w.gmx[g0 + t] = fmaxf(x.w.gm[c0 + t / L], x.w.gmx[g0 + t]);
}

// A block's 32 x 32 tile of a [D, D] state: rows r0 + (tid / 32) + 8 j,
// column c0 + tid % 32, j = 0..3.
struct TileMap {
  int r0, c0, row, col;
  __device__ TileMap(int tile, int nt) {
    r0 = (tile / nt) * TS;
    c0 = (tile % nt) * TS;
    row = threadIdx.x / 32;
    col = threadIdx.x % 32;
  }
  __device__ bool ok(int j, int D) const {
    return r0 + row + 8 * j < D && c0 + col < D;
  }
  __device__ size_t idx(int j, int D) const {
    return (size_t)(r0 + row + 8 * j) * D + c0 + col;
  }
};

// ---------------------------------------------------------------------------
// 2. chunk-start states C_c, n_c
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) states_kernel(Args<T> x) {
  __shared__ float ks[L][LD], vs[L][LD];
  __shared__ float sa[L], smx[L], sb[L], dec[L];
  __shared__ float red[WARPS];
  const bool want_final = x.dC1 || x.dn1;
  const int bh = blockIdx.y, D = x.D;
  const int b = bh / x.H, h = bh % x.H;
  const TileMap tm(blockIdx.x, x.NT);
  const bool has_n = tm.c0 == 0 && threadIdx.x < TS &&
                     tm.r0 + (int)threadIdx.x < D;
  float C[4], n = 0.f;
  for (int j = 0; j < 4; ++j)
    C[j] = tm.ok(j, D) ? x.C0[(size_t)bh * D * D + tm.idx(j, D)] : 0.f;
  if (has_n) n = x.n0[(size_t)bh * D + tm.r0 + threadIdx.x];
  for (int c = 0; c < x.NC; ++c) {
    const size_t cs = (size_t)bh * x.NC + c;
    for (int j = 0; j < 4; ++j)
      if (tm.ok(j, D)) x.w.Cw[cs * D * D + tm.idx(j, D)] = C[j];
    if (has_n) x.w.nw[cs * D + tm.r0 + threadIdx.x] = n;
    if (c == x.NC - 1 && !want_final) break;
    const int lc = chunk_len(x.S, c);
    __syncthreads();
    load_gates(x, bh, c, lc, sa, smx, sb);
    load_rows<L>(ks, at(x, x.k, b, h, c * L, tm.r0), (size_t)x.H * D, lc,
                 min(TS, D - tm.r0));
    load_rows<L>(vs, at(x, x.v, b, h, c * L, tm.c0), (size_t)x.H * D, lc,
                 min(TS, D - tm.c0));
    __syncthreads();
    const float mxl = smx[lc - 1];
    for (int t = threadIdx.x; t < L; t += THREADS)
      dec[t] = t < lc ? expf(sa[t] - mxl) : 0.f;
    __syncthreads();
    const float carry = expf(x.w.gm[cs] - mxl);
    for (int j = 0; j < 4; ++j) {
      float acc = 0.f;
      for (int s = 0; s < lc; ++s)
        acc = fmaf(dec[s] * ks[s][tm.row + 8 * j], vs[s][tm.col], acc);
      C[j] = fmaf(carry, C[j], acc);
    }
    if (has_n) {
      float acc = 0.f;
      for (int s = 0; s < lc; ++s) acc = fmaf(dec[s], ks[s][threadIdx.x], acc);
      n = fmaf(carry, n, acc);
    }
  }
  if (!want_final) return;
  // C, n now the final state: this tile's <dC1, C1> + <dn1, n1>
  float p = 0.f;
  if (x.dC1)
    for (int j = 0; j < 4; ++j)
      if (tm.ok(j, D))
        p = fmaf(x.dC1[(size_t)bh * D * D + tm.idx(j, D)], C[j], p);
  if (has_n && x.dn1) p = fmaf(x.dn1[(size_t)bh * D + tm.r0 + threadIdx.x],
                               n, p);
  p = warp_sum(p);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = p;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w];
    x.w.dmf[(size_t)bh * x.NT * x.NT + blockIdx.x] = s;
  }
}

// sw[t][s] of chunk c into `sw` (and w into `wout` when given), from q and
// k slabs of 32 through xa, xb; q . n_c into qn[t] (nvec holds n_c).
// Thread (ty, tx) = (tid / 16, tid % 16) owns t = ty + 16 i, s = tx + 16 j.
template <typename T>
__device__ void chunk_scores(const Args<T>& x, int b, int h, int c, int lc,
                             const float* sa, const float* smx,
                             const float* nvec, float (*xa)[LD],
                             float (*xb)[LD], float (*sw)[LDL],
                             float (*wout)[LDL], float* qn) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, D = x.D;
  float acc[4][4] = {};
  float qacc = 0.f;
  for (int d0 = 0; d0 < D; d0 += TS) {
    __syncthreads();
    load_rows<L>(xa, at(x, x.q, b, h, c * L, d0), (size_t)x.H * D, lc,
                 min(TS, D - d0));
    load_rows<L>(xb, at(x, x.k, b, h, c * L, d0), (size_t)x.H * D, lc,
                 min(TS, D - d0));
    __syncthreads();
    for (int kk = 0; kk < TS; ++kk) {
      float qa[4], kb[4];
      for (int i = 0; i < 4; ++i) qa[i] = xa[ty + 16 * i][kk];
      for (int j = 0; j < 4; ++j) kb[j] = xb[tx + 16 * j][kk];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qa[i], kb[j], acc[i][j]);
    }
    if (qn && threadIdx.x < L && d0 < D)
      for (int kk = 0; kk < min(TS, D - d0); ++kk)
        qacc = fmaf(xa[threadIdx.x][kk], nvec[d0 + kk], qacc);
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int t = ty + 16 * i, s = tx + 16 * j;
      const bool keep = t < lc && s <= t;
      const float w = keep ? expf(sa[s] - smx[t]) : 0.f;
      sw[t][s] = keep ? acc[i][j] * x.scale * w : 0.f;
      if (wout) wout[t][s] = w;
    }
  if (qn && threadIdx.x < L) qn[threadIdx.x] = qacc;
}

// ---------------------------------------------------------------------------
// 3. per chunk: den, dden_raw, the exp branch's db and dm's inter share
// ---------------------------------------------------------------------------

constexpr size_t LOCAL_SMEM =
    (L * LDL + 2 * L * LD + DMAX + 10 * L) * sizeof(float);

template <typename T>
__global__ void __launch_bounds__(THREADS) local_kernel(Args<T> x) {
  extern __shared__ float sm[];
  float(*sw)[LDL] = reinterpret_cast<float(*)[LDL]>(sm);
  float(*xa)[LD] = reinterpret_cast<float(*)[LD]>(sm + L * LDL);
  float(*xb)[LD] = xa + L;
  float* nvec = sm + L * LDL + 2 * L * LD;
  float *sa = nvec + DMAX, *smx = sa + L, *sb = smx + L, *sinter = sb + L,
        *sden = sinter + L, *sdraw = sden + L, *sdeni = sdraw + L,
        *sqn = sdeni + L, *sdot1 = sqn + L, *sdot2 = sdot1 + L;
  const int c = blockIdx.x, bh = blockIdx.y, D = x.D;
  const int b = bh / x.H, h = bh % x.H;
  const int lc = chunk_len(x.S, c);
  const size_t cs = (size_t)bh * x.NC + c;
  const float m = x.w.gm[cs];
  load_gates(x, bh, c, lc, sa, smx, sb);
  for (int d = threadIdx.x; d < D; d += THREADS) nvec[d] = x.w.nw[cs * D + d];
  for (int t = threadIdx.x; t < L; t += THREADS) {
    sdot1[t] = 0.f;
    sdot2[t] = 0.f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += THREADS)
    sinter[t] = t < lc ? expf(m - smx[t]) : 0.f;
  chunk_scores(x, b, h, c, lc, sa, smx, nvec, xa, xb, sw, (float(*)[LDL])0,
               sqn);
  __syncthreads();
  if (threadIdx.x < L) {
    const int t = threadIdx.x;
    float rs = 0.f;
    for (int s = 0; s < L; ++s) rs += sw[t][s];
    const float deni = sqn[t] * x.scale * sinter[t];
    const float draw = rs + deni;
    const float den = fmaxf(fabsf(draw), expf(-(sb[t] + smx[t])));
    sden[t] = t < lc ? den : 1.f;
    sdraw[t] = draw;
    sdeni[t] = deni;
  }
  // num = scale inter q C_c + sw V a value slab at a time; dh . num
  // (inter share and total) by warp sums.  Warp w owns rows w + 8 i.
  const int lane = threadIdx.x % 32, wr = threadIdx.x / 32;
  const float* Cc = x.w.Cw + cs * D * D;
  for (int v0 = 0; v0 < D; v0 += TS) {
    const int nv = min(TS, D - v0);
    float o[8] = {};
    for (int d0 = 0; d0 < D; d0 += TS) {
      __syncthreads();
      load_rows<L>(xa, at(x, x.q, b, h, c * L, d0), (size_t)x.H * D, lc,
                   min(TS, D - d0));
      load_rows<TS>(xb, Cc + (size_t)d0 * D + v0, D, min(TS, D - d0), nv);
      __syncthreads();
      for (int kk = 0; kk < TS; ++kk) {
        const float cv = xb[kk][lane];
        for (int i = 0; i < 8; ++i) o[i] = fmaf(xa[wr + 8 * i][kk], cv, o[i]);
      }
    }
    for (int i = 0; i < 8; ++i) o[i] *= x.scale * sinter[wr + 8 * i];
    __syncthreads();
    load_rows<L>(xa, at(x, x.dh, b, h, c * L, v0), (size_t)x.H * D, lc, nv);
    load_rows<L>(xb, at(x, x.v, b, h, c * L, v0), (size_t)x.H * D, lc, nv);
    __syncthreads();
    for (int i = 0; i < 8; ++i) {
      const float p = warp_sum(xa[wr + 8 * i][lane] * o[i]);
      if (lane == 0) sdot1[wr + 8 * i] += p;
    }
    for (int s = 0; s < L; ++s) {
      const float vv = xb[s][lane];
      for (int i = 0; i < 8; ++i) o[i] = fmaf(sw[wr + 8 * i][s], vv, o[i]);
    }
    for (int i = 0; i < 8; ++i) {
      const float p = warp_sum(xa[wr + 8 * i][lane] * o[i]);
      if (lane == 0) sdot2[wr + 8 * i] += p;
    }
  }
  __syncthreads();
  if (threadIdx.x < L) {
    const int t = threadIdx.x;
    float dm = 0.f;
    if (t < lc) {
      const float den = sden[t], draw = sdraw[t];
      const float hdh = sdot2[t] / den;
      const bool raw = fabsf(draw) >= expf(-(sb[t] + smx[t]));
      const float sgn = draw > 0.f ? 1.f : (draw < 0.f ? -1.f : 0.f);
      const float ddr = raw ? (-sgn * hdh) / den : 0.f;
      const size_t g = (size_t)bh * x.S + (size_t)c * L + t;
      x.w.den[g] = den;
      x.w.ddr[g] = ddr;
      x.w.dbm[g] = raw ? 0.f : hdh;
      dm = sdot1[t] / den + sdeni[t] * ddr;
    }
    sdot1[t] = dm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int t = 0; t < lc; ++t) s += sdot1[t];
    x.w.dmi[cs] = s;
  }
}

// ---------------------------------------------------------------------------
// 4. dC and dn carried backwards over the chunks
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) reverse_kernel(Args<T> x) {
  __shared__ float qs[L][LD], dns[L][LD];
  __shared__ float sa[L], smx[L], sb[L], sden[L], coef[L], cddr[L];
  __shared__ float red[WARPS];
  const int bh = blockIdx.y, D = x.D;
  const int b = bh / x.H, h = bh % x.H;
  const TileMap tm(blockIdx.x, x.NT);
  const bool has_n = tm.c0 == 0 && threadIdx.x < TS &&
                     tm.r0 + (int)threadIdx.x < D;
  float dC[4], dn = 0.f;
  for (int j = 0; j < 4; ++j)
    dC[j] = (x.dC1 && tm.ok(j, D))
                ? x.dC1[(size_t)bh * D * D + tm.idx(j, D)] : 0.f;
  if (has_n && x.dn1) dn = x.dn1[(size_t)bh * D + tm.r0 + threadIdx.x];
  for (int c = x.NC - 1; c >= 0; --c) {
    const size_t cs = (size_t)bh * x.NC + c;
    const int lc = chunk_len(x.S, c);
    float p = 0.f;
    for (int j = 0; j < 4; ++j)
      if (tm.ok(j, D)) {
        x.w.dCw[cs * D * D + tm.idx(j, D)] = dC[j];
        p = fmaf(dC[j], x.w.Cw[cs * D * D + tm.idx(j, D)], p);
      }
    if (has_n) {
      x.w.dnw[cs * D + tm.r0 + threadIdx.x] = dn;
      p = fmaf(dn, x.w.nw[cs * D + tm.r0 + threadIdx.x], p);
    }
    p = warp_sum(p);
    __syncthreads();
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = p;
    load_gates(x, bh, c, lc, sa, smx, sb);
    for (int t = threadIdx.x; t < L; t += THREADS)
      sden[t] = t < lc ? x.w.den[(size_t)bh * x.S + (size_t)c * L + t] : 1.f;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += red[w];
      x.w.dmp[cs * x.NT * x.NT + blockIdx.x] = s;
    }
    const float m = x.w.gm[cs];
    for (int t = threadIdx.x; t < L; t += THREADS) {
      coef[t] = t < lc ? x.scale * expf(m - smx[t]) : 0.f;
      cddr[t] = t < lc ? x.w.ddr[(size_t)bh * x.S + (size_t)c * L + t] : 0.f;
    }
    load_rows<L>(qs, at(x, x.q, b, h, c * L, tm.r0), (size_t)x.H * D, lc,
                 min(TS, D - tm.r0));
    load_rows<L>(dns, at(x, x.dh, b, h, c * L, tm.c0), (size_t)x.H * D, lc,
                 min(TS, D - tm.c0), sden);
    __syncthreads();
    const float carry = expf(m - smx[lc - 1]);
    for (int j = 0; j < 4; ++j) {
      float g = 0.f;
      for (int t = 0; t < lc; ++t)
        g = fmaf(coef[t] * qs[t][tm.row + 8 * j], dns[t][tm.col], g);
      dC[j] = fmaf(carry, dC[j], g);
    }
    if (has_n) {
      float g = 0.f;
      for (int t = 0; t < lc; ++t)
        g = fmaf(coef[t] * cddr[t], qs[t][threadIdx.x], g);
      dn = fmaf(carry, dn, g);
    }
  }
  for (int j = 0; j < 4; ++j)
    if (tm.ok(j, D)) x.dC0[(size_t)bh * D * D + tm.idx(j, D)] = dC[j];
  if (has_n) x.dn0[(size_t)bh * D + tm.r0 + threadIdx.x] = dn;
}

// ---------------------------------------------------------------------------
// 5. per chunk: dq, dk, dv, di, df (and dm0 in chunk 0's block)
// ---------------------------------------------------------------------------

constexpr size_t GRAD_SMEM =
    (3 * L * LDL + 3 * L * LD + TS * LD + 2 * DMAX + 12 * L) * sizeof(float);

// dm of chunk c's starting state: its inter share plus carry times the
// tiles' partials, summed in tile order.
template <typename T>
__device__ float chunk_dm(const Args<T>& x, int bh, int c) {
  const size_t cs = (size_t)bh * x.NC + c;
  const int lc = chunk_len(x.S, c);
  float s = 0.f;
  for (int i = 0; i < x.NT * x.NT; ++i) s += x.w.dmp[cs * x.NT * x.NT + i];
  const float mxl = x.w.gmx[(size_t)bh * x.S + (size_t)c * L + lc - 1];
  return x.w.dmi[cs] + expf(x.w.gm[cs] - mxl) * s;
}

// Whether chunk c's m0 holds the max that sets mx_L (m0 >= max_s a_s:
// fmaxf returned m0).
template <typename T>
__device__ bool m0_holds(const Args<T>& x, int bh, int c) {
  const int lc = chunk_len(x.S, c);
  return x.w.gmx[(size_t)bh * x.S + (size_t)c * L + lc - 1] ==
         x.w.gm[(size_t)bh * x.NC + c];
}

// The residual r of mx_L's gradient at chunk c's end: dm1 - <dC1, C1> -
// <dn1, n1> (the tiles' partials in tile order) where m0 holds the max in
// every later chunk, else 0.
template <typename T>
__device__ float chunk_residual(const Args<T>& x, int bh, int c) {
  if (!x.dC1 && !x.dn1 && !x.dm1) return 0.f;
  float s = 0.f;
  if (x.dC1 || x.dn1)
    for (int i = 0; i < x.NT * x.NT; ++i)
      s += x.w.dmf[(size_t)bh * x.NT * x.NT + i];
  const float r = (x.dm1 ? x.dm1[bh] : 0.f) - s;
  for (int cc = x.NC - 1; cc > c; --cc)
    if (!m0_holds(x, bh, cc)) return 0.f;
  return r;
}

// dm of chunk c's output state (the next chunk's dm0, with the residual
// where the next chunk's m0 held it) into sdm[0]; the residual's share for
// da at s* into sdm[1]; dm0 by chunk 0's caller.
template <typename T>
__device__ void chunk_ends(const Args<T>& x, int bh, int c, float* sdm) {
  const float r = chunk_residual(x, bh, c);
  const bool held = m0_holds(x, bh, c);
  sdm[0] = c == x.NC - 1 ? (x.dm1 ? x.dm1[bh] : 0.f)
                         : chunk_dm(x, bh, c + 1) + r;
  sdm[1] = held ? 0.f : r;
  if (c == 0) x.dm0[bh] = chunk_dm(x, bh, 0) + (held ? r : 0.f);
}

// The gates, by threads t = 0 .. L - 1 of the caller's group (`sync` its
// barrier): di = da (+ the residual at the first argmax s* of a), db =
// exp-branch term - da (+ dm at the last step), df = (reverse cumsum of
// db) sigmoid(-f).  da = sda + decay sda2; sdb is scratch.
template <typename T, typename Sync>
__device__ void gate_tail(const Args<T>& x, int bh, int c, int lc, int t,
                          const float* sa, float mxl, float* sda,
                          const float* sda2, const float* sdec,
                          const float* sdbm, float* sdb, const float* sdm,
                          Sync sync) {
  const int b = bh / x.H, h = bh % x.H;
  if (t < L) {
    float da = sda[t] + sdec[t] * sda2[t];
    if (t < lc && sa[t] == mxl) {
      bool first = true;
      for (int s = 0; s < t; ++s) first = first && sa[s] != mxl;
      if (first) da += sdm[1];
    }
    sda[t] = da;
    sdb[t] = sdbm[t] + (t == lc - 1 ? sdm[0] : 0.f) - da;
  }
  sync();
  if (t == 0) {
    float acc = 0.f;
    for (int s = lc - 1; s >= 0; --s) {
      acc += sdb[s];
      sdb[s] = acc;
    }
  }
  sync();
  if (t < lc) {
    const size_t g = ((size_t)b * x.S + (size_t)c * L + t) * x.H + h;
    x.di[g] = sda[t];
    x.df[g] = sdb[t] * (1.f / (1.f + expf(x.fg[g])));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) grad_kernel(Args<T> x) {
  extern __shared__ float sm[];
  float(*sw)[LDL] = reinterpret_cast<float(*)[LDL]>(sm);
  float(*ds)[LDL] = sw + L;       // w, then scale dsw o w
  float(*pp)[LDL] = ds + L;       // dsw o sw
  float(*xa)[LD] = reinterpret_cast<float(*)[LD]>(sm + 3 * L * LDL);
  float(*xb)[LD] = xa + L;
  float(*xc)[LD] = xb + L;
  float(*t32)[LD] = xc + L;
  float* nvec = sm + 3 * L * LDL + 3 * L * LD + TS * LD;
  float *dnvec = nvec + DMAX, *sa = dnvec + DMAX, *smx = sa + L,
        *sb = smx + L, *sden = sb + L, *sddr = sden + L, *sdbm = sddr + L,
        *sdec = sdbm + L, *sinter = sdec + L, *sda = sinter + L,
        *sda2 = sda + L, *sdb = sda2 + L, *sdm = sdb + L;
  const int c = blockIdx.x, bh = blockIdx.y, D = x.D;
  const int b = bh / x.H, h = bh % x.H;
  const int lc = chunk_len(x.S, c);
  const size_t cs = (size_t)bh * x.NC + c;
  const float m = x.w.gm[cs];
  const size_t hd = (size_t)x.H * D;
  load_gates(x, bh, c, lc, sa, smx, sb);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    nvec[d] = x.w.nw[cs * D + d];
    dnvec[d] = x.w.dnw[cs * D + d];
  }
  for (int t = threadIdx.x; t < L; t += THREADS) {
    const size_t g = (size_t)bh * x.S + (size_t)c * L + t;
    sden[t] = t < lc ? x.w.den[g] : 1.f;
    sddr[t] = t < lc ? x.w.ddr[g] : 0.f;
    sdbm[t] = t < lc ? x.w.dbm[g] : 0.f;
    sda2[t] = 0.f;
  }
  if (threadIdx.x == 0) chunk_ends(x, bh, c, sdm);
  __syncthreads();
  const float mxl = smx[lc - 1];
  for (int t = threadIdx.x; t < L; t += THREADS) {
    sinter[t] = t < lc ? expf(m - smx[t]) : 0.f;
    sdec[t] = t < lc ? expf(sa[t] - mxl) : 0.f;
  }
  chunk_scores(x, b, h, c, lc, sa, smx, nvec, xa, xb, sw, ds,
               (float*)nullptr);
  // dsw = dnum V^T + dden_raw, over value slabs
  {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[4][4] = {};
    for (int v0 = 0; v0 < D; v0 += TS) {
      __syncthreads();
      load_rows<L>(xa, at(x, x.dh, b, h, c * L, v0), hd, lc,
                   min(TS, D - v0), sden);
      load_rows<L>(xb, at(x, x.v, b, h, c * L, v0), hd, lc, min(TS, D - v0));
      __syncthreads();
      for (int kk = 0; kk < TS; ++kk) {
        float da_[4], vb[4];
        for (int i = 0; i < 4; ++i) da_[i] = xa[ty + 16 * i][kk];
        for (int j = 0; j < 4; ++j) vb[j] = xb[tx + 16 * j][kk];
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(da_[i], vb[j], acc[i][j]);
      }
    }
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, s = tx + 16 * j;
        const float dsw = (t < lc && s <= t) ? acc[i][j] + sddr[t] : 0.f;
        pp[t][s] = dsw * sw[t][s];
        ds[t][s] = dsw * ds[t][s] * x.scale;
      }
  }
  __syncthreads();
  if (threadIdx.x < L) {
    float s = 0.f;
    for (int t = 0; t < L; ++t) s += pp[t][threadIdx.x];
    sda[threadIdx.x] = s;
  }
  // the output slabs: warp wr owns rows wr + 8 i, lane the column
  const int lane = threadIdx.x % 32, wr = threadIdx.x / 32;
  const float* Cc = x.w.Cw + cs * D * D;
  const float* dCc = x.w.dCw + cs * D * D;
  const size_t row0 = (((size_t)b * x.S + (size_t)c * L) * x.H + h) * D;
  for (int j0 = 0; j0 < D; j0 += TS) {
    const int nj = min(TS, D - j0);
    // dq = ds K + scale inter (C_c dnum + dden_raw n_c)
    float o[8] = {}, p[8] = {};
    __syncthreads();
    load_rows<L>(xa, at(x, x.k, b, h, c * L, j0), hd, lc, nj);
    __syncthreads();
    for (int s = 0; s < L; ++s) {
      const float kv = xa[s][lane];
      for (int i = 0; i < 8; ++i) o[i] = fmaf(ds[wr + 8 * i][s], kv, o[i]);
    }
    for (int v0 = 0; v0 < D; v0 += TS) {
      __syncthreads();
      load_rows<L>(xb, at(x, x.dh, b, h, c * L, v0), hd, lc,
                   min(TS, D - v0), sden);
      load_cols(t32, Cc + (size_t)j0 * D + v0, D, nj, min(TS, D - v0));
      __syncthreads();
      for (int vv = 0; vv < TS; ++vv) {
        const float cv = t32[vv][lane];
        for (int i = 0; i < 8; ++i) p[i] = fmaf(xb[wr + 8 * i][vv], cv, p[i]);
      }
    }
    for (int i = 0; i < 8; ++i) {
      const int t = wr + 8 * i;
      if (t < lc && lane < nj)
        store1(x.dq + row0 + (size_t)t * hd + j0 + lane,
               o[i] + x.scale * sinter[t] *
                          (p[i] + sddr[t] * nvec[j0 + lane]));
    }
    // dk = ds^T Q + decay (dC v + dn); da's carried share k . (dC v + dn)
    for (int i = 0; i < 8; ++i) o[i] = p[i] = 0.f;
    __syncthreads();
    load_rows<L>(xc, at(x, x.q, b, h, c * L, j0), hd, lc, nj);
    __syncthreads();
    for (int t = 0; t < L; ++t) {
      const float qv = xc[t][lane];
      for (int i = 0; i < 8; ++i) o[i] = fmaf(ds[t][wr + 8 * i], qv, o[i]);
    }
    for (int v0 = 0; v0 < D; v0 += TS) {
      __syncthreads();
      load_rows<L>(xb, at(x, x.v, b, h, c * L, v0), hd, lc, min(TS, D - v0));
      load_cols(t32, dCc + (size_t)j0 * D + v0, D, nj, min(TS, D - v0));
      __syncthreads();
      for (int vv = 0; vv < TS; ++vv) {
        const float cv = t32[vv][lane];
        for (int i = 0; i < 8; ++i) p[i] = fmaf(xb[wr + 8 * i][vv], cv, p[i]);
      }
    }
    for (int i = 0; i < 8; ++i) {
      const int s = wr + 8 * i;
      const float u = p[i] + (lane < nj ? dnvec[j0 + lane] : 0.f);
      if (s < lc && lane < nj)
        store1(x.dk + row0 + (size_t)s * hd + j0 + lane, o[i] + sdec[s] * u);
      const float kd = warp_sum(xa[s][lane] * u);
      if (lane == 0) sda2[s] += kd;
    }
    // dv = sw^T dnum + decay dC^T k
    for (int i = 0; i < 8; ++i) o[i] = p[i] = 0.f;
    __syncthreads();
    load_rows<L>(xc, at(x, x.dh, b, h, c * L, j0), hd, lc, nj, sden);
    __syncthreads();
    for (int t = 0; t < L; ++t) {
      const float dv = xc[t][lane];
      for (int i = 0; i < 8; ++i) o[i] = fmaf(sw[t][wr + 8 * i], dv, o[i]);
    }
    for (int d0 = 0; d0 < D; d0 += TS) {
      __syncthreads();
      load_rows<L>(xb, at(x, x.k, b, h, c * L, d0), hd, lc, min(TS, D - d0));
      load_rows<TS>(t32, dCc + (size_t)d0 * D + j0, D, min(TS, D - d0), nj);
      __syncthreads();
      for (int dd = 0; dd < TS; ++dd) {
        const float cv = t32[dd][lane];
        for (int i = 0; i < 8; ++i) p[i] = fmaf(xb[wr + 8 * i][dd], cv, p[i]);
      }
    }
    for (int i = 0; i < 8; ++i) {
      const int s = wr + 8 * i;
      if (s < lc && lane < nj)
        store1(x.dv + row0 + (size_t)s * hd + j0 + lane, o[i] + sdec[s] * p[i]);
    }
  }
  __syncthreads();
  gate_tail(x, bh, c, lc, threadIdx.x, sa, mxl, sda, sda2, sdec, sdbm, sdb,
            sdm, [] { __syncthreads(); });
}

template <typename T>
int launch(Args<T> x, cudaStream_t st) {
  const int bh = x.B * x.H;
  const dim3 tiles(x.NT * x.NT, bh), chunks(x.NC, bh);
  cudaError_t e;
  gates_kernel<T><<<bh, 256, 0, st>>>(x);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  states_kernel<T><<<tiles, THREADS, 0, st>>>(x);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  static bool opted_in[64] = {};    // the attributes, once a device
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidValue;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(local_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)LOCAL_SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(grad_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)GRAD_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  local_kernel<T><<<chunks, THREADS, LOCAL_SMEM, st>>>(x);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reverse_kernel<T><<<tiles, THREADS, 0, st>>>(x);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  grad_kernel<T><<<chunks, THREADS, GRAD_SMEM, st>>>(x);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgmma route (bfloat16): 64 x 64 tiles, every product on the tensor cores
// ---------------------------------------------------------------------------

namespace wg {

constexpr int T = 64;               // a tile's side: a chunk's steps, or 64
                                    // columns of D (zero-padded to DP)
constexpr int TILE = T * T * 2;     // a bf16 tile: 128-byte rows, swizzled
constexpr int TILE16 = TILE >> 4;   // its size in descriptor units
using bf16 = __nv_bfloat16;
using WArgs = Args<bf16>;

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// wait until at most one of this thread's bulk store groups still reads
// its shared memory
__device__ __forceinline__ void bulk_wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// Descriptors of a tile.  K-major: its 64 columns are the contraction (a
// k16 step adds 2); MN-major: its rows are (a k16 step adds 16 rows, 128).
__device__ __forceinline__ uint64_t kmaj(const uint8_t* t) {
  return hopper::opaque(hopper::desc<128>(t, 16, 1024));
}
__device__ __forceinline__ uint64_t mnmaj(const uint8_t* t) {
  return hopper::opaque(hopper::desc<128>(t, TILE, 1024));
}

__device__ __forceinline__ uint32_t swz(int row, int col) {
  return hopper::swizzle<128>(row * 128 + col * 2);
}

// elements (row, col), (row, col + 1) of a tile, col even
__device__ __forceinline__ float2 get2(const uint8_t* t, int row, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(t + swz(row, col)));
}

__device__ __forceinline__ float get1(const uint8_t* t, int row, int col) {
  return __bfloat162float(
      *reinterpret_cast<const bf16*>(t + swz(row, col)));
}

// x0, x1 at (row, col), (row, col + 1) of a tile pair: a bf16 high part
// and the bf16 rounding of what it leaves, ~2^-16 relative together
__device__ __forceinline__ void put2(uint8_t* hi, uint8_t* lo, int row,
                                     int col, float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  const uint32_t o = swz(row, col);
  *reinterpret_cast<__nv_bfloat162*>(hi + o) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + o) = r;
}

// The accumulator layout of a 64 x 64 product (hopper.cuh): element
// 4 jn + e of a thread is row vr + 8 (e / 2), column 8 jn + cq + e % 2.
struct Frag {
  int lane, w4, vr, cq;
  __device__ explicit Frag(int t) {
    lane = t % 32;
    w4 = (t / 32) % 4;
    vr = 16 * w4 + lane / 4;
    cq = 2 * (lane % 4);
  }
  __device__ int row(int k) const { return vr + 8 * ((k % 4) >> 1); }
  __device__ int col(int k) const { return 8 * (k / 4) + cq + (k & 1); }
};

// the two rows' sums across the four lanes that share them
__device__ __forceinline__ void quad_sum(float (&r)[2]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    r[hr] += __shfl_xor_sync(0xffffffffu, r[hr], 1);
    r[hr] += __shfl_xor_sync(0xffffffffu, r[hr], 2);
  }
}

__device__ __forceinline__ void zero(float (&a)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k] = 0.f;
}

// A tile [k][m] (64 x 64, 128-byte rows, swizzled) as the A operands of
// its transpose [m][k] for 4 k16 steps (hopper.cuh's register layout: a[0]
// row r, columns c, c + 1 with c = 16 kc + cq; a[1] row r + 8; a[2], a[3]
// columns c + 8, c + 9), each column k scaled by f[k], as a bf16 hi + lo
// pair: ldmatrix.trans, matrix i of a k16 step holding m + 8 (i & 1), k +
// 8 (i >> 1), lane 8 i + r giving row k + r.
__device__ __forceinline__ void scaled_t(const uint8_t* t, const float* f,
                                         const Frag& fr, uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
  const int mi = fr.lane / 8, m = 16 * fr.w4 + 8 * (mi & 1);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t a[4];
    const int k = 16 * kc + 8 * (mi >> 1) + fr.lane % 8;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(hopper::smem_u32(t + swz(k, m))));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = 16 * kc + fr.cq + 8 * (u >> 1);
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&a[u]));
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(f[c] * x.x, f[c + 1] * x.y);
      const __nv_bfloat162 r = __floats2bfloat162_rn(
          f[c] * x.x - __low2float(h), f[c + 1] * x.y - __high2float(h));
      hi[kc][u] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kc][u] = *reinterpret_cast<const uint32_t*>(&r);
    }
  }
}

// The chunk's four step tensors' TMA maps and the state planes'.
struct Maps {
  CUtensorMap q, k, v, dh, Ch, Cl, dCh, dCl;
};

// ---------------------------------------------------------------------------
// 2. the states walk: C_c as bf16 planes, n_c, dh . q C_c partials
// ---------------------------------------------------------------------------

constexpr int WST = 4;              // the walks' ring stages
constexpr int WALK_STAGE = 4 * TILE;
constexpr int WALK_FLOATS = 2 * WST * T + 2 * WST + 8;
constexpr int WALK_SMEM = 1024 + WST * WALK_STAGE + 2 * 2 * TILE +
                          WALK_FLOATS * 4 + 3 * WST * 8;
constexpr int WORKERS = 64;         // the producer's warps 0 - 1

// Block (64 x 64 tile (i, j) of C, b h), 256 threads.  Warpgroup 0 holds
// the tile in wgmma accumulators over the chunks.  In warpgroup 1, warp
// 3's lane 0 keeps a 4-stage ring of k_i, v_j, q_i, dh_j full by TMA;
// warps 0 - 1 put each chunk's decays and carry into its stage and sum
// k_i's decayed rows (n's increment), the next chunk's gate terms already
// loaded.  A chunk: C_c to the staging pair (hi + lo) and out by TMA; then
// C <- carry C + (dec o k_i)^T v_j (the decayed k^T as hi + lo register
// operands) and P = q_i C_c (rows t, this tile's v) are issued together,
// and P's partial sum_v dh_tv P_tv is taken once the next chunk's
// fragments are ready (no accumulator is read while a product runs).
template <int NT>
__global__ void __launch_bounds__(256, 1)
states_wg_kernel(const __grid_constant__ Maps m, WArgs x) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);
  uint8_t* stg = ring + WST * WALK_STAGE;           // [2][hi, lo]
  float* dec = reinterpret_cast<float*>(stg + 2 * 2 * TILE);   // [WST][T]
  float* kd = dec + WST * T;                        // [WST][T]
  float* carry = kd + WST * T;                      // [WST]
  float* red = carry + 2 * WST;                     // [4]
  uint64_t* loaded = reinterpret_cast<uint64_t*>(dec + WALK_FLOATS);
  uint64_t* ready = loaded + WST;
  uint64_t* empty = ready + WST;
  const int tile = blockIdx.x, bh = blockIdx.y, i = tile / NT, j = tile % NT;
  const int b = bh / x.H, h = bh % x.H, D = x.D, NC = x.NC;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < WST; ++s) {
      hopper::mbar_init(&loaded[s], 1);
      hopper::mbar_init(&ready[s], WORKERS);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {                 // the producer warpgroup
    const int p = tid - 128;
    if (p == 96)                    // warp 3: the TMA thread
      for (int n = 0; n < NC; ++n) {
        const int st = n % WST;
        uint8_t* sb = ring + st * WALK_STAGE;
        hopper::mbar_wait(&empty[st], ((n / WST) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&loaded[st], 4 * TILE);
        hopper::tma_load_4d(sb, &m.k, &loaded[st], i * T, h, n * T, b);
        hopper::tma_load_4d(sb + TILE, &m.v, &loaded[st], j * T, h, n * T, b);
        hopper::tma_load_4d(sb + 2 * TILE, &m.q, &loaded[st], i * T, h,
                            n * T, b);
        hopper::tma_load_4d(sb + 3 * TILE, &m.dh, &loaded[st], j * T, h,
                            n * T, b);
      }
    if (p >= WORKERS) return;
    // step p's decay exp(a_p - mx_L) of chunk n, and the chunk's carry
    float nd = 0.f, ncarry = 0.f;
    auto gate = [&](int n) {
      const int lc = chunk_len(x.S, n);
      const size_t g = (size_t)bh * x.S + (size_t)n * T;
      const float mxl = x.w.gmx[g + lc - 1];
      nd = p < lc ? expf(x.ig[((size_t)b * x.S + (size_t)n * T + p) * x.H +
                              h] - x.w.gb[g + p] - mxl)
                  : 0.f;
      ncarry = expf(x.w.gm[(size_t)bh * NC + n] - mxl);
    };
    gate(0);
    for (int n = 0; n < NC; ++n) {
      const int st = n % WST;
      const uint8_t* sb = ring + st * WALK_STAGE;
      hopper::mbar_wait(&loaded[st], (n / WST) & 1);  // and so chunk n - WST
      dec[st * T + p] = nd;                           // is done
      if (p == 0) carry[st] = ncarry;
      if (n + 1 < NC) gate(n + 1);
      hopper::named_barrier(2, WORKERS);
      float acc = 0.f;              // sum_s dec_s k_s, n's increment
#pragma unroll 16
      for (int s = 0; s < T; ++s)
        acc = fmaf(get1(sb, s, p), dec[st * T + s], acc);
      kd[st * T + p] = acc;
      hopper::mbar_arrive(&ready[st]);
    }
    return;
  }

  const Frag fr(tid);
  const int d0 = i * T, v0 = j * T;
  const bool own_n = j == 0 && tid < T && d0 + tid < D;   // n's row d0 + tid
  float C[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int r = d0 + fr.row(k), cc = v0 + fr.col(k);
    C[k] = r < D && cc < D ? x.C0[((size_t)bh * D + r) * D + cc] : 0.f;
  }
  float n = own_n ? x.n0[(size_t)bh * D + d0 + tid] : 0.f;
  float P[32];
  // chunk c's tail once its products are done: the partial sum_v dh_tv
  // P_tv out, its stage released
  auto tail = [&](int c) {
    const int st = c % WST;
    float et[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const float2 f = get2(ring + st * WALK_STAGE + 3 * TILE, fr.row(k),
                            fr.col(k));
      et[(k % 4) >> 1] += P[k] * f.x + P[k + 1] * f.y;
    }
    quad_sum(et);
    if (fr.lane % 4 == 0)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        x.w.e[(((size_t)bh * NC + c) * NT * NT + tile) * T + fr.vr + 8 * hr] =
            et[hr];
    hopper::mbar_arrive(&empty[st]);
  };
  for (int c = 0; c < NC; ++c) {
    const int st = c % WST;
    const uint8_t* sb = ring + st * WALK_STAGE;
    uint8_t* hi = stg + (c & 1) * 2 * TILE;
    uint8_t* lo = hi + TILE;
    hopper::mbar_wait(&ready[st], (c / WST) & 1);
    uint32_t kh[4][4], kl[4][4];    // (dec o k_i)^T as hi + lo
    scaled_t(sb, dec + st * T, fr, kh, kl);
    // no accumulator is read while a product runs (ptxas would serialize
    // the products): chunk c - 1's are done here
    hopper::wgmma_wait<0>();
    hopper::fence_regs(C);
    hopper::fence_regs(P);
    if (c > 0) tail(c - 1);
    // C_c out
    if (tid == 0) bulk_wait_read1();   // chunk c - 2's stores have read hi, lo
    hopper::named_barrier(1, 128);
#pragma unroll
    for (int k = 0; k < 32; k += 2)
      put2(hi, lo, fr.row(k), fr.col(k), C[k], C[k + 1]);
    const float cr = carry[st];
    if (own_n) {
      x.w.nw[((size_t)bh * NC + c) * D + d0 + tid] = n;
      n = fmaf(cr, n, kd[st * T + tid]);
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1, 128);
    if (tid == 0) {
      hopper::tma_store_3d(&m.Ch, hi, v0, d0, bh * NC + c);
      hopper::tma_store_3d(&m.Cl, lo, v0, d0, bh * NC + c);
      hopper::bulk_commit();
    }
    // C <- carry C + (dec o k_i)^T v_j; P = q_i C_c
#pragma unroll
    for (int k = 0; k < 32; ++k) C[k] *= cr;
    zero(P);
    const uint64_t bv = mnmaj(sb + TILE), aq = kmaj(sb + 2 * TILE),
                   ch = mnmaj(hi), cl = mnmaj(lo);
    hopper::fence_regs(C);
    hopper::fence_regs(P);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      hopper::fence_regs(kh[kc]);
      hopper::fence_regs(kl[kc]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      hopper::wgmma_rs<1>(C, kh[kc], bv + 128 * kc, 1);
      hopper::wgmma_rs<1>(C, kl[kc], bv + 128 * kc, 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::wgmma_ss<0, 1>(P, aq + 2 * kk, ch + 128 * kk, 1);
      hopper::wgmma_ss<0, 1>(P, aq + 2 * kk, cl + 128 * kk, 1);
    }
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(C);
  hopper::fence_regs(P);
  tail(NC - 1);
  if (x.dC1 || x.dn1) {             // C, n the final state
    float p = 0.f;
    if (x.dC1)
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int r = d0 + fr.row(k), cc = v0 + fr.col(k);
        if (r < D && cc < D)
          p = fmaf(x.dC1[((size_t)bh * D + r) * D + cc], C[k], p);
      }
    if (own_n && x.dn1) p = fmaf(x.dn1[(size_t)bh * D + d0 + tid], n, p);
    p = warp_sum(p);
    if (fr.lane == 0) red[fr.w4] = p;
    hopper::named_barrier(1, 128);
    if (tid == 0)
      x.w.dmf[(size_t)bh * NT * NT + tile] = red[0] + red[1] + red[2] + red[3];
  }
  if (tid == 0) hopper::bulk_wait_read();
}

// ---------------------------------------------------------------------------
// 3. per chunk: den, dden_raw, the exp branch's db and dm's inter share
// ---------------------------------------------------------------------------

template <int NT>
constexpr int local_smem() {
  return 1024 + 4 * NT * TILE + (NT * T + 8 * T) * 4 + 8;
}

// Block (chunk, b h), one warpgroup: q, k, v, dh by TMA; S = q k^T and
// G = dh v^T (exact bf16 products); sw, its row sums and sum_s sw G (=
// dh . sw V), q . n_c; dh . h adds the walk's dh . q C_c partials.
template <int NT>
__global__ void __launch_bounds__(128, 1)
local_wg_kernel(const __grid_constant__ Maps m, WArgs x) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = hopper::align1024(smem_raw);
  uint8_t* Ks = Qs + NT * TILE;
  uint8_t* Vs = Ks + NT * TILE;
  uint8_t* Hs = Vs + NT * TILE;
  float* nvec = reinterpret_cast<float*>(Hs + NT * TILE);
  float *sa = nvec + NT * T, *smx = sa + T, *sb = smx + T, *rsum = sb + T,
        *sgs = rsum + T, *qn = sgs + T, *es = qn + T, *sdm = es + T;
  uint64_t* full = reinterpret_cast<uint64_t*>(sdm + T);
  const int c = blockIdx.x, bh = blockIdx.y, D = x.D, NC = x.NC;
  const int b = bh / x.H, h = bh % x.H, tid = threadIdx.x;
  const int lc = chunk_len(x.S, c);
  const size_t cs = (size_t)bh * NC + c;
  if (tid == 0) {
    hopper::mbar_init(full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive_expect_tx(full, 4 * NT * TILE);
    for (int bx = 0; bx < NT; ++bx) {
      hopper::tma_load_4d(Qs + bx * TILE, &m.q, full, bx * T, h, c * T, b);
      hopper::tma_load_4d(Ks + bx * TILE, &m.k, full, bx * T, h, c * T, b);
      hopper::tma_load_4d(Vs + bx * TILE, &m.v, full, bx * T, h, c * T, b);
      hopper::tma_load_4d(Hs + bx * TILE, &m.dh, full, bx * T, h, c * T, b);
    }
  }
  load_gates(x, bh, c, lc, sa, smx, sb);
  for (int d = tid; d < NT * T; d += 128)
    nvec[d] = d < D ? x.w.nw[cs * D + d] : 0.f;
  if (tid < T) {
    float s = 0.f;
    for (int u = 0; u < NT * NT; ++u) s += x.w.e[(cs * NT * NT + u) * T + tid];
    es[tid] = s;
  }
  __syncthreads();
  hopper::mbar_wait(full, 0);
  const Frag fr(tid);
  float Sa[32], Ga[32];
  {
    const uint64_t aq = kmaj(Qs), ak = kmaj(Ks), av = kmaj(Vs), ah = kmaj(Hs);
    hopper::fence_regs(Sa);
    hopper::fence_regs(Ga);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NT; ++kk) {
      const int off = (kk / 4) * TILE16 + (kk % 4) * 2;
      hopper::wgmma_ss<0, 0>(Sa, aq + off, ak + off, kk > 0);
      hopper::wgmma_ss<0, 0>(Ga, ah + off, av + off, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(Sa);
    hopper::fence_regs(Ga);
  }
  float rs[2] = {0.f, 0.f}, sg[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int t = fr.row(k), s = fr.col(k);
    const bool keep = s <= t && t < lc;
    const float w = keep ? expf(sa[s] - smx[t]) : 0.f;
    const float sw = keep ? Sa[k] * x.scale * w : 0.f;
    rs[(k % 4) >> 1] += sw;
    sg[(k % 4) >> 1] += sw * Ga[k];
  }
  quad_sum(rs);
  quad_sum(sg);
  if (fr.lane % 4 == 0)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      rsum[fr.vr + 8 * hr] = rs[hr];
      sgs[fr.vr + 8 * hr] = sg[hr];
    }
  {                                 // q_t . n_c, two threads a row
    const int t = tid / 2, half = tid % 2;
    float acc = 0.f;
    for (int d = half * NT * T / 2; d < (half + 1) * NT * T / 2; ++d)
      acc = fmaf(get1(Qs + (d / T) * TILE, t, d % T), nvec[d], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) qn[t] = acc;
  }
  __syncthreads();
  if (tid < T) {
    const int t = tid;
    float dm = 0.f;
    if (t < lc) {
      const float inter = expf(x.w.gm[cs] - smx[t]);
      const float deni = qn[t] * x.scale * inter;
      const float draw = rsum[t] + deni;
      const float floor_ = expf(-(sb[t] + smx[t]));
      const float den = fmaxf(fabsf(draw), floor_);
      const float einter = x.scale * inter * es[t];
      const float hdh = (sgs[t] + einter) / den;
      const bool raw = fabsf(draw) >= floor_;
      const float sgn = draw > 0.f ? 1.f : (draw < 0.f ? -1.f : 0.f);
      const float ddr = raw ? (-sgn * hdh) / den : 0.f;
      const size_t g = (size_t)bh * x.S + (size_t)c * T + t;
      x.w.den[g] = den;
      x.w.ddr[g] = ddr;
      x.w.dbm[g] = raw ? 0.f : hdh;
      dm = einter / den + deni * ddr;
    }
    sdm[t] = dm;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int t = 0; t < lc; ++t) s += sdm[t];
    x.w.dmi[cs] = s;
  }
}

// ---------------------------------------------------------------------------
// 4. the reverse walk: dC_{c+1} as bf16 planes, dn_{c+1}, <dC_{c+1}, C_c>
// ---------------------------------------------------------------------------

constexpr int REV_STAGE = 4 * TILE;
constexpr int REV_FLOATS = 3 * WST * T + 2 * WST + 8;
constexpr int REV_SMEM = 1024 + WST * REV_STAGE + 2 * 2 * TILE +
                         REV_FLOATS * 4 + 3 * WST * 8;

// Block (tile (i, j) of dC, b h), as the states walk, backwards over the
// chunks: the producer's TMA thread keeps q_i, dh_j and C_c's tile (hi,
// lo) in a 4-stage ring; its workers put each chunk's coef_t / den_t
// (coef = scale inter_t), coef dden_raw and carry into its stage and sum
// q_i's rows times coef dden_raw (dn's increment).  Warpgroup 0 holds the
// tile of dC: <dC_{c+1}, C_c> (and <dn_{c+1}, n_c>) as the tile's partial,
// dC_{c+1} out by TMA, then dC <- carry dC + (coef / den o q_i)^T dh_j (the
// scaled q^T as hi + lo register operands).
template <int NT>
__global__ void __launch_bounds__(256, 1)
reverse_wg_kernel(const __grid_constant__ Maps m, WArgs x) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);
  uint8_t* stg = ring + WST * REV_STAGE;
  float* gsc = reinterpret_cast<float*>(stg + 2 * 2 * TILE);   // [WST][T]
  float* cddr = gsc + WST * T;                                 // [WST][T]
  float* kdn = cddr + WST * T;                                 // [WST][T]
  float* carry = kdn + WST * T;                                // [WST]
  float* red = carry + 2 * WST;                                // [4]
  uint64_t* loaded = reinterpret_cast<uint64_t*>(gsc + REV_FLOATS);
  uint64_t* ready = loaded + WST;
  uint64_t* empty = ready + WST;
  const int tile = blockIdx.x, bh = blockIdx.y, i = tile / NT, j = tile % NT;
  const int b = bh / x.H, h = bh % x.H, D = x.D, NC = x.NC;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < WST; ++s) {
      hopper::mbar_init(&loaded[s], 1);
      hopper::mbar_init(&ready[s], WORKERS);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {                 // the producer warpgroup
    const int p = tid - 128;
    if (p == 96)                    // warp 3: the TMA thread
      for (int n = 0; n < NC; ++n) {
        const int c = NC - 1 - n, st = n % WST;
        uint8_t* sb = ring + st * REV_STAGE;
        hopper::mbar_wait(&empty[st], ((n / WST) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&loaded[st], 4 * TILE);
        hopper::tma_load_4d(sb, &m.q, &loaded[st], i * T, h, c * T, b);
        hopper::tma_load_4d(sb + TILE, &m.dh, &loaded[st], j * T, h, c * T,
                            b);
        hopper::tma_load_3d(sb + 2 * TILE, &m.Ch, &loaded[st], j * T, i * T,
                            bh * NC + c);
        hopper::tma_load_3d(sb + 3 * TILE, &m.Cl, &loaded[st], j * T, i * T,
                            bh * NC + c);
      }
    if (p >= WORKERS) return;
    // step p's coef / den and coef dden_raw of chunk c, the chunk's carry
    float ng = 0.f, nr = 0.f, ncarry = 0.f;
    auto gate = [&](int c) {
      const int lc = chunk_len(x.S, c);
      const size_t g = (size_t)bh * x.S + (size_t)c * T;
      const float mc = x.w.gm[(size_t)bh * NC + c];
      const bool in = p < lc;
      const float coef = in ? x.scale * expf(mc - x.w.gmx[g + p]) : 0.f;
      ng = in ? coef / x.w.den[g + p] : 0.f;
      nr = in ? coef * x.w.ddr[g + p] : 0.f;
      ncarry = expf(mc - x.w.gmx[g + lc - 1]);
    };
    gate(NC - 1);
    for (int n = 0; n < NC; ++n) {
      const int c = NC - 1 - n, st = n % WST;
      const uint8_t* sb = ring + st * REV_STAGE;
      hopper::mbar_wait(&loaded[st], (n / WST) & 1);
      gsc[st * T + p] = ng;
      cddr[st * T + p] = nr;
      if (p == 0) carry[st] = ncarry;
      if (c > 0) gate(c - 1);
      hopper::named_barrier(2, WORKERS);
      float acc = 0.f;              // sum_t coef dden_raw q_t, dn's increment
#pragma unroll 16
      for (int t = 0; t < T; ++t)
        acc = fmaf(cddr[st * T + t], get1(sb, t, p), acc);
      kdn[st * T + p] = acc;
      hopper::mbar_arrive(&ready[st]);
    }
    return;
  }

  const Frag fr(tid);
  const int d0 = i * T, v0 = j * T;
  const bool own_n = j == 0 && tid < T && d0 + tid < D;
  float dC[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int r = d0 + fr.row(k), cc = v0 + fr.col(k);
    dC[k] = x.dC1 && r < D && cc < D ? x.dC1[((size_t)bh * D + r) * D + cc]
                                     : 0.f;
  }
  float dn = own_n && x.dn1 ? x.dn1[(size_t)bh * D + d0 + tid] : 0.f;
  for (int n = 0; n < NC; ++n) {
    const int c = NC - 1 - n, st = n % WST;
    const uint8_t* sb = ring + st * REV_STAGE;
    uint8_t* hi = stg + (n & 1) * 2 * TILE;
    uint8_t* lo = hi + TILE;
    const size_t cs = (size_t)bh * NC + c;
    hopper::mbar_wait(&ready[st], (n / WST) & 1);
    uint32_t qh[4][4], ql[4][4];    // (coef / den o q_i)^T as hi + lo
    scaled_t(sb, gsc + st * T, fr, qh, ql);
    // the previous chunk's update is done: dC = dC_{c+1}, its stage free
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dC);
    if (n > 0) hopper::mbar_arrive(&empty[(n - 1) % WST]);
    float p = 0.f;                  // <dC_{c+1}, C_c> + <dn_{c+1}, n_c>
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const float2 ch = get2(sb + 2 * TILE, fr.row(k), fr.col(k));
      const float2 cl = get2(sb + 3 * TILE, fr.row(k), fr.col(k));
      p = fmaf(dC[k], ch.x + cl.x, p);
      p = fmaf(dC[k + 1], ch.y + cl.y, p);
    }
    const float cr = carry[st];
    if (own_n) {
      p = fmaf(dn, x.w.nw[cs * D + d0 + tid], p);
      x.w.dnw[cs * D + d0 + tid] = dn;
      dn = fmaf(cr, dn, kdn[st * T + tid]);
    }
    p = warp_sum(p);
    // dC_{c+1} out
    if (tid == 0) bulk_wait_read1();
    hopper::named_barrier(1, 128);
#pragma unroll
    for (int k = 0; k < 32; k += 2)
      put2(hi, lo, fr.row(k), fr.col(k), dC[k], dC[k + 1]);
    if (fr.lane == 0) red[fr.w4] = p;
    hopper::fence_proxy_async();
    hopper::named_barrier(1, 128);
    if (tid == 0) {
      hopper::tma_store_3d(&m.dCh, hi, v0, d0, bh * NC + c);
      hopper::tma_store_3d(&m.dCl, lo, v0, d0, bh * NC + c);
      hopper::bulk_commit();
      x.w.dmp[cs * NT * NT + tile] = red[0] + red[1] + red[2] + red[3];
    }
    // dC <- carry dC + (coef / den o q_i)^T dh_j
#pragma unroll
    for (int k = 0; k < 32; ++k) dC[k] *= cr;
    const uint64_t bd = mnmaj(sb + TILE);
    hopper::fence_regs(dC);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      hopper::fence_regs(qh[kc]);
      hopper::fence_regs(ql[kc]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      hopper::wgmma_rs<1>(dC, qh[kc], bd + 128 * kc, 1);
      hopper::wgmma_rs<1>(dC, ql[kc], bd + 128 * kc, 1);
    }
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dC);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int r = d0 + fr.row(k), cc = v0 + fr.col(k);
    if (r < D && cc < D) x.dC0[((size_t)bh * D + r) * D + cc] = dC[k];
  }
  if (own_n) x.dn0[(size_t)bh * D + d0 + tid] = dn;
  if (tid == 0) hopper::bulk_wait_read();
}

// ---------------------------------------------------------------------------
// 5. per chunk: dq, dk, dv, di, df (and dm0 in chunk 0's block)
// ---------------------------------------------------------------------------

constexpr int GST = 3;              // the gradient pass's ring stages

template <int NT>
constexpr int grad_smem() {
  return 1024 + (4 * NT + 4 + 2 * GST) * TILE + (2 * NT * T + 14 * T + 4) * 4 +
         (1 + 2 * GST) * 8;
}

// Block (chunk, b h), 384 threads.  The producer warpgroup (its registers
// given to the other two) loads the chunk's q, k, v, dh, then streams the
// state tiles through a 3-stage ring, C(i, j) and dC(i, j) (each a hi and
// a lo tile) in turn, tile (i, j) in row order.  Warpgroup 1 forms S^T =
// k q^T and G^T = v dh^T, and from them ds^T and sw^T / den (to shared
// memory, hi + lo) and da's sum_t dsw sw; it accumulates k_i dC(i, j) into
// dv_j for every j, then da's decayed share, dv = decay (k dC) + (sw /
// den)^T dh and the gates.  Warpgroup 0 takes row i of tiles at a time:
// dq_i = scale inter / den (dh C(i, .)^T) + scale inter ddr n_i + ds k_i,
// dk_i = decay (v dC(i, .)^T + dn_i) + ds^T q_i.
template <int NT>
__global__ void __launch_bounds__(384, 1)
grad_wg_kernel(const __grid_constant__ Maps m, WArgs x) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = hopper::align1024(smem_raw);
  uint8_t* Ks = Qs + NT * TILE;
  uint8_t* Vs = Ks + NT * TILE;
  uint8_t* Hs = Vs + NT * TILE;
  uint8_t* dsh = Hs + NT * TILE;        // ds^T [s][t], hi and lo
  uint8_t* dsl = dsh + TILE;
  uint8_t* swh = dsl + TILE;            // (sw / den)^T [s][t], hi and lo
  uint8_t* swl = swh + TILE;
  uint8_t* ring = swl + TILE;           // [GST][hi, lo]
  float* nvec = reinterpret_cast<float*>(ring + GST * 2 * TILE);
  float *dnvec = nvec + NT * T, *sa = dnvec + NT * T, *smx = sa + T,
        *sb = smx + T, *rden = sb + T, *sddr = rden + T, *sdbm = sddr + T,
        *sdec = sdbm + T, *sinter = sdec + T, *sda = sinter + T,
        *sda2 = sda + T, *sdb = sda2 + T, *skdn = sdb + T, *sdm = skdn + T;
  uint64_t* steps = reinterpret_cast<uint64_t*>(sdm + 4);
  uint64_t* full = steps + 1;
  uint64_t* empty = full + GST;
  const int c = blockIdx.x, bh = blockIdx.y, D = x.D, NC = x.NC;
  const int b = bh / x.H, h = bh % x.H, tid = threadIdx.x;
  const int lc = chunk_len(x.S, c);
  const size_t cs = (size_t)bh * NC + c;
  if (tid == 0) {
    hopper::mbar_init(steps, 1);
    for (int s = 0; s < GST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);
    }
    hopper::fence_barrier_init();
  }
  load_gates(x, bh, c, lc, sa, smx, sb);
  for (int d = tid; d < NT * T; d += 384) {
    nvec[d] = d < D ? x.w.nw[cs * D + d] : 0.f;
    dnvec[d] = d < D ? x.w.dnw[cs * D + d] : 0.f;
  }
  if (tid < T) {
    const size_t g = (size_t)bh * x.S + (size_t)c * T + tid;
    rden[tid] = tid < lc ? 1.f / x.w.den[g] : 0.f;
    sddr[tid] = tid < lc ? x.w.ddr[g] : 0.f;
    sdbm[tid] = tid < lc ? x.w.dbm[g] : 0.f;
  }
  if (tid == 0) chunk_ends(x, bh, c, sdm);
  __syncthreads();
  const float mxl = smx[lc - 1];
  if (tid < T) {
    sinter[tid] = tid < lc ? expf(x.w.gm[cs] - smx[tid]) : 0.f;
    sdec[tid] = tid < lc ? expf(sa[tid] - mxl) : 0.f;
  }
  __syncthreads();

  if (tid >= 256) {                 // the producer warpgroup: one thread
    hopper::reg_dealloc<40>();
    if (tid == 256) {
      hopper::mbar_arrive_expect_tx(steps, 4 * NT * TILE);
      for (int bx = 0; bx < NT; ++bx) {
        hopper::tma_load_4d(Qs + bx * TILE, &m.q, steps, bx * T, h, c * T, b);
        hopper::tma_load_4d(Ks + bx * TILE, &m.k, steps, bx * T, h, c * T, b);
        hopper::tma_load_4d(Vs + bx * TILE, &m.v, steps, bx * T, h, c * T, b);
        hopper::tma_load_4d(Hs + bx * TILE, &m.dh, steps, bx * T, h, c * T,
                            b);
      }
      const int z = bh * NC + c;
      for (int n = 0; n < 2 * NT * NT; ++n) {   // C(i, j), dC(i, j), ...
        const int i = n / 2 / NT, j = n / 2 % NT, st = n % GST;
        uint8_t* rb = ring + st * 2 * TILE;
        hopper::mbar_wait(&empty[st], ((n / GST) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * TILE);
        hopper::tma_load_3d(rb, n % 2 ? &m.dCh : &m.Ch, &full[st], j * T,
                            i * T, z);
        hopper::tma_load_3d(rb + TILE, n % 2 ? &m.dCl : &m.Cl, &full[st],
                            j * T, i * T, z);
      }
    }
    return;
  }

  hopper::reg_alloc<232>();
  const Frag fr(tid);
  const size_t hd = (size_t)x.H * D;
  const size_t row0 = (((size_t)b * x.S + (size_t)c * T) * x.H + h) * D;
  hopper::mbar_wait(steps, 0);

  if (tid >= 128) {                 // warpgroup 1: scores, dv, the gates
    const int p = tid - 128;
    {
      float Sa[32], Ga[32];
      const uint64_t ak = kmaj(Ks), bq = kmaj(Qs), av = kmaj(Vs),
                     bdh = kmaj(Hs);
      hopper::fence_regs(Sa);
      hopper::fence_regs(Ga);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NT; ++kk) {
        const int off = (kk / 4) * TILE16 + (kk % 4) * 2;
        hopper::wgmma_ss<0, 0>(Sa, ak + off, bq + off, kk > 0);
        hopper::wgmma_ss<0, 0>(Ga, av + off, bdh + off, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(Sa);
      hopper::fence_regs(Ga);
      // rows s, columns t: sw^T, dsw^T; ds^T and sw^T / den out
      float da1[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int s = fr.row(k), t = fr.col(k);
        const bool keep = s <= t && t < lc;
        const float w = keep ? expf(sa[s] - smx[t]) : 0.f;
        const float sw = Sa[k] * x.scale * w;
        const float dsw = keep ? Ga[k] * rden[t] + sddr[t] : 0.f;
        da1[(k % 4) >> 1] += dsw * sw;
        Ga[k] = dsw * w * x.scale;
        Sa[k] = sw * rden[t];
      }
#pragma unroll
      for (int k = 0; k < 32; k += 2) {
        put2(dsh, dsl, fr.row(k), fr.col(k), Ga[k], Ga[k + 1]);
        put2(swh, swl, fr.row(k), fr.col(k), Sa[k], Sa[k + 1]);
      }
      quad_sum(da1);
      if (fr.lane % 4 == 0) {
        sda[fr.vr] = da1[0];
        sda[fr.vr + 8] = da1[1];
      }
    }
    hopper::fence_proxy_async();
    named_arrive(3, 256);           // ds^T is in
    float acc[NT][32];
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) zero(acc[jj]);
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 2 * (i * NT + j), sc = n % GST, sd = (n + 1) % GST;
        hopper::mbar_wait(&full[sc], (n / GST) & 1);      // C(i, j): not
        hopper::mbar_arrive(&empty[sc]);                  // read here
        hopper::mbar_wait(&full[sd], ((n + 1) / GST) & 1);
        const uint8_t* rb = ring + sd * 2 * TILE;
        const uint64_t ak = kmaj(Ks + i * TILE), dch = mnmaj(rb),
                       dcl = mnmaj(rb + TILE);
        hopper::fence_regs(acc[j]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::wgmma_ss<0, 1>(acc[j], ak + 2 * kk, dch + 128 * kk, 1);
          hopper::wgmma_ss<0, 1>(acc[j], ak + 2 * kk, dcl + 128 * kk, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc[j]);
        hopper::mbar_arrive(&empty[sd]);
      }
    // da's decayed share: v_s . (k dC)_s + k_s . dn
    float v2[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
#pragma unroll
      for (int k = 0; k < 32; k += 2) {
        const float2 f = get2(Vs + jj * TILE, fr.row(k), fr.col(k));
        v2[(k % 4) >> 1] += acc[jj][k] * f.x + acc[jj][k + 1] * f.y;
      }
    quad_sum(v2);
    {
      const int s = p / 2, half = p % 2;
      float kd = 0.f;
      for (int d = half * NT * T / 2; d < (half + 1) * NT * T / 2; ++d)
        kd = fmaf(get1(Ks + (d / T) * TILE, s, d % T), dnvec[d], kd);
      kd += __shfl_xor_sync(0xffffffffu, kd, 1);
      if (half == 0) skdn[s] = kd;
    }
    hopper::named_barrier(4, 128);
    if (fr.lane % 4 == 0) {
      sda2[fr.vr] = v2[0] + skdn[fr.vr];
      sda2[fr.vr + 8] = v2[1] + skdn[fr.vr + 8];
    }
    // dv = decay (k dC) + (sw / den)^T dh
    const uint64_t ah = kmaj(swh), al = kmaj(swl);
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[jj][k] *= sdec[fr.row(k)];
      const uint64_t bd = mnmaj(Hs + jj * TILE);
      hopper::fence_regs(acc[jj]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        hopper::wgmma_ss<0, 1>(acc[jj], ah + 2 * kc, bd + 128 * kc, 1);
        hopper::wgmma_ss<0, 1>(acc[jj], al + 2 * kc, bd + 128 * kc, 1);
      }
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
      hopper::fence_regs(acc[jj]);
#pragma unroll
      for (int k = 0; k < 32; k += 2) {
        const int s = fr.row(k), v = jj * T + fr.col(k);
        if (s < lc && v < D)
          *reinterpret_cast<__nv_bfloat162*>(x.dv + row0 + s * hd + v) =
              __floats2bfloat162_rn(acc[jj][k], acc[jj][k + 1]);
      }
    }
    hopper::named_barrier(4, 128);
    gate_tail(x, bh, c, lc, p, sa, mxl, sda, sda2, sdec, sdbm, sdb, sdm,
              [] { hopper::named_barrier(4, 128); });
    return;
  }

  // warpgroup 0: dq and dk, a row of tiles at a time
  hopper::named_barrier(3, 256);    // ds^T is in
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    float dq[32], dk[32];
    zero(dq);
    zero(dk);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 2 * (i * NT + j), sc = n % GST, sd = (n + 1) % GST;
      const uint64_t ah = kmaj(Hs + j * TILE), av = kmaj(Vs + j * TILE);
      hopper::mbar_wait(&full[sc], (n / GST) & 1);
      const uint64_t ch = kmaj(ring + sc * 2 * TILE),
                     cl = kmaj(ring + sc * 2 * TILE + TILE);
      hopper::fence_regs(dq);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_ss<0, 0>(dq, ah + 2 * kk, ch + 2 * kk, 1);
        hopper::wgmma_ss<0, 0>(dq, ah + 2 * kk, cl + 2 * kk, 1);
      }
      hopper::wgmma_commit();
      hopper::mbar_wait(&full[sd], ((n + 1) / GST) & 1);
      const uint64_t dch = kmaj(ring + sd * 2 * TILE),
                     dcl = kmaj(ring + sd * 2 * TILE + TILE);
      hopper::fence_regs(dk);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        hopper::wgmma_ss<0, 0>(dk, av + 2 * kk, dch + 2 * kk, 1);
        hopper::wgmma_ss<0, 0>(dk, av + 2 * kk, dcl + 2 * kk, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();      // dq's products: C(i, j) is free
      hopper::mbar_arrive(&empty[sc]);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      hopper::fence_regs(dk);
      hopper::mbar_arrive(&empty[sd]);
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int t = fr.row(k), d = i * T + fr.col(k);
      dq[k] = x.scale * sinter[t] * (dq[k] * rden[t] + sddr[t] * nvec[d]);
      dk[k] = sdec[t] * (dk[k] + dnvec[d]);
    }
    const uint64_t ads = mnmaj(dsh), adl = mnmaj(dsl), bk = mnmaj(Ks + i * TILE);
    const uint64_t ats = kmaj(dsh), atl = kmaj(dsl), bq = mnmaj(Qs + i * TILE);
    hopper::fence_regs(dq);
    hopper::fence_regs(dk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::wgmma_ss<1, 1>(dq, ads + 128 * kk, bk + 128 * kk, 1);
      hopper::wgmma_ss<1, 1>(dq, adl + 128 * kk, bk + 128 * kk, 1);
      hopper::wgmma_ss<0, 1>(dk, ats + 2 * kk, bq + 128 * kk, 1);
      hopper::wgmma_ss<0, 1>(dk, atl + 2 * kk, bq + 128 * kk, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    hopper::fence_regs(dk);
#pragma unroll
    for (int k = 0; k < 32; k += 2) {
      const int t = fr.row(k), d = i * T + fr.col(k);
      if (t < lc && d < D) {
        *reinterpret_cast<__nv_bfloat162*>(x.dq + row0 + t * hd + d) =
            __floats2bfloat162_rn(dq[k], dq[k + 1]);
        *reinterpret_cast<__nv_bfloat162*>(x.dk + row0 + t * hd + d) =
            __floats2bfloat162_rn(dk[k], dk[k + 1]);
      }
    }
  }
}

template <int NT>
int launch(WArgs x, cudaStream_t st) {
  const int bh = x.B * x.H, DP = NT * T;
  Maps m;
  // q, k, v, dh [B, S, H, D] bf16, innermost first; boxes [64 steps][64
  // columns] of one head, rows past S and columns past D read as zeros
  const uint64_t dims[4] = {(uint64_t)x.D, (uint64_t)x.H, (uint64_t)x.S,
                            (uint64_t)x.B};
  const uint64_t strides[3] = {(uint64_t)x.D * 2, (uint64_t)x.H * x.D * 2,
                               (uint64_t)x.S * x.H * x.D * 2};
  const uint32_t box[4] = {T, 1, T, 1};
  const void* step[4] = {x.q, x.k, x.v, x.dh};
  CUtensorMap* smap[4] = {&m.q, &m.k, &m.v, &m.dh};
  for (int u = 0; u < 4; ++u) {
    const int err = hopper::encode_bf16(smap[u], 4, step[u], dims, strides,
                                        box, 128);
    if (err) return err;
  }
  // the state planes [B H NC, DP, DP]: tiles [64 d][64 v]
  const uint64_t pdims[3] = {(uint64_t)DP, (uint64_t)DP,
                             (uint64_t)bh * x.NC};
  const uint64_t pstrides[2] = {(uint64_t)DP * 2, (uint64_t)DP * DP * 2};
  const uint32_t pbox[3] = {T, T, 1};
  const void* plane[4] = {x.w.Ch, x.w.Cl, x.w.dCh, x.w.dCl};
  CUtensorMap* pmap[4] = {&m.Ch, &m.Cl, &m.dCh, &m.dCl};
  for (int u = 0; u < 4; ++u) {
    const int err = hopper::encode_bf16(pmap[u], 3, plane[u], pdims,
                                        pstrides, pbox, 128);
    if (err) return err;
  }
  const dim3 tiles(NT * NT, bh), chunks(x.NC, bh);
  cudaError_t e;
  static bool opted_in[64] = {};    // the attributes, once a device
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidValue;
  if (!opted_in[dev]) {
    if ((e = cudaFuncSetAttribute(states_wg_kernel<NT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  WALK_SMEM)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(local_wg_kernel<NT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  local_smem<NT>())) != cudaSuccess ||
        (e = cudaFuncSetAttribute(reverse_wg_kernel<NT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  REV_SMEM)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(grad_wg_kernel<NT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  grad_smem<NT>())) != cudaSuccess)
      return (int)e;
    opted_in[dev] = true;
  }
  gates_kernel<bf16><<<bh, 256, 0, st>>>(x);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  states_wg_kernel<NT><<<tiles, 256, WALK_SMEM, st>>>(m, x);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  local_wg_kernel<NT><<<chunks, 128, local_smem<NT>(), st>>>(m, x);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reverse_wg_kernel<NT><<<tiles, 256, REV_SMEM, st>>>(m, x);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  grad_wg_kernel<NT><<<chunks, 384, grad_smem<NT>(), st>>>(m, x);
  return (int)cudaGetLastError();
}

}  // namespace wg

Dims dims_of(int B, int S, int H, int D, int route) {
  return Dims{B, S, H, D, (S + L - 1) / L,
              route == 1 ? (D + wg::T - 1) / wg::T : (D + TS - 1) / TS, route};
}

}  // namespace

// Bytes of the workspace a launch at (B, S, H, D) on `route` needs.
extern "C" long long repro_mlstm_chunk_bwd_workspace(int B, int S, int H,
                                                     int D, int route) {
  Work w;
  return (long long)carve(nullptr, dims_of(B, S, H, D, route), &w);
}

// dtype 0 = float32, 1 = bfloat16 for q, k, v, dh and dq, dk, dv; route 0 =
// simt, 1 = wgmma (bfloat16; q, k, v, dh 16-byte aligned)
extern "C" int repro_mlstm_chunk_bwd(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* C0, const void* n0, const void* m0,
    const void* dh, const void* dC1, const void* dn1, const void* dm1,
    void* dq, void* dk, void* dv, void* di, void* df, void* dC0, void* dn0,
    void* dm0, void* work, long long work_bytes, int B, int S, int H, int D,
    int dtype, int route, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > DMAX || D % 16 ||
      (long long)B * H > 65535 || route < 0 || route > 1 ||
      (route == 1 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Dims d = dims_of(B, S, H, D, route);
  Work w;
  if ((long long)carve((float*)work, d, &w) != work_bytes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define REPRO_ARGS(T)                                                        \
  Args<T> {                                                                  \
    (const T*)q, (const T*)k, (const T*)v, (const T*)dh, (const float*)ig,   \
        (const float*)fg, (const float*)C0, (const float*)n0,                \
        (const float*)m0, (const float*)dC1, (const float*)dn1,              \
        (const float*)dm1, (T*)dq, (T*)dk, (T*)dv, (float*)di, (float*)df,   \
        (float*)dC0, (float*)dn0, (float*)dm0, w, B, S, H, D, d.NC, d.NT,    \
        scale                                                                \
  }
  if (route == 1) {
    const Args<__nv_bfloat16> x = REPRO_ARGS(__nv_bfloat16);
    switch (d.NT) {
      case 1: return wg::launch<1>(x, st);
      case 2: return wg::launch<2>(x, st);
      case 4: return wg::launch<4>(x, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch<float>(REPRO_ARGS(float), st);
  if (dtype == 1) return launch<__nv_bfloat16>(REPRO_ARGS(__nv_bfloat16), st);
#undef REPRO_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
