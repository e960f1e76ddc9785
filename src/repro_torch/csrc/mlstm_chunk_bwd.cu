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
// q, k, v and dh in and dq, dk, dv out are 58.7 MB (17.5 us at
// 3.35 TB/s).  The products are about 6 L^2 D + 6 L D^2 multiply-adds a
// chunk and head, 16.1 GFLOP in all: 16.3 us at the bf16 tensor-core peak,
// 240 us at the fp32 SIMT peak this kernel computes at.  So the least
// time is the bytes' (the tensor cores could take the products), and this
// SIMT kernel is bound by its fp32 operations: a Hopper redesign puts the
// products on wgmma.
//
// Design: five kernels on the stream, counted as one launch; every sum in
// one fixed order, no atomics, so a launch is bitwise equal to the next.
// A workspace the wrapper allocates (repro_mlstm_chunk_bwd_workspace
// bytes) carries what they hand on: at the training call 64 MB each of
// the chunk-start states C_c and of their gradients.
//  1. gates: a warp per (b, h) walks the chunks in order: the chunk-local
//     cumsum b_t and cummax (warp scans over 32 steps at a time), mx_t and
//     each chunk's starting m_c.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

// The workspace, float32 throughout.  BH = B H, NC chunks, NT tiles a side.
struct Work {
  float *gb, *gmx, *gm;            // b_t, mx_t [BH, S]; m_c [BH, NC]
  float *den, *ddr, *dbm;          // den_t, dden_raw_t, exp-branch db [BH, S]
  float *dmi, *dmp;                // dm's inter share [BH, NC]; tile
                                   // partials [BH, NC, NT^2]
  float* dmf;                      // <dC1, C1> + <dn1, n1>, tile partials
                                   // [BH, NT^2]
  float *nw, *dnw;                 // n_c, dn_{c+1} [BH, NC, D]
  float *Cw, *dCw;                 // C_c, dC_{c+1} [BH, NC, D, D]
};

struct Dims {
  int B, S, H, D, NC, NT;
  size_t BH() const { return (size_t)B * H; }
};

size_t carve(float* base, const Dims& d, Work* w) {
  const size_t bh = d.BH(), S = d.S, NC = d.NC, D = d.D, NT = d.NT;
  const size_t sizes[13] = {bh * S, bh * S, bh * NC, bh * S, bh * S, bh * S,
                            bh * NC, bh * NC * NT * NT, bh * NT * NT,
                            bh * NC * D, bh * NC * D, bh * NC * D * D,
                            bh * NC * D * D};
  float** slots[13] = {&w->gb, &w->gmx, &w->gm, &w->den, &w->ddr, &w->dbm,
                       &w->dmi, &w->dmp, &w->dmf, &w->nw, &w->dnw, &w->Cw,
                       &w->dCw};
  size_t off = 0;
  for (int i = 0; i < 13; ++i) {
    *slots[i] = base ? base + off : nullptr;
    off += (sizes[i] + 3) / 4 * 4;      // each slot on 16 bytes
  }
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
// 1. gate cumulatives, a warp per (b, h)
// ---------------------------------------------------------------------------

// Inclusive scans across a warp: the sum and the max of v over lanes <= l.
__device__ __forceinline__ float warp_cumsum(float v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}
__device__ __forceinline__ float warp_cummax(float v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = fmaxf(v, u);
  }
  return v;
}

// A warp walks one (b, h)'s chunks in order, 32 steps at a time: each
// lane takes one step's log sigmoid(f); b and cummax a are warp scans
// carried across the chunk's 32-step pieces; m passes from chunk to chunk.
template <typename T>
__global__ void gates_kernel(Args<T> x) {
  const int bh = blockIdx.x, lane = threadIdx.x;
  const int b = bh / x.H, h = bh % x.H;
  float m = x.m0[bh];
  for (int c = 0; c < x.NC; ++c) {
    if (lane == 0) x.w.gm[(size_t)bh * x.NC + c] = m;
    const int t0 = c * L, t1 = t0 + chunk_len(x.S, c);
    float bsum = 0.f, M = -INFINITY;
    for (int p = t0; p < t1; p += 32) {
      const int t = p + lane;
      const size_t g = ((size_t)b * x.S + t) * x.H + h;
      const float lf = t < t1 ? log_sigmoid(x.fg[g]) : 0.f;
      const float bt = bsum + warp_cumsum(lf, lane);
      const float a = t < t1 ? x.ig[g] - bt : -INFINITY;
      const float Mt = fmaxf(M, warp_cummax(a, lane));
      if (t < t1) {
        x.w.gb[(size_t)bh * x.S + t] = bt;
        x.w.gmx[(size_t)bh * x.S + t] = fmaxf(m, Mt);
      }
      bsum = __shfl_sync(0xffffffffu, bt, 31);
      M = __shfl_sync(0xffffffffu, Mt, 31);
    }
    m = bsum + fmaxf(m, M);
  }
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
  if (threadIdx.x == 0) {
    // dm of this chunk's output state (the next chunk's dm0, with the
    // residual where the next chunk's m0 held it); the residual's share
    // for da at s*; dm0 in chunk 0's block
    const float r = chunk_residual(x, bh, c);
    const bool held = m0_holds(x, bh, c);
    sdm[0] = c == x.NC - 1 ? (x.dm1 ? x.dm1[bh] : 0.f)
                           : chunk_dm(x, bh, c + 1) + r;
    sdm[1] = held ? 0.f : r;
    if (c == 0) x.dm0[bh] = chunk_dm(x, bh, 0) + (held ? r : 0.f);
  }
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
  // the gates: di = da (+ the residual at the first argmax s* of a),
  // db = exp-branch term - da (+ dm at the last step), df = (reverse
  // cumsum of db) sigmoid(-f)
  if (threadIdx.x < L) {
    const int t = threadIdx.x;
    float da = sda[t] + sdec[t] * sda2[t];
    if (t < lc && sa[t] == mxl) {
      bool first = true;
      for (int s = 0; s < t; ++s) first = first && sa[s] != mxl;
      if (first) da += sdm[1];
    }
    sda[t] = da;
    sdb[t] = sdbm[t] + (t == lc - 1 ? sdm[0] : 0.f) - da;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int t = lc - 1; t >= 0; --t) {
      acc += sdb[t];
      sdb[t] = acc;
    }
  }
  __syncthreads();
  if (threadIdx.x < lc) {
    const int t = threadIdx.x;
    const size_t g = ((size_t)b * x.S + (size_t)c * L + t) * x.H + h;
    x.di[g] = sda[t];
    x.df[g] = sdb[t] * (1.f / (1.f + expf(x.fg[g])));
  }
}

template <typename T>
int launch(Args<T> x, cudaStream_t st) {
  const int bh = x.B * x.H;
  const dim3 tiles(x.NT * x.NT, bh), chunks(x.NC, bh);
  cudaError_t e;
  gates_kernel<T><<<bh, 32, 0, st>>>(x);
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

Dims dims_of(int B, int S, int H, int D) {
  return Dims{B, S, H, D, (S + L - 1) / L, (D + TS - 1) / TS};
}

}  // namespace

// Bytes of the workspace a launch at (B, S, H, D) needs.
extern "C" long long repro_mlstm_chunk_bwd_workspace(int B, int S, int H,
                                                     int D) {
  Work w;
  return (long long)carve(nullptr, dims_of(B, S, H, D), &w);
}

extern "C" int repro_mlstm_chunk_bwd(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* C0, const void* n0, const void* m0,
    const void* dh, const void* dC1, const void* dn1, const void* dm1,
    void* dq, void* dk, void* dv, void* di, void* df, void* dC0, void* dn0,
    void* dm0, void* work, long long work_bytes, int B, int S, int H, int D,
    int dtype, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D > DMAX || D % 16 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Dims d = dims_of(B, S, H, D);
  Work w;
  if ((long long)carve((float*)work, d, &w) > work_bytes)
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
  if (dtype == 0) return launch<float>(REPRO_ARGS(float), st);
  if (dtype == 1) return launch<__nv_bfloat16>(REPRO_ARGS(__nv_bfloat16), st);
#undef REPRO_ARGS
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
