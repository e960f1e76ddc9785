"""Each hand-written kernel's work, counted once: a function per kernel
of the port (``KERNEL_WORK``), from the operands its wrapper takes to
the operations, the bytes (each input read once, each output written
once), the peak class that bounds it and the route the card's launcher
takes for them.  It reads shapes and dtypes, never data, so the card's
kernel, its plain version and its ``meta`` entry are charged the same
work.  ``charge`` records it in the active op profilers;
``launch.roofline`` turns it into times on the H100's constants, and
``chip_smoke.py``'s bound column reads it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class KernelWork:
    """One kernel call's work: ``flops`` operations (a multiply-add is
    2) on the ``peak`` class (``bf16``, ``tf32`` or ``fp32``), ``bytes``
    moved, on ``route`` (the launcher's route; None for a kernel with
    one)."""

    flops: float
    bytes: float
    peak: str
    route: Optional[str] = None


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _is_bf16(t) -> bool:
    return str(t.dtype) == "torch.bfloat16"


def _elt(t) -> int:
    return t.element_size()


# ---------------------------------------------------------------------------
# the kernels' work, one function per kernel: the wrapper's operands in
# ---------------------------------------------------------------------------


def link_geometry_work(positions, active, gain_scale=None) -> KernelWork:
    """Per link 18 fp32 operations (distance 6, gain 3, threshold 2, the
    row's max 2, the rate 5); positions [B, U, 2] and the active flags
    (float32, as the kernel reads them) in, three [B, U, U] float32 out,
    the gain scale read where given."""
    B, U = positions.shape[0], positions.shape[1]
    nbytes = 4 * (B * U * 2 + B * U + 3 * B * U * U)
    if gain_scale is not None:
        nbytes += 4 * B * U * U
    return KernelWork(18.0 * B * U * U, nbytes, "fp32")


def chain_dp_work(rate, sources, active, order, prev_dev, bits_in,
                  input_bits, ct, ok) -> KernelWork:
    """One chain-DP solve as the fused kernel does it: per output, each
    block start's min over s0 once (S + 1 adds and S compares for each of
    the L - 1 rows a >= 1), and at step j an add, the mask and a compare
    for each of the j block starts ``ok`` leaves; per scenario the
    transfer tensor's divisions, per output the source row's; per slot
    the backtrack's argmin and L steps.  Every operand read once,
    ``assign`` [B, M, L] int32 and ``latency`` [B, M] float32 written
    once."""
    B, U = rate.shape[0], rate.shape[1]
    M, L, S = sources.shape[1], ct.shape[0], ct.shape[2]
    from repro_torch.kernels.tropical_dp.tropical_dp import chain_route
    nbytes = _nbytes(rate, sources, active, order, prev_dev, bits_in,
                     input_bits, ct, ok) + 4 * B * M * L + 4 * B * M
    per_out = (L - 1) * (2 * S + 1) + 3 * L * (L + 1) // 2 + 1
    nops = (B * M * S * per_out + B * (L - 1) * S * (S + 1) + B * M * S
            + B * M * (S + 4 * L))
    return KernelWork(float(nops), nbytes, "fp32", chain_route(L, S, U))


def dp_step_work(dp, tr, tr0, ct, ok) -> KernelWork:
    """One wavefront step of the chain DP (the ``step`` route's kernel):
    per output (b, m, s) an add and a compare per (a, s0) and an add, the
    mask and a compare per a; dp [B, M, L, S+1], tr, tr0, ct, ok read,
    row, pa, ps [B, M, S] written."""
    B, M, L, S1 = dp.shape
    S = S1 - 1
    nbytes = 4 * (B * M * L * S1 + B * L * S * S1 + B * M * S + 2 * L * S
                  + 3 * B * M * S)
    return KernelWork(float(B * M * S * (L * S1 * 2 + 3 * L)), nbytes,
                      "fp32")


def conv2d_work(x, w, b) -> KernelWork:
    """The conv layer's GEMM with bias and ReLU: x [M, K], w [K, N], b [N]
    read, y [M, N] written, float32.  On the ``wgmma`` route (K a multiple
    of 4) its 2 M N K operations run three times on the TF32 tensor cores
    (3xTF32: lo.hi + hi.lo + hi.hi); on ``simt`` once in fp32."""
    from repro_torch.kernels.conv2d.conv2d import gemm_route
    M, K = x.shape
    N = w.shape[1]
    nbytes = 4 * (M * K + K * N + N + M * N)
    if gemm_route(K) == "wgmma":
        return KernelWork(3.0 * 2 * M * N * K, nbytes, "tf32", "wgmma")
    return KernelWork(2.0 * M * N * K, nbytes, "fp32", "simt")


def _sum_to(n: int) -> int:
    """1 + 2 + ... + n (0 for n <= 0)."""
    return n * (n + 1) // 2 if n > 0 else 0


def kept_pairs(sq: int, sk: int, causal: bool, window: int,
               q_offset: int = 0) -> int:
    """The (query, key) pairs the masks keep, query row i at position
    ``q_offset + i`` (masks need Sk >= q_offset + Sq): a row at position
    p keeps keys j <= p (causal) with p - j < window, or every key from p
    - window + 1 on (a window alone)."""
    if not causal and not window:
        return sq * sk
    lo, hi = q_offset, q_offset + sq         # positions [lo, hi)
    if causal:
        # sum over p of min(p + 1, window) (p + 1 without a window)
        if not window:
            return _sum_to(hi) - _sum_to(lo)
        below = max(0, min(hi, window) - lo)    # rows with p + 1 <= window
        return _sum_to(lo + below) - _sum_to(lo) + (sq - below) * window
    # sum over p of sk - max(0, p - window + 1)
    return sq * sk - (_sum_to(hi - window) - _sum_to(lo - window))


def flash_work(q, k, v, *, causal=True, window=0, cap=0.0,
               with_lse=False, q_offset=0) -> KernelWork:
    """Prefill attention q [B, H, Sq, D], k/v [B, KV, Sk, D]: two products
    of 2 D operations a kept pair and head; q, k, v read, the output
    written (and the log-sum-exp, float32, with ``with_lse``); on the
    bf16 tensor cores in bfloat16 (``wgmma``), fp32 SIMT in float32
    (``simt``); query row i at position ``q_offset + i``."""
    B, H, S, D = q.shape
    pairs = kept_pairs(S, k.shape[2], causal, window, q_offset)
    nbytes = _nbytes(q, k, v) + _elt(q) * B * H * S * D
    if with_lse:
        nbytes += 4 * B * H * S
    if _is_bf16(q):
        return KernelWork(4.0 * B * H * D * pairs, nbytes, "bf16", "wgmma")
    return KernelWork(4.0 * B * H * D * pairs, nbytes, "fp32", "simt")


def flash_bwd_work(q, k, v, o, lse, do, *, causal=True, window=0,
                   cap=0.0, q_offset=0) -> KernelWork:
    """The attention backward: five products of 2 D operations a kept
    pair and head (S and dP recomputed, dV, dK, dQ); q, k, v, o, dO and
    the log-sum-exp read, dq, dk, dv written; ``bwd_route``'s route."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        bwd_route
    B, H, S, D = q.shape
    pairs = kept_pairs(S, k.shape[2], causal, window, q_offset)
    nbytes = _nbytes(q, k, v, o, lse, do) + _nbytes(q, k, v)
    return KernelWork(10.0 * B * H * D * pairs, nbytes,
                      "bf16" if _is_bf16(q) else "fp32", bwd_route(q.dtype))


def decode_work(q, k, v, pos, *, cap=0.0, return_lse=False) -> KernelWork:
    """One decode step's attention, q [B, KV, G, D] against the caches
    [B, KV, S, D] over every slot (the shapes bound it; a row stops at
    ``pos``, which the count does not read): two products of 2 D
    operations a slot and query head; q and the caches read, the output
    written (float32 with ``return_lse``, and the log-sum-exp), pos
    read.  bfloat16 with G > 8 and D >= 64 forms them on the
    tensor cores (``mma.sync``), other shapes in fp32."""
    B, KV, G, D = q.shape
    S = k.shape[2]
    nbytes = 2 * _nbytes(q) + _nbytes(k, v, pos)
    if return_lse:
        nbytes += (4 - _elt(q)) * q.numel() + 4 * B * KV * G
    tc = _is_bf16(q) and G > 8 and D >= 64
    return KernelWork(4.0 * B * KV * G * D * S, nbytes,
                      "bf16" if tc else "fp32")


def _expert(flops: float, nbytes: int, t, d: int, f: int) -> KernelWork:
    """An expert GEMM's work on the route its launchers take for ``t``'s
    dtype at (D, F) (``bwd_route``: forward, dX and dW alike)."""
    from repro_torch.kernels.moe_matmul.moe_matmul import bwd_route
    route = bwd_route(t.dtype, d, f)
    return KernelWork(flops, nbytes, "bf16" if route == "wgmma" else "fp32",
                      route)


def moe_work(x, w) -> KernelWork:
    """The grouped expert GEMM x [E, C, D] @ w [E, D, F]: 2 E C D F
    operations; x and w read, y written; bf16 tensor cores on ``wgmma``,
    fp32 on ``simt``."""
    E, C, D = x.shape
    F = w.shape[2]
    return _expert(2.0 * E * C * D * F,
                   _nbytes(x, w) + _elt(x) * E * C * F, x, D, F)


def moe_dx_work(dy, w) -> KernelWork:
    """dx [E, C, D] = dy [E, C, F] w^T: 2 E C D F operations; dy, w read,
    dx written."""
    E, C, F = dy.shape
    D = w.shape[1]
    return _expert(2.0 * E * C * D * F,
                   _nbytes(dy, w) + _elt(dy) * E * C * D, dy, D, F)


def moe_dw_work(x, dy) -> KernelWork:
    """dw [E, D, F] = x^T dy: 2 E C D F operations; x, dy read, dw
    written."""
    E, C, D = x.shape
    F = dy.shape[2]
    return _expert(2.0 * E * C * D * F,
                   _nbytes(x, dy) + _elt(x) * E * D * F, x, D, F)


def rglru_work(a, b, h0) -> KernelWork:
    """h_t = a_t h_{t-1} + b_t over [B, T, W]: an FMA a step and channel;
    a, b read and h written, h0 read and hT written; ``rglru_route``'s
    route."""
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_route
    B, T, W = a.shape
    return KernelWork(2.0 * B * T * W,
                      3 * _nbytes(a) + 2 * _nbytes(h0), "fp32",
                      rglru_route(a.dtype, T, W))


def rglru_bwd_work(a, h, h0, dh, dhT=None) -> KernelWork:
    """The reverse scan: 3 operations a step and channel; a, h, dh read,
    da, db written, h0 (and dhT where given) read, dh0 written;
    ``rglru_route``'s route."""
    from repro_torch.kernels.rglru_scan.rglru_scan import rglru_route
    B, T, W = a.shape
    return KernelWork(3.0 * B * T * W,
                      5 * _nbytes(a) + 2 * _nbytes(h0) + _nbytes(dhT),
                      "fp32", rglru_route(a.dtype, T, W))


def mlstm_work(q, k, v, i_pre, f_pre, C0, n0, m0, scale) -> KernelWork:
    """The chunkwise mLSTM over [B, S, H, D] from a state, in the chunks
    of the route the card takes (``mlstm_route``): q, k, v and the gates
    read once, h written once, the state read and written once; per
    chunk of l steps the two D x D products a step (q C and the rank-one
    update of C), the causal half of q k^T and of sw v (l (l + 1) / 2
    pairs of D), and q n and the update of n; 2 operations a
    multiply-add.  On ``wgmma`` (bf16 tensor cores) the products with a
    float32 operand (q C, the C update, sw v) are issued twice, as a bf16
    high and low part, and counted twice, and q n and n's update (on fp32
    lanes beside them) are left out; ``simt`` and ``decode`` count fp32
    operations."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (CHUNK,
                                                            mlstm_route)
    b, s, h, d = q.shape
    route = mlstm_route(q.dtype, s)
    nbytes = 4 * b * s * h * d * _elt(q) + 2 * b * s * h * 4 \
        + 2 * b * h * (d * d + d + 1) * 4
    chunk, fmas = CHUNK[route], 0
    full, rest = divmod(s, chunk)
    for l, n in ((chunk, full), (rest, 1 if rest else 0)):
        pairs = l * (l + 1) // 2
        if route == "wgmma":
            fmas += n * (2 * (2 * l * d * d) + pairs * d + 2 * pairs * d)
        else:
            fmas += n * (2 * l * d * d + 2 * pairs * d + 2 * l * d)
    return KernelWork(2.0 * b * h * fmas, nbytes,
                      "bf16" if route == "wgmma" else "fp32", route)


def mlstm_decode_block_work(q, k, v, i_pre, f_pre, C0, n0, m0,
                            scale) -> KernelWork:
    """The decode step on a block of DK of D key rows: per (b, head) the
    two DK x D products (q C and the rank-one update of C) and q . k, q .
    n and n's update, 2 operations a multiply-add, on fp32 lanes; q, k,
    v, the gates and the state block read, num and den written in
    float32 and the state block written (route ``decode_block``)."""
    b, _, h, dk = q.shape
    d = v.shape[-1]
    nbytes = _nbytes(q, k, v, i_pre, f_pre) + 4 * b * h * (d + 1) \
        + 2 * b * h * (dk * d + dk + 1) * 4
    return KernelWork(2.0 * b * h * (2 * dk * d + 3 * dk), nbytes, "fp32",
                      "decode_block")


def mlstm_bwd_work(q, k, v, i_pre, f_pre, C0, n0, m0, scale, dh, dC1=None,
                   dn1=None, dm1=None) -> KernelWork:
    """The mLSTM backward in ``BWD_CHUNK`` chunks: per chunk of l steps
    and head 6 l^2 D + 6 l D^2 multiply-adds (q k^T, sw V, dnum V^T, dS K,
    dS^T Q, sw^T dnum; q C, C dnum, the dC update, dC v, dC^T k, the C
    recompute), 2 operations each; q, k, v, dh read and dq, dk, dv
    written in the dtype, the gates read and their gradients written and
    the initial state read and its gradient written in float32; bf16
    tensor cores on ``wgmma``, fp32 on ``simt``."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (BWD_CHUNK,
                                                            mlstm_bwd_route)
    b, s, h, d = q.shape
    nbytes = 7 * b * s * h * d * _elt(q) + 4 * b * s * h * 4 \
        + 2 * b * h * (d * d + d + 1) * 4
    full, rest = divmod(s, BWD_CHUNK)
    fmas = sum(n * (6 * l * l * d + 6 * l * d * d)
               for l, n in ((BWD_CHUNK, full), (rest, 1 if rest else 0)))
    route = mlstm_bwd_route(q.dtype, s, d)
    return KernelWork(2.0 * b * h * fmas, nbytes,
                      "bf16" if route == "wgmma" else "fp32", route)


#: kernel name (``kernels.launch_counts``) -> its work from the operands
#: its wrapper takes
KERNEL_WORK = {
    "link_geometry": link_geometry_work,
    "tropical_dp": chain_dp_work,
    "tropical_dp_step": dp_step_work,
    "conv2d": conv2d_work,
    "flash_attention": flash_work,
    "flash_attention_bwd": flash_bwd_work,
    "decode_attention": decode_work,
    "moe_matmul": moe_work,
    "moe_matmul_dx": moe_dx_work,
    "moe_matmul_dw": moe_dw_work,
    "rglru_scan": rglru_work,
    "rglru_scan_bwd": rglru_bwd_work,
    "mlstm_chunk": mlstm_work,
    "mlstm_chunk_bwd": mlstm_bwd_work,
    "mlstm_decode_block": mlstm_decode_block_work,
}


__all__ = ["KERNEL_WORK", "KernelWork", "kept_pairs"]
