"""CUDA wrapper for the chunkwise mLSTM cell (``csrc/mlstm_chunk.cu``).

Replaces the Pallas kernel ``src/repro/kernels/mlstm_chunk/mlstm_chunk.py``
(``mlstm_chunk``), with two additions for serving: it starts from a
given state ``(C0, n0, m0)`` and returns the final one, and it takes any
``S >= 1`` (its own chunks, the last one ragged).  Bound by bytes in
decode (reading and writing ``C``) and in bf16 prefill on the tensor
cores; by operations in float32 prefill (the two ``D x D`` products a
token on fp32 lanes).  Three routes, chosen by ``mlstm_route`` from the
dtype and ``S`` alone and counted in ``mlstm_chunk.launches_by_route``:

* ``wgmma`` (bfloat16, ``S > 1``): chunks of 64 steps; a block per
  (b, head, value tile of 64 columns) holds its tile of ``C`` transposed
  in fp32 ``wgmma`` accumulator registers for the whole sequence; q k^T,
  q C, sw V and the C update are ``wgmma`` products, the float32
  operands (C, sw, the decayed values) as bf16 high + low pairs; a
  score warpgroup forms q k^T and sw a chunk ahead of the state's
  chain, its TMA thread keeping a 2-stage ring of q, k, v full and its
  gate warp taking the gate cumulatives by warp scans;
* ``decode`` (``S == 1``, either dtype): the rank-one update streamed
  over 16-column strips of ``C`` with 16-byte loads and stores;
* ``simt`` (float32, ``S > 1``): chunks of 32 steps, a SIMT block per
  (b, head, value tile) holding its tile of ``C`` in shared memory.

``mlstm_decode_block`` is the ``decode`` route's key-block mode, its own
wrapper with its own counts (route ``decode_block``): one step on a
block of the state's key rows, the block's partial numerator and
denominator returned undivided for a ``psum`` over ``model``.

Every route is deterministic launch to launch.

The backward ``mlstm_chunk_bwd`` (``csrc/mlstm_chunk_bwd.cu``; no Pallas
kernel has one: the reference leaves ``mlstm_chunk_math``'s gradient to
XLA) recomputes the chunk-start states, carries the state's gradient
backwards over the chunks and then forms dq, dk, dv and the gates'
gradients chunk by chunk, in chunks of ``BWD_CHUNK``.  Two routes, chosen
by ``mlstm_bwd_route`` from the dtype alone and counted in
``mlstm_chunk_bwd.launches_by_route``:

* ``wgmma`` (bfloat16, any S and head dim): every product on the bf16
  tensor cores, the float32 operands (the states C_c and dC_{c+1}, the
  decayed keys, the scaled q, ds and sw / den) as bf16 high + low pairs;
  the two chunk chains walk 64 x 64 tiles of C and dC held in ``wgmma``
  accumulators, their operands fed by TMA rings, and hand the states on
  as bf16 planes that the per-chunk gradient pass reads by TMA;
* ``simt`` (float32): float32 SIMT products over 32 x 32 tiles.

Both are deterministic launch to launch (no atomics).  ``ops.mlstm``
calls both kernels through an autograd Function when a gradient is
wanted; the bare forward refuses to run under grad (its output would
carry no gradient).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, refuse_grad

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
#: launcher route codes
ROUTES = ("simt", "wgmma", "decode")
#: each route's chunk length
CHUNK = {"simt": 32, "wgmma": 64, "decode": 1}
MAX_ROWS = 2 ** 31 - 1           # B x H, the grid's x extent
_BWD_ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_longlong] + \
    [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
#: the backward's launcher route codes, its chunk length and its grid's y
#: extent (B x H)
BWD_ROUTES = ("simt", "wgmma")
BWD_CHUNK = 64
BWD_MAX_ROWS = 65535


def mlstm_route(dtype: torch.dtype, s: int) -> str:
    """The route a launch over ``s`` steps of ``dtype`` takes: ``decode``
    at ``s == 1``, else ``wgmma`` for bfloat16 and ``simt`` for
    float32."""
    if s == 1:
        return "decode"
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def mlstm_bwd_route(dtype: torch.dtype, s: int, d: int) -> str:
    """The route the backward over ``s`` steps of head dim ``d`` in
    ``dtype`` takes: ``wgmma`` for bfloat16 (every S >= 1 and every head
    dim in ``HEAD_DIMS``: TMA zero-pads a short chunk and a head dim
    under 64), ``simt`` for float32 (``wgmma`` has no float32 input)."""
    del s, d                      # the rule reads the dtype alone
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def bwd_workspace_bytes(B: int, S: int, H: int, D: int, route: str) -> int:
    """Bytes of the backward's workspace at (B, S, H, D) on ``route``, as
    the launcher's ``repro_mlstm_chunk_bwd_workspace`` carves it (each
    slot a whole number of 16 bytes): the gates' b_t, mx_t and the
    per-step den, dden_raw and db [BH, S]; m_c, dm's inter share, b_L and
    max a [BH, NC]; dm's tile partials [BH, NC, NT^2] and [BH, NT^2]; n_c
    and dn_{c+1} [BH, NC, D]; then on ``simt`` C_c and dC_{c+1} [BH, NC,
    D, D] in float32, on ``wgmma`` the [BH, NC, NT^2, 64] partials of
    dh . q C and the four bf16 planes of C_c and dC_{c+1} [BH, NC, DP,
    DP] (NT tiles of 64 a side, DP = 64 NT).  The card's wrapper
    allocates this many bytes and the launcher refuses a workspace of
    another size (``invalid argument``), so a layout this copy does not
    follow fails every launch."""
    bh, nc = B * H, -(-S // BWD_CHUNK)
    wg = route == "wgmma"
    nt = -(-D // 64) if wg else -(-D // 32)
    plane = bh * nc * (64 * nt) ** 2 // 2 if wg else 0   # floats
    slots = [bh * S, bh * S, bh * nc, bh * S, bh * S, bh * S, bh * nc,
             bh * nc * nt * nt, bh * nt * nt, bh * nc * D, bh * nc * D,
             0 if wg else bh * nc * D * D, 0 if wg else bh * nc * D * D,
             bh * nc * nt * nt * 64 if wg else 0, bh * nc, bh * nc,
             plane, plane, plane, plane]
    return 4 * sum(-(-n // 4) * 4 for n in slots)


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_pre: torch.Tensor, f_pre: torch.Tensor, C0: torch.Tensor,
                n0: torch.Tensor, m0: torch.Tensor, scale: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """q, k, v [B, S, H, D] contiguous, of one dtype (float32 or
    bfloat16; q unscaled), i_pre, f_pre [B, S, H] and the state C0
    [B, H, D, D], n0 [B, H, D], m0 [B, H] contiguous float32, all CUDA
    tensors on one device; D in ``HEAD_DIMS``, S >= 1 -> (h [B, S, H, D]
    in q's dtype, C1, n1, m1), on the current stream without
    synchronising.  Raises under grad: the training path goes through
    ``ops.mlstm``."""
    refuse_grad("mlstm_chunk", "14.8: call ops.mlstm, whose autograd "
                "Function launches mlstm_chunk_bwd", q, k, v, i_pre, f_pre,
                C0, n0, m0)
    if q.dim() != 4 or tuple(k.shape) != tuple(q.shape) or \
            tuple(v.shape) != tuple(q.shape):
        raise ValueError(f"mlstm_chunk: want q, k, v [B, S, H, D] of one "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    want = {"i_pre": (B, S, H), "f_pre": (B, S, H), "C0": (B, H, D, D),
            "n0": (B, H, D), "m0": (B, H)}
    got = {"i_pre": i_pre, "f_pre": f_pre, "C0": C0, "n0": n0, "m0": m0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"mlstm_chunk: {name} must be {shape}; got "
                             f"{tuple(got[name].shape)}")
    if D not in HEAD_DIMS or S < 1 or B * H > MAX_ROWS:
        raise ValueError(f"mlstm_chunk: head dim {D} (want one of "
                         f"{HEAD_DIMS}), S {S} (want >= 1), B x H {B * H}")
    route = mlstm_route(q.dtype, S)
    # the wgmma route reads q, k, v by TMA: 16-byte aligned data
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(
            f"mlstm_chunk: bfloat16 q, k, v with S > 1 are read by TMA and "
            f"need 16-byte aligned data; got data_ptr % 16 = "
            f"{[t.data_ptr() % 16 for t in (q, k, v)]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype not in _DTYPES or \
                t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"mlstm_chunk: {name} must be a contiguous "
                             f"CUDA float32 or bfloat16 tensor of q's "
                             f"dtype; got {t.device} {t.dtype}")
    for name, t in got.items():
        if t.device != q.device or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"mlstm_chunk: {name} must be a contiguous "
                             f"CUDA float32 tensor on {q.device}; got "
                             f"{t.device} {t.dtype}")
    h = torch.empty_like(q)
    C1, n1, m1 = (torch.empty_like(t) for t in (C0, n0, m0))
    lib = _build.load("mlstm_chunk")
    fn = lib.repro_mlstm_chunk
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
                 f_pre.data_ptr(), C0.data_ptr(), n0.data_ptr(),
                 m0.data_ptr(), h.data_ptr(), C1.data_ptr(), n1.data_ptr(),
                 m1.data_ptr(), B, S, H, D, _DTYPES[q.dtype],
                 ROUTES.index(route), float(scale), stream)
    _build.check_launch(lib, "mlstm_chunk", err)
    mlstm_chunk.launches += 1
    mlstm_chunk.launches_by_route[route] += 1
    return h, C1, n1, m1


mlstm_chunk.launches = 0
mlstm_chunk.launches_by_route = dict.fromkeys(ROUTES, 0)


_BLOCK_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + \
    [ctypes.c_float, ctypes.c_void_p]


def mlstm_decode_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i_pre: torch.Tensor, f_pre: torch.Tensor,
                       C0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                       scale: float) -> Tuple[torch.Tensor, ...]:
    """The ``decode`` route's key-block mode (``csrc/mlstm_chunk.cu``,
    ``repro_mlstm_decode_block``): one step on DK of the D key rows of the
    state, as a position of a mesh whose ``model`` axis splits them holds
    it.  q, k [B, 1, H, DK] and v [B, 1, H, D] contiguous, of one dtype
    (float32 or bfloat16), the gates [B, 1, H], C0 [B, H, DK, D], n0
    [B, H, DK] and m0 [B, H] contiguous float32, all CUDA tensors on one
    device; D in ``HEAD_DIMS``, 1 <= DK <= D -> (num [B, H, D], den
    [B, H]: the block's partial numerator and raw denominator in float32,
    undivided; C1, n1 of the block, m1), as ``ref.mlstm_decode_block_ref``.
    Counted in ``launches`` and ``launches_by_route["decode_block"]``."""
    refuse_grad("mlstm_decode_block", "25.3: the key-block decode step "
                "serves; training runs the chunk kernels on row blocks", q,
                k, v, i_pre, f_pre, C0, n0, m0)
    if q.dim() != 4 or q.shape[1] != 1 or tuple(k.shape) != tuple(q.shape):
        raise ValueError(f"mlstm_decode_block: want q, k [B, 1, H, DK] of "
                         f"one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, _, H, DK = q.shape
    D = v.shape[-1]
    want = {"v": (B, 1, H, D), "i_pre": (B, 1, H), "f_pre": (B, 1, H),
            "C0": (B, H, DK, D), "n0": (B, H, DK), "m0": (B, H)}
    got = {"v": v, "i_pre": i_pre, "f_pre": f_pre, "C0": C0, "n0": n0,
           "m0": m0}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"mlstm_decode_block: {name} must be {shape}; "
                             f"got {tuple(got[name].shape)}")
    if D not in HEAD_DIMS or not 1 <= DK <= D or B * H > MAX_ROWS:
        raise ValueError(f"mlstm_decode_block: head dim {D} (want one of "
                         f"{HEAD_DIMS}), key rows {DK} (want 1..{D}), "
                         f"B x H {B * H}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype not in _DTYPES or \
                t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"mlstm_decode_block: {name} must be a "
                             f"contiguous CUDA float32 or bfloat16 tensor "
                             f"of q's dtype; got {t.device} {t.dtype}")
    for name in ("i_pre", "f_pre", "C0", "n0", "m0"):
        t = got[name]
        if t.device != q.device or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"mlstm_decode_block: {name} must be a "
                             f"contiguous CUDA float32 tensor on "
                             f"{q.device}; got {t.device} {t.dtype}")
    f32 = dict(dtype=torch.float32, device=q.device)
    num, den = torch.empty((B, H, D), **f32), torch.empty((B, H), **f32)
    C1, n1, m1 = (torch.empty_like(t) for t in (C0, n0, m0))
    fn = _build.launcher("mlstm_chunk", "repro_mlstm_decode_block",
                         _BLOCK_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, i_pre, f_pre, C0, n0, m0,
                                          num, den, C1, n1, m1)),
                 B, H, DK, D, _DTYPES[q.dtype], float(scale), stream)
    _build.check_launch(_build.load("mlstm_chunk"), "mlstm_decode_block",
                        err)
    mlstm_decode_block.launches += 1
    mlstm_decode_block.launches_by_route["decode_block"] += 1
    return num, den, C1, n1, m1


mlstm_decode_block.launches = 0
mlstm_decode_block.launches_by_route = {"decode_block": 0}


def mlstm_decode_block_meta(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, i_pre: torch.Tensor,
                            f_pre: torch.Tensor, C0: torch.Tensor,
                            n0: torch.Tensor, m0: torch.Tensor,
                            scale: float) -> Tuple[torch.Tensor, ...]:
    """``mlstm_decode_block`` on ``meta``: (num, den, C1, n1, m1) of its
    shapes and dtypes; no launch, no arithmetic."""
    B, _, H, _ = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.empty((B, H, v.shape[-1]), **f32),
            torch.empty((B, H), **f32)) + \
        tuple(torch.empty_like(t) for t in (C0, n0, m0))


def mlstm_chunk_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor,
                    C0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                    scale: float, dh: torch.Tensor,
                    dC1: Optional[torch.Tensor] = None,
                    dn1: Optional[torch.Tensor] = None,
                    dm1: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """The chunk kernel's gradient: the forward's operands as
    ``mlstm_chunk`` takes them, dh [B, S, H, D] contiguous in q's dtype
    and the final state's dC1, dn1, dm1 (None: zeros) contiguous float32,
    all CUDA tensors on one device -> (dq, dk, dv in q's dtype; di, df
    [B, S, H], dC0, dn0, dm0 float32), on the current stream without
    synchronising, on ``mlstm_bwd_route``'s route (``wgmma``: q, k, v,
    dh 16-byte aligned).  Its workspace (``bwd_workspace_bytes``) is
    allocated here and freed with the call's tensors."""
    if q.dim() != 4 or any(tuple(t.shape) != tuple(q.shape)
                           for t in (k, v, dh)):
        raise ValueError(f"mlstm_chunk_bwd: want q, k, v, dh [B, S, H, D] "
                         f"of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(dh.shape)}")
    B, S, H, D = q.shape
    want = {"i_pre": (B, S, H), "f_pre": (B, S, H), "C0": (B, H, D, D),
            "n0": (B, H, D), "m0": (B, H), "dC1": (B, H, D, D),
            "dn1": (B, H, D), "dm1": (B, H)}
    got = {"i_pre": i_pre, "f_pre": f_pre, "C0": C0, "n0": n0, "m0": m0,
           "dC1": dC1, "dn1": dn1, "dm1": dm1}
    got = {name: t for name, t in got.items() if t is not None}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"mlstm_chunk_bwd: {name} must be "
                             f"{want[name]}; got {tuple(t.shape)}")
    if D not in HEAD_DIMS or S < 1 or B * H > BWD_MAX_ROWS:
        raise ValueError(f"mlstm_chunk_bwd: head dim {D} (want one of "
                         f"{HEAD_DIMS}), S {S} (want >= 1), B x H {B * H} "
                         f"(at most {BWD_MAX_ROWS})")
    route = mlstm_bwd_route(q.dtype, S, D)
    # the wgmma route reads q, k, v and dh by TMA: 16-byte aligned data
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v, dh)):
        raise ValueError(
            f"mlstm_chunk_bwd: bfloat16 q, k, v, dh are read by TMA and need "
            f"16-byte aligned data; got data_ptr % 16 = "
            f"{[t.data_ptr() % 16 for t in (q, k, v, dh)]}")
    for name, t in (("q", q), ("k", k), ("v", v), ("dh", dh)):
        if t.device.type != "cuda" or t.dtype not in _DTYPES or \
                t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"mlstm_chunk_bwd: {name} must be a "
                             f"contiguous CUDA float32 or bfloat16 tensor "
                             f"of q's dtype; got {t.device} {t.dtype}")
    for name, t in got.items():
        if t.device != q.device or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"mlstm_chunk_bwd: {name} must be a contiguous "
                             f"CUDA float32 tensor on {q.device}; got "
                             f"{t.device} {t.dtype}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di, df = torch.empty_like(i_pre), torch.empty_like(f_pre)
    dC0, dn0, dm0 = (torch.empty_like(t) for t in (C0, n0, m0))
    code = BWD_ROUTES.index(route)
    nbytes = bwd_workspace_bytes(B, S, H, D, route)
    work = torch.empty((nbytes + 3) // 4, dtype=torch.float32,
                       device=q.device)
    fn = _build.launcher("mlstm_chunk_bwd", "repro_mlstm_chunk_bwd",
                         _BWD_ARGTYPES)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(ptr(t) for t in (q, k, v, i_pre, f_pre, C0, n0, m0, dh,
                                    dC1, dn1, dm1, dq, dk, dv, di, df, dC0,
                                    dn0, dm0, work)),
                 nbytes, B, S, H, D, _DTYPES[q.dtype], code, float(scale),
                 stream)
    _build.check_launch(_build.load("mlstm_chunk_bwd"), "mlstm_chunk_bwd",
                        err)
    mlstm_chunk_bwd.launches += 1
    mlstm_chunk_bwd.launches_by_route[route] += 1
    return dq, dk, dv, di, df, dC0, dn0, dm0


mlstm_chunk_bwd.launches = 0
mlstm_chunk_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


def mlstm_chunk_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i_pre: torch.Tensor, f_pre: torch.Tensor,
                     C0: torch.Tensor, n0: torch.Tensor, m0: torch.Tensor,
                     scale: float):
    """``mlstm_chunk`` on ``meta``: (h, C1, n1, m1) of its shapes and
    dtypes; no launch, no arithmetic."""
    refuse_grad("mlstm_chunk", "14.8: call ops.mlstm, whose autograd "
                "Function launches mlstm_chunk_bwd", q, k, v, i_pre, f_pre,
                C0, n0, m0)
    return (torch.empty_like(q),) + tuple(torch.empty_like(t)
                                          for t in (C0, n0, m0))


def mlstm_chunk_bwd_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         i_pre: torch.Tensor, f_pre: torch.Tensor,
                         C0: torch.Tensor, n0: torch.Tensor,
                         m0: torch.Tensor, scale: float, dh: torch.Tensor,
                         dC1: Optional[torch.Tensor] = None,
                         dn1: Optional[torch.Tensor] = None,
                         dm1: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, ...]:
    """``mlstm_chunk_bwd`` on ``meta``: its eight gradients' shapes and
    dtypes and the workspace the card's wrapper allocates
    (``bwd_workspace_bytes``); no launch, no arithmetic."""
    B, S, H, D = q.shape
    route = mlstm_bwd_route(q.dtype, S, D)
    out = tuple(torch.empty_like(q) for _ in range(3)) + \
        (torch.empty_like(i_pre), torch.empty_like(f_pre)) + \
        tuple(torch.empty_like(t) for t in (C0, n0, m0))
    torch.empty((bwd_workspace_bytes(B, S, H, D, route) + 3) // 4,
                dtype=torch.float32, device=q.device)
    return out
