"""CUDA wrapper for prefill attention (``csrc/flash_attention.cu``).

Replaces the Pallas kernel ``src/repro/kernels/flash_attention/
flash_attention.py`` (``flash_attention``): online-softmax attention
with a causal mask, a sliding window and a tanh logit softcap, GQA by
``kv head = h // (H / KV)``, masked positions at ``-1e30`` and the
running sum clamped at ``1e-30``; float32 math from float32 or bfloat16
inputs, output in ``q.dtype``.  The keys may be longer or shorter than
the queries (Sk != Sq: cross-attention, which the TPU kernel's single S
does not take) when neither the causal mask nor a window is set; under a
mask, ``q_offset`` places query row i at position ``q_offset + i`` over
the first ``Sk >= q_offset + Sq`` keys (a row block of a sequence split
over ``model``, ``models.attention.attention_seq_sharded``).  Bound
by operations at the serving
shapes (4 B H S^2 D / 2 flops for causal rows, at the H100's 989 bf16
TFLOP/s).  Two routes, counted in ``flash_attention.launches_by_route``:

* ``wgmma`` (bfloat16): 64 query rows per consumer warpgroup, two a
  block up to D 128 and one at D 256, Q and 64-key K and V tiles brought
  in by TMA through 2-stage mbarrier rings by a producer thread, Q K^T
  and P V by ``wgmma`` with fp32 accumulators (a tile's Q K^T beside the
  previous tile's P V), the softmax on the accumulator fragment in
  registers, P as a bf16 high + low pair;
* ``simt`` (float32): a SIMT tile of 64 query rows a block with fp32
  ``fmaf`` products (``wgmma`` has no fp32 input).

Both skip kv tiles wholly above the diagonal or outside the window
(exact: they carry zero weight) and are deterministic launch to launch.
With ``with_lse`` the launch also stores each row's log-sum-exp, which
the backward ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``)
reads; ``ops.mha`` calls both through an autograd Function when a
gradient is wanted, and the bare wrapper refuses to run under grad
(its output would carry no gradient).  The backward has two routes by
dtype as well, counted in ``flash_attention_bwd.launches_by_route``:
``wgmma`` (bfloat16: a dK/dV kernel of two warpgroups over a TMA ring
of Q and dO tiles, dK and dV in registers, and a dQ kernel shaped as the
forward, P and dS as bf16 high + low register operands) and ``simt``
(float32: SIMT fp32 products).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.flash_attention.ref import check_key_length

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 2 + [ctypes.c_void_p]
             + [ctypes.POINTER(ctypes.c_int)])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
#: launcher route codes
ROUTES = ("simt", "wgmma")
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                 + [ctypes.POINTER(ctypes.c_longlong)]
                 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
#: the backward's launcher route codes: SIMT fp32 products (float32),
#: bf16 ``wgmma`` + TMA (bfloat16)
BWD_ROUTES = ("simt", "wgmma")
#: the backward's scratch rows (delta, the padded lse) are padded to a
#: multiple of this many queries (``ROW_PAD`` in the source)
BWD_ROW_PAD = 128


def check_operand(fn: str, name: str, t: torch.Tensor, ref: torch.Tensor,
                  shape, vec: int) -> None:
    """Raise unless ``t`` is a CUDA tensor on ``ref``'s device, of its
    dtype and of ``shape``, with the last dim contiguous and rows of
    ``vec`` elements aligned for vector loads (any strides above that)."""
    item = t.element_size()
    if t.device != ref.device or t.device.type != "cuda" or \
            t.dtype != ref.dtype or tuple(t.shape) != tuple(shape) or \
            t.stride(-1) != 1 or t.data_ptr() % (vec * item) or \
            any(st % vec for st in t.stride()[:-1]):
        raise ValueError(
            f"{fn}: {name} must be a CUDA {ref.dtype} tensor of shape "
            f"{tuple(shape)} on {ref.device} with the last dim contiguous "
            f"and strides a multiple of {vec}; got {t.device} {t.dtype} "
            f"{tuple(t.shape)} strides {t.stride()}")


def _check_shapes(fn: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, causal: bool, window: int,
                  q_offset: int = 0) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{fn}: want q [B,H,Sq,D], k/v [B,KV,Sk,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    H, D = q.shape[1], q.shape[3]
    KV = k.shape[1]
    check_key_length(fn, q.shape[2], k.shape[2], causal, window, q_offset)
    if q.dtype not in _DTYPES or D not in HEAD_DIMS or KV < 1 or H % KV:
        raise ValueError(f"{fn}: dtype {q.dtype} (want float32 or "
                         f"bfloat16), head dim {D} (want {HEAD_DIMS}), "
                         f"{H} heads over {KV} kv heads")


def check_tma(fn: str, *named) -> None:
    """Raise ``ValueError`` unless each ``(name, tensor)`` can be read by
    TMA: data 16-byte aligned, and the strides above the last dim nonzero
    multiples of 8 elements (a broadcast view has no tensor map)."""
    for name, t in named:
        if t.data_ptr() % 16 or any(st % 8 or st == 0
                                    for st in t.stride()[:-1]):
            raise ValueError(
                f"{fn}: bfloat16 {name} is read by TMA and needs 16-byte "
                f"aligned data and nonzero strides that are multiples of 8 "
                f"elements; got data_ptr % 16 = {t.data_ptr() % 16}, "
                f"strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    cap: float = 0.0, with_lse: bool = False,
                    q_offset: int = 0):
    """q [B,H,Sq,D]; k/v [B,KV,Sk,D] (KV divides H; D in 16, 32, 64, 128,
    256; Sk >= 1, and Sk = Sq when ``causal`` or ``window`` is set, or Sk
    >= q_offset + Sq with query row i at position ``q_offset + i``;
    float32 or bfloat16, all one dtype, on one CUDA device; strided views
    allowed with D contiguous) -> [B,H,Sq,D] contiguous, in ``q.dtype``,
    on the current stream without synchronising; with ``with_lse`` the
    pair (out, lse float32 [B,H,Sq]).  Raises under grad (see
    ``ops.mha``)."""
    refuse_grad("flash_attention", "14.4: call ops.mha, whose autograd "
                "Function launches flash_attention_bwd", q, k, v)
    _check_shapes("flash_attention", q, k, v, causal, window, q_offset)
    B, H, S, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:      # the wgmma route reads by TMA
        check_tma("flash_attention", ("q", q), ("k", k), ("v", v))
    for name, t, shape in (("q", q, (B, H, S, D)), ("k", k, (B, KV, Sk, D)),
                           ("v", v, (B, KV, Sk, D))):
        check_operand("flash_attention", name, t, q, shape, 4)
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    scale = 1.0 / math.sqrt(D)
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else None,
                 B, H, KV, S, Sk, D, _DTYPES[q.dtype],
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(causal), int(window), int(q_offset), float(scale),
                 float(cap), stream, ctypes.byref(route))
    _build.check_launch(lib, "flash_attention", err)
    flash_attention.launches += 1
    flash_attention.launches_by_route[ROUTES[route.value]] += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)


def bwd_route(dtype: torch.dtype) -> str:
    """The backward launcher's route for ``dtype``: ``wgmma`` for
    bfloat16 (every head dim), ``simt`` for float32."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0, cap: float = 0.0,
                        q_offset: int = 0):
    """The gradient of ``flash_attention``: q [B,H,Sq,D], k/v [B,KV,Sk,D],
    the forward's output o and the output's gradient do [B,H,Sq,D] (one
    dtype, strided views allowed with D contiguous and rows aligned to 4
    elements), the forward's lse float32 [B,H,Sq] -> (dq [B,H,Sq,D], dk,
    dv [B,KV,Sk,D]) contiguous in ``q.dtype`` (zeros at keys that no
    query reads, at a ``q_offset``), with float32 math; three
    kernels (delta, dK/dV, dQ) on the current stream, counted as one
    launch on its route (``bwd_route``).  The bfloat16 route reads q, k, v
    and do by TMA and refuses, before building, operands it cannot read
    (``check_tma``)."""
    _check_shapes("flash_attention_bwd", q, k, v, causal, window, q_offset)
    B, H, S, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if bwd_route(q.dtype) == "wgmma":
        check_tma("flash_attention_bwd", ("q", q), ("k", k), ("v", v),
                  ("do", do))
    for name, t, shape in (("q", q, (B, H, S, D)), ("k", k, (B, KV, Sk, D)),
                           ("v", v, (B, KV, Sk, D)), ("o", o, (B, H, S, D)),
                           ("do", do, (B, H, S, D))):
        check_operand("flash_attention_bwd", name, t, q, shape, 4)
    if lse.device != q.device or lse.dtype != torch.float32 or \
            tuple(lse.shape) != (B, H, S) or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"float32 tensor of shape {(B, H, S)} on "
                         f"{q.device}; got {lse.device} {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dq = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, torch.zeros_like(k, memory_format=torch.contiguous_format),\
            torch.zeros_like(v, memory_format=torch.contiguous_format)
    dk = torch.empty((B, KV, Sk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, KV, Sk, D), dtype=q.dtype, device=q.device)
    # delta and the wgmma route's padded lse, [B, H, S padded] each
    pad = -(-S // BWD_ROW_PAD) * BWD_ROW_PAD
    scratch = torch.empty(2 * B * H * pad, dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_longlong * 15)(*(st for t in (q, k, v, o, do)
                                         for st in t.stride()[:3]))
    fn = _build.launcher("flash_attention_bwd", "repro_flash_attention_bwd",
                         _BWD_ARGTYPES)
    route = ctypes.c_int(-1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, KV, S, Sk,
                 D, _DTYPES[q.dtype], strides, int(causal), int(window),
                 int(q_offset), float(1.0 / math.sqrt(D)), float(cap), stream,
                 ctypes.byref(route))
    _build.check_launch(_build.load("flash_attention_bwd"),
                        "flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[BWD_ROUTES[route.value]] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES, 0)


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         cap: float = 0.0, with_lse: bool = False,
                         q_offset: int = 0):
    """``flash_attention`` on ``meta``: its refusals on shapes and under
    grad, outputs of its shapes and dtypes; no launch, no arithmetic."""
    refuse_grad("flash_attention", "14.4: call ops.mha, whose autograd "
                "Function launches flash_attention_bwd", q, k, v)
    _check_shapes("flash_attention", q, k, v, causal, window, q_offset)
    B, H, S, D = q.shape
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    return (out, lse) if with_lse else out


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             cap: float = 0.0, q_offset: int = 0):
    """``flash_attention_bwd`` on ``meta``: (dq, dk, dv) of its shapes and
    dtypes and the scratch rows the card's wrapper allocates; no launch,
    no arithmetic."""
    del o, lse, do, cap
    _check_shapes("flash_attention_bwd", q, k, v, causal, window, q_offset)
    B, H, S, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    dq = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, torch.zeros_like(k, memory_format=torch.contiguous_format),\
            torch.zeros_like(v, memory_format=torch.contiguous_format)
    dk = torch.empty((B, KV, Sk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, KV, Sk, D), dtype=q.dtype, device=q.device)
    pad = -(-S // BWD_ROW_PAD) * BWD_ROW_PAD
    torch.empty(2 * B * H * pad, dtype=torch.float32, device=q.device)
    return dq, dk, dv
