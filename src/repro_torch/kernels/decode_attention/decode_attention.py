"""CUDA wrapper for one decode step's attention
(``csrc/decode_attention.cu``).

Replaces the Pallas kernel ``src/repro/kernels/decode_attention/
decode_attention.py`` (``decode_attention``): one query token per
sequence, its G = H / KV query heads packed per kv head, against the KV
cache with an online softmax over the slots; slot ``s`` of sequence
``b`` is valid iff ``s <= pos[b]``; optional tanh softcap; float32 math
from float32 or bfloat16 inputs, output in ``q.dtype``.  Bound by bytes
(the cache rows up to ``pos[b]``, read once).  Split-KV: the slot axis
is cut into ``decode_splits`` ranges; one block per (b, kv head, range)
streams only the slots ``<= pos[b]`` of its range (bulk copies into a
shared-memory ring) into a float32 partial (workspace from
``torch.empty``), and a second kernel merges the partials in split
order.  bfloat16 with more than 8 query heads a kv head forms q kᵀ and
P V on the tensor cores (``mma.sync``); other shapes on the SIMT cores.
A call is two CUDA launches, counted once in ``launches``, and is
deterministic launch to launch.  With ``return_lse`` the merge also
writes each query head's log-sum-exp of its masked logits (``-inf``
where no slot is valid) and the output in float32, so the partial
results of a cache split over ``model`` merge across it in float32
(``models.attention.decode_attention_seq_kv``); rounded to the inputs'
dtype, that output is the call without ``return_lse`` bit for bit.  A
row whose ``pos`` is negative has no valid slot and gives 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS, check_operand)

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 6 + [ctypes.c_float] * 2
             + [ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 16         # query heads per kv head the kernel holds
#: the shortest split, in slots: below it a block's fixed cost (q, the
#: ring's fill, its partial and their merge) outweighs its slots
MIN_SPLIT = 32
MAX_SPLITS = 4096      # the merge kernel's weights in shared memory
#: blocks of the split kernel an SM holds at once (96 registers a thread,
#: 288 threads, 96 KB of ring in bfloat16)
BLOCKS_PER_SM = 2


def decode_splits(B: int, KV: int, S: int, n_sm: int):
    """(splits, slots a split) for a cache of ``S`` slots.  The (B * KV) x
    splits blocks fill at least two waves of ``n_sm`` SMs; among up to
    twice that many splits, the count that leaves the fewest idle places
    in the last round of ``BLOCKS_PER_SM`` resident blocks an SM is taken
    (the fewest splits on a tie).  No split is shorter than ``MIN_SPLIT``
    slots.  The splits ``[j L, min((j + 1) L, S))`` cover ``[0, S)``;
    shapes only, never ``pos``."""
    rows, resident = B * KV, BLOCKS_PER_SM * n_sm
    least = max(1, -(-2 * n_sm // rows))
    best = None
    for want in range(least, 2 * least + 1):
        length = max(-(-S // want), MIN_SPLIT, -(-S // MAX_SPLITS))
        n = -(-S // length)
        blocks = rows * n
        idle = -(-blocks // resident) * resident - blocks
        if best is None or idle * best[2] < best[0] * blocks:
            best = (idle, (n, length), blocks)
    return best[1]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, cap: float = 0.0,
                     return_lse: bool = False):
    """q [B,KV,G,D] contiguous (G <= 16; D in 16, 32, 64, 128, 256); k/v
    [B,KV,S,D] (strided views allowed with D contiguous); pos [B] int32
    (negative: no valid slot); float32 or bfloat16, all on one CUDA
    device -> [B,KV,G,D] in ``q.dtype`` (with ``return_lse`` the pair
    (out float32, lse float32 [B,KV,G])), on the current stream without
    synchronising.  Raises
    under grad: training never decodes, and no backward is planned
    (ROADMAP queue 1 item 14.4)."""
    refuse_grad("decode_attention", "14.4 (training runs prefill "
                "attention only)", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or pos.dim() != 1:
        raise ValueError(f"decode_attention: want q [B,KV,G,D], k/v "
                         f"[B,KV,S,D], pos [B]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(pos.shape)}")
    B, KV, G, D = q.shape
    S = k.shape[2]
    if q.dtype not in _DTYPES or D not in HEAD_DIMS or not \
            1 <= G <= MAX_GROUP:
        raise ValueError(f"decode_attention: dtype {q.dtype} (want float32 "
                         f"or bfloat16), head dim {D} (want {HEAD_DIMS}), "
                         f"group {G} (want 1..{MAX_GROUP})")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    check_operand("decode_attention", "q", q, q, (B, KV, G, D), 8)
    for name, t in (("k", k), ("v", v)):
        check_operand("decode_attention", name, t, q, (B, KV, S, D), 8)
    if pos.device != q.device or pos.dtype != torch.int32 or \
            tuple(pos.shape) != (B,) or not pos.is_contiguous():
        raise ValueError(f"decode_attention: pos must be a contiguous CUDA "
                         f"int32 tensor of shape ({B},) on {q.device}; got "
                         f"{pos.device} {pos.dtype} {tuple(pos.shape)}")
    out, lse = _outputs(q, return_lse)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    scale = 1.0 / math.sqrt(D)
    n_split, length = decode_splits(B, KV, S, sm_count(q.device))
    part_acc = torch.empty((B * KV * n_split * G * D,), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B * KV * n_split * 2 * G,), dtype=torch.float32,
                          device=q.device)
    lib = _build.load("decode_attention")
    fn = lib.repro_decode_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                 out.data_ptr(), lse.data_ptr() if return_lse else None,
                 part_acc.data_ptr(), part_ml.data_ptr(), B,
                 KV, G, S, D, length, n_split, _DTYPES[q.dtype],
                 *k.stride()[:3], *v.stride()[:3], float(scale), float(cap),
                 stream)
    _build.check_launch(lib, "decode_attention", err)
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0


def _outputs(q: torch.Tensor, return_lse: bool):
    """(out, lse or None): out in ``q.dtype``, or float32 with the lse."""
    if not return_lse:
        return torch.empty_like(q), None
    return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
            torch.empty(q.shape[:3], dtype=torch.float32, device=q.device))


def decode_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor, *, cap: float = 0.0,
                          return_lse: bool = False):
    """``decode_attention`` on ``meta``: the output's shape and dtype, the
    split partials the card's wrapper allocates (``decode_splits`` at the
    H100 SXM's SMs); no launch, no arithmetic."""
    del v, pos, cap
    refuse_grad("decode_attention", "14.4 (training runs prefill "
                "attention only)", q, k)
    B, KV, G, D = q.shape
    S = k.shape[2]
    out, lse = _outputs(q, return_lse)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    n_split, _ = decode_splits(B, KV, S, sm_count(q.device))
    torch.empty((B * KV * n_split * G * D,), dtype=torch.float32,
                device=q.device)
    torch.empty((B * KV * n_split * 2 * G,), dtype=torch.float32,
                device=q.device)
    return (out, lse) if return_lse else out
