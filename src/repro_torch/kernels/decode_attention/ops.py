"""Public entry for one decode step's attention: the model's layouts (q
``[B, 1, H, D]``, caches ``[B, S, KV, D]``) in and out.

The query heads are grouped by kv head (``[B, KV, G, D]``, a view) and
the caches are passed as transposed ``[B, KV, S, D]`` views: the CUDA
kernel reads any strides over (B, KV, S) with the head dimension
contiguous, so no step copies the cache.  The call runs in the profiler
range ``attention.decode``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import charge, charged_unit
from repro_torch.kernels.decode_attention.decode_attention import (
    decode_attention, decode_attention_meta)
from repro_torch.kernels.decode_attention.ref import decode_ref

#: tensor device type -> implementation: CUDA launches the kernel (or
#: raises), the CPU takes the plain version, ``meta`` makes the output's
#: shape; nothing falls back
_BY_DEVICE = {"cuda": decode_attention, "cpu": decode_ref,
              "meta": decode_attention_meta}


@charged_unit
def decode_mha(q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: torch.Tensor, *,
               cap: float = 0.0, return_lse: bool = False):
    """q [B,1,H,D]; caches [B,S,KV,D]; pos [B] int32 -> [B,1,H,D]; with
    ``return_lse`` the pair (out float32, lse float32 [B,H]): each head's
    log-sum-exp of its masked logits, ``-inf`` (and out 0) for a row
    whose ``pos`` is negative."""
    fn = _BY_DEVICE.get(q.device.type)
    if fn is None:
        raise ValueError(f"decode_mha: unsupported device {q.device}")
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    qg = q[:, 0].reshape(b, kv, h // kv, d).contiguous()
    kt, vt = k_cache.transpose(1, 2), v_cache.transpose(1, 2)
    charge("decode_attention", qg, kt, vt, pos, cap=cap,
           return_lse=return_lse)
    with torch.profiler.record_function("attention.decode"):
        out = fn(qg, kt, vt, pos, cap=cap, return_lse=return_lse)
    if return_lse:
        return out[0].reshape(b, 1, h, d), out[1].reshape(b, h)
    return out.reshape(b, 1, h, d)


__all__ = ["decode_mha"]
