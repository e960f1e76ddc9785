"""whisper-tiny's encoder-decoder transformer (the reference's
``models/whisper.py``), served through ``prefill`` and ``decode_step``
and trained through ``train_loss``.

The conv/mel frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings [B, enc_seq, d], and sinusoidal positions
are added here (to the decoder's tokens as well).  The encoder's
self-attention is non-causal over the frames, the decoder's causal over
the prompt, and each decoder layer cross-attends from the prompt to the
encoder's output: all three through the flash kernel in prefill (the
cross call with a key length of its own, ``enc_seq``), and in a decode
step the self and the cross attention through the decode kernel.  The
cross K/V are computed once, in prefill, and kept in the cache.

Parameters follow the reference's tree: ``embed`` (the tied table),
``enc`` and ``dec`` (lists of layers with ``ln1``, ``attn``, ``ln2``,
``mlp``, and on decoder layers ``ln_x`` and ``xattn``), ``enc_norm`` and
``dec_norm``.  Weight matrices are held in the compute dtype (float32
masters for training), layer-norm scales and biases and the qkv biases
in float32, as ``TransformerLM`` holds them.  The decode cache is one dict a decoder layer: the self
cache ``k`` / ``v`` [B, cache_len, KV, Dh] and ``cross_k`` / ``cross_v``
[B, enc_seq, KV, Dh] (the reference nests the self cache under
``self``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (cross_entropy, embed_init,
                                       embed_lookup, layernorm,
                                       layernorm_init, lm_head, mlp,
                                       mlp_init)

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """pos [...] int -> [..., d] sinusoidal embedding (sines, then
    cosines), in float32."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    inv = torch.exp(-math.log(10000.0) * dim / d)
    ang = pos.to(torch.float32)[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class WhisperLM:
    """Functional encoder-decoder on ``device`` (``None`` = the card;
    raises without one): parameters are plain dicts of tensors, the
    methods pure except that ``decode_step`` writes the new self K/V into
    the cache in place."""

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        if cfg.family != "audio":
            raise ValueError(f"WhisperLM serves family 'audio', not "
                             f"{cfg.family!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]

    # ------------------------------------------------------------------
    def _layer_init(self, generator: torch.Generator, cross: bool,
                    dtype: torch.dtype) -> Params:
        cfg, a, dev = self.cfg, self.cfg.attention, generator.device

        def attn():
            return attn_mod.attn_init(cfg.d_model, a.n_heads, a.n_kv_heads,
                                      cfg.head_dim, True, generator, dtype)

        p = {"ln1": layernorm_init(cfg.d_model, dev),
             "ln2": layernorm_init(cfg.d_model, dev),
             "attn": attn(),
             "mlp": mlp_init(cfg.d_model, cfg.d_ff, cfg.glu, generator,
                             dtype)}
        if cross:
            p["ln_x"] = layernorm_init(cfg.d_model, dev)
            p["xattn"] = attn()
        return p

    def init(self, generator: torch.Generator,
             dtype: Optional[torch.dtype] = None) -> Params:
        """Random parameters drawn tensor by tensor on the generator's
        device (which must be the model's), matrices in ``dtype``
        (default the compute dtype)."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        dtype = dtype or self.dtype
        return {
            "embed": embed_init(cfg.vocab_size, cfg.d_model, generator,
                                dtype),
            "enc": [self._layer_init(generator, False, dtype)
                    for _ in range(cfg.enc_layers)],
            "dec": [self._layer_init(generator, True, dtype)
                    for _ in range(cfg.n_layers)],
            "enc_norm": layernorm_init(cfg.d_model, self.device),
            "dec_norm": layernorm_init(cfg.d_model, self.device),
        }

    # ------------------------------------------------------------------
    def _positions(self, batch: int, s: int) -> torch.Tensor:
        pos = torch.arange(s, dtype=torch.int32, device=self.device)
        return pos[None, :].expand(batch, s)

    def _with_positions(self, x: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
        return x + sinusoid_at(pos, self.cfg.d_model).to(self.dtype)

    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, enc_seq, d] (precomputed embeddings) -> the
        encoder's output [B, enc_seq, d]: non-causal self-attention."""
        x = frames.to(self.dtype)
        pos = self._positions(*x.shape[:2])
        x = self._with_positions(x, pos)
        for p in params["enc"]:
            h = layernorm(p["ln1"], x)
            x = x + attn_mod.attention(p["attn"], h, pos, causal=False,
                                       theta=0.0)[0]
            x = self._mlp(p, x)
        return layernorm(params["enc_norm"], x)

    def _mlp(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        return x + mlp(p["mlp"], layernorm(p["ln2"], x), self.cfg.act,
                       self.cfg.glu)

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return lm_head(params["embed"]["table"],
                       layernorm(params["dec_norm"], x))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def train_loss(self, params: Params, tokens: torch.Tensor,
                   labels: torch.Tensor, frames: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode ``frames``, then next-token cross-entropy over the
        decoder's prompt ``tokens`` / ``labels`` [B, S] (float32 scalar).
        The encoder's and the cross-attention's flash calls are
        non-causal, the cross one over the frames' own length."""
        enc_out = self.encode(params, frames)
        x = embed_lookup(params["embed"], tokens, self.dtype)
        pos = self._positions(*x.shape[:2])
        x = self._with_positions(x, pos)
        for p in params["dec"]:
            h = layernorm(p["ln1"], x)
            x = x + attn_mod.attention(p["attn"], h, pos, causal=True,
                                       theta=0.0)[0]
            xk = attn_mod.proj(p["xattn"], enc_out, "wk", "bk")
            xv = attn_mod.proj(p["xattn"], enc_out, "wv", "bv")
            x = x + attn_mod.attention(p["xattn"], layernorm(p["ln_x"], x),
                                       pos, causal=False, theta=0.0,
                                       kv=(xk, xv))[0]
            x = self._mlp(p, x)
        return cross_entropy(self._logits(params, x), labels, mask)

    def prefill(self, params: Params, tokens: torch.Tensor,
                frames: torch.Tensor,
                cache_len: int) -> Tuple[torch.Tensor, Cache]:
        """Encode ``frames``, then the prompt ``tokens`` [B, S] -> (last
        position's logits [B, V], decode-ready cache)."""
        enc_out = self.encode(params, frames)
        x = embed_lookup(params["embed"], tokens, self.dtype)
        pos = self._positions(*x.shape[:2])
        x = self._with_positions(x, pos)
        cache: Cache = []
        for p in params["dec"]:
            h = layernorm(p["ln1"], x)
            y, k, v = attn_mod.attention(p["attn"], h, pos, causal=True,
                                         theta=0.0)
            xk = attn_mod.proj(p["xattn"], enc_out, "wk", "bk")
            xv = attn_mod.proj(p["xattn"], enc_out, "wv", "bv")
            cache.append({"k": attn_mod.flat_cache(k, cache_len),
                          "v": attn_mod.flat_cache(v, cache_len),
                          "cross_k": xk, "cross_v": xv})
            x = x + y
            x = x + attn_mod.attention(p["xattn"], layernorm(p["ln_x"], x),
                                       pos, causal=False, theta=0.0,
                                       kv=(xk, xv))[0]
            x = self._mlp(p, x)
        return self._logits(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    pos: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens [B, 1]; pos [B, 1] int32; the cross K/V reused from the
        cache.  Returns (logits [B, V], the cache, updated in place)."""
        x = self._with_positions(
            embed_lookup(params["embed"], tokens, self.dtype), pos)
        for p, st in zip(params["dec"], cache):
            y, _ = attn_mod.decode_attention(p["attn"],
                                             layernorm(p["ln1"], x), pos, st,
                                             theta=0.0)
            x = x + y
            x = x + attn_mod.cross_decode_attention(
                p["xattn"], layernorm(p["ln_x"], x),
                (st["cross_k"], st["cross_v"]))
            x = self._mlp(p, x)
        return self._logits(params, x)[:, 0], cache

    def init_cache(self, batch: int, cache_len: int) -> Cache:
        """Zeroed decode cache, one dict a decoder layer."""
        cfg = self.cfg

        def zeros(s):
            return torch.zeros((batch, s, cfg.attention.n_kv_heads,
                                cfg.head_dim), dtype=self.dtype,
                               device=self.device)

        return [{"k": zeros(cache_len), "v": zeros(cache_len),
                 "cross_k": zeros(cfg.enc_seq), "cross_v": zeros(cfg.enc_seq)}
                for _ in range(cfg.n_layers)]


__all__ = ["WhisperLM", "sinusoid_at"]
