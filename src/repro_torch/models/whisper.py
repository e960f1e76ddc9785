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
from repro_torch.models.layers import (cross_entropy, cross_entropy_sharded,
                                       embed_init, embed_lookup,
                                       embed_lookup_sharded, layernorm,
                                       layernorm_init, lm_head,
                                       lm_head_sharded, mlp, mlp_init,
                                       mlp_sharded)
from repro_torch.models.transformer import ShardedCache, ShardedModel
from repro_torch.parallel.param_sharding import kv_model_dim

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


def cross_layout(cfg: ArchConfig, sp) -> str:
    """How ``param_sharding.cache_shardings`` holds the cross K/V
    ``[B, enc_seq, KV, Dh]`` on ``sp``'s mesh (``kv_model_dim``): by
    ``slots`` where ``model`` divides the frames (under
    ``seq_shard_kv``), by ``heads`` where it divides the KV heads, else
    ``whole``."""
    dim = kv_model_dim((1, cfg.enc_seq, cfg.attention.n_kv_heads,
                        cfg.head_dim), sp.mesh.shape["model"], sp.seq_kv)
    return {1: "slots", 2: "heads", None: "whole"}[dim]


def _add(xs, ys):
    return [a + b for a, b in zip(xs, ys)]


class WhisperLM(ShardedModel):
    """Functional encoder-decoder on ``device`` (``None`` = the card;
    raises without one): parameters are plain dicts of tensors, the
    methods pure except that ``decode_step`` writes the new self K/V into
    the cache in place.

    Under ``use_mesh_rules`` with the reference's rules the program runs
    sharded where ``transformer.mesh_layout_gap`` says it does: training
    and prefill under ``attn_seq_shard`` (the decoder's rows over
    ``model``, and the encoder's frames, padded at the end to a multiple
    of |model|; weights FSDP-only, gathered at use; the self-attention
    causal at each position's query offset, the encoder's and the cross
    attention non-causal over K/V all-gathered and cut to the real
    frames), prefill and decode under ``seq_shard_kv`` (the self cache by
    slots, the cross cache as ``cross_layout`` says; a decode step's MLP
    column-parallel over ``model``).  The cache is then a
    ``ShardedCache`` of the four-tensor layer dicts."""

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
        non-causal, the cross one over the frames' own length.  Under a
        mesh whose rules give the sharded program it runs sharded
        (``train_loss_sharded``)."""
        sp = self.spmd("train", tokens.shape[0])
        if sp is not None:
            from repro_torch.parallel.param_sharding import shard_params
            return self.train_loss_sharded(
                sp, shard_params(sp, params), self._rows(sp, tokens),
                self._rows(sp, labels), self._rows(sp, frames),
                self._rows(sp, mask))
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
        position's logits [B, V], decode-ready cache; a ``ShardedCache``
        under a mesh whose rules give the sharded program, ``params`` then
        possibly held by position already)."""
        sp = self.spmd("prefill", tokens.shape[0])
        if sp is not None:
            return self._prefill_sharded(sp, params, tokens, frames,
                                         cache_len)
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
        cache.  Returns (logits [B, V], the cache, updated in place; a
        ``ShardedCache`` under a mesh, as ``prefill``)."""
        sp = self.spmd("decode", tokens.shape[0])
        if sp is not None:
            return self._decode_sharded(sp, params, tokens, pos, cache)
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

    # ------------------------------------------------------------------
    # the sharded program (under ``use_mesh_rules``)
    # ------------------------------------------------------------------
    def _norm_sharded(self, p, name: str, x):
        """Layer norm on each position's rows, its scale and bias
        gathered."""
        q = p.sub(name)
        return [layernorm({"scale": a, "bias": b}, xk) for a, b, xk in
                zip(q.gather("scale"), q.gather("bias"), x)]

    def _mlp_sharded(self, sp, p, x):
        h = self._norm_sharded(p, "ln2", x)
        return _add(x, mlp_sharded(sp, p.sub("mlp"), h, self.cfg.act,
                                   self.cfg.glu))

    def _block_rows(self, sp, xs, total: int):
        """Each position's block of its rows ``xs`` of a sequence of
        ``total`` rows (``_row_block``), and their positions."""
        out, pos = [], []
        for k, x in enumerate(xs):
            lo, c = self._row_block(sp, k, total)
            out.append(x[:, lo:lo + c])
            p_ = torch.arange(lo, lo + c, dtype=torch.int32,
                              device=sp.device(k))
            pos.append(p_[None, :].expand(x.shape[0], c))
        return out, pos

    def _encode_sharded(self, sp, P, frames):
        """The encoder on the positions' frames (their batch rows): the
        frames padded at the end to a multiple of |model| and split over
        it, each position's rows through the layers, the K/V gathered and
        cut to the real frames.  Returns (the positions' rows of the
        encoder's output, the real frames)."""
        f = frames[0].shape[1]
        pad = -f % sp.mesh.shape["model"] if sp.seq_rows else 0
        if pad:
            frames = [torch.cat([x, x.new_zeros((x.shape[0], pad,
                                                 x.shape[2]))], dim=1)
                      for x in frames]
        x, pos = self._block_rows(sp, frames, f + pad)
        x = [self._with_positions(xk.to(self.dtype), pk)
             for xk, pk in zip(x, pos)]
        for i in range(self.cfg.enc_layers):
            p = P.sub("enc", i)
            h = self._norm_sharded(p, "ln1", x)
            y, _, _ = attn_mod.attention_seq_sharded(
                sp, p.sub("attn"), h, pos, causal=False, theta=0.0, keys=f)
            x = self._mlp_sharded(sp, p, _add(x, y))
        return self._norm_sharded(P, "enc_norm", x), f

    def _decoder_rows(self, sp, P, tokens, enc, frames: int,
                      cache_len: int = 0, real: int = 0):
        """The decoder on the positions' token rows (their blocks of the
        sequence) over the encoder's rows ``enc``: (the positions' output
        rows, their cache blocks when ``cache_len``: the self cache of the
        ``real`` rows by slots, the cross cache as ``cross_layout``)."""
        cfg, a = self.cfg, self.cfg.attention
        s = tokens[0].shape[1] * (sp.mesh.shape["model"] if sp.seq_rows
                                  else 1)
        x = embed_lookup_sharded(sp, P.sub("embed"), tokens, self.dtype)
        _, pos = self._block_rows(sp, x, s)
        x = [self._with_positions(xk, pk) for xk, pk in zip(x, pos)]
        layout = cross_layout(cfg, sp)
        caches: List[Cache] = [[] for _ in range(sp.n)]
        for i in range(cfg.n_layers):
            p = P.sub("dec", i)
            h = self._norm_sharded(p, "ln1", x)
            y, ks, vs = attn_mod.attention_seq_sharded(
                sp, p.sub("attn"), h, pos, causal=True, theta=0.0)
            xk, xv = attn_mod.kv_seq_sharded(sp, p.sub("xattn"), enc, frames)
            if cache_len:
                for k in range(sp.n):
                    blk = attn_mod.cache_block(sp, k, {
                        "k": attn_mod.flat_cache(ks[k][:, :real], cache_len),
                        "v": attn_mod.flat_cache(vs[k][:, :real], cache_len)},
                        a.n_heads, a.n_kv_heads)
                    blk.update(self._cross_block(sp, k, xk[k], xv[k], layout))
                    caches[k].append(blk)
            x = _add(x, y)
            hx = self._norm_sharded(p, "ln_x", x)
            y, _, _ = attn_mod.attention_seq_sharded(
                sp, p.sub("xattn"), hx, pos, causal=False, theta=0.0,
                kv=(xk, xv))
            x = self._mlp_sharded(sp, p, _add(x, y))
        return x, caches

    def _cross_block(self, sp, k: int, xk, xv, layout: str):
        """Position ``k``'s block of the whole cross K/V (its rows), as
        ``cross_layout`` holds it."""
        a, n = self.cfg.attention, sp.mesh.shape["model"]
        m = sp.index(k)["model"]
        out = {}
        for name, t in (("cross_k", xk), ("cross_v", xv)):
            if layout == "slots":
                c = t.shape[1] // n
                t = t.narrow(1, m * c, c)
            elif layout == "heads":
                _, _, lo, cnt = attn_mod.local_heads(a.n_heads, a.n_kv_heads,
                                                     n, m)
                t = t.narrow(2, lo, cnt)
            out[name] = t.contiguous()
        return out

    def _logits_sharded(self, sp, P, x):
        """(each position's logits, whether the vocabulary is split over
        ``model``: decode's rules split a table ``model`` divides; under
        ``attn_seq_shard`` each position reads the whole table)."""
        x = self._norm_sharded(P, "dec_norm", x)
        emb = P.sub("embed")
        vp = emb.spec("table")[0] == "model" and not sp.seq_rows
        return lm_head_sharded(sp, emb.gather("table"), x, 0.0, vp), vp

    def train_loss_sharded(self, sp, P, tokens, labels, frames,
                           mask=None) -> torch.Tensor:
        """``train_loss`` on the positions' blocks: ``P`` the parameters
        held by position, ``tokens`` / ``labels`` / ``frames`` / ``mask``
        the positions' batch rows.  The loss is the mean over every
        token of the batch axes and ``model``."""
        enc, f = self._encode_sharded(sp, P, frames)
        s = tokens[0].shape[1]
        toks, _ = self._block_rows(sp, tokens, s)
        labels, _ = self._block_rows(sp, labels, s)
        if mask is not None:
            mask, _ = self._block_rows(sp, mask, s)
        x, _ = self._decoder_rows(sp, P, toks, enc, f)
        logits, vp = self._logits_sharded(sp, P, x)
        return cross_entropy_sharded(sp, logits, labels, mask, vp)

    def _prefill_sharded(self, sp, params, tokens, frames, cache_len: int):
        P = self._held(sp, params)
        real = tokens.shape[1]
        pad = -real % sp.mesh.shape["model"]
        if pad:                 # past every real row's causal reach
            tokens = torch.cat([tokens, tokens.new_zeros(
                (tokens.shape[0], pad))], dim=1)
        enc, f = self._encode_sharded(sp, P, self._rows(sp, frames))
        s = tokens.shape[1]
        toks, _ = self._block_rows(sp, self._rows(sp, tokens), s)
        x, caches = self._decoder_rows(sp, P, toks, enc, f, cache_len, real)
        c = s // sp.mesh.shape["model"]
        owner, last = divmod(real - 1, c)
        x = [xk[:, min(last, xk.shape[1] - 1)][:, None] for xk in x]
        # the owner's row sent to one position, the head's logits then
        # all-reduced (``from_index``), as ``TransformerLM`` does
        sp.charge("collective-permute", x[0].numel() * x[0].element_size(),
                  "model")
        logits, vp = self._logits_sharded(sp, P, x)
        logits = sp.from_index([t[:, 0] for t in logits], "model", owner)
        return self._logits_out(sp, logits, vp), ShardedCache(sp, caches)

    def _cache_blocks(self, sp, cache: Cache) -> List[Cache]:
        """A whole decode cache's blocks by position: the self cache by
        slots (``attention.cache_view``), the cross cache as
        ``cross_layout``."""
        a = self.cfg.attention
        layout = cross_layout(self.cfg, sp)
        out = []
        for k in range(sp.n):
            layers = []
            for st in cache:
                rows = {n: sp.block(t, (sp.batch_entry(),), k, copy=False)
                        for n, t in st.items()}
                blk = {n: attn_mod.cache_view(sp, k, rows[n], a.n_heads,
                                              a.n_kv_heads)
                       for n in ("k", "v")}
                blk.update(self._cross_block(sp, k, rows["cross_k"],
                                             rows["cross_v"], layout))
                if not sp.one_position:
                    blk = {n: t.contiguous().to(sp.device(k))
                           for n, t in blk.items()}
                layers.append(blk)
            out.append(layers)
        return out

    def _decode_sharded(self, sp, params, tokens, pos, cache):
        if not isinstance(cache, ShardedCache):
            cache = ShardedCache(sp, self._cache_blocks(sp, cache))
        P = self._held(sp, params)
        x = embed_lookup_sharded(sp, P.sub("embed"), self._rows(sp, tokens),
                                 self.dtype)
        pos = self._rows(sp, pos)
        x = [self._with_positions(xk, pk) for xk, pk in zip(x, pos)]
        layout = cross_layout(self.cfg, sp)
        for i in range(self.cfg.n_layers):
            p = P.sub("dec", i)
            st = [c[i] for c in cache.blocks]
            h = self._norm_sharded(p, "ln1", x)
            y, _ = attn_mod.decode_attention_seq_kv(sp, p.sub("attn"), h, pos,
                                                    st, theta=0.0)
            x = _add(x, y)
            hx = self._norm_sharded(p, "ln_x", x)
            x = _add(x, attn_mod.cross_decode_sharded(
                sp, p.sub("xattn"), hx,
                [(c["cross_k"], c["cross_v"]) for c in st], layout))
            x = self._mlp_sharded(sp, p, x)
        logits, vp = self._logits_sharded(sp, P, x)
        return self._logits_out(sp, [t[:, 0] for t in logits], vp), cache

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


__all__ = ["WhisperLM", "cross_layout", "sinusoid_at"]
