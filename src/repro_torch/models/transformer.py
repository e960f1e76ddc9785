"""Layer-stacked LM for the dense families (minicpm, phi4, qwen1.5,
gemma2's alternating local/global attention with softcaps), the MoE
family (granite-moe, olmoe), griffin (recurrentgemma: two RG-LRU blocks
to one local-attention block), xLSTM (family ``ssm``, xlstm-350m:
sLSTM and mLSTM blocks alternating) and the VLM (qwen2-vl: M-RoPE, and
patch embeddings from a stub frontend prepended to the prompt), served
through ``prefill`` and ``decode_step``, and trained through
``train_loss`` (every family here, the MoE loss with its
load-balancing term).  Family ``audio`` is
``models.whisper.WhisperLM``.

The kind sequence comes from ``core.cost_model._block_kinds``, as in the
reference.  Parameters are a dict with ``embed`` (``table [V, d]``),
``final_norm``, ``head`` (untied only) and ``layers``, a list of one
block's params per layer in layer order; the reference stacks layers per
period slot instead (``convert.lm_params_from_arrays`` interleaves).
Serving holds weight matrices in the compute dtype (``cfg.dtype``), norm
scales and qkv biases in float32: the reference casts each weight to the
compute dtype at use, so the results agree and the memory is half.
Training holds float32 master weights (``init(dtype=torch.float32)``);
the layers cast each to the compute dtype at use, as the reference's
``_cast_compute`` does once a step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost_model import _block_kinds as block_kinds
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.blocks import Ctx, block_def
from repro_torch.models.layers import (cross_entropy, embed_init,
                                       embed_lookup, lm_head, rmsnorm,
                                       rmsnorm_init, truncated_normal)
from repro_torch.tree import leaves_with_paths

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: layers a period of the reference's scanned stack, by attention pattern
#: (xLSTM's period is 2)
_PERIOD = {"full": 1, "local": 1, "alternating": 2, "griffin": 3}


class TransformerLM:
    """Functional LM on ``device`` (``None`` = the card; raises without
    one): parameters are plain dicts of tensors, the methods pure except
    that ``decode_step`` writes the new K/V into the cache in place (an
    RG-LRU or xLSTM layer's state is replaced)."""

    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        if cfg.family == "audio":
            raise ValueError("use repro_torch.models.whisper.WhisperLM")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kinds = block_kinds(cfg)
        self.blocks = [block_def(k) for k in self.kinds]
        self.dtype = _DTYPES[cfg.dtype]
        # gemma scales embeddings by sqrt(d) rounded to the compute dtype
        self.embed_scale = float(torch.tensor(math.sqrt(cfg.d_model),
                                              dtype=self.dtype)) \
            if cfg.name.startswith(("gemma", "recurrentgemma")) else None

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator,
             dtype: Optional[torch.dtype] = None) -> Params:
        """Random parameters drawn tensor by tensor on the generator's
        device (which must be the model's), each in float32 and then cast
        to its held dtype: the weight matrices' is ``dtype`` (default the
        compute dtype; training passes float32 for master weights)."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        dtype = dtype or self.dtype
        params: Params = {
            "embed": embed_init(cfg.vocab_size, cfg.d_model, generator,
                                dtype),
            "final_norm": rmsnorm_init(cfg.d_model, self.device),
            "layers": [blk.init(cfg, generator, dtype)
                       for blk in self.blocks],
        }
        if not cfg.tie_embeddings:
            params["head"] = {"w": truncated_normal(
                (cfg.vocab_size, cfg.d_model), 1.0 / math.sqrt(cfg.d_model),
                generator, dtype)}
        return params

    def stacked_groups(self, params: Params) -> List[List[int]]:
        """Leaf indices of ``params`` (in ``tree.leaves`` order) that the
        reference holds as one stacked leaf: the same leaf of the layers
        ``j * period + i`` for each period slot i (its ``rem`` layers and
        everything outside ``layers`` alone).  ``grad_compress`` scales a
        group as the reference scales its stacked tensor."""
        cfg = self.cfg
        period = 2 if cfg.family == "ssm" else _PERIOD[cfg.attention.pattern]
        n_scan = cfg.n_layers // period * period
        groups: Dict[Any, List[int]] = {}
        for i, (path, _) in enumerate(leaves_with_paths(params)):
            key: Any = path
            if path.startswith("['layers']["):
                j, rest = path[len("['layers']["):].split("]", 1)
                j = int(j)
                key = ("slot", j % period, rest) if j < n_scan else path
            groups.setdefault(key, []).append(i)
        return list(groups.values())

    # ------------------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor,
               extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = embed_lookup(params["embed"], tokens, self.dtype)
        if self.embed_scale is not None:
            x = x * self.embed_scale
        if extra_embeds is not None:       # vlm patch embeddings (stub)
            x = torch.cat([extra_embeds.to(self.dtype), x], dim=1)
        return x

    def _mrope_axes(self, pos: torch.Tensor) -> torch.Tensor:
        """[B, S] positions -> [B, S, 3] (t, h, w all the text position)
        under M-RoPE, else unchanged."""
        if self.cfg.attention.mrope_sections:
            return pos[..., None].expand(*pos.shape, 3)
        return pos

    def _positions(self, batch: int, s: int) -> torch.Tensor:
        pos = torch.arange(s, dtype=torch.int32, device=self.device)
        return self._mrope_axes(pos[None, :].expand(batch, s))

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        table = params["embed"]["table"] if cfg.tie_embeddings \
            else params["head"]["w"]
        return lm_head(table, x, cfg.final_logit_softcap)

    def _run_stack_train(self, params: Params, x: torch.Tensor,
                         ctx: Ctx) -> Tuple[torch.Tensor, torch.Tensor]:
        """The train path: every layer, no cache in or out; returns the
        output and the layers' auxiliary losses summed in layer order (a
        float32 scalar).  With ``cfg.remat`` other than ``none`` each layer
        is a ``torch.utils.checkpoint`` region, its activations recomputed
        in the backward (the reference wraps its scanned layer body in
        ``jax.checkpoint``); the aux loss leaves the region as one of its
        outputs, so its gradient flows back through the recompute."""
        remat = self.cfg.remat != "none"
        aux = x.new_zeros((), dtype=torch.float32)
        for blk, p in zip(self.blocks, params["layers"]):
            if remat:
                x, a = checkpoint(blk.apply, p, x, None, ctx,
                                  use_reentrant=False)
            else:
                x, a = blk.apply(p, x, None, ctx)
            aux = aux + a
        return x, aux

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def train_loss(self, params: Params, tokens: torch.Tensor,
                   labels: torch.Tensor,
                   extra_embeds: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Next-token cross-entropy (float32 scalar): tokens / labels
        [B, S_text]; ``extra_embeds`` [B, P, d] (the VLM's patches) go in
        front and the loss is taken on the text positions only.  With MoE
        layers the loss adds ``aux_loss_weight`` times the layers' mean
        load-balancing loss, as the reference does."""
        x = self._embed(params, tokens, extra_embeds)
        b, s = x.shape[:2]
        ctx = Ctx(self.cfg, "train", self._positions(b, s))
        x, aux = self._run_stack_train(params, x, ctx)
        if extra_embeds is not None:       # loss only on the text positions
            x = x[:, extra_embeds.shape[1]:]
        loss = cross_entropy(self._head(params, x), labels, mask)
        if self.cfg.moe.enabled:
            loss = loss + self.cfg.moe.aux_loss_weight * \
                aux / max(self.cfg.n_layers, 1)
        return loss

    def prefill(self, params: Params, tokens: torch.Tensor,
                cache_len: int,
                extra_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """tokens [B, S] -> (last-position logits [B, V], decode-ready
        cache: one state per layer, ``{"k", "v"}`` for attention,
        ``{"h", "conv"}`` for an RG-LRU block, ``{"C", "n", "m"}`` for an
        mLSTM block and ``{"c", "n", "h", "m"}`` for an sLSTM block).
        ``extra_embeds`` [B, P, d] (the VLM's patch embeddings) are put in
        front of the prompt: the sequence is P + S long, and decoding goes
        on at position P + S."""
        x = self._embed(params, tokens, extra_embeds)
        b, s = x.shape[:2]
        ctx = Ctx(self.cfg, "prefill", self._positions(b, s),
                  cache_len=cache_len)
        cache: Cache = []
        for blk, p in zip(self.blocks, params["layers"]):
            x, st = blk.apply(p, x, None, ctx)
            cache.append(st)
        return self._head(params, x[:, -1:])[:, 0], cache

    def decode_step(self, params: Params, tokens: torch.Tensor,
                    pos: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """One token per sequence.  tokens [B, 1]; pos [B, 1] int32.
        Returns (logits [B, V], the cache, updated in place)."""
        x = self._embed(params, tokens)
        ctx = Ctx(self.cfg, "decode", self._mrope_axes(pos))
        for i, (blk, p) in enumerate(zip(self.blocks, params["layers"])):
            x, cache[i] = blk.apply(p, x, cache[i], ctx)
        return self._head(params, x)[:, 0], cache

    def init_cache(self, batch: int, cache_len: int) -> Cache:
        """Zeroed decode cache, one state per layer."""
        return [blk.state_init(self.cfg, batch, self.dtype, cache_len,
                               self.device) for blk in self.blocks]


__all__ = ["TransformerLM"]
