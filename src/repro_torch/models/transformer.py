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

Under ``use_mesh_rules`` with the reference's FSDP x TP rules the dense,
MoE, VLM, hybrid and xLSTM families run sharded (``mesh_layout_gap`` says
where they do; whisper's sharded program is ``WhisperLM``'s): each mesh position runs its block of every layer in turn
(``parallel.sharding.Spmd``), prefill and decode hold the KV cache by
heads, or by slots under ``seq_shard_kv`` (``ShardedCache``), and
``train_loss_sharded`` is the training program ``make_train_step`` runs
on the positions' parameter blocks.  Under ``attn_seq_shard`` (dense,
VLM and xLSTM) the rows of the sequence, the VLM's patch embeddings in
front, are split over ``model`` (a prefill whose rows ``model`` does not
divide is padded at the end, past every real row's causal reach; an
xLSTM position runs its recurrence on its real rows only, so the state
it hands on stops at the last real row).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost_model import _block_kinds as block_kinds
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import cache_view, local_heads
from repro_torch.models.blocks import Ctx, block_def
from repro_torch.models.layers import (cross_entropy, cross_entropy_sharded,
                                       embed_init, embed_lookup,
                                       embed_lookup_sharded, lm_head,
                                       lm_head_sharded, rmsnorm,
                                       rmsnorm_init, truncated_normal)
from repro_torch.models.recurrent import state_block
from repro_torch.parallel.param_sharding import ShardedTree, shard_params
from repro_torch.parallel.sharding import (PartitionSpec, Spmd,
                                           current_mesh, current_spmd,
                                           logical_spec, rule_splits)
from repro_torch.tree import leaves_with_paths

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: layers a period of the reference's scanned stack, by attention pattern
#: (xLSTM's period is 2)
_PERIOD = {"full": 1, "local": 1, "alternating": 2, "griffin": 3}


#: the families the port runs under a mesh's layouts (``audio`` is
#: ``models.whisper.WhisperLM``)
SHARDED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")
#: the layout a family or a rule needs that the port does not run yet,
#: and its ROADMAP item
MISSING_LAYOUT = {
    "attn_seq_shard_moe": "ROADMAP queue 1 item 25.4",
    "attn_seq_shard_hybrid": "ROADMAP queue 1 item 25.4",
    "audio_heads": "ROADMAP queue 1 item 25.5",
    "ssm_heads": "ROADMAP queue 1 item 25.5",
}


def _heads_split(cfg: ArchConfig, n_model: int) -> bool:
    """Whether ``model`` splits the heads into blocks that read whole KV
    groups (``local_heads``)."""
    try:
        local_heads(cfg.attention.n_heads, cfg.attention.n_kv_heads,
                    n_model, 0)
    except ValueError:
        return False
    return True


def mesh_layout_gap(cfg: ArchConfig, mesh, kind: str,
                    batch: Optional[int] = None) -> Optional[str]:
    """None where the current rules on ``mesh`` give ``cfg``'s ``kind``
    program (``train``, ``prefill``, ``decode``) the port's sharded
    layouts (FSDP over ``data``; heads, MLP, vocabulary and RG-LRU width
    over ``model``, or under ``attn_seq_shard`` the rows of the sequence,
    for dense, VLM, xLSTM and whisper models, an xLSTM's recurrence
    handed on along ``model`` row block by row block; KV caches by heads,
    or by slots under ``seq_shard_kv``; an xLSTM's decode state along
    its widest trailing dimension; whisper's cross cache by slots, by
    heads or whole, as ``cache_shardings`` holds it; the batch rows over
    the batch axes); else the gap: a key of ``MISSING_LAYOUT`` (a layout
    the port does not run yet: among them whisper's and xLSTM's heads
    over ``model``, but for whisper's decode under ``seq_shard_kv``),
    ``heads`` where the rules ask for heads over ``model`` that it does
    not divide (the program runs whole, as the rules give it; decode
    under ``seq_shard_kv``, and an xLSTM's decode, need no head split),
    ``batch`` where the rows do not split, ``experts`` where ``model``
    does not divide them."""
    if cfg.family not in SHARDED_FAMILIES:
        return cfg.family
    n_model = mesh.shape.get("model", 1)
    rows = kind != "decode" and rule_splits("act_btd", 1)
    seq_kv = kind != "train" and rule_splits("kv_bskd", 1)
    heads = _heads_split(cfg, n_model)
    ssm = cfg.family == "ssm"
    if heads and cfg.family in ("audio", "ssm") and not (
            cfg.family == "audio" and kind == "decode" and seq_kv):
        return f"{cfg.family}_heads"
    if rows and cfg.family in ("moe", "hybrid"):
        return f"attn_seq_shard_{cfg.family}"
    if rows:
        if kind == "prefill" and not seq_kv and not heads and not ssm:
            return "heads"              # a cache by heads needs the split
    elif not heads and not (kind == "decode" and (seq_kv or ssm)):
        return "heads"
    if cfg.moe.enabled and cfg.moe.n_experts % n_model:
        return "experts"
    n_batch = math.prod(mesh.shape[a] for a in ("pod", "data")
                        if a in mesh.shape)
    kv = logical_spec("kv_bskd")
    replicated = kind != "train" and kv is not None and kv[0] is None
    if batch is not None and batch % n_batch and not replicated:
        return "batch"
    return None


def sharded_program(cfg: ArchConfig, kind: str,
                    batch: Optional[int] = None) -> Optional[Spmd]:
    """The sharded program's positions where the current mesh and rules
    give ``cfg``'s ``kind`` program the port's layouts
    (``mesh_layout_gap``), else None (the program runs whole, its MoE
    expert-parallel where ``model`` divides the experts).  Raises where
    only the ``batch`` rows keep the program from its layouts: they must
    split over the batch axes (``ContinuousBatcher`` pads them), so which
    program a mesh runs never depends on the rows."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return None
    gap = mesh_layout_gap(cfg, mesh, kind, batch)
    if gap == "batch":
        n = math.prod(mesh.shape[a] for a in ("pod", "data")
                      if a in mesh.shape)
        raise ValueError(f"{cfg.name}: {batch} rows do not split over the "
                         f"mesh's {n} batch positions; pad them to a "
                         f"multiple of {n}")
    return None if gap is not None else current_spmd(kind)


class ShardedCache:
    """A decode cache held by position, as ``prefill`` and
    ``decode_step`` return it under a mesh: ``blocks[k]`` is position
    k's list of layer states (``kv_bskd``: its rows and KV heads, or
    under ``seq_shard_kv`` its rows and block of slots; ``state_bw``: its
    rows and RG-LRU channels)."""

    def __init__(self, sp: Spmd, blocks: List[Cache]):
        self.sp, self.blocks = sp, blocks


class ShardedModel:
    """What the LMs' sharded programs share (``TransformerLM``,
    ``whisper.WhisperLM``): the positions a program runs on
    (``spmd``), the positions' batch rows and row blocks, the logits
    assembled and the weights held by position; ``self.cfg``,
    ``self.device``."""

    def spmd(self, kind: str, batch: Optional[int] = None
             ) -> Optional[Spmd]:
        """``sharded_program`` of this model's config."""
        return sharded_program(self.cfg, kind, batch)

    def _rows(self, sp: Spmd, t: Optional[torch.Tensor]):
        """The positions' rows of a batch tensor (views on one
        position's program)."""
        if t is None:
            return None
        spec = (sp.batch_entry(),) + (None,) * (t.dim() - 1)
        return sp.split(t, spec, copy=False if sp.one_position else None)

    def _row_block(self, sp: Spmd, k: int, total: int) -> Tuple[int, int]:
        """(first row, rows) of position k's block of a sequence of
        ``total`` rows under ``sp.seq_rows`` (all of them otherwise)."""
        if not sp.seq_rows:
            return 0, total
        n = sp.mesh.shape["model"]
        if total % n:
            raise ValueError(f"{self.cfg.name}: {total} rows do not split "
                             f"over a model axis of {n}")
        c = total // n
        return sp.index(k)["model"] * c, c

    def _logits_out(self, sp: Spmd, logits, vp: bool) -> torch.Tensor:
        """The positions' last-position logits as one [B, V] (the
        position's own block on one position's program)."""
        spec = PartitionSpec(sp.batch_entry(), "model" if vp else None)
        return sp.assemble(logits, spec, self.device)

    def _held(self, sp: Spmd, params) -> ShardedTree:
        """The parameters by position: ``params`` itself where it is a
        ``ShardedTree`` already (a server shards its weights once),
        else ``shard_params``."""
        return params if isinstance(params, ShardedTree) \
            else shard_params(sp, params)


class TransformerLM(ShardedModel):
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
    # the sharded program (under ``use_mesh_rules``)
    # ------------------------------------------------------------------
    def _positions_sharded(self, sp: Spmd, b: int, s: int) -> list:
        """The positions' rotary positions of a sequence of ``s`` rows
        (each position's own rows under ``sp.seq_rows``; the three M-RoPE
        axes alike)."""
        out = []
        for k in range(sp.n):
            lo, c = self._row_block(sp, k, s)
            pos = torch.arange(lo, lo + c, dtype=torch.int32,
                               device=sp.device(k))
            out.append(self._mrope_axes(pos[None, :].expand(b, c)))
        return out

    def _embed_sharded(self, sp: Spmd, P: ShardedTree, tokens, extra):
        """The positions' embedded rows.  Under ``sp.seq_rows`` a
        position embeds only the token rows of its block of the sequence
        (the patch embeddings, in front, taken as they are), the whole
        table gathered."""
        if sp.seq_rows:
            n_extra = extra[0].shape[1] if extra is not None else 0
            total = n_extra + tokens[0].shape[1]
            cut = [self._text_rows(sp, k, total, n_extra)
                   for k in range(sp.n)]
            tokens = [t[:, c0 - n_extra:c1 - n_extra]
                      for t, (_, c0, c1) in zip(tokens, cut)]
            if extra is not None:
                extra = [e[:, lo:c0] for e, (lo, c0, _) in zip(extra, cut)]
        x = embed_lookup_sharded(sp, P.sub("embed"), tokens, self.dtype)
        if self.embed_scale is not None:
            x = [xk * self.embed_scale for xk in x]
        if extra is not None:
            x = [torch.cat([e.to(self.dtype), xk], dim=1)
                 for e, xk in zip(extra, x)]
        return x

    def _head_sharded(self, sp: Spmd, P: ShardedTree, x):
        """(each position's logits over its vocabulary slice, whether the
        vocabulary is split over ``model``)."""
        cfg = self.cfg
        scale = P.sub("final_norm").gather("scale")
        x = [rmsnorm({"scale": sc_}, xk, cfg.norm_eps)
             for sc_, xk in zip(scale, x)]
        tree, name = (P.sub("embed"), "table") if cfg.tie_embeddings \
            else (P.sub("head"), "w")
        vp = tree.spec(name)[0] == "model" and not sp.seq_rows
        return lm_head_sharded(sp, tree.gather(name), x,
                               cfg.final_logit_softcap, vp), vp

    def train_loss_sharded(self, sp: Spmd, P: ShardedTree, tokens, labels,
                           extra_embeds=None, mask=None) -> torch.Tensor:
        """``train_loss`` on the positions' blocks: ``P`` the parameters
        held by position, ``tokens`` / ``labels`` / ``extra_embeds`` /
        ``mask`` the positions' rows.  Each layer (a ``checkpoint`` region
        under ``cfg.remat``) runs position by position; the loss is the
        vocab-parallel cross-entropy's, the MoE's aux losses (each data
        shard's own, as the reference's expert-parallel path takes them)
        averaged over the batch axes.  A recompute reruns its whole layer
        (no early stop), its weights' gathers and collectives included,
        as the reference's ``jax.checkpoint`` does."""
        cfg = self.cfg
        n_extra = extra_embeds[0].shape[1] if extra_embeds is not None \
            else 0
        b, s = tokens[0].shape[0], n_extra + tokens[0].shape[1]
        x = self._embed_sharded(sp, P, tokens, extra_embeds)
        ctx = Ctx(cfg, "train", self._positions_sharded(sp, b, s))
        remat = cfg.remat != "none"
        aux = None
        for i, blk in enumerate(self.blocks):
            lp = P.sub("layers", i)
            if remat:
                with set_checkpoint_early_stop(False):
                    x, a = checkpoint(blk.apply_sharded, sp, lp, x, None,
                                      ctx, use_reentrant=False)
            else:
                x, a = blk.apply_sharded(sp, lp, x, None, ctx)
            aux = a if aux is None else [u + v for u, v in zip(aux, a)]
        if sp.seq_rows:
            # each position's text rows, and their labels and mask
            cut = [self._text_rows(sp, k, s, n_extra) for k in range(sp.n)]
            x = [xk[:, c0 - lo:c1 - lo] for xk, (lo, c0, c1) in zip(x, cut)]
            labels = [t[:, c0 - n_extra:c1 - n_extra]
                      for t, (_, c0, c1) in zip(labels, cut)]
            if mask is not None:
                mask = [t[:, c0 - n_extra:c1 - n_extra]
                        for t, (_, c0, c1) in zip(mask, cut)]
        elif extra_embeds is not None:
            x = [xk[:, n_extra:] for xk in x]
        logits, vp = self._head_sharded(sp, P, x)
        loss = cross_entropy_sharded(sp, logits, labels, mask, vp)
        if cfg.moe.enabled:
            mean_aux = sp.unreplicate(sp.pmean(aux, sp.batch_axes()))
            loss = loss + cfg.moe.aux_loss_weight * mean_aux / \
                max(cfg.n_layers, 1)
        return loss

    def _text_rows(self, sp: Spmd, k: int, total: int,
                   n_extra: int) -> Tuple[int, int, int]:
        """(first row of position k's block, first and end text row in
        it, as sequence rows) under ``sp.seq_rows``: the rows past the
        ``n_extra`` patch rows."""
        lo, c = self._row_block(sp, k, total)
        c0 = min(max(lo, n_extra), lo + c)
        return lo, c0, lo + c

    def _prefill_sharded(self, sp: Spmd, params,
                         tokens: torch.Tensor, cache_len: int,
                         extra_embeds: Optional[torch.Tensor]):
        P = self._held(sp, params)
        n_extra = extra_embeds.shape[1] if extra_embeds is not None else 0
        real = n_extra + tokens.shape[1]
        if sp.seq_rows:
            # rows padded at the end to a multiple of |model|: past every
            # real row's causal reach, and cut from the cache
            pad = -real % sp.mesh.shape["model"]
            tokens = torch.cat([tokens, tokens.new_zeros(
                (tokens.shape[0], pad))], dim=1) if pad else tokens
        x = self._embed_sharded(sp, P, self._rows(sp, tokens),
                                self._rows(sp, extra_embeds))
        b, s = x[0].shape[0], n_extra + tokens.shape[1]
        ctx = Ctx(self.cfg, "prefill", self._positions_sharded(sp, b, s),
                  cache_len=cache_len, seq_len=real)
        caches: List[Cache] = [[] for _ in range(sp.n)]
        for i, blk in enumerate(self.blocks):
            x, st = blk.apply_sharded(sp, P.sub("layers", i), x, None, ctx)
            for k in range(sp.n):
                caches[k].append(st[k])
        # the last real row: in the block of position ``owner`` on ``model``
        owner, last = 0, real - 1
        if sp.seq_rows:
            c = s // sp.mesh.shape["model"]
            owner, last = divmod(real - 1, c)
        x = [xk[:, min(last, xk.shape[1] - 1)][:, None] for xk in x]
        if sp.seq_rows:
            # the reference's x[:, -1:] under GSPMD: the owner's row sent
            # to one position (a collective-permute), the head's logits
            # then all-reduced (``from_index``)
            sp.charge("collective-permute",
                      x[0].numel() * x[0].element_size(), "model")
        logits, vp = self._head_sharded(sp, P, x)
        logits = [t[:, 0] for t in logits]
        if sp.seq_rows:
            logits = sp.from_index(logits, "model", owner)
        return self._logits_out(sp, logits, vp), ShardedCache(sp, caches)

    def _cache_blocks(self, sp: Spmd, cache: Cache) -> List[Cache]:
        """A whole decode cache's blocks by position (contiguous copies
        on their devices; views on one position's program): an attention
        layer's by its KV heads, or by slots under ``sp.seq_kv``; an
        xLSTM layer's along each leaf's widest trailing dimension
        (``state_block``)."""
        a = self.cfg.attention
        n_model = sp.mesh.shape["model"]
        out: List[Cache] = []
        for k in range(sp.n):
            m = sp.index(k)["model"]
            layers = []
            for kind, st in zip(self.kinds, cache):
                blk = {}
                for name, t in st.items():
                    t = sp.block(t, (sp.batch_entry(),), k,
                                 copy=False)
                    if kind.startswith("attn"):
                        t = cache_view(sp, k, t, a.n_heads, a.n_kv_heads)
                    elif kind in ("mlstm", "slstm"):
                        t = state_block(sp, k, t)
                    else:
                        w = t.shape[-1] // n_model
                        t = t.narrow(t.dim() - 1, m * w, w)
                    if not sp.one_position:
                        t = t.contiguous().to(sp.device(k))
                    blk[name] = t
                layers.append(blk)
            out.append(layers)
        return out

    def _decode_sharded(self, sp: Spmd, params: Params,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        cache) -> Tuple[torch.Tensor, ShardedCache]:
        if not isinstance(cache, ShardedCache):
            cache = ShardedCache(sp, self._cache_blocks(sp, cache))
        P = self._held(sp, params)
        x = self._embed_sharded(sp, P, self._rows(sp, tokens), None)
        pos = [self._mrope_axes(p_) for p_ in self._rows(sp, pos)]
        ctx = Ctx(self.cfg, "decode", pos)
        for i, blk in enumerate(self.blocks):
            x, st = blk.apply_sharded(sp, P.sub("layers", i), x,
                                      [c[i] for c in cache.blocks], ctx)
            for k in range(sp.n):
                cache.blocks[k][i] = st[k]
        logits, vp = self._head_sharded(sp, P, x)
        return self._logits_out(sp, [t[:, 0] for t in logits], vp), cache

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
        load-balancing loss, as the reference does.  Under a mesh whose
        rules give this slice's layouts the program runs sharded
        (``train_loss_sharded``; the parameters' gradients are their
        blocks' gradients assembled)."""
        sp = self.spmd("train", tokens.shape[0])
        if sp is not None:
            return self.train_loss_sharded(
                sp, shard_params(sp, params), self._rows(sp, tokens),
                self._rows(sp, labels), self._rows(sp, extra_embeds),
                self._rows(sp, mask))
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
        on at position P + S.  Under a mesh whose rules give this slice's
        layouts the program runs sharded: ``params`` may be held by
        position already (a ``ShardedTree`` from ``shard_params``), the
        cache is a ``ShardedCache``, the logits assembled from the
        positions' blocks (one position's own block on a mesh of
        ``meta`` entries)."""
        sp = self.spmd("prefill", tokens.shape[0])
        if sp is not None:
            return self._prefill_sharded(sp, params, tokens, cache_len,
                                         extra_embeds)
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
        Returns (logits [B, V], the cache, updated in place).  Under a
        mesh (as ``prefill``) the cache returned is a ``ShardedCache``; a
        whole cache passed in is split into the positions' blocks
        first."""
        sp = self.spmd("decode", tokens.shape[0])
        if sp is not None:
            return self._decode_sharded(sp, params, tokens, pos, cache)
        x = self._embed(params, tokens)
        ctx = Ctx(self.cfg, "decode", self._mrope_axes(pos))
        for i, (blk, p) in enumerate(zip(self.blocks, params["layers"])):
            x, cache[i] = blk.apply(p, x, cache[i], ctx)
        return self._head(params, x)[:, 0], cache

    def init_cache(self, batch: int, cache_len: int) -> Cache:
        """Zeroed decode cache, one state per layer."""
        return [blk.state_init(self.cfg, batch, self.dtype, cache_len,
                               self.device) for blk in self.blocks]


__all__ = ["MISSING_LAYOUT", "SHARDED_FAMILIES", "ShardedCache",
           "TransformerLM", "mesh_layout_gap", "sharded_program"]
