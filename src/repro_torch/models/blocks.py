"""Residual block kinds of the served LMs, with the reference's kind
strings (``core.cost_model._block_kinds``), so the planner's units and the
model's blocks agree.

``apply(params, x, state, ctx) -> (x, new_state)``; ``ctx.mode`` is
``prefill``, ``decode`` or ``train`` (the full sequence as in prefill, no
cache built: the second output is then the block's auxiliary loss, a
float32 scalar, the MoE load-balancing loss of an attention block with a
MoE MLP and zero for every other block).  The attention blocks
(``attn_full``, ``attn_local``) with a dense or MoE MLP, the RG-LRU block
(``rglru``) and the xLSTM blocks (``slstm``, ``mlstm``) are ported.  The
MoE load-balancing loss is a training term: serving drops it, as the
reference's prefill and decode do.  Under ``use_mesh_rules(mesh)`` with
a ``model`` axis that divides the experts, the MoE MLP takes the
expert-parallel path (``moe_apply_expert_parallel``), as the
reference's does.  ``BlockDef.apply_sharded`` runs an attention,
RG-LRU or xLSTM block under the mesh's layouts, position by position
(``TransformerLM``'s sharded program); an attention block takes the
rules' sequence layouts from its ``Spmd`` (``seq_rows``: its rows and
K/V all-gathered; ``seq_kv``: the KV cache by slots), the RG-LRU and MoE
parts keep theirs; an xLSTM block's rows run block after block along
``model``, each from the state its predecessor hands on, and its decode
state is split along its widest trailing dimension.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.layers import (mlp, mlp_init, mlp_sharded, rmsnorm,
                                       rmsnorm_init)
from repro_torch.models.moe import (moe_apply, moe_apply_expert_parallel,
                                   moe_init, moe_sharded)
from repro_torch.parallel.sharding import current_mesh

Params = Dict[str, Any]

class Ctx(NamedTuple):
    cfg: ArchConfig
    mode: str                   # 'prefill' | 'decode' | 'train'
    pos: torch.Tensor           # [B, S] int32, [B, S, 3] under M-RoPE
    cache_len: int = 0          # decode cache size (flat)
    seq_len: int = 0            # a padded prefill's real rows (0: all)


def _norms_init(cfg: ArchConfig, post: bool, device) -> Params:
    p = {"ln1": rmsnorm_init(cfg.d_model, device),
         "ln2": rmsnorm_init(cfg.d_model, device)}
    if post:
        p["ln1p"] = rmsnorm_init(cfg.d_model, device)
        p["ln2p"] = rmsnorm_init(cfg.d_model, device)
    return p


def _post(p: Params, name: str, x: torch.Tensor, cfg: ArchConfig):
    return rmsnorm(p[name], x, cfg.norm_eps) if name in p else x


def _outputs(ctx: Ctx, x: torch.Tensor, new_state, aux=None):
    """A block's outputs: the new state when serving, the auxiliary loss
    (zero unless given) in ``train`` mode."""
    if ctx.mode != "train":
        return x, new_state
    return x, aux if aux is not None else x.new_zeros((),
                                                      dtype=torch.float32)


def _attn_block_init(cfg: ArchConfig, generator: torch.Generator,
                     dtype: torch.dtype) -> Params:
    a = cfg.attention
    # gemma2 style post-norms exist only with an attention softcap
    p = _norms_init(cfg, post=a.logit_softcap > 0, device=generator.device)
    p["attn"] = attn_mod.attn_init(cfg.d_model, a.n_heads, a.n_kv_heads,
                                   cfg.head_dim, a.qkv_bias, generator,
                                   dtype)
    if cfg.moe.enabled:
        p["moe"] = moe_init(cfg.d_model, cfg.moe.n_experts,
                            cfg.moe.d_expert, cfg.glu, generator, dtype)
    elif cfg.d_ff:
        p["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, cfg.glu, generator, dtype)
    return p


def _attn_window(cfg: ArchConfig, local: bool) -> int:
    return cfg.attention.window if local else 0


def _attn_block_apply(local: bool) -> Callable:
    def apply(p: Params, x: torch.Tensor, state, ctx: Ctx):
        cfg = ctx.cfg
        a = cfg.attention
        win = _attn_window(cfg, local)
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        if ctx.mode == "decode":
            y, new_state = attn_mod.decode_attention(
                p["attn"], h, ctx.pos, state, window=win,
                cap=a.logit_softcap, theta=a.rope_theta,
                mrope=a.mrope_sections)
        else:
            y, k, v = attn_mod.attention(
                p["attn"], h, ctx.pos, window=win, cap=a.logit_softcap,
                theta=a.rope_theta, mrope=a.mrope_sections)
            new_state = _prefill_cache(k, v, ctx, win) \
                if ctx.mode == "prefill" else None
        x = x + _post(p, "ln1p", y, cfg)
        if not (cfg.moe.enabled or cfg.d_ff):
            return _outputs(ctx, x, new_state)
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        aux = None
        if cfg.moe.enabled:
            kw = dict(top_k=cfg.moe.top_k, act=cfg.act, glu=cfg.glu,
                      capacity_factor=cfg.moe.capacity_factor)
            mesh = current_mesh()
            if mesh is not None and "model" in mesh.axis_names and \
                    cfg.moe.n_experts % mesh.shape["model"] == 0:
                y2, aux = moe_apply_expert_parallel(p["moe"], h2, mesh=mesh,
                                                    **kw)
            else:
                y2, aux = moe_apply(p["moe"], h2, **kw)
        else:
            y2 = mlp(p["mlp"], h2, cfg.act, cfg.glu)
        return _outputs(ctx, x + _post(p, "ln2p", y2, cfg), new_state, aux)
    return apply


def _prefill_cache(k: torch.Tensor, v: torch.Tensor, ctx: Ctx,
                   win: int) -> Dict[str, torch.Tensor]:
    """Lay the prompt's rotated K/V out as a decode-ready cache: the
    last ``size`` positions rolled into their ``pos % size`` slots for a
    rolling cache the prompt fills, else zero-padded (or cut) to size."""
    s = k.shape[1]
    size = min(win, ctx.cache_len) if win else ctx.cache_len
    out = {}
    for name, t in (("k", k), ("v", v)):
        if win and s >= size:
            out[name] = torch.roll(t[:, -size:], s % size,
                                   dims=1).contiguous()
        else:
            out[name] = attn_mod.flat_cache(t, size)
    return out


def _attn_state_init(local: bool) -> Callable:
    def init(cfg: ArchConfig, batch: int, dtype, cache_len: int, device):
        return attn_mod.init_cache(batch, cache_len,
                                   cfg.attention.n_kv_heads, cfg.head_dim,
                                   _attn_window(cfg, local), dtype, device)
    return init


def _rglru_width(cfg: ArchConfig) -> int:
    return cfg.rglru_width or cfg.d_model


def _rglru_block_init(cfg: ArchConfig, generator: torch.Generator,
                      dtype: torch.dtype) -> Params:
    p = _norms_init(cfg, post=False, device=generator.device)
    p["rglru"] = rec_mod.rglru_init(cfg.d_model, _rglru_width(cfg),
                                    cfg.rglru_conv_size, generator, dtype)
    if cfg.d_ff:
        p["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, cfg.glu, generator, dtype)
    return p


def _rglru_block_apply(p: Params, x: torch.Tensor, state, ctx: Ctx):
    cfg = ctx.cfg
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if state is None:
        state = rec_mod.rglru_block_state(x.shape[0], _rglru_width(cfg),
                                          cfg.rglru_conv_size, x.dtype,
                                          x.device)
    y, new_state = rec_mod.rglru_block_apply(p["rglru"], h, state,
                                             decode=ctx.mode == "decode")
    x = x + y
    if cfg.d_ff:
        x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act,
                    cfg.glu)
    return _outputs(ctx, x, new_state)


def _rglru_state_init(cfg: ArchConfig, batch: int, dtype, cache_len: int,
                      device):
    return rec_mod.rglru_block_state(batch, _rglru_width(cfg),
                                     cfg.rglru_conv_size, dtype, device)


def _xlstm_block_init(flavor: str) -> Callable:
    cell_init = rec_mod.mlstm_init if flavor == "mlstm" \
        else rec_mod.slstm_init

    def init(cfg: ArchConfig, generator: torch.Generator,
             dtype: torch.dtype) -> Params:
        p = _norms_init(cfg, post=False, device=generator.device)
        p["cell"] = cell_init(cfg.d_model, cfg.attention.n_heads,
                              cfg.head_dim, generator, dtype)
        if cfg.d_ff:
            p["mlp"] = mlp_init(cfg.d_model, cfg.d_ff, cfg.glu, generator,
                                dtype)
        return p
    return init


def _xlstm_state(flavor: str, cfg: ArchConfig, batch: int, dtype, device):
    a = cfg.attention
    if flavor == "mlstm":
        return rec_mod.mlstm_state(batch, a.n_heads, cfg.head_dim, device)
    return rec_mod.slstm_state(batch, a.n_heads, cfg.head_dim, dtype, device)


def _xlstm_block_apply(flavor: str) -> Callable:
    cell = rec_mod.mlstm_seq if flavor == "mlstm" else rec_mod.slstm_seq

    def apply(p: Params, x: torch.Tensor, state, ctx: Ctx):
        """Prefill starts from the zero state; decode (S = 1) carries
        ``state`` and replaces it."""
        cfg = ctx.cfg
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        if state is None:
            state = _xlstm_state(flavor, cfg, x.shape[0], x.dtype, x.device)
        y, new_state = cell(p["cell"], h, state)
        x = x + y
        if cfg.d_ff:
            x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                        cfg.act, cfg.glu)
        return _outputs(ctx, x, new_state)
    return apply


def _xlstm_state_init(flavor: str) -> Callable:
    def init(cfg: ArchConfig, batch: int, dtype, cache_len: int, device):
        return _xlstm_state(flavor, cfg, batch, dtype, device)
    return init


# ---------------------------------------------------------------------------
# the blocks under a mesh (``TransformerLM``'s sharded program)
# ---------------------------------------------------------------------------
#
# ``apply_sharded(sp, p, x, states, ctx) -> (x, new_states or aux)``:
# ``p`` the layer's ``ShardedTree``, ``x`` / ``states`` / ``ctx.pos`` the
# positions' lists; in ``train`` mode the second output is the positions'
# auxiliary losses (their data shards' own, replicated over ``model``).


def _norm_sharded(sp, p, name: str, x, cfg: ArchConfig):
    scale = p.sub(name).gather("scale")
    return [rmsnorm({"scale": s}, xk, cfg.norm_eps)
            for s, xk in zip(scale, x)]


def _add(xs, ys):
    return [a + b for a, b in zip(xs, ys)]


def _zeros_aux(x):
    return [xk.new_zeros((), dtype=torch.float32) for xk in x]


def _mlp_part_sharded(sp, p, x, cfg: ArchConfig):
    """The block's MLP on ``x`` (after ``ln2``, before the residual add):
    (y, the positions' aux losses or None)."""
    h2 = _norm_sharded(sp, p, "ln2", x, cfg)
    if not cfg.moe.enabled:
        return mlp_sharded(sp, p.sub("mlp"), h2, cfg.act, cfg.glu), None
    kw = dict(top_k=cfg.moe.top_k, act=cfg.act, glu=cfg.glu,
              capacity_factor=cfg.moe.capacity_factor)
    return moe_sharded(sp, p.sub("moe"), h2, **kw)


def _attn_block_sharded(local: bool) -> Callable:
    def apply(sp, p, x, states, ctx: Ctx):
        cfg = ctx.cfg
        a = cfg.attention
        win = _attn_window(cfg, local)
        kw = dict(cap=a.logit_softcap, theta=a.rope_theta,
                  mrope=a.mrope_sections)
        h = _norm_sharded(sp, p, "ln1", x, cfg)
        if ctx.mode == "decode":
            fn = attn_mod.decode_attention_seq_kv if sp.seq_kv else \
                attn_mod.decode_attention_sharded
            y, new = fn(sp, p.sub("attn"), h, ctx.pos, states, window=win,
                        **kw)
        else:
            fn = attn_mod.attention_seq_sharded if sp.seq_rows else \
                attn_mod.attention_sharded
            y, ks, vs = fn(sp, p.sub("attn"), h, ctx.pos, window=win, **kw)
            new = _prefill_blocks(sp, ks, vs, ctx, win) \
                if ctx.mode == "prefill" else None
        if p.has("ln1p"):
            y = _norm_sharded(sp, p, "ln1p", y, cfg)
        x = _add(x, y)
        aux = None
        if cfg.moe.enabled or cfg.d_ff:
            y2, aux = _mlp_part_sharded(sp, p, x, cfg)
            if p.has("ln2p"):
                y2 = _norm_sharded(sp, p, "ln2p", y2, cfg)
            x = _add(x, y2)
        if ctx.mode != "train":
            return x, new
        return x, aux if aux is not None else _zeros_aux(x)
    return apply


def _prefill_blocks(sp, ks, vs, ctx: Ctx, win: int):
    """The positions' blocks of the decode-ready cache from a sharded
    prefill's K/V: head-parallel, each position's own heads' cache; under
    ``sp.seq_kv`` or ``sp.seq_rows``, the whole cache (``_prefill_cache``
    of every KV head over the real rows: the K/V ``attention_seq_sharded``
    gathered, or the positions' heads all-gathered, ``all_kv_heads``), cut
    to the position's block (``attention.cache_block``: its slots, or
    under ``seq_rows`` alone its KV heads)."""
    if not (sp.seq_rows or sp.seq_kv):
        return [_prefill_cache(kk, v, ctx, win) for kk, v in zip(ks, vs)]
    a = ctx.cfg.attention
    if not sp.seq_rows:
        ks, vs = (attn_mod.all_kv_heads(sp, t, a.n_heads, a.n_kv_heads)
                  for t in (ks, vs))
    real = ctx.seq_len or ks[0].shape[1]
    return [attn_mod.cache_block(
        sp, k, _prefill_cache(kk[:, :real], v[:, :real], ctx, win),
        a.n_heads, a.n_kv_heads) for k, (kk, v) in enumerate(zip(ks, vs))]


def _rglru_block_sharded(sp, p, x, states, ctx: Ctx):
    cfg = ctx.cfg
    h = _norm_sharded(sp, p, "ln1", x, cfg)
    y, new = rec_mod.rglru_block_sharded(sp, p.sub("rglru"), h, states,
                                         decode=ctx.mode == "decode")
    x = _add(x, y)
    if cfg.d_ff:
        y2, _ = _mlp_part_sharded(sp, p, x, cfg)
        x = _add(x, y2)
    if ctx.mode != "train":
        return x, new
    return x, _zeros_aux(x)


def _xlstm_block_sharded(flavor: str) -> Callable:
    cell = rec_mod.mlstm_sharded if flavor == "mlstm" else \
        rec_mod.slstm_sharded

    def apply(sp, p, x, states, ctx: Ctx):
        """An xLSTM block under a mesh: ``ln1`` on each position's rows,
        the cell with its rows handed on along ``model`` (train, prefill)
        or on the positions' state blocks (decode), the MLP where the
        config has one; a prefill leaves each position its block of the
        final state (``rec_mod.final_state_blocks``)."""
        cfg = ctx.cfg
        h = _norm_sharded(sp, p, "ln1", x, cfg)
        decode = ctx.mode == "decode"
        y, new = cell(sp, p.sub("cell"), h, states, decode, ctx.seq_len)
        if ctx.mode == "prefill":
            new = rec_mod.final_state_blocks(sp, new, flavor)
        x = _add(x, y)
        if cfg.d_ff:
            y2, _ = _mlp_part_sharded(sp, p, x, cfg)
            x = _add(x, y2)
        if ctx.mode != "train":
            return x, new
        return x, _zeros_aux(x)
    return apply


class BlockDef(NamedTuple):
    init: Any
    apply: Any
    state_init: Any
    apply_sharded: Any = None


BLOCK_KINDS: Dict[str, BlockDef] = {
    "attn_full": BlockDef(_attn_block_init, _attn_block_apply(False),
                          _attn_state_init(False),
                          _attn_block_sharded(False)),
    "attn_local": BlockDef(_attn_block_init, _attn_block_apply(True),
                           _attn_state_init(True),
                           _attn_block_sharded(True)),
    "rglru": BlockDef(_rglru_block_init, _rglru_block_apply,
                      _rglru_state_init, _rglru_block_sharded),
    "slstm": BlockDef(_xlstm_block_init("slstm"), _xlstm_block_apply("slstm"),
                      _xlstm_state_init("slstm"),
                      _xlstm_block_sharded("slstm")),
    "mlstm": BlockDef(_xlstm_block_init("mlstm"), _xlstm_block_apply("mlstm"),
                      _xlstm_state_init("mlstm"),
                      _xlstm_block_sharded("mlstm")),
}


def block_def(kind: str) -> BlockDef:
    """The block of ``kind``; an unknown kind raises ``KeyError`` naming
    the ported ones."""
    if kind not in BLOCK_KINDS:
        raise KeyError(f"unknown block kind {kind!r}; ported: "
                       f"{sorted(BLOCK_KINDS)}")
    return BLOCK_KINDS[kind]


__all__ = ["BLOCK_KINDS", "BlockDef", "Ctx", "block_def"]
