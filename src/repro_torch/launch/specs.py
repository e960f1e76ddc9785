"""``input_specs()``: ``meta`` stand-ins for every input of a dry-run cell
and the port's ``NamedSharding`` trees for them (the reference's
``launch/specs.py``, whose ``ShapeDtypeStruct``s these are).  The keys,
shapes, dtypes and ``PartitionSpec``s are the reference's; the shardings
come from ``parallel.param_sharding`` by the same rules.  Nothing here
allocates: the model is built on ``meta`` and ``shape_init`` draws its
parameters there (the counterpart of ``jax.eval_shape(model.init)``).
The port holds a model's layers as a list, where the reference stacks
them per period slot: the same leaves, one tree a layer.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, TrainConfig
from repro_torch.device import MetaGenerator
from repro_torch.parallel.param_sharding import (cache_shardings,
                                                 param_shardings)
from repro_torch.parallel.sharding import Mesh, NamedSharding
from repro_torch.parallel.sharding import PartitionSpec as P

META = torch.device("meta")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def shape_init(model, dtype=None):
    """``model.init`` on ``meta`` (the model built there): every
    parameter's shape and dtype, no data."""
    return model.init(MetaGenerator(), dtype=dtype)


def _batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _bspec(mesh: Mesh, batch: int):
    b = _batch_axes(mesh)
    n = int(np.prod([mesh.shape[a] for a in b])) if b else 1
    if batch % n == 0 and batch > 1:
        return b if len(b) > 1 else b[0]
    # small batches: shard along 'data' only if divisible, else replicate
    if "data" in mesh.axis_names and batch % mesh.shape["data"] == 0 \
            and batch > 1:
        return "data"
    return None


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, NamedSharding]]:
    """Training / prefill batch stand-ins + shardings."""
    b, s = shape.global_batch, shape.seq_len
    bs = _bspec(mesh, b)
    structs: Dict[str, torch.Tensor] = {}
    shards: Dict[str, NamedSharding] = {}
    s_text = s
    if cfg.family == "vlm":
        s_text = s - cfg.vision_tokens
        structs["patch_embeds"] = _meta((b, cfg.vision_tokens, cfg.d_model),
                                        torch.bfloat16)
        shards["patch_embeds"] = NamedSharding(mesh, P(bs, None, None))
    if cfg.family == "audio":
        structs["frames"] = _meta((b, cfg.enc_seq, cfg.d_model),
                                  torch.bfloat16)
        shards["frames"] = NamedSharding(mesh, P(bs, None, None))
    structs["tokens"] = _meta((b, s_text), torch.int32)
    shards["tokens"] = NamedSharding(mesh, P(bs, None))
    if shape.kind == "train":
        structs["labels"] = _meta((b, s_text), torch.int32)
        shards["labels"] = NamedSharding(mesh, P(bs, None))
    return structs, shards


def decode_specs(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, model
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Decode-step inputs: one new token + the KV / recurrent cache."""
    b = shape.global_batch
    bs = _bspec(mesh, b)
    cache = model.init_cache(b, shape.seq_len)
    # sequence-shard the KV when heads can't cover the model axis or the
    # context is very long (flash-decode layout)
    seq_shard = (shape.seq_len >= 262144 or
                 cfg.attention.n_kv_heads % mesh.shape["model"] != 0)
    structs = {"tokens": _meta((b, 1), torch.int32),
               "pos": _meta((b, 1), torch.int32), "cache": cache}
    shards = {"tokens": NamedSharding(mesh, P(bs, None)),
              "pos": NamedSharding(mesh, P(bs, None)),
              "cache": cache_shardings(mesh, cache, seq_shard=seq_shard)}
    return structs, shards


def _model_shard(cfg: ArchConfig, mesh: Mesh, kind: str = "train") -> bool:
    # sequence-parallel archs (heads don't divide the model axis) keep
    # weights FSDP-only, but only where activations carry a long seq dim
    # (train / prefill); decode keeps TP weights
    if kind == "decode":
        return True
    return cfg.attention.n_heads % mesh.shape["model"] == 0 \
        if cfg.attention.n_heads else True


def state_specs(cfg: ArchConfig, tcfg: TrainConfig, mesh: Mesh, model
                ) -> Tuple[Any, Any]:
    """Train-state stand-ins + shardings (params + AdamW moments)."""
    from repro_torch.runtime.train_loop import init_state
    ms = _model_shard(cfg, mesh)
    state = init_state(model, MetaGenerator(), tcfg)
    shards = {
        "params": param_shardings(mesh, state["params"], model_shard=ms),
        "opt": {
            "m": param_shardings(mesh, state["opt"]["m"], model_shard=ms),
            "v": param_shardings(mesh, state["opt"]["v"], model_shard=ms),
            "step": NamedSharding(mesh, P()),
        },
    }
    if "err" in state:
        shards["err"] = param_shardings(mesh, state["err"], model_shard=ms)
    return state, shards


def param_specs(cfg: ArchConfig, mesh: Mesh, model,
                kind: str = "train") -> Tuple[Any, Any]:
    """The parameters as ``init`` makes them in ``cfg.param_dtype`` (the
    reference's float32), with their shardings."""
    params = shape_init(model, _DTYPES[cfg.param_dtype])
    return params, param_shardings(
        mesh, params, model_shard=_model_shard(cfg, mesh, kind))


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, model,
                tcfg: TrainConfig = None):
    """Everything the dry run needs for one (arch x shape) cell: (inputs,
    shardings), keyed ``state`` / ``batch`` (train), ``params`` /
    ``batch`` (prefill) or ``params`` / ``tokens`` / ``pos`` / ``cache``
    (decode).  ``model`` is built on ``meta``."""
    tcfg = tcfg or TrainConfig()
    if shape.kind == "train":
        state, state_sh = state_specs(cfg, tcfg, mesh, model)
        batch, batch_sh = batch_specs(cfg, shape, mesh)
        return {"state": state, "batch": batch}, \
               {"state": state_sh, "batch": batch_sh}
    if shape.kind == "prefill":
        params, params_sh = param_specs(cfg, mesh, model, "prefill")
        batch, batch_sh = batch_specs(cfg, shape, mesh)
        return {"params": params, "batch": batch}, \
               {"params": params_sh, "batch": batch_sh}
    params, params_sh = param_specs(cfg, mesh, model, "decode")
    dec, dec_sh = decode_specs(cfg, shape, mesh, model)
    return {"params": params, **dec}, {"params": params_sh, **dec_sh}


def shard_bytes(t: torch.Tensor, sharding: NamedSharding) -> int:
    """Bytes of one device's block of ``t`` under ``sharding`` (each
    dimension split over the product of its axes, rounded up, as
    ``jax.sharding.NamedSharding.shard_shape`` takes an even split)."""
    n = t.element_size()
    for dim, entry in zip(t.shape, tuple(sharding.spec) +
                          (None,) * (t.dim() - len(sharding.spec))):
        axes = () if entry is None else \
            (entry if isinstance(entry, tuple) else (entry,))
        parts = int(np.prod([sharding.mesh.shape[a] for a in axes])) \
            if axes else 1
        n *= -(-dim // parts)
    return n


def argument_bytes(inputs, shardings) -> int:
    """Per-device bytes of every input leaf under its sharding."""
    if isinstance(inputs, dict):
        return sum(argument_bytes(v, shardings[k]) for k, v in inputs.items())
    if isinstance(inputs, (list, tuple)):
        return sum(argument_bytes(v, s) for v, s in zip(inputs, shardings))
    return shard_bytes(inputs, shardings)


__all__ = ["argument_bytes", "batch_specs", "decode_specs", "input_specs",
           "param_specs", "shape_init", "shard_bytes", "state_specs"]
