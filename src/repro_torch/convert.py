"""Carry a planning problem across from the reference package.

The reference's ``ScenarioEngine`` keeps its problem as numpy constants
(``compute``, ``memory``, ``act_bits``, ``input_bits``, ``mem_cap``,
``compute_cap``, ``throughput`` and the device ``order``) and its radio
as a frozen ``RadioParams``.  ``engine_arrays`` reads those off any engine
by attribute (it imports nothing of the reference), and
``engine_from_arrays`` / ``fleet_from_arrays`` build the port's engine for
the same problem, so both packages plan identical inputs.  Rollout state
and random streams cross as numpy arrays: ``FleetRollout.run`` makes its
host draws in the reference's order.  ``cnn_params_from_arrays`` carries
a CNN's parameters (HWIO conv filters, [in, out] FC weights, as numpy
arrays) into the port's tensors, so both packages run the same network;
``lm_params_from_arrays`` does the same for an LM's parameter tree and
``whisper_params_from_arrays`` for whisper's; ``train_state_from_arrays``
carries a whole training state (parameters, AdamW moments and step, the
compression error) in float32.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.channel import RadioParams
from repro_torch.core.cost_model import LayerCost, ModelCost
from repro_torch.core.placement import Device
from repro_torch.core.rollout import PositionSpec, RolloutSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime.fleet_rollout import FleetRollout
from repro_torch.runtime.scenario_engine import PlanFnCache, ScenarioEngine
from repro_torch.tree import leaves

ARRAY_KEYS = ("compute", "memory", "act_bits", "mem_cap", "compute_cap",
              "throughput")


def engine_arrays(engine) -> dict:
    """The numpy constants of an engine (reference or port), by attribute."""
    out = {k: np.asarray(getattr(engine, k), np.float64) for k in ARRAY_KEYS}
    out["input_bits"] = float(engine.input_bits)
    out["order"] = tuple(int(o) for o in engine.order)
    return out


def _problem(arrays: Mapping, radio: Mapping):
    params = RadioParams(**dict(radio))
    L = len(arrays["compute"])
    model = ModelCost("converted", tuple(
        LayerCost(f"layer{j}", float(arrays["compute"][j]),
                  float(arrays["memory"][j]), float(arrays["act_bits"][j]))
        for j in range(L)), float(arrays["input_bits"]))
    devices = [Device(f"uav{i}", float(m), float(c), float(e))
               for i, (m, c, e) in enumerate(zip(arrays["mem_cap"],
                                                 arrays["compute_cap"],
                                                 arrays["throughput"]))]
    return params, devices, model, tuple(arrays["order"])


def engine_from_arrays(arrays: Mapping, radio: Mapping,
                       device: DeviceLike = None, *,
                       position_spec: Optional[PositionSpec] = None,
                       plan_cache: Optional[PlanFnCache] = None
                       ) -> ScenarioEngine:
    """The port's ``ScenarioEngine`` for the problem in ``arrays`` (see
    ``engine_arrays``) and ``radio`` (``dataclasses.asdict`` of a
    ``RadioParams``)."""
    params, devices, model, order = _problem(arrays, radio)
    return ScenarioEngine(params, devices, model, device_order=order,
                          plan_cache=plan_cache, position_spec=position_spec,
                          device=device)


def fleet_from_arrays(arrays: Mapping, radio: Mapping, spec: RolloutSpec,
                      device: DeviceLike = None, *, seed: int = 0,
                      position_spec: Optional[PositionSpec] = None,
                      plan_cache: Optional[PlanFnCache] = None
                      ) -> FleetRollout:
    """The port's ``FleetRollout`` for the problem in ``arrays`` and
    ``radio``; with the reference's ``seed`` its host draws are the
    reference's."""
    params, devices, model, order = _problem(arrays, radio)
    return FleetRollout(params, devices, model, spec, device_order=order,
                        plan_cache=plan_cache, position_spec=position_spec,
                        seed=seed, device=device)


def cnn_params_from_arrays(arrays: Sequence[Mapping],
                           device: DeviceLike = None
                           ) -> List[dict]:
    """One ``{"w", "b"}`` dict of numpy arrays per layer (``{}`` for a
    pool), in the reference's layouts -> the same list of float32 tensors
    on ``device``."""
    dev = resolve_device(device)
    return [{k: torch.tensor(np.asarray(v, np.float32), device=dev)
             for k, v in layer.items()} for layer in arrays]


#: leaves the port holds in float32 whatever the compute dtype: norm
#: scales, layer-norm biases, the qkv biases and the RG-LRU gate biases
#: (the reference casts them at use too), and the RG-LRU's
#: ``log_lambda``, whose softplus the reference takes in float32
_FLOAT32_LEAVES = ("scale", "bias", "bq", "bk", "bv", "b_a", "b_i",
                   "log_lambda")


def _tensors(cfg: ArchConfig, device: DeviceLike,
             dtype: Optional[torch.dtype] = None):
    """``tree(t)``: a nest of dicts and lists of numpy arrays -> the same
    nest of tensors on ``device``, each leaf in ``dtype`` (default
    ``cfg.dtype``) unless its key is in ``_FLOAT32_LEAVES``."""
    dev = resolve_device(device)
    dtype = dtype or {"float32": torch.float32,
                      "bfloat16": torch.bfloat16}[cfg.dtype]

    def tree(t, name=""):
        if isinstance(t, Mapping):
            return {k: tree(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [tree(v, name) for v in t]
        dt = torch.float32 if name in _FLOAT32_LEAVES else dtype
        return torch.tensor(np.asarray(t, np.float32), device=dev).to(dt)
    return tree


def lm_params_from_arrays(cfg: ArchConfig, arrays: Mapping[str, Any],
                          device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None) -> dict:
    """A reference ``TransformerLM`` parameter tree as numpy arrays
    (``embed``, ``final_norm``, ``blocks`` stacked per period slot
    ``b0``, ``b1``, ..., optional ``rem`` and ``head``) -> the port's
    parameters on ``device``: the same dict with ``layers`` in layer
    order, layer ``j * period + i`` from ``blocks["b{i}"][j]`` (for
    gemma2's alternating stack ``b0`` holds the local layers 0, 2, ...
    and ``b1`` the global 1, 3, ...; for griffin's period of 3 ``b0`` and
    ``b1`` the RG-LRU layers, ``b2`` the local attention; for xLSTM's
    period of 2 ``b0`` the sLSTM layers, ``b1`` the mLSTM), then the
    ``rem`` layers.  Matrices (MoE experts and router, RG-LRU weights,
    the xLSTM cells' ``w_if``, ``b_if``, ``w_in``, ``r``, ``b`` and
    ``wo`` included) keep the reference's shapes and are cast to
    ``dtype`` (default ``cfg.dtype``), where the reference casts them at
    use; the leaves of ``_FLOAT32_LEAVES`` stay float32."""
    tree = _tensors(cfg, device, dtype)

    def slice_j(t, j):
        if isinstance(t, Mapping):
            return {k: slice_j(v, j) for k, v in t.items()}
        return np.asarray(t)[j]

    blocks = arrays["blocks"]
    period = len(blocks)
    n_full = len(np.asarray(blocks["b0"]["ln1"]["scale"]))
    layers = [tree(slice_j(blocks[f"b{i}"], j)) for j in range(n_full)
              for i in range(period)]
    layers += [tree(r) for r in arrays.get("rem", [])]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config has "
                         f"{cfg.n_layers}")
    out = {"embed": tree(arrays["embed"]),
           "final_norm": tree(arrays["final_norm"]), "layers": layers}
    if "head" in arrays:
        out["head"] = tree(arrays["head"])
    return out


def whisper_params_from_arrays(cfg: ArchConfig, arrays: Mapping[str, Any],
                               device: DeviceLike = None,
                               dtype: Optional[torch.dtype] = None) -> dict:
    """The reference ``WhisperLM.init`` tree as numpy arrays (``embed``,
    ``enc`` and ``dec`` lists of layers, ``enc_norm``, ``dec_norm``) ->
    the port's ``WhisperLM`` parameters on ``device``: the same tree,
    matrices in ``dtype`` (default ``cfg.dtype``), layer-norm scales and
    biases and the qkv biases in float32."""
    out = _tensors(cfg, device, dtype)(arrays)
    if (len(out["enc"]), len(out["dec"])) != (cfg.enc_layers, cfg.n_layers):
        raise ValueError(f"{len(out['enc'])} encoder and {len(out['dec'])} "
                         f"decoder layers in the tree, config has "
                         f"{cfg.enc_layers} and {cfg.n_layers}")
    return out


def train_state_from_arrays(cfg: ArchConfig, arrays: Mapping[str, Any],
                            device: DeviceLike = None) -> dict:
    """A reference train state as numpy arrays (``params``; ``opt`` with
    the moments ``m`` and ``v``, trees shaped like ``params``, and
    ``step``; optional ``err``) -> the port's state on ``device``, every
    tree in float32 and laid out as the port's parameters (an LM's
    stacked layers interleaved as ``lm_params_from_arrays`` does,
    whisper's tree leaf for leaf), the parameters requiring grad and the
    step an int32 scalar."""
    f32 = torch.float32
    conv = whisper_params_from_arrays if cfg.family == "audio" \
        else lm_params_from_arrays
    state = {"params": conv(cfg, arrays["params"], device, f32),
             "opt": {"m": conv(cfg, arrays["opt"]["m"], device, f32),
                     "v": conv(cfg, arrays["opt"]["v"], device, f32),
                     "step": torch.tensor(int(np.asarray(
                         arrays["opt"]["step"])), dtype=torch.int32,
                         device=resolve_device(device))}}
    if arrays.get("err") is not None:
        state["err"] = conv(cfg, arrays["err"], device, f32)
    for leaf in leaves(state["params"]):
        leaf.requires_grad_(True)
    return state


__all__ = ["ARRAY_KEYS", "cnn_params_from_arrays", "engine_arrays",
           "engine_from_arrays", "fleet_from_arrays", "lm_params_from_arrays",
           "train_state_from_arrays", "whisper_params_from_arrays"]
