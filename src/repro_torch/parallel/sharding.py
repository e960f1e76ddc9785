"""Device meshes of the port: the fleet rollout's 1-D trajectory mesh, and
named meshes with the reference's logical sharding rules (MaxText style).

**Fleet meshes.** ``fleet_mesh`` names the devices the trajectory axis B
of a ``FleetRollout.run`` is split over, as a tuple of ``torch.device``s
in shard order: each device takes an equal block of rows, runs the same
built rollout on them and the host gathers the blocks.  A mesh may name
one device more than once; its shards then run one after the other on
that device.  That is how the split, the padding of a ragged B and the
``RolloutTrace.valid`` mask are exercised on one card, or on the CPU.
``mesh_signature`` is the hashable token a ``PlanFnCache`` key carries so
that a mesh's entries never collide with the single-device ones, and
``pad_to_multiple`` the padded B of a ragged split.

**Named meshes.** A ``Mesh`` is an array of devices with an axis name a
dimension (``data``, ``model``, ``pod``, ``stage``), as jax's is; one card
may fill every entry.  ``default_rules`` maps the reference's logical
names (``act_btd``, ``w_df``, ``moe_ecd``, ...) to ``PartitionSpec``s,
``use_mesh_rules`` makes a mesh and its rules current for the calling
thread, and model code asks ``current_mesh`` / ``logical_spec``.  The
host runs a mesh's shards in turn: ``run_shards`` (and
``shard_map_compat``, which assembles the outputs) calls a function once
a mesh position, in row-major order, on that position's block of
each input, and the collectives (``psum``, ``pmax``, ``pmean``,
``ppermute``) are plain functions over the shards' values in mesh order,
each summed or compared in that fixed order, so a run repeats bitwise.

Axis vocabulary
  batch axes   -> ("pod", "data")   (pod present only on the multi-pod mesh)
  model axes   -> "model"           (heads / ffn / vocab / experts / kv-seq)
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.kernels import charge_collective, charged_unit

#: Axis name of the 1-D fleet-rollout mesh (the B trajectory axis).
FLEET_AXIS = "traj"

_state = threading.local()


def _pin(dev) -> torch.device:
    """A concrete device: a bare ``cuda`` names the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _checked(devs: Sequence, what: str) -> Tuple[torch.device, ...]:
    """``devs`` pinned, all of one type, CUDA ones only with CUDA (or
    ``meta``: the dry run lays a mesh of shapes over it)."""
    devs = tuple(_pin(d) for d in devs)
    if not devs:
        raise ValueError(f"{what} needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"{what}: one device type a mesh; got "
                         f"{[str(d) for d in devs]}")
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{what}: {d} named but CUDA is not "
                               "available")
        if d.type not in ("cuda", "cpu", "meta"):
            raise ValueError(f"{what}: unsupported device {d}")
    return devs


def _cuda_devices(n: int, what: str) -> Tuple[torch.device, ...]:
    """The first ``n`` visible CUDA devices; raises if there are fewer."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 1 or n > avail:
        raise ValueError(
            f"{what}: requested a {n}-device mesh but {avail} CUDA "
            f"device(s) are available (name a device more than once to "
            f"fill a mesh from one card or from the CPU, e.g. "
            f"[torch.device('cpu')] * n)")
    return tuple(torch.device("cuda", i) for i in range(n))


# ---------------------------------------------------------------------------
# 1-D fleet meshes (the rollout's trajectory axis) + topology signatures
# ---------------------------------------------------------------------------


def fleet_mesh(devices: Union[None, int, Sequence] = None
               ) -> Tuple[torch.device, ...]:
    """A 1-D mesh over ``devices`` for trajectory-axis sharding.

    ``devices`` may be an int n (the first n CUDA devices; n must not
    exceed ``torch.cuda.device_count()``), a sequence of devices (one
    device may appear more than once; an existing mesh is one), or None
    (every visible CUDA device; raises without one).
    """
    if devices is None:
        devices = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
    if isinstance(devices, int):
        return _cuda_devices(devices, "fleet_mesh")
    return _checked(devices, "fleet_mesh")


def mesh_signature(mesh) -> Optional[tuple]:
    """Hashable device-topology token for built-function cache keys:
    ``("mesh", axes, shape, platform, device indices)``, None for no mesh.
    A fleet mesh (a tuple of devices) has the one axis ``FLEET_AXIS``
    and its length for shape; a named ``Mesh`` its axis names and
    shape.  A mesh's shard rollouts and the single-device rollout are
    different entries; the key carries this signature so they never
    collide."""
    if mesh is None:
        return None
    if isinstance(mesh, Mesh):
        devs = list(mesh.devices.flat)
        axes, shape = mesh.axis_names, tuple(mesh.devices.shape)
    else:
        devs, axes, shape = list(mesh), FLEET_AXIS, len(mesh)
    idx = tuple(-1 if d.index is None else d.index for d in devs)
    return ("mesh", axes, shape, devs[0].type, idx)


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest padded size >= n divisible by ``multiple`` (every shard
    takes the same number of rows)."""
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# named meshes and partition specs
# ---------------------------------------------------------------------------


class Mesh:
    """An array of ``torch.device``s with a name for each of its axes.
    ``shape`` maps each axis to its size, in axis order, as jax's
    ``Mesh.shape`` does.  Entries may repeat a device (a bare ``cuda``
    is pinned to the current card), so a (data 2, model 4) mesh can be
    eight entries of one card."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"Mesh: {arr.ndim}-d devices for axes "
                             f"{axis_names}")
        self.devices = np.array(_checked(list(arr.flat), "Mesh"),
                                dtype=object).reshape(arr.shape)
        self.axis_names = axis_names

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    def positions(self) -> List[Tuple[int, ...]]:
        """Every mesh position, in row-major order."""
        return list(np.ndindex(*self.devices.shape))

    def index(self, pos: Tuple[int, ...]) -> Dict[str, int]:
        """``pos``'s index along each axis (``lax.axis_index``)."""
        return dict(zip(self.axis_names, pos))

    def __eq__(self, other):
        return isinstance(other, Mesh) and \
            mesh_signature(self) == mesh_signature(other)

    def __hash__(self):
        return hash(mesh_signature(self))

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``Mesh`` of ``shape`` over the first prod(shape) of ``devices``
    (default: the visible CUDA devices; raises if there are fewer), in
    row-major order, as ``jax.make_mesh``."""
    n = int(np.prod(shape))
    devs = _cuda_devices(n, "make_mesh") if devices is None \
        else list(devices)
    if len(devs) < n:
        raise ValueError(f"make_mesh: {len(devs)} device(s) for a mesh of "
                         f"{tuple(shape)}")
    return Mesh(np.array(devs[:n], dtype=object).reshape(tuple(shape)),
                axis_names)


class PartitionSpec(tuple):
    """A dimension's entry is None (not split), an axis name or a tuple of
    axis names (split over their product, the first outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


def _batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def default_rules(mesh: Mesh, seq_shard_kv: bool = False,
                  fsdp: bool = True,
                  attn_seq_shard: bool = False,
                  kv_batch_shard: bool = True) -> Dict[str, PartitionSpec]:
    """FSDP(data) x TP(model) rules, the reference's table.

    ``seq_shard_kv``: shard decode KV caches along the sequence dim on the
    model axis (flash-decode layout for long contexts / few KV heads).
    ``attn_seq_shard``: heads don't divide the model axis: the residual
    stream is row-sharded [B, S("model"), ...] and weights are FSDP-only.
    ``kv_batch_shard``: KV caches shard their batch on the batch axes.
    """
    b = _batch_axes(mesh)
    bb = b if len(b) > 1 else (b[0] if b else None)
    fs = b[-1] if (fsdp and b) else None    # FSDP shard axis for weights
    kv_b = bb if kv_batch_shard else None
    kv_spec = P(kv_b, "model", None, None) if seq_shard_kv \
        else P(kv_b, None, "model", None)
    bthd = P(bb, "model", None, None) if attn_seq_shard \
        else P(bb, None, "model", None)
    q_chunk = P(bb, "model", None, None) if attn_seq_shard \
        else P(bb, None, "model", None)
    seq = "model" if attn_seq_shard else None
    return {
        # activations
        "act_btd": P(bb, seq, None),
        "act_btf": P(bb, seq, "model" if not attn_seq_shard else None),
        "act_bthd": bthd,
        "attn_q_chunk": q_chunk,
        "act_btv": P(bb, seq, "model" if not attn_seq_shard else None),
        "act_bd": P(bb, None),
        # KV cache [batch, seq, kv_heads, head_dim]
        "kv_bskd": kv_spec,
        # recurrent state [batch, width]
        "state_bw": P(bb, "model"),
        "state_bhij": P(bb, "model", None, None),
        # weights
        "w_df": P(fs, "model"),
        "w_fd": P("model", fs),
        "w_dd": P(fs, "model"),
        "w_qkv": P(fs, "model", None),      # [d, heads, head_dim]
        "w_o": P("model", None, fs),        # [heads, head_dim, d]
        "w_vd": P("model", fs),             # embedding [vocab, d]
        "w_edf": P("model", fs, None),      # experts [E, d, ff]
        "w_efd": P("model", None, fs),      # experts [E, ff, d]
        "w_bias": P(None),
        "w_scan": P(None),                  # per-layer scalars
        # MoE dispatch buffer [experts, capacity, d]
        "moe_ecd": P("model", bb, None),
        "moe_ted": P(bb, None, None),
    }


@contextmanager
def use_mesh_rules(mesh: Optional[Mesh],
                   rules: Optional[Dict[str, PartitionSpec]] = None, **kw):
    """Make ``mesh`` and its rules (default ``default_rules(mesh, **kw)``)
    current for model code run in this thread; None clears them."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = None if mesh is None else \
        (mesh, rules or default_rules(mesh, **kw))
    try:
        yield
    finally:
        _state.ctx = prev


def logical_spec(name: str) -> Optional[PartitionSpec]:
    ctx = getattr(_state, "ctx", None)
    return None if ctx is None else ctx[1].get(name)


def current_mesh() -> Optional[Mesh]:
    ctx = getattr(_state, "ctx", None)
    return None if ctx is None else ctx[0]


def sc(x, name: str):
    """Returns ``x``.  The reference's ``sc`` constrains only where XLA
    lays ``x`` out (``with_sharding_constraint``), never its values; the
    port runs a mesh's shards from the host in turn, so a tensor has no
    layout over the mesh to constrain.  Kept so code ported from the
    reference reads the same; the model code does not call it."""
    return x


def named_sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def batch_spec(mesh: Mesh) -> PartitionSpec:
    b = _batch_axes(mesh)
    return P(b if len(b) > 1 else (b[0] if b else None))


# ---------------------------------------------------------------------------
# the shard runner and the collectives
# ---------------------------------------------------------------------------


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _block_index(mesh: Mesh, axes: Tuple[str, ...],
                 idx: Mapping[str, int]) -> Tuple[int, int]:
    """(block index, number of blocks) of a dimension split over
    ``axes`` at the position whose axis indices are ``idx``."""
    i, n = 0, 1
    for a in axes:
        i, n = i * mesh.shape[a] + idx[a], n * mesh.shape[a]
    return i, n


def shard_of(x: torch.Tensor, mesh: Mesh, spec: Sequence,
             pos: Tuple[int, ...]) -> torch.Tensor:
    """Mesh position ``pos``'s block of ``x`` under ``spec`` (a dimension
    split over axes a1, a2, ... is cut into size(a1) size(a2) ... equal
    blocks, indexed row-major), contiguous, on the position's device."""
    dev = mesh.devices[pos]
    if x.device.type != dev.type:
        raise ValueError(f"a mesh of {dev.type} devices given a tensor on "
                         f"{x.device}")
    if len(spec) > x.dim():
        raise ValueError(f"spec {tuple(spec)} for a {x.dim()}-d tensor")
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if not axes:
            continue
        i, n = _block_index(mesh, axes, mesh.index(pos))
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split into {n} blocks over {axes}")
        blk = x.shape[dim] // n
        x = x.narrow(dim, i * blk, blk)
    return x.contiguous().to(dev, non_blocking=True)


def assemble(blocks: np.ndarray, mesh: Mesh, spec: Sequence,
             device: Optional[torch.device] = None) -> torch.Tensor:
    """The tensor whose ``spec`` blocks ``blocks`` (an object array of
    the mesh's shape) hold, on ``device`` (default the mesh's first
    entry).  An axis the spec does not name takes the block at index 0
    along it (the shards are replicas there)."""
    device = device if device is not None else mesh.devices.flat[0]
    named = {a for e in spec for a in _axes_of(e)}
    parts: Dict[tuple, torch.Tensor] = {}
    for pos in mesh.positions():
        idx = mesh.index(pos)
        if any(i for a, i in idx.items() if a not in named):
            continue
        key = tuple(_block_index(mesh, _axes_of(e), idx)[0] for e in spec)
        parts[key] = blocks[pos].to(device)

    def cat(prefix: tuple, dim: int) -> torch.Tensor:
        if dim == len(spec):
            return parts[prefix]
        n = math.prod(mesh.shape[a] for a in _axes_of(spec[dim]))
        return torch.cat([cat(prefix + (i,), dim + 1) for i in range(n)],
                         dim=dim)
    return cat((), 0)


def run_shards(f: Callable, mesh: Mesh, in_specs: Sequence,
               *args) -> np.ndarray:
    """``f(index, *blocks)`` once a mesh position, in row-major order,
    where ``index`` maps each axis to the position's index along it
    (what ``lax.axis_index`` reads) and ``blocks`` are the position's
    blocks of ``args`` under ``in_specs``, on its device.  Returns the
    object array of the positions' outputs, for the caller's
    collectives."""
    outs = np.empty(mesh.devices.shape, dtype=object)
    for pos in mesh.positions():
        outs[pos] = f(mesh.index(pos), *[shard_of(a, mesh, s, pos)
                                          for a, s in zip(args, in_specs)])
    return outs


def shard_map_compat(f: Callable, mesh: Mesh, in_specs: Sequence,
                     out_specs: Optional[Any]):
    """The host's counterpart of ``shard_map``: ``run(*args)`` is
    ``run_shards(f, mesh, in_specs, *args)``.  With ``out_specs`` (one
    spec, or a tuple of specs for a tuple of outputs) the outputs are
    assembled by them (``assemble``); with None, ``run`` returns the
    object array of the positions' outputs."""
    def run(*args):
        outs = run_shards(f, mesh, in_specs, *args)
        if out_specs is None:
            return outs
        if isinstance(out_specs, PartitionSpec):
            return assemble(outs, mesh, out_specs)
        return tuple(assemble(field(outs, i), mesh, s)
                     for i, s in enumerate(out_specs))
    return run


def field(outs: np.ndarray, i: int) -> np.ndarray:
    """Output ``i`` of each position in ``outs`` (an object array of the
    positions' output tuples), as an object array of the same shape."""
    arr = np.empty(outs.shape, dtype=object)
    for k in np.ndindex(*outs.shape):
        arr[k] = outs[k][i]
    return arr


def groups_along(mesh: Mesh, axes: Union[str, Sequence[str]]
                 ) -> List[List[Tuple[int, ...]]]:
    """The mesh's positions in groups that differ only along ``axes``
    (each group in row-major order over them): a collective over
    ``axes`` runs once a group."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    groups: Dict[tuple, List[Tuple[int, ...]]] = {}
    for pos in mesh.positions():
        key = tuple(i for a, i in zip(mesh.axis_names, pos)
                    if a not in axes)
        groups.setdefault(key, []).append(pos)
    return list(groups.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _reduce(values: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    """``op`` folded over ``values`` in order on the first value's
    device; the result placed on every value's device."""
    acc = values[0]
    for v in values[1:]:
        acc = op(acc, v.to(acc.device))
    return [acc.to(v.device) for v in values]


@charged_unit
def psum(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The shards' sum, added in shard order, on every shard's device.
    An op profiler charges it as an all-reduce: twice the result's bytes
    a shard."""
    charge_collective("all-reduce", 2 * _nbytes(values[0]), len(values))
    return _reduce(values, torch.add)


@charged_unit
def pmax(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The shards' elementwise max, on every shard's device (an
    all-reduce to an op profiler)."""
    charge_collective("all-reduce", 2 * _nbytes(values[0]), len(values))
    return _reduce(values, torch.maximum)


@charged_unit
def pmean(values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``psum`` divided by the number of shards (one all-reduce)."""
    return [s / len(values) for s in psum(values)]


@charged_unit
def ppermute(values: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Shard j gets shard i's value for each (i, j) of ``perm``, moved to
    shard j's device; a shard no pair names gets zeros.  An op profiler
    charges a collective-permute of the result's bytes a shard."""
    charge_collective("collective-permute", _nbytes(values[0]), len(values))
    out = [torch.zeros_like(v) for v in values]
    for i, j in perm:
        out[j] = values[i].to(values[j].device, non_blocking=True)
    return out


def collective(blocks: np.ndarray, mesh: Mesh,
               axes: Union[str, Sequence[str]],
               fn: Callable[[Sequence[torch.Tensor]], List[torch.Tensor]]
               ) -> np.ndarray:
    """``fn`` (``psum``, ``pmax``, ...) over each group of ``blocks`` (an
    object array of the mesh's shape) along ``axes``."""
    out = np.empty(blocks.shape, dtype=object)
    for group in groups_along(mesh, axes):
        for pos, v in zip(group, fn([blocks[p] for p in group])):
            out[pos] = v
    return out


__all__ = ["FLEET_AXIS", "Mesh", "NamedSharding", "P", "PartitionSpec",
           "assemble", "batch_spec", "collective", "current_mesh",
           "default_rules", "field", "fleet_mesh", "groups_along",
           "logical_spec", "make_mesh", "mesh_signature", "named_sharding",
           "pad_to_multiple", "pmax", "pmean", "ppermute", "psum",
           "run_shards", "sc", "shard_map_compat", "shard_of",
           "use_mesh_rules"]
