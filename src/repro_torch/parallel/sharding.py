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
each input (``Spmd``'s positions and blocks), and the collectives (``psum``, ``pmax``, ``pmean``,
``ppermute``) are plain functions over the shards' values in mesh order,
each summed or compared in that fixed order, so a run repeats bitwise.

**The sharded program.** ``Spmd`` runs a model's layers under a mesh's
rules position by position, region by region: a value is a list of the
positions' blocks, and its collectives (``psum``, ``pmax``,
``pbroadcast``, ``all_gather``, ``psum_scatter``) are autograd Functions
whose backwards are the transposed collectives, each charging its bytes
(and whether its group crosses ``pod``) to the op profiler.  On a mesh
of ``meta`` entries it runs one position only, the program a device of
the mesh would run: the last along ``model`` (index 0 along the other
axes), which under the sequence layouts holds the last row block or the
last cache block, the most attention work.  Its layouts are the rules':
``seq_rows`` (``attn_seq_shard``: a position holds a block of the
sequence's rows, weights FSDP-only, K/V all-gathered over ``model``; a
recurrence runs block after block along ``model``, each position
starting from the state its predecessor hands on, ``hand_on``)
and ``seq_kv`` (``seq_shard_kv``: a position holds a block of the KV
cache's slots; decode merges the blocks' partial attention by their
log-sum-exps).

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
                   rules: Optional[Dict[str, PartitionSpec]] = None,
                   one_position: Union[bool, int, None] = None, **kw):
    """Make ``mesh`` and its rules (default ``default_rules(mesh, **kw)``)
    current for model code run in this thread; None clears them.
    ``one_position``: whether a sharded program runs one position only,
    or the index along ``model`` of that one position (``Spmd``; default:
    one, the last along ``model``, where every entry is ``meta``)."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = None if mesh is None else \
        (mesh, rules or default_rules(mesh, **kw), one_position)
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


def rule_splits(name: str, dim: int, axis: str = "model") -> bool:
    """Whether the current rules split dimension ``dim`` of the logical
    name ``name`` over ``axis`` (``act_btd`` 1: ``attn_seq_shard``'s
    rows; ``kv_bskd`` 1: ``seq_shard_kv``'s cache slots)."""
    spec = logical_spec(name)
    return spec is not None and len(spec) > dim and spec[dim] == axis


def current_spmd(kind: Optional[str] = None) -> Optional["Spmd"]:
    """The positions a sharded program runs on the current mesh (as
    ``use_mesh_rules`` set them), or None without a mesh.  For a model
    program of ``kind`` (``train``, ``prefill``, ``decode``) its layouts
    follow the rules: rows over ``model`` (``attn_seq_shard``) but in
    decode, whose one new token has no rows to split, and the cache's
    slots over ``model`` (``seq_shard_kv``) where a cache is made or
    read."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return None
    kv = logical_spec("kv_bskd")
    return Spmd(ctx[0], one_position=ctx[2],
                seq_rows=kind in ("train", "prefill") and
                rule_splits("act_btd", 1),
                seq_kv=kind in ("prefill", "decode") and
                rule_splits("kv_bskd", 1),
                batch_rows=kind == "train" or kv is None or
                kv[0] is not None)


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
    blocks, indexed row-major), contiguous, on the position's device
    (``Spmd.block``)."""
    sp = Spmd(mesh, one_position=False)
    return sp.block(x, spec, sp.positions.index(tuple(pos))).contiguous()


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
    sp = Spmd(mesh, one_position=False)
    outs = np.empty(mesh.devices.shape, dtype=object)
    for k, pos in enumerate(sp.positions):
        outs[pos] = f(sp.index(k), *[sp.block(a, s, k).contiguous()
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


# ---------------------------------------------------------------------------
# the sharded program: each position's block, region by region
# ---------------------------------------------------------------------------
#
# A sharded program holds one tensor a mesh position for each value (a
# list in ``Spmd.positions`` order) and runs the positions in turn, region
# by region; the collectives below combine the positions' values between
# regions.  Their gradients follow the reference's ``shard_map``: a value
# replicated over an axis carries its whole cotangent on every replica,
# so ``psum``'s backward is the identity and ``pbroadcast`` (the identity,
# where a replicated value enters a computation that differs along the
# axis) sums its cotangents; ``all_gather``'s backward is
# ``psum_scatter`` and the reverse.  Each collective and each backward
# charges its bytes to the active op profilers.


def _axes_tuple(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Spmd:
    """The positions a sharded program runs on ``mesh``: every position
    in row-major order, or, on a mesh of ``meta`` entries (the dry run),
    one position only (``one_position``): the last along ``model`` (or
    the index along it that ``one_position`` gives) and the first along
    every other axis, whose blocks are the largest (under ``seq_rows``
    its rows attend to the whole K/V prefix; a split by heads, experts
    or width gives every position alike blocks).  Its collectives then
    make that position's outputs and charge its own bytes, as a device
    of the mesh would.  ``seq_rows`` and ``seq_kv``
    are the program's sequence layouts, ``batch_rows`` whether its batch
    rows split over the batch axes (serving under
    ``kv_batch_shard=False`` replicates them over those axes, as the
    reference does a batch of one) (``current_spmd``)."""

    def __init__(self, mesh: Mesh,
                 one_position: Union[bool, int, None] = None,
                 seq_rows: bool = False, seq_kv: bool = False,
                 batch_rows: bool = True):
        self.mesh = mesh
        at = mesh.shape.get("model", 1) - 1
        if one_position is None:
            one_position = all(d.type == "meta" for d in mesh.devices.flat)
        elif not isinstance(one_position, bool):
            at, one_position = int(one_position), True
        self.one_position = bool(one_position)
        self.seq_rows, self.seq_kv = bool(seq_rows), bool(seq_kv)
        self.batch_rows = bool(batch_rows)
        if self.one_position:
            self.positions = [tuple(at if a == "model" else 0
                                    for a in mesh.shape)]
        else:
            self.positions = mesh.positions()

    @property
    def n(self) -> int:
        """Positions this program runs."""
        return len(self.positions)

    def index(self, k: int) -> Dict[str, int]:
        return self.mesh.index(self.positions[k])

    def device(self, k: int) -> torch.device:
        return self.mesh.devices[self.positions[k]]

    def size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in _axes_tuple(axes)
                         if a in self.mesh.shape)

    def batch_axes(self) -> Tuple[str, ...]:
        return _batch_axes(self.mesh)

    def batch_entry(self):
        """The spec entry of a batch dimension: the batch axes, or None
        where the rows are replicated over them (``batch_rows``)."""
        return batch_spec(self.mesh)[0] if self.batch_rows else None

    def groups(self, axes) -> List[List[int]]:
        """Indices into ``positions`` of the positions that differ only
        along ``axes``, a group each, in row-major order over them."""
        axes = _axes_tuple(axes)
        groups: Dict[tuple, List[int]] = {}
        for k, pos in enumerate(self.positions):
            key = tuple(i for a, i in zip(self.mesh.axis_names, pos)
                        if a not in axes)
            groups.setdefault(key, []).append(k)
        return list(groups.values())

    def crosses_pod(self, axes) -> bool:
        return "pod" in _axes_tuple(axes) and self.mesh.shape.get("pod",
                                                                   1) > 1

    def block(self, x: torch.Tensor, spec: Sequence, k: int,
              copy: Optional[bool] = None) -> torch.Tensor:
        """Position ``k``'s block of ``x`` under ``spec``: a view of ``x``
        where it lies on the position's device (positions that share a
        card share its storage), else a contiguous copy on that device;
        ``copy`` True or False forces one or the other."""
        if x.device.type != self.device(k).type:
            raise ValueError(f"a mesh of {self.device(k).type} devices "
                             f"given a tensor on {x.device}")
        if len(spec) > x.dim():
            raise ValueError(f"spec {tuple(spec)} for a {x.dim()}-d tensor")
        idx = self.index(k)
        for dim, entry in enumerate(spec):
            axes = _axes_of(entry)
            if axes:
                i, n = _block_index(self.mesh, axes, idx)
                if x.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of "
                                     f"{tuple(x.shape)} does not split "
                                     f"into {n} blocks over {axes}")
                blk = x.shape[dim] // n
                x = x.narrow(dim, i * blk, blk)
        if copy is None:
            copy = x.device != self.device(k)
        if not copy:
            return x
        return x.to(self.device(k), copy=True,
                    memory_format=torch.contiguous_format)

    def split(self, x: torch.Tensor, spec: Sequence,
              copy: Optional[bool] = None) -> List[torch.Tensor]:
        """Every position's block of ``x`` under ``spec``."""
        return [self.block(x, spec, k, copy) for k in range(self.n)]

    def assemble(self, xs: Sequence[torch.Tensor], spec: Sequence,
                 device: Optional[torch.device] = None) -> torch.Tensor:
        """The tensor the positions' blocks ``xs`` make under ``spec``
        (``assemble``); on one position, its block."""
        if self.one_position:
            return xs[0]
        arr = np.empty(self.mesh.devices.shape, dtype=object)
        for k, pos in enumerate(self.positions):
            arr[pos] = xs[k]
        return assemble(arr, self.mesh, spec, device)

    # -- the collectives, over each group along ``axes`` --------------------
    def psum(self, xs, axes):
        """The sum over ``axes`` on every position (an all-reduce); its
        backward is the identity."""
        return _collective(self, axes, "psum", "identity", 0, xs)

    def pmean(self, xs, axes):
        n = self.size(axes)
        return [x / n for x in self.psum(xs, axes)]

    def pmax(self, xs, axes):
        """The elementwise max over ``axes`` (an all-reduce), without a
        gradient: the sharded logsumexp's stabiliser."""
        return _collective(self, axes, "pmax", None, 0,
                           [x.detach() for x in xs])

    def from_index(self, xs, axis: str, i: int) -> List[torch.Tensor]:
        """Each position given the value of the position at index ``i``
        along ``axis`` in its group (on one position, its own): where one
        position's block holds a result, as the last row of a prefill.
        The host reads the block it chooses; the transfer is charged as
        GSPMD makes it, an all-reduce over ``axis`` to which the other
        positions add zeros."""
        out = list(xs)
        for group in self.groups(axis):
            if len(group) > 1:
                for k in group:
                    out[k] = xs[group[i]]
        self.charge("all-reduce", 2 * _nbytes(xs[0]), axis)
        return out

    def charge(self, kind: str, nbytes: int, axes) -> None:
        """Charge one ``kind`` collective of ``nbytes`` a shard over
        ``axes`` to the positions this program runs: a transfer the host
        makes by its choice of block (``from_index``)."""
        size = self.size(axes)
        if size > 1:
            for group in self.groups(axes):
                charge_collective(kind, nbytes, size, len(group),
                                  self.crosses_pod(axes))

    def pbroadcast(self, xs, axes):
        """The identity, where a value replicated over ``axes`` enters a
        computation that differs along them: its backward sums the
        positions' cotangents over ``axes`` (an all-reduce)."""
        return _collective(self, axes, "identity", "psum", 0, xs)

    def all_gather(self, xs, axes, dim: int):
        """The group's blocks concatenated along ``dim`` in group order,
        on every position; the backward is ``psum_scatter``."""
        return _collective(self, axes, "all_gather", "psum_scatter", dim,
                           xs)

    def psum_scatter(self, xs, axes, dim: int):
        """The sum over ``axes``, position i of the group keeping block i
        of it along ``dim`` (a reduce-scatter); the backward is
        ``all_gather``."""
        return _collective(self, axes, "psum_scatter", "all_gather", dim,
                           xs)

    def prev_along(self, k: int, axis: str = "model") -> Optional[int]:
        """The index into ``positions`` of the position one step before
        position ``k`` along ``axis`` (in row-major order it runs
        before k), or None where k is the first along it or this
        program does not run that position (one position's)."""
        pos = list(self.positions[k])
        i = self.mesh.axis_names.index(axis)
        if pos[i] == 0:
            return None
        pos[i] -= 1
        pos = tuple(pos)
        return self.positions.index(pos) if pos in self.positions else None

    def hand_on(self, k: int, prev, init, anchor=None,
                axis: str = "model") -> List[torch.Tensor]:
        """Position ``k``'s starting state in a chain along ``axis`` (a
        recurrence whose rows are split over it, each block starting
        where the one before stopped): its predecessor's final state
        ``prev`` (a tuple of tensors) moved onto its device, or ``init``
        where it has none: the first along ``axis``, or on one
        position's program a position whose predecessor it does not run
        (there it receives ``init``'s values, a ``meta`` stand-in in the
        dry run).  A collective-permute along ``axis`` that every
        position of a group takes part in (each sends its final state on
        and receives its predecessor's), charged for position k, the
        state's bytes, once in the forward and once in the backward,
        where the state's gradient goes back to the predecessor.
        ``anchor`` (the position's rows entering the chain) ties the
        backward, and its charge, to the graph at every position, the
        first too."""
        src = tuple(prev if prev is not None else init)
        nbytes = sum(_nbytes(t) for t in src)
        return list(_HandOn.apply(self, k, axis, nbytes, anchor, *src))

    def unreplicate(self, xs) -> torch.Tensor:
        """The value every position holds alike (a loss after its
        ``pmean``), once: its cotangent reaches every position's copy
        whole, as a replicated output's does."""
        return _Unreplicate.apply(*xs)


_KIND = {"psum": "all-reduce", "pmax": "all-reduce",
         "all_gather": "all-gather", "psum_scatter": "reduce-scatter"}


def _wide(x: torch.Tensor, op: str) -> torch.Tensor:
    """A sum's accumulator: float32 for 16-bit values."""
    if op != "pmax" and x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x


@charged_unit
def _run_collective(sp: Spmd, axes, op: str, dim: int,
                    xs: Sequence[torch.Tensor],
                    need: Optional[Sequence[bool]] = None
                    ) -> List[Optional[torch.Tensor]]:
    """``op`` over each group of ``xs`` along ``axes``, charged: each
    group's bytes a shard for the shards present (on one position, the
    group's size is the mesh's and the other shards' values are taken
    to be alike).  Sums of 16-bit values are added in float32 and
    rounded once, as the unsharded product's accumulator is; the bytes
    charged are the values' own.  ``need`` (a backward's inputs that take
    a gradient) leaves the other positions' results None: a weight's
    replicas over eight entries of one card would otherwise each hold a
    copy of its gradient."""
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    size = sp.size(axes)
    pod = sp.crosses_pod(axes)
    need = [True] * len(xs) if need is None else need
    for group in sp.groups(axes):
        vals = [xs[k] for k in group]
        if op == "identity":
            res = vals
            shape = vals[0].shape
        elif op in ("psum", "pmax"):
            fold = torch.add if op == "psum" else torch.maximum
            acc = _wide(vals[0], op)
            for v in vals[1:]:
                acc = fold(acc, _wide(v.to(acc.device), op))
            res = [acc.to(sp.device(k), vals[0].dtype, copy=True)
                   if need[k] else None for k in group]
            shape = acc.shape
        elif op == "all_gather":
            if sp.one_position:
                full = torch.cat([vals[0]] * size, dim=dim)
            else:
                full = torch.cat([v.to(vals[0].device) for v in vals], dim)
            res = [full.to(sp.device(k), copy=True) if need[k] else None
                   for k in group]
            shape = full.shape
        elif op == "psum_scatter":
            acc = _wide(vals[0], op)
            for v in vals[1:]:
                acc = acc + _wide(v.to(acc.device), op)
            blk = acc.shape[dim] // size
            res = [acc.narrow(dim, (j if not sp.one_position else 0) * blk,
                              blk).to(sp.device(k), vals[0].dtype, copy=True)
                   if need[k] else None for j, k in enumerate(group)]
            shape = acc.narrow(dim, 0, blk).shape
        else:
            raise ValueError(f"unknown collective {op!r}")
        if op != "identity" and size > 1:
            nbytes = math.prod(shape) * vals[0].element_size()
            if op in ("psum", "pmax"):
                nbytes *= 2
            elif op == "psum_scatter":
                nbytes *= size
            charge_collective(_KIND[op], nbytes, size, len(group), pod)
        for k, r in zip(group, res):
            out[k] = r
    return out


class _Collective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sp, axes, op, back, dim, *xs):
        ctx.sp, ctx.axes, ctx.back, ctx.dim = sp, axes, back, dim
        return tuple(_run_collective(sp, axes, op, dim, xs))

    @staticmethod
    def backward(ctx, *gs):
        if ctx.back is None:
            raise RuntimeError("this collective has no gradient")
        return (None,) * 5 + tuple(_run_collective(
            ctx.sp, ctx.axes, ctx.back, ctx.dim, gs,
            ctx.needs_input_grad[5:]))


def _collective(sp: Spmd, axes, op: str, back: Optional[str], dim: int,
                xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return list(_Collective.apply(sp, axes, op, back, dim, *xs))


class _HandOn(torch.autograd.Function):
    """``Spmd.hand_on``'s transfer: the state onto position k's device,
    its gradient back onto the source's; one collective-permute shard
    charged each way."""

    @staticmethod
    @charged_unit
    def forward(ctx, sp, k, axis, nbytes, anchor, *xs):
        ctx.sp, ctx.k, ctx.axis, ctx.nbytes = sp, k, axis, nbytes
        ctx.devices = [x.device for x in xs]
        _charge_permute(sp, axis, nbytes)
        return tuple(x.to(sp.device(k), copy=True) for x in xs)

    @staticmethod
    @charged_unit
    def backward(ctx, *gs):
        _charge_permute(ctx.sp, ctx.axis, ctx.nbytes)
        return (None,) * 5 + tuple(
            None if g is None else g.to(d, copy=True)
            for g, d in zip(gs, ctx.devices))


def _charge_permute(sp: Spmd, axis: str, nbytes: int) -> None:
    size = sp.size(axis)
    if size > 1:
        charge_collective("collective-permute", nbytes, size, 1,
                          sp.crosses_pod(axis))


class _Unreplicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.devices = [x.device for x in xs]
        return xs[0].clone()

    @staticmethod
    def backward(ctx, g):
        return tuple(g.to(d, copy=True) for d in ctx.devices)


__all__ = ["FLEET_AXIS", "Mesh", "NamedSharding", "P", "PartitionSpec", "Spmd",
           "assemble", "batch_spec", "collective", "current_mesh",
           "current_spmd", "default_rules", "field", "fleet_mesh",
           "groups_along", "logical_spec", "make_mesh", "mesh_signature",
           "named_sharding", "pad_to_multiple", "pmax", "pmean", "ppermute",
           "psum", "rule_splits", "run_shards", "sc", "shard_map_compat",
           "shard_of", "use_mesh_rules"]
