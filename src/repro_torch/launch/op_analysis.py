"""Op-level profiler of the port: the counterpart of the reference's
``launch/hlo_analysis.py``, which parses a compiled HLO module.  Torch
has no HLO, so this counts the program as it runs, op by op, under a
``TorchDispatchMode`` that works on ``meta``, CPU and CUDA tensors alike
(the dry run runs the port's real entry points on ``meta``).  It counts:

* ``dot_flops``: the matrix products of the aten ops (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, the convolutions, SDPA: the formulas of
  ``torch.utils.flop_counter``).  Eager execution runs every loop
  iteration, so each is counted as often as it runs: the reference's
  trip-count multiplication;
* ``traffic_bytes``: the input plus output bytes of every aten op that
  is not free (views, ``empty``, ``detach`` and the like move nothing:
  the reference's ``_FREE_OPS``, with each eager op a kernel boundary);
* the collectives the port's host collectives charge
  (``parallel.sharding.psum`` / ``pmax`` / ``pmean`` / ``ppermute``,
  ``optim.grad_compress.psum_compressed`` through them, and the sharded
  program's ``Spmd`` collectives with their backwards) by kind, in the
  reference's accounting (an all-reduce 2x its result's bytes, a
  reduce-scatter its result's bytes times the group, the others 1x),
  summed over the shards charged, with the bytes of groups that cross
  pods and the schedule (``roofline.CollectiveStats``);
* each hand-written kernel call by name and route, with its work
  (``kernels.work.KERNEL_WORK``).  While a kernel's public entry in
  ``kernels/<k>/ops.py`` runs (its autograd Function included), the ops
  inside it are not counted: the CPU's plain version, the card's kernel
  and the ``meta`` entry give the same counts, whatever copies or
  padding each route makes;
* the peak of live storage bytes the program allocates (storages keyed
  by their ``StorageImpl``, not by data pointer, which is 0 on ``meta``;
  a finalizer drops each when it dies).  A storage first seen as an op's
  input existed before (an argument) and is not counted.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels
from repro_torch.launch.roofline import CollectiveStats

aten = torch.ops.aten

#: ops that move no bytes: views (``OpOverload.is_view``) and these
_FREE_OPS = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
    aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
    aten.set_, aten.resize_, aten._unsafe_view,
}

_CONVS = {aten.convolution, aten._convolution, aten.cudnn_convolution,
          aten.convolution_overrideable, aten._slow_conv2d_forward,
          aten.convolution_backward}


def _tensors(tree, out=None) -> list:
    """The tensors in a nest of tuples, lists and dicts (an op's
    arguments and outputs, a program's inputs)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_class(conv: bool, inputs) -> str:
    """The peak class of a product (``conv``: a convolution): bf16 / fp16
    inputs on the tensor cores; float32 on TF32 tensor cores where torch
    lets the library use them, else fp32."""
    if any(t.dtype in (torch.bfloat16, torch.float16) for t in inputs):
        return "bf16"
    if conv:
        return "tf32" if torch.backends.cudnn.allow_tf32 else "fp32"
    return "fp32" if torch.get_float32_matmul_precision() == "highest" \
        else "tf32"


@dataclass
class OpProfile:
    """What ``OpProfiler`` counted.  ``flops_by_class`` holds the aten
    products by class plus each kernel's work by its class;
    ``kernels[name][route]`` the calls, FLOPs and bytes of a kernel on a
    route (route None: a kernel with one); ``by_op[aten op]`` the calls,
    bytes and FLOPs of each counted op; ``coll_*`` are summed over the
    shards that take part."""

    dot_flops: float = 0.0
    traffic_bytes: float = 0.0
    flops_by_class: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    kernels: Dict[str, Dict[Any, Dict[str, float]]] = field(
        default_factory=dict)
    kernel_bytes: float = 0.0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    peak_bytes: int = 0
    by_op: Dict[str, list] = field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0, 0.0]))

    @property
    def coll_bytes(self) -> Dict[str, float]:
        return self.collectives.bytes_by_kind

    @property
    def coll_count(self) -> Dict[str, float]:
        return self.collectives.count_by_kind

    @property
    def total_coll_bytes(self) -> float:
        return self.collectives.total_bytes

    def kernel_calls(self) -> Dict[str, Dict[Any, Dict[str, float]]]:
        """``kernels`` as plain dicts (routes as strings), for equality
        and JSON."""
        return {n: {str(r): dict(v) for r, v in routes.items()}
                for n, routes in sorted(self.kernels.items())}

    def counts(self) -> Dict[str, Any]:
        """The counts a device-independent run must repeat exactly: the
        aten products and traffic, and the kernel calls with their
        work."""
        return {"dot_flops": self.dot_flops,
                "traffic_bytes": self.traffic_bytes,
                "kernels": self.kernel_calls()}


class OpProfiler(TorchDispatchMode):
    """Counts every aten op run inside the ``with`` block into
    ``self.profile`` (an ``OpProfile``).  ``quiet`` > 0 while a charged
    unit (a kernel's entry, a host collective) runs: its ops are not
    counted, but their allocations are tracked.  With ``device`` (a
    device type: ``cuda``, ``meta``) only the program on that device is
    counted: an op none of whose tensors is there is host work (the
    host's copy of a batch, the RNG states a recompute saves), and only
    storages there count to the peak."""

    def __init__(self, device: Optional[str] = None):
        super().__init__()
        self.device = None if device is None else torch.device(device).type
        # the tensor attribute that says a tensor is on ``device``
        self._on = None if device is None else f"is_{self.device}"
        self.profile = OpProfile()
        self.quiet = 0
        # storage (its StorageImpl's address) -> bytes, or None for one
        # that existed before the block; each entry leaves when its
        # storage dies (a finalizer on the storage's Python object, which
        # torch keeps as long as the storage lives)
        self._seen: Dict[int, Optional[int]] = {}
        self._live_bytes = 0

    def __enter__(self):
        kernels.PROFILERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            kernels.PROFILERS.remove(self)

    # -- the units' charges -------------------------------------------------
    def record_kernel(self, name: str, work) -> None:
        rec = self.profile.kernels.setdefault(name, {}).setdefault(
            work.route, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += work.flops
        rec["bytes"] += work.bytes
        self.profile.flops_by_class[work.peak] += work.flops
        self.profile.kernel_bytes += work.bytes

    def record_collective(self, kind: str, nbytes: float, group: int,
                          shards: Optional[int] = None,
                          pod: bool = False) -> None:
        """One collective over a group of ``group`` shards, ``nbytes``
        moved by each of the ``shards`` charged (default the group), into
        ``profile.collectives``."""
        self.profile.collectives.add(kind, nbytes, group,
                                     group if shards is None else shards,
                                     pod)

    # -- the ops ------------------------------------------------------------
    def _died(self, key: int) -> None:
        nbytes = self._seen.pop(key, None)
        if nbytes:
            self._live_bytes -= nbytes

    def _note(self, st, nbytes: Optional[int]) -> None:
        key = st._cdata
        if key in self._seen:
            return
        self._seen[key] = nbytes
        weakref.finalize(st, self._died, key)
        if nbytes:
            self._live_bytes += nbytes

    def arguments(self, tree) -> None:
        """Mark the storages of ``tree``'s tensors as existing before the
        block (the program's arguments)."""
        for t in _tensors(tree):
            self._note(t.untyped_storage(), None)

    def _track(self, inputs, outputs) -> None:
        """Storages first seen as an input existed before the block;
        those first seen as an output are the block's, live until they
        are freed."""
        for t in inputs:
            self._note(t.untyped_storage(), None)
        for t in outputs:
            st = t.untyped_storage()
            self._note(st, st.nbytes() if self._on is None or
                       getattr(t, self._on) else None)
        if self._live_bytes > self.profile.peak_bytes:
            self.profile.peak_bytes = self._live_bytes

    def live_bytes(self, tree=()) -> Tuple[int, int]:
        """(bytes of the block's storages still live, of those the bytes
        ``tree``'s tensors hold)."""
        keys = {t.untyped_storage()._cdata for t in _tensors(tree)}
        return self._live_bytes, sum(self._seen.get(k) or 0 for k in keys)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, flop_fn, moves, conv, fresh = _OP_INFO.get(func) or \
            _op_info(func)
        out = _call(func, fresh, args, kwargs)
        inputs = _tensors(args)
        if kwargs:
            _tensors(kwargs, inputs)
        outputs = _tensors(out)
        self._track(inputs, outputs)
        on = self._on
        if self.quiet or (on is not None and not any(
                getattr(t, on) for t in inputs) and not any(
                getattr(t, on) for t in outputs)):
            return out
        rec = self.profile.by_op[name]
        rec[0] += 1
        if flop_fn is not None:
            flops = float(flop_fn(*args, **kwargs, out_val=out))
            self.profile.dot_flops += flops
            self.profile.flops_by_class[_dot_class(conv, inputs)] += flops
            rec[2] += flops
        if moves:
            nbytes = sum(_nbytes(t) for t in inputs) + \
                sum(_nbytes(t) for t in outputs)
            self.profile.traffic_bytes += nbytes
            rec[1] += nbytes
        return out


_OP_INFO: Dict[Any, tuple] = {}


def _op_info(func) -> tuple:
    """(name, flop formula or None, moves bytes, a convolution, returns
    new tensors only) of an aten op, once an op."""
    info = _OP_INFO.get(func)
    if info is None:
        packet = func.overloadpacket
        schema = func._schema
        fresh = (not func.is_view and not schema.is_mutable and
                 bool(schema.returns) and
                 all(r.alias_info is None and str(r.type) == "Tensor"
                     for r in schema.returns))
        info = (str(func), flop_registry.get(packet),
                not func.is_view and packet not in _FREE_OPS,
                packet in _CONVS, fresh)
        _OP_INFO[func] = info
    return info


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


class _Unkeyable(Exception):
    pass


def _key(x):
    if isinstance(x, torch.Tensor):
        if not x.is_meta and x.dim():
            raise _Unkeyable
        return (x.shape, x.stride(), x.dtype, x.is_meta)
    if isinstance(x, _SCALARS):
        return x
    if isinstance(x, (tuple, list)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    raise _Unkeyable


#: (op, its arguments' key) -> its outputs' (shape, stride, dtype)
_META_OUT: Dict[Any, tuple] = {}


def _call(func, fresh, args, kwargs):
    """``func(*args, **kwargs)``; on ``meta`` an op that returns new
    tensors only is run once a signature (shapes, strides, dtypes and the
    other arguments): later calls get tensors of the outputs' shapes,
    strides and dtypes from ``empty_strided``.  Most of torch's ``meta``
    kernels are Python references (about 0.2 ms an op), which a
    full-size cell would run millions of times."""
    if not fresh:
        return func(*args, **kwargs)
    try:
        key = (func, _key(args), _key(kwargs))
    except _Unkeyable:
        return func(*args, **kwargs)
    spec = _META_OUT.get(key)
    if spec is not None:
        outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                         device="meta")
                     for shape, stride, dtype in spec)
        return outs if len(outs) > 1 else outs[0]
    out = func(*args, **kwargs)
    outs = out if isinstance(out, tuple) else (out,)
    # an op whose schema promises new tensors may still hand back its
    # input's storage (``_unsafe_view``): never run from the cache
    ins = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
    if any(isinstance(o, torch.Tensor) and o.untyped_storage()._cdata in ins
           for o in outs):
        _OP_INFO[func] = _OP_INFO[func][:4] + (False,)
        return out
    if all(isinstance(o, torch.Tensor) and o.is_meta for o in outs):
        _META_OUT[key] = tuple((o.shape, o.stride(), o.dtype)
                               for o in outs)
    return out


def profile(fn: Callable, *args, device: Optional[str] = None,
            **kwargs) -> OpProfile:
    """Run ``fn(*args, **kwargs)`` under an ``OpProfiler`` (counting the
    program on ``device``, or everything); returns what it counted (the
    reference's ``profile(hlo_text)``)."""
    with OpProfiler(device) as prof:
        fn(*args, **kwargs)
    return prof.profile


__all__ = ["OpProfile", "OpProfiler", "profile"]
