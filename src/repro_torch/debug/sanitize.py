"""Runtime sanitizer of the port (the reference's ``debug/sanitize.py``).

``sanitized()`` checks a live run:

* NaN debugging: a dispatch mode checks every floating output of every
  aten op run inside the block and raises ``FloatingPointError`` naming
  the first op that made a NaN; backward passes run under
  ``torch.autograd.set_detect_anomaly(True, check_nan=True)``.  Both are
  restored on exit.  The reference's ``jax_debug_nans`` checks only the
  outputs of jit-compiled functions, so a NaN that a ``where`` masks
  before the output (an ``inf - inf`` inside it) does not fire there;
  here it does, at the op that made it.  The hand-written kernels'
  outputs are filled outside torch's dispatcher: an aten op that reads a
  NaN from one and passes it on fires.
* a re-build audit over ``PlanFnCache`` instances: a "retrace" of the
  reference is, in the port, a new build of a cache key.  The audit
  snapshots each cache's ``builds`` on entry and diffs them on a clean
  exit.  A key new in the block may build ``max_traces_per_new_key``
  times; a key that existed and builds again, or a new one that builds
  more often, raises ``RetraceAuditError`` naming the keys.  An
  exception inside the block propagates with no audit (half-run counters
  prove nothing).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.runtime.scenario_engine import PLAN_FN_CACHE, PlanFnCache


class RetraceAuditError(AssertionError):
    """A PlanFnCache key was built again inside a ``sanitized()``
    block."""


def _snapshot(caches: Sequence[PlanFnCache]) -> Dict[int, Dict[tuple, int]]:
    return {id(c): dict(c.builds) for c in caches}


def _audit(caches: Sequence[PlanFnCache],
           before: Dict[int, Dict[tuple, int]],
           max_traces_per_new_key: int) -> None:
    offenders: list = []
    for cache in caches:
        base = before.get(id(cache), {})
        for key, count in cache.builds.items():
            prior = base.get(key)
            if prior is None:
                if count > max_traces_per_new_key:
                    offenders.append((key, 0, count))
            elif count > prior:
                offenders.append((key, prior, count))
    if offenders:
        lines = "\n".join(
            f"  {key[0] if key else key}...: {prior} -> {count} builds"
            for key, prior, count in offenders)
        raise RetraceAuditError(
            f"{len(offenders)} plan-cache key(s) re-traced (built again) "
            f"inside a sanitized() block — a static knob is missing from a "
            f"cache key, or the cache evicted a signature still in use:\n"
            f"{lines}")


def _floats(out):
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() and out.device.type != "meta":
            yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _floats(o)


class _NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first aten op whose floating
    output holds a NaN (``meta`` tensors hold no values)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _floats(out):
            if bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"NaN in the output of {func} (shape {tuple(t.shape)}, "
                    f"{t.dtype}, {t.device}) inside a sanitized() block")
        return out


@contextmanager
def sanitized(*caches: PlanFnCache, debug_nans: bool = True,
              retrace_audit: bool = True, max_traces_per_new_key: int = 1
              ) -> Iterator[Tuple[PlanFnCache, ...]]:
    """Run a block under NaN debugging and a plan-cache re-build audit.

    ``caches`` defaults to the process-wide ``PLAN_FN_CACHE``; pass
    engine-private caches explicitly to audit them too.  The audit runs
    only when the block exits cleanly."""
    audited: Tuple[PlanFnCache, ...] = caches or (PLAN_FN_CACHE,)
    anomaly = (torch.is_anomaly_enabled(),
               torch.is_anomaly_check_nan_enabled())
    mode = _NanCheck() if debug_nans else None
    if debug_nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        mode.__enter__()
    before = _snapshot(audited)
    try:
        yield audited
    except BaseException:
        raise
    else:
        if retrace_audit:
            _audit(audited, before, max_traces_per_new_key)
    finally:
        if debug_nans:
            mode.__exit__(None, None, None)
            torch.autograd.set_detect_anomaly(*anomaly)


__all__ = ["RetraceAuditError", "sanitized"]
