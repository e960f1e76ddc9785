"""Build the CUDA sources in ``repro_torch/csrc`` at first use, load them
with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so ``nvcc`` takes seconds, not minutes).
All missing libraries are compiled together, one ``nvcc`` process per
source started at once, into ``build/repro_torch_kernels/`` at the repo
root, keyed by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags: an edited source or header rebuilds, an unchanged one is
reused.

A launcher takes device pointers and the stream as ``c_void_p`` and ints
as ``c_int``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``check_launch`` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHERS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels "
                       "are built from source at first use")


def _artifact(name: str) -> Path:
    """The library's path, keyed by the source, every shared header
    (``csrc/*.cuh``, which a source may include) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes running at once.  Returns seconds per library
    built in this call (empty when everything was cached)."""
    todo = [(n, _artifact(n)) for n in names if not _artifact(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for name, out in todo:
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    took: Dict[str, float] = {}
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        took[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          f"{out.with_suffix('.log').read_text()}")
            continue
        os.replace(tmp, out)          # atomic: a reader never sees half
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    for the current build of ``name``; empty if it was not built here."""
    log = _artifact(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_artifact(name)))
            _LIBS[name] = lib
        return lib


def launcher(name: str, symbol: str, argtypes,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The launcher ``symbol`` of ``csrc/<name>.cu`` (built and loaded on
    first use), its argument types and return type (a CUDA error code by
    default) bound once, so a call sets nothing."""
    key = (name, symbol)
    fn = _LAUNCHERS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = argtypes, restype
        _LAUNCHERS[key] = fn
    return fn


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err != 0:
        fn = lib.repro_cuda_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({fn(err).decode()})")


def sources() -> Tuple[str, ...]:
    """Names of every CUDA source in ``csrc``."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "build_log",
           "check_launch", "launcher", "load", "sources"]
