"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Builds happen at first use, into ``build/kernels/``
at the repository root (or ``$REPRO_TORCH_BUILD_DIR``), keyed by a digest
of the sources and flags; all missing libraries compile in parallel, one
``nvcc`` each.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false -prec-div=true`` so
that the QSGD arithmetic is never contracted into FMAs or approximated —
the kernels must be bit-exact with the reference.  ``LAUNCHES`` counts the
launches of every kernel by name.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("topk_mask", "qsgd", "ternary", "bitpack")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-prec-div=true", "-Xptxas=-v")

# CUDA launches by kernel name: each wrapper adds one where it launches its
# kernel, and nowhere else
LAUNCHES: collections.Counter = collections.Counter()

# ptxas reports (registers, shared memory, spills) of the last build, by name
LOG: dict = {}

_LIBS: dict = {}
_FUNCS: dict = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "repro_torch CUDA kernels cannot be built, so a CUDA tensor "
            "cannot be encoded with backend='kernel'")
    return cand


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest(name)}.so"


def build(names=SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, all in
    parallel.  Returns the wall seconds spent; raises on a failed build."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return 0.0
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out / f".{name}-{os.getpid()}.so"
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        text, _ = proc.communicate()
        LOG[name] = text
        if proc.returncode:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{text}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(lib: str, symbol: str, argtypes):
    """The C entry ``symbol`` of library ``lib`` (built on first use), with
    ``argtypes`` set and an ``int`` (a ``cudaError_t``) result."""
    key = (lib, symbol)
    with _LOCK:
        fn = _FUNCS.get(key)
        if fn is None:
            if lib not in _LIBS:
                build((lib,))
                _LIBS[lib] = ctypes.CDLL(str(lib_path(lib)))
            fn = getattr(_LIBS[lib], symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[key] = fn
    return fn


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
