"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library with
a plain C interface, and loaded with :mod:`ctypes`.  The libraries live in
``build/torch_kernels/<hash>/`` beside the package (the hash covers every
file under ``csrc/``, headers included, and the flags), so a changed source
rebuilds and an unchanged one loads at once.  All sources compile concurrently, one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module on
machines that have no ``nvcc``.  :func:`load` is called by a kernel wrapper
the first time it launches on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

__all__ = ["SOURCES", "BuildError", "build", "check", "load", "nvcc_path"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

#: Library name -> source file under csrc/.
SOURCES: Dict[str, str] = {
    "chain": "chain.cu", "fused": "fused.cu", "scan": "scan.cu", "sort": "sort.cu",
}

_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: Seconds the last :func:`build` spent compiling (0.0 when it only loaded).
last_build_seconds = 0.0
#: ptxas register / shared-memory report of the last compile, per library.
ptxas_report: Dict[str, str] = {}


class BuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        try:
            from torch.utils.cpp_extension import CUDA_HOME as home
        except Exception:  # pragma: no cover - torch without cpp_extension
            home = None
    if home:
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _lib_path(out_dir: str, name: str) -> str:
    return os.path.join(out_dir, f"libtb_{name}.so")


def build() -> Dict[str, str]:
    """Compile every source that has no up-to-date library; returns the
    library paths by name.  Raises :class:`BuildError` with the compiler's
    output on failure."""
    global last_build_seconds
    out_dir = os.path.join(_BUILD_ROOT, _digest())
    os.makedirs(out_dir, exist_ok=True)
    paths = {name: _lib_path(out_dir, name) for name in SOURCES}
    todo = [n for n, p in paths.items() if not os.path.exists(p)]
    if not todo:
        last_build_seconds = 0.0
        return paths
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs: List[tuple] = []
    for name in todo:
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        cmd = [nvcc, *_FLAGS, "-o", tmp, os.path.join(_CSRC, SOURCES[name])]
        procs.append(
            (name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        )
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        ptxas_report[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{out}")
            continue
        os.replace(tmp, paths[name])  # atomic: concurrent builders agree
    last_build_seconds = time.perf_counter() - t0
    if errors:
        raise BuildError("\n".join(errors))
    return paths


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "scan":
        lib.tb_affine_scan.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.tb_affine_scan.restype = i
        lib.tb_dfa_scan.argtypes = [p, p, i, i, i, i, i, i, p]
        lib.tb_dfa_scan.restype = i
    elif name == "sort":
        lib.tb_sort2.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.tb_sort2.restype = i
        lib.tb_sort3.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.tb_sort3.restype = i
    elif name == "fused":
        ip, pp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
        lib.tb_fused_scan.argtypes = [ip, i, pp, i, i, i, i, i, p]
        lib.tb_fused_scan.restype = i
    elif name == "chain":
        ip, pp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
        lib.tb_chain_encode.argtypes = [ip, i, i, i, ip]
        lib.tb_chain_encode.restype = i
        lib.tb_chain_launch.argtypes = [i, pp, i, pp, i, i, i, i, i, i, i, p]
        lib.tb_chain_launch.restype = i


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building every source first if needed),
    with every entry point's argument types declared — pointers and the
    stream as ``c_void_p`` so none is cut to 32 bits."""
    lib: Optional[ctypes.CDLL] = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            paths = build()
            for n, path in paths.items():
                handle = ctypes.CDLL(path)
                _declare(n, handle)
                _loaded[n] = handle
        return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
