"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library with
a plain C interface, and loaded with :mod:`ctypes`.  The libraries live in
``build/torch_kernels/<hash>/`` beside the package (the hash covers every
file under ``csrc/``, headers included, and the flags), so a changed source
rebuilds and an unchanged one loads at once.  All sources compile concurrently, one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module on
machines that have no ``nvcc``.  :func:`load` is called when a pipeline is
set up on ``cuda`` and by a kernel wrapper the first time it launches on a
CUDA tensor.
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

__all__ = ["SOURCES", "BuildError", "CUDA_ERRORS", "build", "check", "error_name", "load", "nvcc_path"]

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
        for fn in (lib.tb_error_name, lib.tb_error_string):
            fn.argtypes = [i]
            fn.restype = ctypes.c_char_p
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
    """The loaded library ``name`` (building and loading every source first
    if needed), with every entry point's argument types declared — pointers
    and the stream as ``c_void_p`` so none is cut to 32 bits.  Any failure
    to build or load raises :class:`BuildError`, which the resilience
    layer's classifier holds fatal: a run must not move to the host when a
    kernel cannot be built."""
    lib: Optional[ctypes.CDLL] = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            try:
                paths = build()
                handles = {n: ctypes.CDLL(path) for n, path in paths.items()}
                for n, handle in handles.items():
                    _declare(n, handle)
            except BuildError:
                raise
            except Exception as e:  # noqa: BLE001 — reported as a build failure
                raise BuildError(f"could not build or load the kernels: {e!r}") from e
            _loaded.update(handles)
        return _loaded[name]


#: The runtime's names and messages of the CUDA errors that the resilience
#: layer's classifier tells apart (resilience/retry.py): out of memory is
#: retryable, the sticky errors are fatal.  Used when no library is loaded;
#: a loaded library answers for every code (``tb_error_name``).
CUDA_ERRORS: Dict[int, tuple] = {
    2: ("cudaErrorMemoryAllocation", "out of memory"),
    700: ("cudaErrorIllegalAddress", "an illegal memory access was encountered"),
    702: ("cudaErrorLaunchTimeout", "the launch timed out and was terminated"),
    710: ("cudaErrorAssert", "device-side assert triggered"),
    719: ("cudaErrorLaunchFailure", "unspecified launch failure"),
}


def error_name(err: int) -> tuple:
    """``(name, message)`` of CUDA error ``err``, from the runtime the
    libraries link (:data:`CUDA_ERRORS`, else ``unknown``, when none is
    loaded)."""
    lib = _loaded.get("scan")
    if lib is not None:
        return lib.tb_error_name(err).decode(), lib.tb_error_string(err).decode()
    return CUDA_ERRORS.get(err, ("unknown", "unknown CUDA error"))


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code; the message
    names the error, so that the classifier can tell an out-of-memory
    error from a sticky one."""
    if err != 0:
        name, msg = error_name(err)
        raise RuntimeError(f"{what}: CUDA error {err} ({name}: {msg})")
