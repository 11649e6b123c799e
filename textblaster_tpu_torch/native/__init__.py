"""Native host runtime: a C++ core built at first use, bound with ctypes.

The host-side hot paths (UTF-8 batch packing, UAX#29-lite word
segmentation, n-gram duplicate scans, byte-level BPE counting — see
``src/textblaster_native.cpp``) are C++.  Everything has a numpy path
(``textblaster_tpu_torch/utils/text.py``), which stays the semantic source
of truth: tests hold the two to identical results.

The build: ``$CXX`` (else ``g++``) with ``-O3 -march=native -std=c++17
-fPIC -shared`` into ``build/torch_native/<hash>/libtextblaster_native.so``
beside the package, never inside it.  The hash covers the source, the
flags, the compiler's ``--version`` line and the host CPU's model name, so
a changed source or compiler builds anew and an unchanged one loads at
once.  Concurrent builders (test workers, processes of one host) take an
``fcntl`` lock on a file in that directory, compile to a per-pid temporary
and ``os.replace`` it into place: one builds, the others load its whole
library.  A failed build or load logs the compiler's output once;
:func:`available` is then False and the numpy paths serve, until the
source or ``$CXX`` changes.

Switches: ``TEXTBLASTER_NATIVE=0`` (read at every call) forces the numpy
paths; :func:`disabled` does the same inside a ``with`` block, for every
thread of the process.  :data:`CALLS` counts each entry point's calls into
the library.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "CALLS",
    "available",
    "build",
    "disabled",
    "pack_utf8",
    "utf8_lengths",
    "word_spans_native",
    "dup_ngram_bytes",
    "top_ngram_bytes",
    "dup_items",
    "BpeCounter",
    "reset_calls",
]

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "src", "textblaster_native.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "torch_native")
_LIB_NAME = "libtextblaster_native.so"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

#: Calls into the library per entry point (the BPE's per text).
CALLS: Dict[str, int] = {
    "pack_utf8": 0, "utf8_lengths": 0, "word_spans": 0, "dup_ngram_bytes": 0,
    "top_ngram_bytes": 0, "dup_items": 0, "bpe_count": 0,
}
#: Seconds the last compile in this process took (0.0 until one ran).
last_build_seconds = 0.0

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed: Optional[tuple] = None  # the (compiler, source stat) a build failed on
_disabled = 0

_i64 = ctypes.c_int64
_p_u8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_p_i64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def reset_calls() -> None:
    with _count_lock:
        for k in CALLS:
            CALLS[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        CALLS[name] += 1


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _digest(source: str, cxx: str) -> str:
    try:
        version = subprocess.run(
            [cxx, "--version"], capture_output=True, text=True, timeout=60
        ).stdout.splitlines()[:1]
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"compiler {cxx!r} did not run: {e}") from e
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for part in (*version, _cpu_model(), platform.machine()):
        h.update(b"\0" + part.encode())
    with open(source, "rb") as f:
        h.update(b"\0" + f.read())
    return h.hexdigest()[:16]


def build(root: Optional[str] = None) -> str:
    """Compile the core unless its library is already in ``root`` (default
    ``build/torch_native/``); returns the library's path.  Raises
    ``RuntimeError`` with the compiler's output tail on failure."""
    global last_build_seconds
    cxx = _compiler()
    out_dir = os.path.join(root or _BUILD_ROOT, _digest(SOURCE, cxx))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(path):
        return path
    import fcntl

    with open(os.path.join(out_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(path):  # another process built it while we waited
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native build did not run: {e}") from e
        if proc.returncode != 0:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise RuntimeError(f"native build failed:\n{proc.stderr[-2000:]}")
        os.replace(tmp, path)  # atomic: no process loads a half-written file
        last_build_seconds = time.perf_counter() - t0
    return path


def _declare(lib: ctypes.CDLL) -> None:
    lib.tb_pack_utf8.argtypes = [_p_u8, _p_i64, _i64, _p_i32, _p_i32, _i64, _i64]
    lib.tb_pack_utf8.restype = None
    lib.tb_utf8_lengths.argtypes = [_p_u8, _p_i64, _i64, _p_i32]
    lib.tb_utf8_lengths.restype = None
    lib.tb_word_spans.argtypes = [_p_i32, _i64, _p_u8, _p_i32, _i64]
    lib.tb_word_spans.restype = _i64
    lib.tb_dup_ngram_bytes.argtypes = [_p_i32, _p_i32, _i64, _i64]
    lib.tb_dup_ngram_bytes.restype = _i64
    lib.tb_top_ngram_bytes.argtypes = [_p_i32, _p_i32, _i64, _i64]
    lib.tb_top_ngram_bytes.restype = _i64
    lib.tb_dup_items.argtypes = [_p_i32, _p_i32, _i64, ctypes.POINTER(ctypes.c_int64)]
    lib.tb_dup_items.restype = _i64
    lib.tb_bpe_new.argtypes = [_p_u8, _i64]
    lib.tb_bpe_new.restype = ctypes.c_void_p
    lib.tb_bpe_set_table.argtypes = [ctypes.c_void_p, _p_u8, _i64]
    lib.tb_bpe_set_table.restype = None
    lib.tb_bpe_free.argtypes = [ctypes.c_void_p]
    lib.tb_bpe_free.restype = None
    lib.tb_bpe_count.argtypes = [ctypes.c_void_p, _p_u8, _i64]
    lib.tb_bpe_count.restype = _i64


def _source_key() -> tuple:
    try:
        st = os.stat(SOURCE)
        return _compiler(), st.st_mtime_ns, st.st_size
    except OSError:
        return _compiler(), None, None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _disabled or os.environ.get("TEXTBLASTER_NATIVE", "1") == "0":
        return None
    if _lib is not None:
        return _lib
    key = _source_key()
    if _failed == key:
        return None
    with _lock:
        if _lib is None and _failed != key:
            try:
                lib = ctypes.CDLL(build())
                _declare(lib)
                _lib, _failed = lib, None
            except (OSError, RuntimeError, AttributeError) as e:
                _failed = key
                logger.warning("native core unavailable; the numpy paths serve: %s", e)
        return _lib


def available() -> bool:
    """True when the compiled library is (or can be) loaded and not
    switched off."""
    return _load() is not None


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Run the numpy paths inside the block, on every thread."""
    global _disabled
    with _lock:
        _disabled += 1
    try:
        yield
    finally:
        with _lock:
            _disabled -= 1


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


# --- packing ----------------------------------------------------------------


def pack_utf8(
    data: np.ndarray, offsets: np.ndarray, max_len: int, batch_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode ``n_docs`` UTF-8 documents (Arrow layout: ``data`` bytes +
    ``offsets``) into a zero-padded ``[batch_size, max_len] int32`` codepoint
    tensor.  Returns ``(cps, lengths)``; ``lengths[i] < 0`` flags an
    over-length document (row zeroed, magnitude = its codepoint count)."""
    lib = _require()
    n_docs = offsets.shape[0] - 1
    assert n_docs <= batch_size
    cps = np.zeros((batch_size, max_len), dtype=np.int32)
    lengths = np.zeros(batch_size, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if n_docs > 0:
        _count("pack_utf8")
        lib.tb_pack_utf8(data, offsets, n_docs, cps, lengths, max_len, max_len)
    return cps, lengths


def utf8_lengths(data: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Codepoint count per document without decoding (for bucketing)."""
    lib = _require()
    n_docs = offsets.shape[0] - 1
    out = np.zeros(n_docs, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if n_docs > 0:
        _count("utf8_lengths")
        lib.tb_utf8_lengths(data, offsets, n_docs, out)
    return out


# --- segmentation + duplicate scans ----------------------------------------


def word_spans_native(cps: np.ndarray, cls: np.ndarray) -> Optional[np.ndarray]:
    """Word (start, end) spans as an ``[n, 2] int32`` array, or ``None`` when
    the native library is unavailable.  Semantics identical to
    ``utils.text.word_spans(text, cjk_dict=False)``."""
    lib = _load()
    if lib is None:
        return None
    n = cps.shape[0]
    cps = np.ascontiguousarray(cps, dtype=np.int32)
    cls = np.ascontiguousarray(cls, dtype=np.uint8)
    max_spans = n + 1
    out = np.empty(2 * max_spans, dtype=np.int32)
    _count("word_spans")
    count = lib.tb_word_spans(cps, n, cls, out, max_spans)
    if count < 0:  # cannot happen (spans <= n), but keep the fallback seam
        return None
    return out[: 2 * count].reshape(-1, 2)


def _flat_spans(cps: np.ndarray, spans: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return (np.ascontiguousarray(cps, dtype=np.int32),
            np.ascontiguousarray(spans.reshape(-1), dtype=np.int32))


def dup_ngram_bytes(cps: np.ndarray, spans: np.ndarray, n: int) -> int:
    """find_all_duplicate over word spans (utils.text semantics)."""
    lib = _require()
    cps, spans = _flat_spans(cps, spans)
    _count("dup_ngram_bytes")
    return int(lib.tb_dup_ngram_bytes(cps, spans, spans.shape[0] // 2, n))


def top_ngram_bytes(cps: np.ndarray, spans: np.ndarray, n: int) -> int:
    """find_top_duplicate over space-joined n-grams of the word spans."""
    lib = _require()
    cps, spans = _flat_spans(cps, spans)
    _count("top_ngram_bytes")
    return int(lib.tb_top_ngram_bytes(cps, spans, spans.shape[0] // 2, n))


def dup_items(cps: np.ndarray, spans: np.ndarray) -> Tuple[int, int]:
    """find_duplicates over item spans: (dup_elems, dup_utf8_bytes)."""
    lib = _require()
    cps, spans = _flat_spans(cps, spans)
    elems = ctypes.c_int64(0)
    _count("dup_items")
    bytes_ = lib.tb_dup_items(cps, spans, spans.shape[0] // 2, ctypes.byref(elems))
    return int(elems.value), int(bytes_)


# --- BPE --------------------------------------------------------------------


class BpeCounter:
    """Byte-level BPE token counter (GPT-2 family) over a local merges.txt.

    The native analogue of the HF-tokenizers core used by TokenCounter
    (token_counter.rs:8-43 parity for token *counting* — ids are not needed
    for ``metadata["token_count"]``).
    """

    def __init__(self, merges_text: str) -> None:
        lib = _require()
        blob = np.frombuffer(merges_text.encode("utf-8"), dtype=np.uint8).copy()
        self._lib = lib
        self._handle = lib.tb_bpe_new(blob, blob.shape[0])
        from ..utils.chartables import char_table

        self._table = np.ascontiguousarray(char_table())
        lib.tb_bpe_set_table(self._handle, self._table, self._table.shape[0])

    @classmethod
    def from_file(cls, merges_path: str) -> "BpeCounter":
        with open(merges_path, encoding="utf-8") as f:
            return cls(f.read())

    def count(self, text: str) -> int:
        data = np.frombuffer(text.encode("utf-8"), dtype=np.uint8)
        if data.shape[0] == 0:
            return 0
        data = np.ascontiguousarray(data)
        _count("bpe_count")
        return int(self._lib.tb_bpe_count(self._handle, data, data.shape[0]))

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tb_bpe_free(handle)
            self._handle = None
