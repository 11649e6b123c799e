"""Row-wise inclusive scans: the per-scan kernels, the fused multi-group
scan and the dependency-chained multi-pass scan.

The port's counterpart of the JAX package's
``textblaster_tpu/ops/pallas_scan.py``:

* the per-scan half, ``affine_hash_scan`` and ``dfa_compose_scan`` (their
  Pallas kernel is ``_pallas_scan_tuple``; here ``csrc/scan.cu``, laid
  out by :func:`scan_geometry`);
* the fused half, :func:`fused_scan` over a list of independent groups
  built by :func:`affine_group`, :func:`add_group` and :func:`dfa_group`
  (its Pallas kernel is ``_fused_call``; here ``csrc/fused.cu``);
* the chain half, :func:`chain_scan` over ordered passes whose groups tap
  earlier passes' streams (:class:`Tap`, :func:`chain_group`,
  :func:`segmax_group`, :func:`copy_group`, :func:`chain_pass`; its Pallas
  kernel is ``_chain_call``; here ``csrc/chain.cu``).

On a CUDA tensor each wrapper launches its hand-written kernel or raises;
on a CPU tensor it runs the plain PyTorch version beside it, which follows
the Hillis–Steele shift schedule of the JAX ops (``_affine_op``,
``_add_op``, ``_dfa_op``, ``_segmax_op``).  Every schedule gives the same
int32 result by integer associativity, so the two agree bit for bit.

The switches select the JAX package's *schedules*, never a plain version
on the card: ``TEXTBLAST_DEPFUSE=off`` the fused schedule (callers gate on
:func:`chain_scan_ok`), ``TEXTBLAST_FUSED=off`` the staged one (it turns
the chain off too, as in the JAX package).

``LAUNCHES`` counts kernel launches per kernel; only a launch on the card
adds to it.  Under ``--trace-device`` each launch is also bracketed by two
timing events (``utils/trace.py`` ``KERNEL_SPANS``), named by the launch's
``SHAPE_LAUNCHES`` key.

Dispatch accounting (the JAX package's ``count_scan_dispatches``): inside a
:func:`count_scan_dispatches` scope on this thread, every wrapper, on any
device, counts its scan dispatch by kind ("pallas_scan" for the per-scan
kernels, "fused" for ``fused_scan`` and for one ``chain_scan`` however many
passes it carries; ``ops/device.py`` counts its plain scans as
"lax_scan") and records the launch it stands for with its modeled bytes
and operations (``ops/cost.py``); ``sort2`` and ``sort3`` record their
launches without counting a scan dispatch.  The scope also opens the
host-sync gates that stand for the JAX package's ``lax.cond``
(:func:`gates_open`), so what it records depends on the shapes alone.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels.build import check
from ..utils.trace import KERNEL_SPANS
from . import cost
from .device import shift_scan_tuple

__all__ = [
    "CHAIN_SHAPE_LAUNCHES",
    "CHAIN_SITE_LAUNCHES",
    "ChainGeometry",
    "DispatchCounts",
    "LAUNCHES",
    "SHAPE_LAUNCHES",
    "PREPS",
    "ScanGeometry",
    "Tap",
    "add_group",
    "affine_group",
    "affine_hash_scan",
    "affine_hash_scan_plain",
    "chain_geometry",
    "chain_group",
    "chain_pass",
    "chain_prep",
    "chain_probe_program",
    "chain_scan",
    "chain_scan_ok",
    "chain_scan_plain",
    "copy_group",
    "count_scan_dispatches",
    "depfuse_enabled",
    "dfa_compose_scan",
    "dfa_compose_scan_plain",
    "dfa_group",
    "dfa_ident",
    "fused_enabled",
    "fused_geometry",
    "fused_scan",
    "fused_scan_ok",
    "fused_scan_plain",
    "gates_open",
    "record_launch",
    "record_scan_dispatch",
    "scan_geometry",
    "segmax_group",
]

#: Kernel launches on the card, by kernel name.
LAUNCHES: Dict[str, int] = {"affine_scan": 0, "dfa_scan": 0, "fused_scan": 0, "chain_scan": 0}
#: The same launches by variant: ``(kernel, rows, width, k)`` for
#: ``affine_scan`` (k accumulators), ``(kernel, rows, width, n_states)``
#: for ``dfa_scan``, ``(kernel, rows, width)`` for ``fused_scan`` and
#: ``chain_scan``.
SHAPE_LAUNCHES: Dict[Tuple[Any, ...], int] = {}
#: The ``chain_scan`` launches of LAUNCHES by call site (the ``site`` its
#: caller names), and by ``(site, width)``.
CHAIN_SITE_LAUNCHES: Dict[str, int] = {}
CHAIN_SHAPE_LAUNCHES: Dict[Tuple[Optional[str], int], int] = {}


# --- dispatch accounting ----------------------------------------------------
#
# Thread-local, and a no-op unless a count_scan_dispatches() scope is active
# on this thread: a scope armed on one thread never sees another thread's
# launches (the dispatch thread's real batches), and the hot path pays one
# getattr.

_tls = threading.local()


class DispatchCounts(dict):
    """Per-kind scan dispatch counts of one :func:`count_scan_dispatches`
    scope (``dict(counts)`` is the JAX package's result), and in
    :attr:`launches` every hand-kernel launch the scope saw, as
    ``(SHAPE_LAUNCHES key, modeled bytes, modeled operations)``."""

    def __init__(self) -> None:
        super().__init__()
        self.launches: List[Tuple[Tuple[Any, ...], float, float]] = []

    def dispatch(self, kind: str) -> None:
        self[kind] = self.get(kind, 0) + 1

    def launch(self, key: Tuple[Any, ...], model: Callable[[], Tuple[float, float]]) -> None:
        """One launch of ``key`` (``(kernel, rows, width, ...)``), with
        ``model()``'s ``(bytes, operations)``; a launch on an empty tensor
        (no rows or no lanes) launches nothing on the card and is not
        recorded on any device."""
        if key[1] and key[2]:
            self.launches.append((key, *model()))


def _scope() -> Optional[DispatchCounts]:
    return getattr(_tls, "dispatch_counts", None)


def record_scan_dispatch(kind: str) -> None:
    """Count one scan dispatch of ``kind`` ("fused", "pallas_scan",
    "lax_scan") if a :func:`count_scan_dispatches` scope is active."""
    scope = _scope()
    if scope is not None:
        scope.dispatch(kind)


def record_launch(key: Tuple[Any, ...], model: Callable[[], Tuple[float, float]]) -> None:
    """Record one hand-kernel launch (:meth:`DispatchCounts.launch`) if a
    scope is active."""
    scope = _scope()
    if scope is not None:
        scope.launch(key, model)


def gates_open() -> bool:
    """Whether a :func:`count_scan_dispatches` scope is active on this
    thread.  The statistic functions' host-sync gates (the JAX package's
    ``lax.cond``, whose both branches its ``eval_shape`` traces) take their
    costly branch when it is, so a count does not depend on the data."""
    return _scope() is not None


@contextlib.contextmanager
def count_scan_dispatches():
    """Collect the scan dispatches and kernel launches issued on this thread
    while the scope is active (:class:`DispatchCounts`)."""
    prev = _scope()
    counts = DispatchCounts()
    _tls.dispatch_counts = counts
    try:
        yield counts
    finally:
        _tls.dispatch_counts = prev


#: The JAX fused kernel's lane cap (``pallas_scan._FUSED_MAX_LANES``), kept
#: so that every bucket takes the JAX package's schedule.
FUSED_MAX_LANES = 16384

#: Limits of ``csrc/fused.cu``'s by-value parameter block.
FUSED_MAX_GROUPS = 8
FUSED_MAX_STREAMS = 16


def _affine_op(xs, ys):
    # h -> m*h + a composed earlier-then-later (pallas_scan._affine_op).
    mx, axs = xs[0], xs[1:]
    my, ays = ys[0], ys[1:]
    return (mx * my,) + tuple(ay + my * ax for ax, ay in zip(axs, ays))


def _add_op(xs, ys):
    # Elementwise running sums (pallas_scan._add_op).
    return tuple(x + y for x, y in zip(xs, ys))


def _dfa_op(n_states: int):
    def op(xs, ys):
        # (b . a)(s) = b[a[s]] over nibble-packed maps (pallas_scan._dfa_op).
        a, b = xs[0], ys[0]
        out = None
        for s in range(n_states):
            nib = (a >> (4 * s)) & 15
            term = ((b >> (nib << 2)) & 15) << (4 * s)
            out = term if out is None else out | term
        return (out,)

    return op


#: Identity of the segmented-max value stream: max(_I32_MIN, x) == x.
_I32_MIN = -(2**31)


def _segmax_op(xs, ys):
    # Segmented running max over (value, reset) pairs (pallas_scan._segmax_op):
    # a signed max, restarted where the later element resets.
    av, ar = xs
    bv, br = ys
    return torch.where(br != 0, bv, torch.maximum(av, bv)), ar | br


def dfa_ident(n_states: int) -> int:
    """The identity map: nibble ``s`` holds ``s``."""
    ident = 0
    for s in range(n_states):
        ident |= s << (4 * s)
    return ident


def affine_hash_scan_plain(
    m: torch.Tensor, accs: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch affine-hash scan (shift schedule)."""
    xs = (m.to(torch.int32),) + tuple(a.to(torch.int32) for a in accs)
    identities = (1,) + (0,) * len(accs)
    return shift_scan_tuple(_affine_op, identities, xs)[1:]


def dfa_compose_scan_plain(fns: torch.Tensor, n_states: int) -> torch.Tensor:
    """Plain PyTorch DFA-composition scan (shift schedule)."""
    (out,) = shift_scan_tuple(
        _dfa_op(n_states), (dfa_ident(n_states),), (fns.to(torch.int32),)
    )
    return out


def _check(name: str, ts: Sequence[torch.Tensor]) -> None:
    """Raises unless every operand is a contiguous int32 ``[rows, len]``
    tensor of one shape on one device (probed with the cheap accessors: the
    per-scan wrappers run this on every call)."""
    ref = ts[0]
    shape, dev, cuda = ref.shape, ref.get_device(), ref.is_cuda
    for t in ts:
        if t.get_device() != dev or t.is_cuda != cuda:
            raise ValueError(f"{name}: operands on different devices")
        if t.dtype is not torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if t.shape != shape or len(shape) != 2:
            raise ValueError(f"{name}: expected equal [rows, len] operands")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if shape[0] > 2**31 - 1 or shape[1] > 2**31 - 1:
        raise ValueError(f"{name}: shape {tuple(shape)} too large")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _span(device: torch.device):
    """The start event of a launch's device span when ``--trace-device`` is
    armed (:data:`~..utils.trace.KERNEL_SPANS`), else None: one attribute
    check.  A launch inside a :func:`count_scan_dispatches` scope (a cost
    pass, outside every batch) takes no span."""
    return KERNEL_SPANS.begin(device) if KERNEL_SPANS.enabled and _scope() is None else None


def _count(kernel: str, rows: int, width: int, *variant: int, span=None, device=None) -> None:
    LAUNCHES[kernel] += 1
    key = (kernel, rows, width, *variant)
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    if span is not None:
        KERNEL_SPANS.end(span, device, kernel, key)


# --- the per-scan kernels (csrc/scan.cu) ----------------------------------------

#: Lanes a thread holds, by op (``Affine::ITEMS``, ``Add::ITEMS`` and
#: ``Dfa::ITEMS`` in csrc/scan_ops.cuh).
SCAN_ITEMS = {"affine": 4, "add": 4, "dfa": 16}


class ScanGeometry(NamedTuple):
    """How ``csrc/scan.cu`` lays a ``[rows, length]`` scan out: a row is
    ``cluster`` chunks of ``threads * SCAN_ITEMS[op]`` consecutive lanes,
    one CTA each (a thread block cluster when ``cluster > 1``), walked in
    ``segments`` segments of ``cluster`` chunks."""

    cluster: int
    threads: int
    segments: int


def scan_geometry(length: int, op: str) -> ScanGeometry:
    """The launch geometry of a row of ``length`` lanes under ``op``
    (``"affine"`` or ``"dfa"``):

    * affine (4 lanes a thread): one CTA of up to 512 threads to 8192
      lanes, walking 2048-lane segments; wider, a 2-CTA cluster of 1024
      threads walking 8192-lane segments (64 rows: 128 CTAs);
    * dfa (16 lanes a thread): one CTA to 2048 lanes; wider, a cluster of
      up to 8 CTAs of 64 threads (to 8192 lanes) or 128, walking segments
      of 8 chunks beyond 16384 lanes."""
    items = SCAN_ITEMS[op]
    if op == "affine":
        if length <= 8192:
            threads = min(512, -(-length // (32 * items)) * 32)
            return ScanGeometry(1, threads, -(-length // (threads * items)))
        return ScanGeometry(2, 1024, -(-length // (2 * 1024 * items)))
    if length <= 2048:
        return ScanGeometry(1, -(-length // (32 * items)) * 32, 1)
    threads = 64 if length <= 8192 else 128
    cluster = min(8, -(-length // (threads * items)))
    return ScanGeometry(cluster, threads, -(-length // (cluster * threads * items)))


#: The library of csrc/scan.cu, loaded on first use (no import or lookup
#: on later calls).
_SCAN_LIB: List[ctypes.CDLL] = []


def _scan_lib() -> ctypes.CDLL:
    if not _SCAN_LIB:
        from ..kernels.build import load

        _SCAN_LIB.append(load("scan"))
    return _SCAN_LIB[0]


def affine_hash_scan(
    m: torch.Tensor, accs: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of the shared-multiplier affine hash op along axis 1:
    returns the scanned accumulator streams (1 or 2 of them; the scanned
    multiplier is internal).  All operands are contiguous int32
    ``[rows, len]`` tensors on one device; any shape is taken."""
    accs = tuple(accs)
    scope = _scope()
    if scope is not None:
        rows, length = m.shape
        scope.dispatch("pallas_scan")
        scope.launch(("affine_scan", rows, length, len(accs)),
                     lambda: cost.scan_cost("affine_scan", rows, length, len(accs)))
    if not m.is_cuda:
        if m.device.type == "cpu":
            return affine_hash_scan_plain(m, accs)
        raise ValueError(f"affine_hash_scan: unsupported device {m.device}")
    k = len(accs)
    if k not in (1, 2):
        raise ValueError("affine_hash_scan: the kernel takes 1 or 2 accumulators")
    _check("affine_hash_scan", (m,) + accs)
    rows, length = m.shape
    shape = (rows, length)
    if k == 2:
        outs = (m.new_empty(shape), m.new_empty(shape))
        ptrs = (m.data_ptr(), accs[0].data_ptr(), accs[1].data_ptr(), outs[0].data_ptr(),
                outs[1].data_ptr())
    else:
        outs = (m.new_empty(shape),)
        ptrs = (m.data_ptr(), accs[0].data_ptr(), None, outs[0].data_ptr(), None)
    if rows == 0 or length == 0:
        return outs
    cluster, threads, segs = scan_geometry(length, "affine")
    lib = _scan_lib()
    span = _span(m.device)
    with torch.cuda.device(m.device):
        err = lib.tb_affine_scan(*ptrs, rows, length, k, cluster, threads, segs, _stream(m))
    check(err, "affine_hash_scan")
    _count("affine_scan", rows, length, k, span=span, device=m.device)
    return outs


def dfa_compose_scan(fns: torch.Tensor, n_states: int) -> torch.Tensor:
    """Inclusive scan of nibble-packed DFA transition maps along axis 1, for
    ``n_states`` <= 8.  ``fns`` is a contiguous int32 ``[rows, len]``
    tensor whose nibbles below ``n_states`` hold states below 8 (valid maps
    hold states below ``n_states``)."""
    scope = _scope()
    if scope is not None:
        rows, length = fns.shape
        scope.dispatch("pallas_scan")
        scope.launch(("dfa_scan", rows, length, n_states),
                     lambda: cost.scan_cost("dfa_scan", rows, length, n_states))
    if not fns.is_cuda:
        if fns.device.type == "cpu":
            return dfa_compose_scan_plain(fns, n_states)
        raise ValueError(f"dfa_compose_scan: unsupported device {fns.device}")
    if not 1 <= n_states <= 8:
        raise ValueError("dfa_compose_scan: the kernel takes 1..8 states")
    _check("dfa_compose_scan", (fns,))
    rows, length = fns.shape
    out = fns.new_empty((rows, length))
    if rows == 0 or length == 0:
        return out
    cluster, threads, segs = scan_geometry(length, "dfa")
    lib = _scan_lib()
    span = _span(fns.device)
    with torch.cuda.device(fns.device):
        err = lib.tb_dfa_scan(fns.data_ptr(), out.data_ptr(), rows, length, n_states, cluster,
                              threads, segs, _stream(fns))
    check(err, "dfa_compose_scan")
    _count("dfa_scan", rows, length, n_states, span=span, device=fns.device)
    return out


# --- fused multi-group scan ---------------------------------------------------
#
# A group is one independent associative scan over one or more int32 [B, L]
# streams.  fused_scan() evaluates a list of groups in one kernel launch:
# each group emits its scanned streams ("scan") or only its final [B, 1]
# carry ("last", a per-row total that never widens to [B, L]).


def affine_group(
    m: torch.Tensor, accs: Sequence[torch.Tensor], emit: str = "scan"
) -> dict:
    """Shared-multiplier affine-hash group (the fused twin of
    :func:`affine_hash_scan`); emits only the accumulator streams."""
    return {"kind": "affine", "xs": (m,) + tuple(accs), "emit": emit}


def add_group(vals: Sequence[torch.Tensor], emit: str = "scan") -> dict:
    """Running-sum group; ``emit="last"`` yields ``[B, 1]`` row totals."""
    return {"kind": "add", "xs": tuple(vals), "emit": emit}


def dfa_group(fns: torch.Tensor, n_states: int, emit: str = "scan") -> dict:
    """Nibble-packed DFA map composition group (the fused twin of
    :func:`dfa_compose_scan`)."""
    return {"kind": "dfa", "xs": (fns,), "emit": emit, "n_states": n_states}


def _group_spec(g: dict):
    """``(op, identities, n_operands, emitted stream indices, emit_last)``
    of one group (``pallas_scan._group_spec``).  ``n_operands`` counts the
    streams the op runs over: for a chain group with a ``prep`` it is
    ``g["n_ops"]`` (what the prep returns), not the dep count.  A copy
    group has no op (``None``): it stores its operands as they are."""
    kind = g["kind"]
    n_in = g.get("n_ops", len(g["xs"]))
    emit = g.get("emit", "scan")
    if emit not in ("scan", "last", "none"):
        raise ValueError(f"unknown emit mode {emit!r}")
    emit_last = emit == "last"
    if kind == "affine":
        return _affine_op, (1,) + (0,) * (n_in - 1), n_in, tuple(range(1, n_in)), emit_last
    if kind == "add":
        return _add_op, (0,) * n_in, n_in, tuple(range(n_in)), emit_last
    if kind == "dfa":
        n_states = g["n_states"]
        return _dfa_op(n_states), (dfa_ident(n_states),), 1, (0,), emit_last
    if kind == "segmax":
        return _segmax_op, (_I32_MIN, 0), 2, (0,), emit_last
    if kind == "copy":
        if emit_last:
            raise ValueError("copy groups cannot emit='last'")
        return None, (0,) * n_in, n_in, tuple(range(n_in)), False
    raise ValueError(f"unknown group kind {kind!r}")


#: Group kinds by their code in csrc/fused.cu and csrc/chain.cu.
_KINDS = {"affine": 0, "add": 1, "dfa": 2}


def fused_enabled() -> bool:
    """``TEXTBLAST_FUSED=off`` (or ``0``/``false``) selects the staged
    schedule; re-read per call so tests and benches can toggle it."""
    return os.environ.get("TEXTBLAST_FUSED", "").lower() not in ("off", "0", "false")


def fused_scan_ok(b: int, length: int) -> bool:
    """Whether a caller takes the fused schedule for a ``[b, length]``
    batch: the ``TEXTBLAST_FUSED`` switch and the JAX package's lane cap
    (16384), so each bucket takes the JAX schedule: fused at
    512/2048/8192, staged at 32768/65536.  The TPU tiling rules
    (``b % 8``, ``length % 128``) are dropped: the CUDA kernel masks
    ragged edges."""
    del b  # any row count works
    return fused_enabled() and length <= FUSED_MAX_LANES


def _fused_spec(g: dict):
    """:func:`_group_spec` for the kinds and emit modes the fused kernel
    takes (``csrc/fused.cu``): affine, add and dfa; scan or last."""
    if g["kind"] not in _KINDS or g.get("emit", "scan") not in ("scan", "last"):
        raise ValueError(f"fused_scan takes affine/add/dfa groups that emit scan or last, got {g['kind']!r}")
    return _group_spec(g)


def fused_scan_plain(groups: Sequence[dict]) -> List[Tuple[torch.Tensor, ...]]:
    """Plain PyTorch fused scan: each group's op on the shift schedule,
    the last column taken for ``emit="last"``."""
    out = []
    for g in groups:
        op, identities, _, emit_idx, emit_last = _fused_spec(g)
        xs = tuple(x.to(torch.int32) for x in g["xs"])
        scanned = shift_scan_tuple(op, identities, xs)
        if emit_last and xs[0].shape[1] == 0:  # an empty row's carry is the identity
            scanned = tuple(torch.full((x.shape[0], 1), v, dtype=torch.int32, device=x.device)
                            for x, v in zip(xs, identities))
        elif emit_last:
            scanned = tuple(x[:, -1:] for x in scanned)
        out.append(tuple(scanned[i] for i in emit_idx))
    return out


#: Largest CTA ``csrc/fused.cu`` takes (its ``__launch_bounds__``).
FUSED_MAX_THREADS = 512


def fused_geometry(length: int) -> int:
    """Threads per CTA of ``csrc/fused.cu`` for rows of ``length`` lanes,
    one number for every scan unit of the launch: enough threads of four
    lanes to cover the row in one segment, at most 256 (a unit walks
    ``ceil(length / (threads * SCAN_ITEMS[op]))`` segments; a DFA unit's
    threads hold 16 lanes).  On the card (``kernel_ab.py --sweep``;
    PERF.md), 256 threads beat 512 at 2048 and 8192 lanes on the main
    path's lists, and at 512 lanes 128 beat 256 and 512."""
    return min(256, max(1, -(-length // (32 * SCAN_ITEMS["add"]))) * 32)


#: The library of csrc/fused.cu, loaded on first use.
_FUSED_LIB: List[ctypes.CDLL] = []


def _fused_lib() -> ctypes.CDLL:
    if not _FUSED_LIB:
        from ..kernels.build import load

        _FUSED_LIB.append(load("fused"))
    return _FUSED_LIB[0]


def fused_scan(groups: Sequence[dict]) -> List[Tuple[torch.Tensor, ...]]:
    """Evaluate independent scan groups in ONE kernel launch; returns one
    tuple of int32 streams per group: ``[B, L]`` scans for
    ``emit="scan"``, ``[B, 1]`` final carries for ``emit="last"``.

    Every operand is a contiguous int32 ``[B, L]`` tensor on one device;
    at most 8 groups and 16 input and 16 output streams; DFA groups take
    1..8 states.  The kernel runs one CTA per (row, scan unit) with
    :func:`fused_geometry`'s threads.  Callers gate on
    :func:`fused_scan_ok` first."""
    groups = list(groups)
    if not groups:
        raise ValueError("fused_scan: no groups")
    dev = groups[0]["xs"][0].device
    scope = _scope()
    if scope is not None:
        rows, length = groups[0]["xs"][0].shape
        scope.dispatch("fused")
        scope.launch(("fused_scan", rows, length), lambda: cost.fused_cost(groups))
    if dev.type == "cpu":
        return fused_scan_plain(groups)
    if dev.type != "cuda":
        raise ValueError(f"fused_scan: unsupported device {dev}")
    specs = [_fused_spec(g) for g in groups]
    xs = tuple(x for g in groups for x in g["xs"])
    n_out = sum(len(s[3]) for s in specs)
    if len(groups) > FUSED_MAX_GROUPS:
        raise ValueError(f"fused_scan: {len(groups)} groups, the kernel takes {FUSED_MAX_GROUPS}")
    if len(xs) > FUSED_MAX_STREAMS or n_out > FUSED_MAX_STREAMS:
        raise ValueError(
            f"fused_scan: {len(xs)} inputs / {n_out} outputs, the kernel takes "
            f"{FUSED_MAX_STREAMS} of each"
        )
    for g in groups:
        if g["kind"] == "affine" and len(g["xs"]) < 2:
            raise ValueError("fused_scan: an affine group needs a multiplier and an accumulator")
        if g["kind"] == "dfa" and not 1 <= g["n_states"] <= 8:
            raise ValueError("fused_scan: the kernel takes 1..8 DFA states")
    _check("fused_scan", xs)
    rows, length = xs[0].shape
    res, outs = [], []
    for _, _, _, emit_idx, emit_last in specs:
        shape = (rows, 1) if emit_last else (rows, length)
        res.append(tuple(torch.empty(shape, dtype=torch.int32, device=dev) for _ in emit_idx))
        outs.extend(res[-1])
    if rows == 0:
        return res
    code = [v for g, s in zip(groups, specs)
            for v in (_KINDS[g["kind"]], len(g["xs"]), int(s[4]), g.get("n_states", 0))]
    ptrs = (ctypes.c_void_p * (len(xs) + len(outs)))(*(t.data_ptr() for t in xs + tuple(outs)))
    lib = _fused_lib()
    span = _span(dev)
    with torch.cuda.device(dev):
        err = lib.tb_fused_scan((ctypes.c_int * len(code))(*code), len(groups), ptrs, len(xs),
                                len(outs), rows, length, fused_geometry(length), _stream(xs[0]))
    check(err, "fused_scan")
    _count("fused_scan", rows, length, span=span, device=dev)
    return res


# --- dependency-chained multi-pass scan ----------------------------------------
#
# A chain is an ordered list of passes; a pass's groups read external [B, L]
# operands and Taps of earlier passes' emitted streams, and one launch walks
# every pass (pallas_scan.py:689-718).  Streams are stored in natural lane
# order.  A reverse pass walks the row back to front and writes its streams
# in natural order, which is the staged rev(scan(rev(x))).  Tap(pass_idx,
# out_idx, shift, fill) names the out_idx-th emitted stream of an earlier
# pass (flattened over that pass's groups, every emit mode counted);
# shift=1 reads the previous walk position (lane i-1 forward, i+1 in a
# reverse pass) with ``fill`` at walk position 0.  An elementwise ``prep``
# maps a group's loaded deps to the op's ``n_ops`` operands.  emit="none"
# streams are tap-only: the kernel keeps them in a workspace and the result
# omits them.


class Tap(NamedTuple):
    """Reference to an earlier chain pass's emitted stream (see above)."""

    pass_idx: int
    out_idx: int
    shift: int = 0
    fill: int = 0


def chain_group(
    kind: str,
    deps: Sequence,
    prep: Optional[Callable] = None,
    n_ops: Optional[int] = None,
    emit: str = "scan",
    n_states: Optional[int] = None,
) -> dict:
    """A chain-pass scan group.  ``deps`` mixes ``[B, L]`` tensors (external
    operands) and :class:`Tap` references; ``prep`` (elementwise) maps the
    loaded deps to the op's ``n_ops`` operand streams; without it the deps
    are the operands."""
    g = {"kind": kind, "xs": tuple(deps), "emit": emit}
    if n_states is not None:
        g["n_states"] = n_states
    if prep is not None:
        if n_ops is None:
            raise ValueError("chain_group with prep= requires n_ops=")
        g["prep"] = prep
        g["n_ops"] = n_ops
    return g


def segmax_group(v, r, emit: str = "scan") -> dict:
    """Segmented running-max group over (value, reset)."""
    return {"kind": "segmax", "xs": (v, r), "emit": emit}


def copy_group(vals: Sequence, emit: str = "none") -> dict:
    """Elementwise materialization group (no scan): stages streams so that
    later passes can tap them."""
    return {"kind": "copy", "xs": tuple(vals), "emit": emit}


def chain_pass(groups: Sequence[dict], reverse: bool = False) -> dict:
    """One pass of a :func:`chain_scan` program."""
    return {"groups": list(groups), "reverse": bool(reverse)}


# --- preps: each has an id that selects its __device__ twin in chain.cu -------

#: name -> (id, deps, operands) of every prep the kernel evaluates.  The
#: same table is spelled in ``csrc/chain.cu`` (struct ``Prep*``, ``ID``,
#: ``N_DEPS``, ``N_OPS``); the functions are the plain versions, registered
#: with :func:`chain_prep` (the sites' preps live in ``ops/stats.py``).
PREPS: Dict[str, Tuple[int, int, int]] = {
    "structure_sym": (1, 4, 2),
    "structure_agg": (2, 11, 3),
    "structure_hash": (3, 10, 3),
    "structure_copy": (4, 8, 2),
    "structure_vend": (5, 4, 1),
    "line_flags": (6, 7, 2),
    "nl_run_total": (7, 2, 2),
    "para_hash": (8, 7, 2),
    "para_bytes": (9, 7, 2),
    "sentence_hst": (10, 4, 2),
    "sentence_cnt": (11, 11, 2),
    "sentence_first": (12, 2, 1),
    "reset_value": (13, 2, 2),
    "sum2": (14, 2, 1),
    "over_50": (15, 1, 1),
    "low_bit": (16, 1, 1),
    "twice": (17, 1, 1),
    "state_is_one": (18, 1, 1),
}

_PREP_FNS: Dict[str, Callable] = {}


def chain_prep(fn: Callable) -> Callable:
    """Register ``fn`` as the plain version of the prep named ``fn.__name__``
    in :data:`PREPS`."""
    name = fn.__name__
    if name not in PREPS:
        raise ValueError(f"prep {name!r} has no id in PREPS (and no twin in csrc/chain.cu)")
    if _PREP_FNS.get(name, fn) is not fn:
        raise ValueError(f"prep {name!r} is registered twice")
    _PREP_FNS[name] = fn
    return fn


def _prep_id(prep: Callable, n_deps: int, n_ops: int) -> int:
    """The kernel's id of a registered prep; raises on any other callable or
    on a group whose dep or operand count differs from the prep's."""
    name = getattr(prep, "__name__", None)
    if name is None or _PREP_FNS.get(name) is not prep:
        raise ValueError(f"chain_scan: prep {prep!r} has no kernel id (register it with chain_prep)")
    pid, want_deps, want_ops = PREPS[name]
    if (n_deps, n_ops) != (want_deps, want_ops):
        raise ValueError(
            f"chain_scan: prep {name} takes {want_deps} deps and returns {want_ops} "
            f"operands, the group has {n_deps} and {n_ops}"
        )
    return pid


@chain_prep
def reset_value(seg, r):
    # The probe's segment total at resets (pallas_scan.py:1015).
    return torch.where(r != 0, seg, 0), r


@chain_prep
def sum2(a, b):
    return (a + b,)


@chain_prep
def over_50(a):
    return (a > 50,)


@chain_prep
def low_bit(a):
    return (a & 1,)


@chain_prep
def twice(a):
    return (a * 2,)


@chain_prep
def state_is_one(pk):
    # A packed DFA stream's state (nibble 0) equals 1.
    return ((pk & 15) == 1,)


def chain_probe_program(vals: torch.Tensor, reset: torch.Tensor) -> List[dict]:
    """The JAX package's chain probe program (pallas_scan.py:1008-1039): a
    scratch seg-add, a reverse segmax over its totals, and a forward copy
    with a shift tap beside an ``emit="last"`` count."""
    m = torch.where(reset != 0, 0, 1).to(torch.int32).contiguous()
    return [
        chain_pass([{"kind": "affine", "xs": (m, vals), "emit": "none"}]),
        chain_pass(
            [chain_group("segmax", (Tap(0, 0), reset), prep=reset_value, n_ops=2)],
            reverse=True,
        ),
        chain_pass(
            [
                chain_group("copy", (Tap(1, 0), Tap(0, 0, shift=1, fill=0)),
                            prep=sum2, n_ops=1, emit="scan"),
                chain_group("add", (Tap(1, 0),), prep=over_50, n_ops=1, emit="last"),
            ]
        ),
    ]


# --- the plan -------------------------------------------------------------------


def _chain_plan(passes: Sequence[dict]):
    """Resolve a chain program (``pallas_scan._chain_plan``): dedup external
    tensors by object identity, give every emitted stream an output slot
    (emit "scan" or "last") or a workspace slot (emit "none"), and check the
    taps.  Returns ``(plan, ext, out_modes, n_scratch, layout)``: per pass
    ``{"reverse", "groups": [{"spec", "g", "deps", "streams"}]}`` with deps
    ``("e", ext index)`` or ``("s", storage, shift, fill)`` and storage
    ``("out", i)`` or ``("scratch", j)``; ``layout`` the output slots per
    pass and group, empty for emit="none" groups."""
    ext: List[torch.Tensor] = []
    ext_index: Dict[int, int] = {}
    stream_table: List[List[Tuple[Tuple[str, int], str]]] = []
    out_modes: List[str] = []
    n_scratch = 0
    plan, layout = [], []
    for p_idx, pss in enumerate(passes):
        groups_plan, pass_streams, pass_layout = [], [], []
        for g in pss["groups"]:
            spec = _group_spec(g)
            emit = g.get("emit", "scan")
            deps = []
            for d in g["xs"]:
                if isinstance(d, Tap):
                    if not 0 <= d.pass_idx < p_idx:
                        raise ValueError(
                            f"Tap(pass_idx={d.pass_idx}) must reference an "
                            f"earlier pass (current pass {p_idx})"
                        )
                    if d.shift not in (0, 1):
                        raise ValueError("Tap.shift must be 0 or 1")
                    if not 0 <= d.out_idx < len(stream_table[d.pass_idx]):
                        raise ValueError(f"Tap(out_idx={d.out_idx}) past pass {d.pass_idx}'s streams")
                    storage, s_emit = stream_table[d.pass_idx][d.out_idx]
                    if s_emit == "last":
                        raise ValueError("cannot tap an emit='last' stream")
                    deps.append(("s", storage, d.shift, int(d.fill)))
                else:
                    key = id(d)
                    if key not in ext_index:
                        ext_index[key] = len(ext)
                        ext.append(d)
                    deps.append(("e", ext_index[key]))
            streams, g_layout = [], []
            for _ in spec[3]:
                if emit == "none":
                    storage = ("scratch", n_scratch)
                    n_scratch += 1
                else:
                    storage = ("out", len(out_modes))
                    out_modes.append(emit)
                    g_layout.append(storage[1])
                streams.append(storage)
                pass_streams.append((storage, emit))
            groups_plan.append({"spec": spec, "g": g, "deps": deps, "streams": streams})
            pass_layout.append(g_layout)
        stream_table.append(pass_streams)
        plan.append({"reverse": bool(pss.get("reverse", False)), "groups": groups_plan})
        layout.append(pass_layout)
    if not ext:
        raise ValueError("chain_scan needs at least one external operand")
    return plan, ext, out_modes, n_scratch, layout


def depfuse_enabled() -> bool:
    """``TEXTBLAST_DEPFUSE=off`` (or ``0``/``false``) selects the fused
    schedule instead of the chain; re-read per call so tests and benches
    can toggle it."""
    return os.environ.get("TEXTBLAST_DEPFUSE", "").lower() not in ("off", "0", "false")


def chain_scan_ok(b: int, length: int) -> bool:
    """Whether a caller takes the chain schedule for a ``[b, length]``
    batch: ``TEXTBLAST_DEPFUSE`` plus :func:`fused_scan_ok` (so
    ``TEXTBLAST_FUSED=off`` and the 16384-lane cap apply), as in the JAX
    package."""
    return depfuse_enabled() and fused_scan_ok(b, length)


def _flip(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(1,))


def chain_scan_plain(passes: Sequence[dict]) -> List[List[Tuple[torch.Tensor, ...]]]:
    """Plain PyTorch chain: the plan evaluated pass by pass on whole
    tensors.  A forward pass is the shift scan, a reverse pass
    ``flip(scan(flip(x)))``; a shift tap reads lane ``i-1`` (forward) or
    ``i+1`` (reverse) with ``fill`` at walk position 0; the prep runs on
    natural-order tensors (it is elementwise, so it commutes with the
    flip); ``emit="last"`` takes the carry at the end of the walk.  Takes
    any elementwise prep, registered or not."""
    plan, _, _, _, _ = _chain_plan(passes)
    emitted: List[List[torch.Tensor]] = []
    results = []
    for pss in plan:
        reverse = pss["reverse"]
        pass_streams, pass_res = [], []
        for gp in pss["groups"]:
            g = gp["g"]
            op, identities, _, emit_idx, emit_last = gp["spec"]
            deps = []
            for d, x in zip(gp["deps"], g["xs"]):
                if d[0] == "s":
                    tap, x = x, emitted[x.pass_idx][x.out_idx]
                    if tap.shift:
                        fill = torch.full_like(x[:, :1], tap.fill)
                        x = (torch.cat([x[:, 1:], fill], 1) if reverse
                             else torch.cat([fill, x[:, :-1]], 1))
                deps.append(x.to(torch.int32))
            prep = g.get("prep")
            ops = tuple(prep(*deps)) if prep is not None else tuple(deps)
            ops = tuple(o.to(torch.int32) for o in ops)
            ref = deps[0]
            if op is not None:
                if reverse:
                    scanned = tuple(_flip(x) for x in
                                    shift_scan_tuple(op, identities, tuple(_flip(o) for o in ops)))
                else:
                    scanned = shift_scan_tuple(op, identities, ops)
            else:
                scanned = ops
            if emit_last:
                rows, length = ref.shape
                if length == 0:
                    scanned = tuple(torch.full((rows, 1), v, dtype=torch.int32, device=ref.device)
                                    for v in identities)
                else:
                    col = slice(0, 1) if reverse else slice(length - 1, length)
                    scanned = tuple(x[:, col] for x in scanned)
            out = tuple(scanned[i] for i in emit_idx)
            pass_streams.extend(out)
            pass_res.append(out if g.get("emit", "scan") != "none" else ())
        emitted.append(pass_streams)
        results.append(pass_res)
    return results


#: Kind codes of csrc/chain.cu (affine/add/dfa as in fused.cu).
_CHAIN_KINDS = {"affine": 0, "add": 1, "dfa": 2, "segmax": 3, "copy": 4}
_EMITS = {"scan": 0, "last": 1, "none": 2}

#: Limits of ``csrc/chain.cu``'s by-value parameter block and its shared
#: memory staging (operands per group).
CHAIN_MAX_PASSES = 8
CHAIN_MAX_GROUPS = 16
CHAIN_MAX_DEPS = 64
CHAIN_MAX_EXT = 16
CHAIN_MAX_SLOTS = 32
CHAIN_MAX_OPS = 5


def _chain_code(plan, n_out: int) -> List[int]:
    """The plan as the flat int program ``tb_chain_scan`` parses: per pass
    ``reverse, n_groups``; per group ``kind, prep id, emit, n_states,
    n_deps, n_ops, n_emit``, then per dep ``tap, index, shift, fill`` (index:
    an external operand, or a stream slot) and the emitted streams' slots.
    Slots are the outputs, then the workspace streams (``n_out + j``)."""

    def slot(storage):
        return storage[1] if storage[0] == "out" else n_out + storage[1]

    code = [len(plan)]
    for pss in plan:
        code += [int(pss["reverse"]), len(pss["groups"])]
        for gp in pss["groups"]:
            g = gp["g"]
            kind = g["kind"]
            _, _, n_ops, _, _ = gp["spec"]
            n_deps = len(gp["deps"])
            prep = g.get("prep")
            pid = _prep_id(prep, n_deps, n_ops) if prep is not None else 0
            if prep is None and n_ops != n_deps:
                raise ValueError("chain_scan: a group without a prep has one operand per dep")
            if not 1 <= n_ops <= CHAIN_MAX_OPS:
                raise ValueError(f"chain_scan: {n_ops} operands in a group, the kernel takes 1..{CHAIN_MAX_OPS}")
            if kind == "affine" and n_ops < 2:
                raise ValueError("chain_scan: an affine group needs a multiplier and an accumulator")
            n_states = g.get("n_states", 0) if kind == "dfa" else 0
            if kind == "dfa" and not 1 <= n_states <= 8:
                raise ValueError("chain_scan: the kernel takes 1..8 DFA states")
            code += [_CHAIN_KINDS[kind], pid, _EMITS[g.get("emit", "scan")], n_states,
                     n_deps, n_ops, len(gp["streams"])]
            for d in gp["deps"]:
                if d[0] == "e":
                    code += [0, d[1], 0, 0]
                else:
                    code += [1, slot(d[1]), d[2], d[3]]
            code += [slot(s) for s in gp["streams"]]
    return code


# --- the launch: each program encoded once ---------------------------------------

#: Dynamic shared memory one CTA may have on an H100 (227 KiB).
CHAIN_SMEM_LIMIT = 232448


class ChainGeometry(NamedTuple):
    """How ``csrc/chain.cu`` lays a ``[rows, length]`` launch out: a row is
    ``cluster`` chunks of ``chunk = threads * items`` lanes, one CTA each
    (a thread block cluster when ``cluster > 1``).  ``tap_smem``: the
    tapped streams stay in shared memory (else they go through global
    memory); ``smem_bytes``: a CTA's dynamic shared memory."""

    cluster: int
    threads: int
    items: int
    chunk: int
    tap_smem: bool
    smem_bytes: int


def _smem_words(n_stage: int, n_keep_rows: int, threads: int, chunk: int) -> int:
    # chain.cu smem_words(): staged operands and keep rows (one skewed chunk
    # each), two buffers of warp totals, two of the chunk aggregate, the
    # chunk's carry and the walk's total.
    skew_len = chunk + chunk // 32 + 1
    return ((n_stage + n_keep_rows) * skew_len + 2 * (threads // 32) * CHAIN_MAX_OPS
            + 4 * CHAIN_MAX_OPS)


def chain_geometry(length: int, n_keep: int, n_stage: int) -> ChainGeometry:
    """The launch geometry of a program with ``n_keep`` tapped streams and
    at most ``n_stage`` operands per group over rows of ``length`` lanes:

    * ``length <= 2048``: one CTA per row, two lanes a thread (up to 1024
      threads).  A batch of 64 such rows leaves SMs idle, so a row's time
      is its latency, and the more warps share it the shorter it is;
    * wider: a cluster of ``min(8, ceil(length / 1024))`` CTAs per row,
      each a contiguous chunk of at least ``length / cluster`` lanes, eight
      lanes a thread (64 rows of 8192 lanes are 512 CTAs, which fill the
      card).

    The tapped streams stay in shared memory when they fit a CTA's 227
    KiB, else they go through global memory; raises if even the staged
    operands do not fit."""
    cluster, lanes = (1, 2) if length <= 2048 else (min(8, -(-length // 1024)), 8)
    per_cta = max(1, -(-length // cluster))
    threads = min(1024, -(-per_cta // (32 * lanes)) * 32)
    items = -(-per_cta // threads)
    chunk = threads * items
    for tap_smem in (True, False):
        smem = 4 * _smem_words(n_stage, n_keep if tap_smem else 0, threads, chunk)
        if smem <= CHAIN_SMEM_LIMIT:
            return ChainGeometry(cluster, threads, items, chunk, tap_smem, smem)
    raise ValueError(f"chain_scan: a row of {length} lanes does not fit the kernel's shared memory")


class _ChainProgram:
    """A program's plan, encoded once: its ``_chain_code``, the output
    slots and their buffers, the tapped streams and widest group, the C
    handle (on first launch) and the geometry per row width."""

    __slots__ = ("code", "n_ext", "n_slots", "n_scratch", "layout", "out_pos", "n_scan",
                 "n_last", "n_keep", "n_stage", "handle", "geometry", "ext_t", "slot_t")

    def __init__(self, passes: Sequence[dict]):
        plan, ext, out_modes, n_scratch, layout = _chain_plan(passes)
        n_groups = sum(len(p["groups"]) for p in plan)
        n_deps = sum(len(gp["deps"]) for p in plan for gp in p["groups"])
        n_slots = len(out_modes) + n_scratch
        limits = ((len(plan), CHAIN_MAX_PASSES, "passes"), (n_groups, CHAIN_MAX_GROUPS, "groups"),
                  (n_deps, CHAIN_MAX_DEPS, "deps"), (len(ext), CHAIN_MAX_EXT, "external operands"),
                  (n_slots, CHAIN_MAX_SLOTS, "streams"))
        for n, most, what in limits:
            if n > most:
                raise ValueError(f"chain_scan: {n} {what}, the kernel takes {most}")
        self.code = _chain_code(plan, len(out_modes))
        self.n_ext, self.n_slots, self.n_scratch, self.layout = len(ext), n_slots, n_scratch, layout
        # Each output's place: emit "scan" streams in one [n_scan, B, L]
        # buffer, emit "last" carries in one [n_last, B, 1] buffer.
        counts = {"scan": 0, "last": 0}
        self.out_pos = []
        for m in out_modes:
            self.out_pos.append((m == "last", counts[m]))
            counts[m] += 1
        self.n_scan, self.n_last = counts["scan"], counts["last"]
        tapped = {d[1] for p in plan for gp in p["groups"] for d in gp["deps"] if d[0] == "s"}
        self.n_keep = len(tapped)
        self.n_stage = max(gp["spec"][2] for p in plan for gp in p["groups"])
        self.handle: Optional[int] = None
        self.geometry: Dict[int, ChainGeometry] = {}
        self.ext_t = ctypes.c_void_p * self.n_ext
        self.slot_t = ctypes.c_void_p * max(1, n_slots)

    def encode(self, lib) -> int:
        """The C handle of the validated program (parsed once)."""
        if self.handle is None:
            info = (ctypes.c_int * 2)()
            h = lib.tb_chain_encode((ctypes.c_int * len(self.code))(*self.code), len(self.code),
                                    self.n_ext, self.n_slots, info)
            if h < 0:
                raise ValueError(f"chain_scan: the kernel refused the program (CUDA error {-h})")
            if (info[0], info[1]) != (self.n_keep, self.n_stage):
                raise RuntimeError("chain_scan: the kernel and the wrapper count the program's "
                                   "streams differently")
            self.handle = h
        return self.handle


#: Structure key -> encoded program (see :func:`_chain_key`).
_CHAIN_PROGRAMS: Dict[tuple, _ChainProgram] = {}


def _chain_key(passes: Sequence[dict]):
    """``(key, ext)``: the program's structure -- per pass the direction,
    per group the kind, prep, emit mode, states, operand count and deps
    (taps with their shift and fill; external operands by their index in
    first-use order) -- and the external tensors in that order, deduplicated
    by identity as :func:`_chain_plan` does."""
    ext: List[torch.Tensor] = []
    seen: Dict[int, int] = {}
    key = []
    for p in passes:
        groups = []
        for g in p["groups"]:
            deps = []
            for d in g["xs"]:
                if isinstance(d, Tap):
                    deps.append(d)
                else:
                    i = seen.get(id(d))
                    if i is None:
                        i = seen[id(d)] = len(ext)
                        ext.append(d)
                    deps.append(i)
            groups.append((g["kind"], g.get("prep"), g.get("emit", "scan"), g.get("n_states"),
                           g.get("n_ops"), tuple(deps)))
        key.append((bool(p.get("reverse", False)), tuple(groups)))
    return tuple(key), ext


def _cached_program(key: tuple, passes: Sequence[dict]) -> _ChainProgram:
    """The encoding cached under ``key``; a new structure is planned and
    validated exactly as :func:`_chain_plan` and :func:`_chain_code` do
    before it is cached."""
    prog = _CHAIN_PROGRAMS.get(key)
    if prog is None:
        prog = _CHAIN_PROGRAMS[key] = _ChainProgram(passes)
    return prog


def _chain_program(passes: Sequence[dict]) -> Tuple[_ChainProgram, List[torch.Tensor]]:
    """The cached encoding of ``passes`` and its external tensors."""
    key, ext = _chain_key(passes)
    return _cached_program(key, passes), ext


def _check_ext(ext: Sequence[torch.Tensor]) -> None:
    """:func:`_check` for the chain's operands, with a fast path for the
    common case."""
    shape, dev = ext[0].shape, ext[0].get_device()
    if len(shape) == 2:
        for t in ext:
            if (t.dtype is not torch.int32 or t.shape != shape or not t.is_contiguous()
                    or t.get_device() != dev):
                break
        else:
            return
    _check("chain_scan", ext)


def chain_scan(passes: Sequence[dict], site: Optional[str] = None
               ) -> List[List[Tuple[torch.Tensor, ...]]]:
    """Evaluate a dependency-chained multi-pass program in ONE kernel
    launch.  Returns, per pass, one tuple of int32 streams per group
    (``[B, L]`` for emit="scan", ``[B, 1]`` for emit="last", empty for
    emit="none").  ``site`` names the caller in
    :data:`CHAIN_SITE_LAUNCHES` and :data:`CHAIN_SHAPE_LAUNCHES`.

    Every external operand is a contiguous int32 ``[B, L]`` tensor on one
    device, every prep is registered (:func:`chain_prep`), and the program
    fits the kernel's limits (``CHAIN_MAX_*``).  A program's structure is
    planned, validated and encoded once (:func:`_chain_program`); a call
    then allocates the outputs and launches with the geometry of
    :func:`chain_geometry`.  Callers gate on :func:`chain_scan_ok` first."""
    passes = list(passes)
    key, ext = _chain_key(passes)
    scope = _scope()
    if scope is not None:
        # One chain books as ONE "fused" dispatch, as in the JAX package.
        scope.dispatch("fused")
        if ext:
            scope.launch(("chain_scan", *ext[0].shape), lambda: cost.chain_cost(passes))
    if not ext or ext[0].device.type == "cpu":
        return chain_scan_plain(passes)
    dev = ext[0].device
    if dev.type != "cuda":
        raise ValueError(f"chain_scan: unsupported device {dev}")
    prog = _cached_program(key, passes)
    _check_ext(ext)
    rows, length = ext[0].shape
    geo = prog.geometry.get(length)
    if geo is None:
        geo = prog.geometry[length] = chain_geometry(length, prog.n_keep, prog.n_stage)
    scan_buf = last_buf = None
    if prog.n_scan:
        scan_buf = torch.empty((prog.n_scan, rows, length), dtype=torch.int32, device=dev)
    if prog.n_last:
        last_buf = torch.empty((prog.n_last, rows, 1), dtype=torch.int32, device=dev)
    scans = scan_buf.unbind(0) if scan_buf is not None else ()
    lasts = last_buf.unbind(0) if last_buf is not None else ()
    outs = [lasts[i] if is_last else scans[i] for is_last, i in prog.out_pos]
    if rows:
        from ..kernels.build import load

        lib = load("chain")
        handle = prog.encode(lib)
        plane = 4 * rows * length
        scan0 = scan_buf.data_ptr() if scan_buf is not None else 0
        last0 = last_buf.data_ptr() if last_buf is not None else 0
        ptrs = [last0 + 4 * rows * i if is_last else scan0 + plane * i
                for is_last, i in prog.out_pos]
        if not geo.tap_smem and prog.n_scratch:
            ws = torch.empty((prog.n_scratch, rows, length), dtype=torch.int32, device=dev)
            ptrs += [ws.data_ptr() + plane * j for j in range(prog.n_scratch)]
        else:
            ptrs += [None] * prog.n_scratch
        args = (handle, prog.ext_t(*[x.data_ptr() for x in ext]), prog.n_ext,
                prog.slot_t(*ptrs), prog.n_slots, rows, length, geo.cluster, geo.threads,
                geo.items, int(geo.tap_smem), _stream(ext[0]))
        span = _span(dev)
        if dev.index == torch.cuda.current_device():
            err = lib.tb_chain_launch(*args)
        else:
            with torch.cuda.device(dev):
                err = lib.tb_chain_launch(*args)
        check(err, "chain_scan")
        _count("chain_scan", rows, length, span=span, device=dev)
        CHAIN_SITE_LAUNCHES[site] = CHAIN_SITE_LAUNCHES.get(site, 0) + 1
        CHAIN_SHAPE_LAUNCHES[(site, length)] = CHAIN_SHAPE_LAUNCHES.get((site, length), 0) + 1
    return [[tuple(outs[s] for s in g_slots) for g_slots in p_layout] for p_layout in prog.layout]
