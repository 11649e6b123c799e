"""Row-wise inclusive scans: the per-scan kernels and the fused multi-group scan.

The port's counterpart of the JAX package's
``textblaster_tpu/ops/pallas_scan.py`` without ``chain_scan``:

* the per-scan half, ``affine_hash_scan`` and ``dfa_compose_scan`` (their
  Pallas kernel is ``_pallas_scan_tuple``; here ``csrc/scan.cu``);
* the fused half, :func:`fused_scan` over a list of independent groups
  built by :func:`affine_group`, :func:`add_group` and :func:`dfa_group`
  (its Pallas kernel is ``_fused_call``; here ``csrc/fused.cu``).

On a CUDA tensor each wrapper launches its hand-written kernel or raises;
on a CPU tensor it runs the plain PyTorch version beside it, which follows
the Hillis–Steele shift schedule of the JAX ops (``_affine_op``,
``_add_op``, ``_dfa_op``).  Every schedule gives the same int32 result by
integer associativity, so the two agree bit for bit.

``TEXTBLAST_FUSED=off`` selects the staged *schedule* (callers gate on
:func:`fused_scan_ok`), as in the JAX package; it never sends a CUDA
tensor to a plain version.

``LAUNCHES`` counts kernel launches per kernel; only a launch on the card
adds to it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Sequence, Tuple

import torch

from .device import shift_scan_tuple

__all__ = [
    "LAUNCHES",
    "add_group",
    "affine_group",
    "affine_hash_scan",
    "affine_hash_scan_plain",
    "dfa_compose_scan",
    "dfa_compose_scan_plain",
    "dfa_group",
    "dfa_ident",
    "fused_enabled",
    "fused_scan",
    "fused_scan_ok",
    "fused_scan_plain",
]

#: Kernel launches on the card, by kernel name.
LAUNCHES: Dict[str, int] = {"affine_scan": 0, "dfa_scan": 0, "fused_scan": 0}

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
    ref = ts[0]
    for t in ts:
        if t.device != ref.device:
            raise ValueError(f"{name}: operands on different devices")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if t.dim() != 2 or t.shape != ref.shape:
            raise ValueError(f"{name}: expected equal [rows, len] operands")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if ref.shape[0] > 2**31 - 1 or ref.shape[1] > 2**31 - 1:
        raise ValueError(f"{name}: shape {tuple(ref.shape)} too large")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def affine_hash_scan(
    m: torch.Tensor, accs: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of the shared-multiplier affine hash op along axis 1:
    returns the scanned accumulator streams (1 or 2 of them; the scanned
    multiplier is internal).  All operands are contiguous int32
    ``[rows, len]`` tensors on one device; any shape is taken."""
    accs = tuple(accs)
    if m.device.type == "cpu":
        return affine_hash_scan_plain(m, accs)
    if m.device.type != "cuda":
        raise ValueError(f"affine_hash_scan: unsupported device {m.device}")
    if len(accs) not in (1, 2):
        raise ValueError("affine_hash_scan: the kernel takes 1 or 2 accumulators")
    _check("affine_hash_scan", (m,) + accs)
    from ..kernels.build import check, load

    lib = load("scan")
    outs = tuple(torch.empty_like(a) for a in accs)
    rows, length = m.shape
    with torch.cuda.device(m.device):
        err = lib.tb_affine_scan(
            m.data_ptr(),
            accs[0].data_ptr(),
            accs[1].data_ptr() if len(accs) == 2 else None,
            outs[0].data_ptr(),
            outs[1].data_ptr() if len(accs) == 2 else None,
            rows,
            length,
            len(accs),
            _stream(m),
        )
    check(err, "affine_hash_scan")
    LAUNCHES["affine_scan"] += 1
    return outs


def dfa_compose_scan(fns: torch.Tensor, n_states: int) -> torch.Tensor:
    """Inclusive scan of nibble-packed DFA transition maps along axis 1, for
    ``n_states`` <= 8.  ``fns`` is a contiguous int32 ``[rows, len]``
    tensor whose nibbles hold states below ``n_states``."""
    if fns.device.type == "cpu":
        return dfa_compose_scan_plain(fns, n_states)
    if fns.device.type != "cuda":
        raise ValueError(f"dfa_compose_scan: unsupported device {fns.device}")
    if not 1 <= n_states <= 8:
        raise ValueError("dfa_compose_scan: the kernel takes 1..8 states")
    _check("dfa_compose_scan", (fns,))
    from ..kernels.build import check, load

    lib = load("scan")
    out = torch.empty_like(fns)
    rows, length = fns.shape
    with torch.cuda.device(fns.device):
        err = lib.tb_dfa_scan(
            fns.data_ptr(), out.data_ptr(), rows, length, n_states, _stream(fns)
        )
    check(err, "dfa_compose_scan")
    LAUNCHES["dfa_scan"] += 1
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
    of one group (``pallas_scan._group_spec`` for the kinds the fused scan
    takes; segmax and copy groups belong to ``chain_scan``, not ported)."""
    kind = g["kind"]
    n_in = len(g["xs"])
    emit = g.get("emit", "scan")
    if emit not in ("scan", "last"):
        raise ValueError(f"unknown emit mode {emit!r}")
    emit_last = emit == "last"
    if kind == "affine":
        return _affine_op, (1,) + (0,) * (n_in - 1), n_in, tuple(range(1, n_in)), emit_last
    if kind == "add":
        return _add_op, (0,) * n_in, n_in, tuple(range(n_in)), emit_last
    if kind == "dfa":
        n_states = g["n_states"]
        return _dfa_op(n_states), (dfa_ident(n_states),), 1, (0,), emit_last
    if kind in ("segmax", "copy"):
        raise ValueError(f"{kind} groups belong to chain_scan, which is not ported")
    raise ValueError(f"unknown fused group kind {kind!r}")


def _regroup(groups: Sequence[dict], flat: Sequence[torch.Tensor]):
    """Split a flat emitted-stream tuple back into per-group tuples."""
    out, i = [], 0
    for g in groups:
        k = len(_group_spec(g)[3])
        out.append(tuple(flat[i : i + k]))
        i += k
    return out


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
    ragged edges.

    The port has no ``chain_scan`` yet, so it runs the JAX package's
    schedule under ``TEXTBLAST_DEPFUSE=off`` whatever that variable says."""
    del b  # any row count works
    return fused_enabled() and length <= FUSED_MAX_LANES


def fused_scan_plain(groups: Sequence[dict]) -> List[Tuple[torch.Tensor, ...]]:
    """Plain PyTorch fused scan: each group's op on the shift schedule,
    the last column taken for ``emit="last"``."""
    out = []
    for g in groups:
        op, identities, _, emit_idx, emit_last = _group_spec(g)
        xs = tuple(x.to(torch.int32) for x in g["xs"])
        scanned = shift_scan_tuple(op, identities, xs)
        if emit_last and xs[0].shape[1] == 0:  # an empty row's carry is the identity
            scanned = tuple(torch.full((x.shape[0], 1), v, dtype=torch.int32, device=x.device)
                            for x, v in zip(xs, identities))
        elif emit_last:
            scanned = tuple(x[:, -1:] for x in scanned)
        out.append(tuple(scanned[i] for i in emit_idx))
    return out


_KINDS = {"affine": 0, "add": 1, "dfa": 2}


def fused_scan(groups: Sequence[dict]) -> List[Tuple[torch.Tensor, ...]]:
    """Evaluate independent scan groups in ONE kernel launch; returns one
    tuple of int32 streams per group: ``[B, L]`` scans for
    ``emit="scan"``, ``[B, 1]`` final carries for ``emit="last"``.

    Every operand is a contiguous int32 ``[B, L]`` tensor on one device;
    at most 8 groups and 16 input and 16 output streams; DFA groups take
    1..8 states.  Callers gate on :func:`fused_scan_ok` first."""
    groups = list(groups)
    if not groups:
        raise ValueError("fused_scan: no groups")
    dev = groups[0]["xs"][0].device
    if dev.type == "cpu":
        return fused_scan_plain(groups)
    if dev.type != "cuda":
        raise ValueError(f"fused_scan: unsupported device {dev}")
    specs = [_group_spec(g) for g in groups]
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
    from ..kernels.build import check, load

    rows, length = xs[0].shape
    outs = []
    for _, _, _, emit_idx, emit_last in specs:
        shape = (rows, 1) if emit_last else (rows, length)
        outs.extend(torch.empty(shape, dtype=torch.int32, device=dev) for _ in emit_idx)
    if rows == 0:
        return _regroup(groups, outs)

    def ints(vals):
        return (ctypes.c_int * len(vals))(*vals)

    lib = load("fused")
    kinds = ints([_KINDS[g["kind"]] for g in groups])
    n_in = ints([len(g["xs"]) for g in groups])
    last = ints([int(s[4]) for s in specs])
    n_states = ints([g.get("n_states", 0) for g in groups])
    in_ptrs = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    with torch.cuda.device(dev):
        err = lib.tb_fused_scan(
            len(groups), kinds, n_in, last, n_states,
            in_ptrs, len(xs), out_ptrs, len(outs), rows, length, _stream(xs[0]),
        )
    check(err, "fused_scan")
    LAUNCHES["fused_scan"] += 1
    return _regroup(groups, outs)
