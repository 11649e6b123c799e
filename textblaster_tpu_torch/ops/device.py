"""Shared device primitives: class tables, segmented scans, word masks.

The port's counterpart of ``textblaster_tpu/ops/device.py``.  Tables are
built in numpy (the same builders the host language model uses) and moved
to the caller's device; every function takes ``[B, L]`` tensors and works
on whatever device they live on.

Scans follow the Hillis–Steele shift schedule (``shift_scan_tuple``): level
``d`` combines position ``i`` with ``i - d``.  Every schedule of an
associative int32 op gives the same result, so these agree bit for bit with
the JAX package's ``assoc``/``shift``/``chunk`` schedules.  These scans are
plain PyTorch on every device: they are XLA lax scans in the JAX package,
not Pallas kernels.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..utils import chartables as ct
from ..utils.text import _MID_ALL, _MID_LETTER, _MID_NUM, _MID_NUM_LET

__all__ = [
    "class_table",
    "lower_table",
    "classify",
    "lowered",
    "const_i32",
    "utf8_width",
    "isin_sorted",
    "shift_scan_tuple",
    "assoc_scan1",
    "seg_scan_add",
    "seg_scan_or",
    "seg_scan_max",
    "latch_scan",
    "use_sort_tables",
    "rev",
    "word_base",
    "word_mask",
    "ALNUM",
    "ALPHA",
    "DIGIT",
    "WS",
    "PUNCT",
    "LOWER",
    "EXTEND",
    "MID_LETTER_CPS",
    "MID_NUM_CPS",
    "MID_ALL_CPS",
]

ALNUM = ct.ALNUM
ALPHA = ct.ALPHA
DIGIT = ct.DIGIT
WS = ct.WS
PUNCT = ct.PUNCT
LOWER = ct.LOWER
EXTEND = ct.EXTEND

_I32_MIN = -(2**31)


@lru_cache(maxsize=1)
def _class_table_np() -> np.ndarray:
    return ct.char_table()


@lru_cache(maxsize=1)
def _lower_table_np() -> np.ndarray:
    table = np.arange(ct._MAX_CP, dtype=np.int32)
    for cp in range(ct._MAX_CP):
        low = chr(cp).lower()
        if len(low) == 1 and ord(low) < ct._MAX_CP:
            table[cp] = ord(low)
    return table


def device_key(device) -> str:
    """The key of ``device`` in the per-device caches: one per physical
    device, so ``cuda`` (the current device) and ``cuda:0`` are one key."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


# Unbounded in devices: every device of a mesh keeps its copy of each table
# (two kinds a device).
@lru_cache(maxsize=None)
def _table_on(kind: str, device: str) -> torch.Tensor:
    arr = _class_table_np() if kind == "class" else _lower_table_np()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def class_table(device) -> torch.Tensor:
    """The host classification table (``[0x40000] uint8``) on ``device``."""
    return _table_on("class", device_key(device))


def lower_table(device) -> torch.Tensor:
    """Codepoint -> lowercase codepoint (identity where ``str.lower`` is not
    a single char), ``[0x40000] int32`` on ``device``."""
    return _table_on("lower", device_key(device))


def _gather_clamped(table: torch.Tensor, cps: torch.Tensor) -> torch.Tensor:
    idx = torch.clamp(cps, max=table.shape[0] - 1).long()
    return table[idx]


def classify(cps: torch.Tensor) -> torch.Tensor:
    """Gather char classes; indices clipped like the host ``classify``,
    with the same plane-14 EXTEND range check."""
    cls = _gather_clamped(class_table(cps.device), cps)
    plane14 = (cps >= ct._PLANE14_LO) & (cps < ct._PLANE14_HI)
    return torch.where(plane14, torch.tensor(EXTEND, dtype=torch.uint8, device=cps.device), cls)


def lowered(cps: torch.Tensor) -> torch.Tensor:
    """Lowercase codepoints via the lower table (clamped gather)."""
    return _gather_clamped(lower_table(cps.device), cps)


def utf8_width(cps: torch.Tensor) -> torch.Tensor:
    """UTF-8 encoded byte width of each codepoint (1/2/3/4), int32."""
    w = torch.where(
        cps < 0x80, 1, torch.where(cps < 0x800, 2, torch.where(cps < 0x10000, 3, 4))
    )
    return w.to(torch.int32)


@lru_cache(maxsize=None)
def _consts_on(device: str):
    """``device``'s own cache of constants (64 of them), so that the
    devices of a mesh do not evict each other's."""

    @lru_cache(maxsize=64)
    def const_on(data: bytes) -> torch.Tensor:
        return torch.from_numpy(np.frombuffer(data, dtype=np.int32).copy()).to(device)

    return const_on


def const_i32(values, device) -> torch.Tensor:
    """A small constant int32 vector on ``device`` (cached per device)."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.int32))
    return _consts_on(device_key(device))(arr.tobytes())


def isin_sorted(cps: torch.Tensor, sorted_vals) -> torch.Tensor:
    """Membership of each element in a small sorted int32 set."""
    vals = const_i32(sorted_vals, cps.device)
    x = cps.to(torch.int32).contiguous()
    idx = torch.searchsorted(vals, x)
    idx = torch.clamp(idx, max=vals.shape[0] - 1)
    return vals[idx] == x


# Plain numpy at module scope; moved to a device per call.
MID_LETTER_CPS = np.sort(
    np.array([ord(c) for c in (_MID_LETTER | _MID_NUM_LET)], dtype=np.int32)
)
MID_NUM_CPS = np.sort(
    np.array([ord(c) for c in (_MID_NUM | _MID_NUM_LET)], dtype=np.int32)
)
MID_ALL_CPS = np.sort(np.array([ord(c) for c in _MID_ALL], dtype=np.int32))


# --- Segmented scans ---------------------------------------------------------
# State (v, r): r = "resets here".  Composition is the standard segmented-scan
# monoid; associative, so any scan schedule computes the same values.


def _seg_add_op(a, b):
    av, ar = a
    bv, br = b
    return torch.where(br, bv, av + bv), ar | br


def _seg_or_op(a, b):
    av, ar = a
    bv, br = b
    return torch.where(br, bv, av | bv), ar | br


def _seg_max_op(a, b):
    av, ar = a
    bv, br = b
    return torch.where(br, bv, torch.maximum(av, bv)), ar | br


def _latch_op(a, b):
    # "Rightmost set value" monoid: b wins where it is set.
    av, ar = a
    bv, br = b
    return torch.where(br, bv, av), ar | br


def _pad_block(x: torch.Tensor, ident, d: int) -> torch.Tensor:
    blk = x[:, :d]
    if isinstance(ident, torch.Tensor):
        pad = torch.broadcast_to(ident.to(x.device, x.dtype), blk.shape)
    else:
        pad = torch.full_like(blk, ident)
    return torch.cat([pad, x[:, :-d]], dim=1)


def shift_scan_tuple(op, identities, xs):
    """Inclusive scan of a TUPLE state along axis 1 under associative ``op``
    via the contiguous-shift (Hillis-Steele) schedule (the JAX package's
    ``device.shift_scan_tuple``).

    ``op`` maps ``(left_state, right_state)`` tuples to a state tuple, where
    the left operand is the earlier prefix.  ``identities`` gives ``op``'s
    identity per component: a scalar, or a tensor broadcastable to a
    ``[B, d, ...]`` pad block.
    """
    xs = tuple(xs)
    length = xs[0].shape[1]
    d = 1
    while d < length:
        shifted = tuple(_pad_block(x, ident, d) for x, ident in zip(xs, identities))
        xs = tuple(op(shifted, xs))
        d *= 2
    return xs


def _seg_scan(op, identity, values: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    # Dispatch accounting (a no-op unless a count_scan_dispatches scope is
    # active).  Imported lazily: scan imports this module.
    from .scan import record_scan_dispatch

    record_scan_dispatch("lax_scan")
    # Virtual elements left of position 0 are (op identity, reset=True).
    v, _ = shift_scan_tuple(op, (identity, True), (values, reset))
    return v


def assoc_scan1(op, identity, x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of one tensor along axis 1 under associative ``op``;
    ``identity`` is a scalar or a tensor broadcastable to a pad block."""
    from .scan import record_scan_dispatch

    record_scan_dispatch("lax_scan")

    def tuple_op(a, b):
        return (op(a[0], b[0]),)

    return shift_scan_tuple(tuple_op, (identity,), (x,))[0]


def seg_scan_add(values: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum along axis 1; ``reset[i]`` starts a segment."""
    return _seg_scan(_seg_add_op, 0, values, reset)


def seg_scan_or(values: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    return _seg_scan(_seg_or_op, 0, values, reset)


def seg_scan_max(values: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    return _seg_scan(_seg_max_op, _I32_MIN, values, reset)


def latch_scan(values: torch.Tensor, set_mask: torch.Tensor) -> torch.Tensor:
    """Inclusive "hold" scan: at each position, the value of the most recent
    position where ``set_mask`` is True (0 before any set position)."""
    return _seg_scan(_latch_op, 0, values, set_mask)


def use_sort_tables() -> bool:
    """Whether per-segment tables are built scatter-free (one position sort +
    gathers) instead of by scatter.  ``TEXTBLAST_TABLE_IMPL`` (sort|scatter)
    pins one, as in the JAX package; the default is scatter on every device
    of the port, the JAX package's off-TPU default."""
    return os.environ.get("TEXTBLAST_TABLE_IMPL", "") == "sort"


def rev(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(1,))


def _shift_right0(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _shift_left0(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


def word_base(cps: torch.Tensor, cls: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw pre-WB4 wordness plus the Extend mask (the elementwise half of
    :func:`word_mask`)."""
    word = ((cls & ALNUM) != 0) | (cps == ord("_"))
    prev_cls = _shift_right0(cls)
    next_cls = _shift_left0(cls)
    letter_ok = (
        isin_sorted(cps, MID_LETTER_CPS)
        & ((prev_cls & ALPHA) != 0)
        & ((next_cls & ALPHA) != 0)
    )
    num_ok = (
        isin_sorted(cps, MID_NUM_CPS)
        & ((prev_cls & DIGIT) != 0)
        & ((next_cls & DIGIT) != 0)
    )
    word = word | letter_ok | num_ok
    ext = (cls & EXTEND) != 0
    return word, ext


def word_mask(cps: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """In-word mask (UAX#29-lite with the WB4 Extend rule): Extend chars
    inherit the wordness of the nearest preceding non-Extend char."""
    word, ext = word_base(cps, cls)
    held = seg_scan_or(word.to(torch.int32), ~ext)
    return torch.where(ext, held > 0, word)
