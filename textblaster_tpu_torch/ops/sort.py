"""Row-wise lexicographic sort of int32 key pairs and key triples.

The port's counterpart of the JAX package's ``textblaster_tpu/ops/
pallas_sort.py`` ``sort2`` and ``sort3`` (their Pallas kernel is
``_pallas_sort_n`` + ``_bitonic_kernel``).  On a CUDA tensor each launches
the hand-written bitonic network of ``csrc/sort.cu`` or raises; on a CPU
tensor :func:`sort2` runs :func:`sort2_plain`, the int64-packed sort of the
JAX package's off-TPU path (``pallas_sort.py:327-333``), and :func:`sort3`
runs :func:`sort3_plain`, three stable sorts.

Both sorts run one register network, templated in ``csrc/sort.cu`` on the
element (two keys in a u64, three in a u64 and a u32), in the layout
:func:`sort_geometry` gives: up to ``REG_WIDTH2`` keys a row for
``sort2`` and ``REG_WIDTH3`` for ``sort3`` (the CPU tests rehearse its
index arithmetic in numpy).  Wider rows take the shared-memory network
with global passes.

``sort3`` has no caller on the port's path, as in the JAX package.

Inside a ``count_scan_dispatches`` scope (``ops/scan.py``) both record
their launch and its modeled bytes and operations (``ops/cost.py``) on any
device; neither counts as a scan dispatch, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..utils.trace import KERNEL_SPANS
from . import cost
from .scan import gates_open, record_launch

__all__ = ["LAUNCHES", "REG_WIDTH2", "REG_WIDTH3", "SHAPE_LAUNCHES", "SortGeometry",
           "sort2", "sort2_plain", "sort3", "sort3_plain", "sort_geometry"]

#: Kernel launches on the card (one per call on CUDA).
LAUNCHES: Dict[str, int] = {"sort2": 0, "sort3": 0}
#: The same launches by ``(kernel, rows, width)``.
SHAPE_LAUNCHES: Dict[Tuple[str, int, int], int] = {}

#: Widest padded row each sort holds in registers: sort2 in a 2-CTA
#: cluster, sort3 in a 4-CTA cluster (the top of the JAX package's Pallas
#: range).  Wider rows take global-memory passes and need a packed scratch
#: buffer (8 bytes an element for two keys, 16 for three).
REG_WIDTH2 = 16384
REG_WIDTH3 = 32768


class SortGeometry(NamedTuple):
    """One row's layout in ``csrc/sort.cu``'s register network: ``mp``
    padded keys, ``keys`` consecutive keys a thread (E), ``threads`` a row
    in one CTA, ``ctas`` a row (a cluster above one) and ``rows_per_cta``
    (4 in the warp path, one warp a row)."""

    mp: int
    keys: int
    threads: int
    ctas: int
    rows_per_cta: int


#: sort3's layout above the warp path, by padded width: (keys a thread E,
#: CTAs a row C), each the fastest of ``kernel_ab.py --kernels sort3
#: --sweep`` (64 rows; kernel ms on an NVIDIA H100 80GB HBM3 at 700 W; the
#: warp path is one warp a row, E = width / 32; a CTA holds at most 8192
#: keys, so the narrowest CTA of E = 8 is 256 keys):
#:
#:   width   warp    E8 C1   E8 C2   E8 C4   E16 C1  E16 C2  E16 C4
#:   256     0.0070  0.0051
#:   512     0.0128  0.0066  0.0077          0.0086
#:   1024    0.0250  0.0083  0.0098  0.0118  0.0113  0.0129
#:   2048            0.0138  0.0121  0.0177  0.0146  0.0171  0.0185
#:   4096            0.0275  0.0203  0.0271  0.0275  0.0220  0.0324
#:   8192            0.0611  0.0367  0.0559  0.0586  0.0380  0.0534
#:   16384                   0.0801  0.1172          0.0765  0.1144
#:   32768                           0.2934                  0.2761
_SORT3_CTA = {256: (8, 1), 512: (8, 1), 1024: (8, 1), 2048: (8, 2), 4096: (8, 2),
              8192: (8, 2), 16384: (16, 2), 32768: (16, 4)}


def sort_geometry(m: int, n_keys: int) -> Optional[SortGeometry]:
    """The register network's layout for rows of ``m`` keys of ``n_keys``
    (2 or 3) int32 keys, or None above ``REG_WIDTH2`` / ``REG_WIDTH3``.
    sort2: one warp a row up to 1024 keys (E = mp / 32), one CTA of 16
    keys a thread up to 8192, a 2-CTA cluster at 16384.  sort3: one warp a
    row up to 128 keys, then ``_SORT3_CTA``'s CTAs and clusters."""
    mp = max(2, 1 << (m - 1).bit_length())
    if mp > (REG_WIDTH2 if n_keys == 2 else REG_WIDTH3):
        return None
    if mp <= (1024 if n_keys == 2 else 128):
        mp = max(mp, 64)
        return SortGeometry(mp, mp // 32, 32, 1, 4)
    keys, ctas = (16, 2 if mp == REG_WIDTH2 else 1) if n_keys == 2 else _SORT3_CTA[mp]
    return SortGeometry(mp, keys, mp // keys // ctas, ctas, 1)


def sort2_plain(k1: torch.Tensor, k2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each row by ``k1`` then ``k2`` ascending: one int64 operand
    ``(k1 << 32) | k2``, exactly the JAX CPU path (non-negative ``k2``)."""
    z = (k1.to(torch.int64) << 32) | k2.to(torch.int64)
    s = torch.sort(z, dim=1).values
    return (s >> 32).to(torch.int32), (s & 0xFFFFFFFF).to(torch.int32)


def _check(name: str, ks) -> None:
    k1 = ks[0]
    for t in ks:
        if t.device != k1.device:
            raise ValueError(f"{name}: operands on different devices")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if t.dim() != 2 or t.shape != k1.shape:
            raise ValueError(f"{name}: expected equal [rows, m] operands")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    rows, m = k1.shape
    if rows > 65535 or m > 2**30:
        raise ValueError(f"{name}: shape {tuple(k1.shape)} not supported")


def _on_device(device: torch.device, fn, args) -> int:
    """``fn(*args)`` with ``device`` current (the device guard only when it
    is not current already)."""
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def _launch(name: str, ks: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """The kernel ``tb_<name>`` on the CUDA operands ``ks`` [rows, m]: the
    register network in ``sort_geometry``'s layout, or the shared-memory
    network with a scratch buffer above it; checked and counted."""
    k1 = ks[0]
    if k1.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {k1.device}")
    _check(name, ks)
    rows, m = k1.shape
    outs = tuple(torch.empty_like(k1) for _ in ks)
    if rows == 0 or m == 0:
        return outs
    mp = max(2, 1 << (m - 1).bit_length())
    g = sort_geometry(m, len(ks))
    scratch = (None if g is not None else
               torch.empty((rows, mp, len(ks) - 1), dtype=torch.int64, device=k1.device))
    from ..kernels.build import check, load

    fn = getattr(load("sort"), f"tb_{name}")
    args = (*(t.data_ptr() for t in ks + outs),
            scratch.data_ptr() if scratch is not None else None, rows, m, mp,
            *(g[1:] if g is not None else (0, 0, 0, 0)),
            torch.cuda.current_stream(k1.device).cuda_stream)
    # A launch inside a dispatch-count scope (a cost pass) takes no span.
    span = (KERNEL_SPANS.begin(k1.device)
            if KERNEL_SPANS.enabled and not gates_open() else None)
    check(_on_device(k1.device, fn, args), name)
    LAUNCHES[name] += 1
    SHAPE_LAUNCHES[(name, rows, m)] = SHAPE_LAUNCHES.get((name, rows, m), 0) + 1
    if span is not None:
        KERNEL_SPANS.end(span, k1.device, name, (name, rows, m))
    return outs


def sort2(k1: torch.Tensor, k2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row sort by key ``k1`` carrying ``k2``; ties order by ``k2``.

    Every caller passes a payload ``k2`` that is non-negative and below
    ``INT32_MAX`` (iotas, byte lengths, codepoints, positions), which is
    what makes the kernel's order equal the plain version's.  Any width is
    taken: the kernel pads a row to the next power of two with
    ``(INT32_MAX, INT32_MAX)`` pairs as it loads it, which sort last, and
    writes back only the real columns — exact under that payload contract.
    """
    record_launch(("sort2", *k1.shape), lambda: cost.sort_cost(2, *k1.shape))
    if k1.device.type == "cpu":
        return sort2_plain(k1, k2)
    return _launch("sort2", (k1, k2))


def sort3_plain(
    k1: torch.Tensor, k2: torch.Tensor, k3: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort each row by ``(k1, k2, k3)`` ascending, signed: three stable
    sorts, from the last key to the first."""
    keys = (k1.to(torch.int32), k2.to(torch.int32), k3.to(torch.int32))
    perm = torch.argsort(keys[2], dim=1, stable=True)
    for k in (keys[1], keys[0]):
        perm = torch.gather(perm, 1, torch.argsort(torch.gather(k, 1, perm), dim=1, stable=True))
    return tuple(torch.gather(k, 1, perm) for k in keys)


def sort3(
    k1: torch.Tensor, k2: torch.Tensor, k3: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row sort by ``(k1, k2, k3)``, lexicographic and signed (the JAX
    ``sort3``; ``lax.sort(num_keys=3)``).  Any int32 keys and any width:
    the kernel pads a row to the next power of two with ``INT32_MAX``
    triples, which sort last, and writes back only the real columns."""
    record_launch(("sort3", *k1.shape), lambda: cost.sort_cost(3, *k1.shape))
    if k1.device.type == "cpu":
        return sort3_plain(k1, k2, k3)
    return _launch("sort3", (k1, k2, k3))
