"""Row-wise lexicographic sort of int32 key pairs and key triples.

The port's counterpart of the JAX package's ``textblaster_tpu/ops/
pallas_sort.py`` ``sort2`` and ``sort3`` (their Pallas kernel is
``_pallas_sort_n`` + ``_bitonic_kernel``).  On a CUDA tensor each launches
the hand-written bitonic network of ``csrc/sort.cu`` or raises; on a CPU
tensor :func:`sort2` runs :func:`sort2_plain`, the int64-packed sort of the
JAX package's off-TPU path (``pallas_sort.py:327-333``), and :func:`sort3`
runs :func:`sort3_plain`, three stable sorts.

Up to ``SMEM_WIDTH`` keys a row, ``sort2``'s kernel holds the keys in
registers (``csrc/sort.cu``; the CPU tests rehearse its index arithmetic in
numpy); wider rows take the shared-memory network with global passes.

``sort3`` has no caller on the port's path, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["LAUNCHES", "SHAPE_LAUNCHES", "SMEM_WIDTH", "SMEM_WIDTH3", "sort2", "sort2_plain",
           "sort3", "sort3_plain"]

#: Kernel launches on the card (one per call on CUDA).
LAUNCHES: Dict[str, int] = {"sort2": 0, "sort3": 0}
#: The same launches by ``(kernel, rows, width)``.
SHAPE_LAUNCHES: Dict[Tuple[str, int, int], int] = {}

#: Widest padded row the kernels sort on chip (sort2 in registers, sort3 in
#: shared memory); wider rows take global-memory passes and need a packed
#: scratch buffer (8 bytes an element for two keys, 16 for three).
SMEM_WIDTH = 16384
SMEM_WIDTH3 = 8192


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


def sort2(k1: torch.Tensor, k2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row sort by key ``k1`` carrying ``k2``; ties order by ``k2``.

    Every caller passes a payload ``k2`` that is non-negative and below
    ``INT32_MAX`` (iotas, byte lengths, codepoints, positions), which is
    what makes the kernel's order equal the plain version's.  Any width is
    taken: the kernel pads a row to the next power of two with
    ``(INT32_MAX, INT32_MAX)`` pairs as it loads it, which sort last, and
    writes back only the real columns — exact under that payload contract.
    """
    if k1.device.type == "cpu":
        return sort2_plain(k1, k2)
    if k1.device.type != "cuda":
        raise ValueError(f"sort2: unsupported device {k1.device}")
    _check("sort2", (k1, k2))
    rows, m = k1.shape
    o1, o2 = torch.empty_like(k1), torch.empty_like(k2)
    if rows == 0 or m == 0:
        return o1, o2
    mp = max(2, 1 << (m - 1).bit_length())
    scratch = (
        torch.empty((rows, mp), dtype=torch.int64, device=k1.device)
        if mp > SMEM_WIDTH
        else None
    )
    from ..kernels.build import check, load

    lib = load("sort")
    args = (k1.data_ptr(), k2.data_ptr(), o1.data_ptr(), o2.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, rows, m, mp,
            torch.cuda.current_stream(k1.device).cuda_stream)
    if k1.device.index == torch.cuda.current_device():
        err = lib.tb_sort2(*args)
    else:
        with torch.cuda.device(k1.device):
            err = lib.tb_sort2(*args)
    check(err, "sort2")
    LAUNCHES["sort2"] += 1
    SHAPE_LAUNCHES[("sort2", rows, m)] = SHAPE_LAUNCHES.get(("sort2", rows, m), 0) + 1
    return o1, o2


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
    if k1.device.type == "cpu":
        return sort3_plain(k1, k2, k3)
    if k1.device.type != "cuda":
        raise ValueError(f"sort3: unsupported device {k1.device}")
    _check("sort3", (k1, k2, k3))
    rows, m = k1.shape
    outs = tuple(torch.empty_like(k1) for _ in range(3))
    if rows == 0 or m == 0:
        return outs
    mp = max(2, 1 << (m - 1).bit_length())
    scratch = (
        torch.empty((rows, mp, 2), dtype=torch.int64, device=k1.device)
        if mp > SMEM_WIDTH3
        else None
    )
    from ..kernels.build import check, load

    lib = load("sort")
    with torch.cuda.device(k1.device):
        err = lib.tb_sort3(
            k1.data_ptr(), k2.data_ptr(), k3.data_ptr(),
            *(o.data_ptr() for o in outs),
            scratch.data_ptr() if scratch is not None else None,
            rows, m, mp, torch.cuda.current_stream(k1.device).cuda_stream,
        )
    check(err, "sort3")
    LAUNCHES["sort3"] += 1
    SHAPE_LAUNCHES[("sort3", rows, m)] = SHAPE_LAUNCHES.get(("sort3", rows, m), 0) + 1
    return outs
