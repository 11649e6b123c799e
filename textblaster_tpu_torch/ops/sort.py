"""Row-wise lexicographic sort of int32 key pairs.

The port's counterpart of the JAX package's ``textblaster_tpu/ops/
pallas_sort.py`` ``sort2`` (its Pallas kernel is ``_pallas_sort_n`` +
``_bitonic_kernel``).  On a CUDA tensor :func:`sort2` launches the
hand-written bitonic network of ``csrc/sort.cu`` or raises; on a CPU tensor
it runs :func:`sort2_plain`, the int64-packed sort of the JAX package's
off-TPU path (``pallas_sort.py:327-333``).

``sort3`` has no caller on the port's path yet and is not ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["LAUNCHES", "sort2", "sort2_plain", "SMEM_WIDTH"]

#: Kernel launches on the card (one per :func:`sort2` call on CUDA).
LAUNCHES: Dict[str, int] = {"sort2": 0}

#: Widest padded row the kernel sorts in one CTA's shared memory; wider rows
#: take its global-memory passes and need a packed scratch buffer.
SMEM_WIDTH = 16384


def sort2_plain(k1: torch.Tensor, k2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each row by ``k1`` then ``k2`` ascending: one int64 operand
    ``(k1 << 32) | k2``, exactly the JAX CPU path (non-negative ``k2``)."""
    z = (k1.to(torch.int64) << 32) | k2.to(torch.int64)
    s = torch.sort(z, dim=1).values
    return (s >> 32).to(torch.int32), (s & 0xFFFFFFFF).to(torch.int32)


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
    for t in (k1, k2):
        if t.device != k1.device:
            raise ValueError("sort2: operands on different devices")
        if t.dtype != torch.int32:
            raise TypeError(f"sort2: expected int32, got {t.dtype}")
        if t.dim() != 2 or t.shape != k1.shape:
            raise ValueError("sort2: expected equal [rows, m] operands")
        if not t.is_contiguous():
            raise ValueError("sort2: operands must be contiguous")
    rows, m = k1.shape
    if rows > 65535 or m > 2**30:
        raise ValueError(f"sort2: shape {tuple(k1.shape)} not supported")
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
    with torch.cuda.device(k1.device):
        err = lib.tb_sort2(
            k1.data_ptr(),
            k2.data_ptr(),
            o1.data_ptr(),
            o2.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            rows,
            m,
            mp,
            torch.cuda.current_stream(k1.device).cuda_stream,
        )
    check(err, "sort2")
    LAUNCHES["sort2"] += 1
    return o1, o2
