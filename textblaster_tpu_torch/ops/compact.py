"""Device-side compaction: masked gather into a fresh packed tensor.

The port's counterpart of ``textblaster_tpu/ops/compact.py``: given a
keep-mask over ``[B, L]`` codepoints, move the kept chars to the front of a
new ``[B, L]`` tensor and recompute lengths.  Two forms behind
:func:`.device.use_sort_tables`: a scatter (the default), and a sorted
partition through :func:`.sort.sort2` (the CUDA bitonic kernel on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .device import use_sort_tables
from .sort import sort2

__all__ = ["compact"]

_I32_MAX = 2**31 - 1


def compact(cps: torch.Tensor, keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack kept chars to the row starts, order preserved.

    Returns ``(new_cps [B, L] int32 zero-padded, new_lengths [B] int32)``.
    """
    b, length = cps.shape
    if use_sort_tables():
        new_lengths = keep.sum(dim=1, dtype=torch.int32)
        # Stable partition by sort: key = original position for kept chars,
        # INT32_MAX for dropped.  Codepoints are non-negative, satisfying
        # sort2's payload contract; sort2 takes any row width.
        pos = torch.arange(length, dtype=torch.int32, device=cps.device)[None, :]
        key = torch.where(keep, pos, _I32_MAX).to(torch.int32).contiguous()
        val = torch.where(keep, cps, 0).to(torch.int32).contiguous()
        s_key, s_val = sort2(key, val)
        new_cps = torch.where(s_key != _I32_MAX, s_val, 0).to(torch.int32)
        return new_cps, new_lengths

    # Flat scatter; dropped chars route to a trash slot past the real data.
    new_pos = torch.cumsum(keep.to(torch.int32), dim=1, dtype=torch.int32) - 1
    new_lengths = torch.where(keep, new_pos + 1, 0).amax(dim=1).to(torch.int32)
    rows = torch.arange(b, dtype=torch.int64, device=cps.device)[:, None]
    flat_idx = torch.where(keep, rows * length + new_pos, b * length)
    out = torch.zeros(b * length + 1, dtype=cps.dtype, device=cps.device)
    out.scatter_(0, flat_idx.reshape(-1), cps.reshape(-1))
    return out[:-1].reshape(b, length), new_lengths
