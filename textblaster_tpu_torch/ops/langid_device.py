"""Language-ID device function.

The port's counterpart of ``textblaster_tpu/ops/langid_tpu.py``
(``langid_scores``): build the normalized letters-and-boundaries stream with
a compaction, hash trigrams, gather the quantized ``[65536, 5]`` log-prob
table, and sum int32 scores per document.  Integer accumulation keeps the
scores bit-identical to the host model.  The table gather is plain PyTorch;
the whole-word hash goes through :func:`.stats._poly_hash`, whose affine
scan is the CUDA kernel on the card.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import torch

from ..models.langid import TABLE_SIZE, get_model
from .compact import compact
from .device import ALPHA, classify, device_key, lowered
from .stats import _poly_hash, _shift_l, _shift_r

__all__ = ["langid_scores", "table_q"]


@lru_cache(maxsize=None)  # one copy on every device of a mesh
def _table_q_on(device: str) -> torch.Tensor:
    return torch.from_numpy(get_model().table_q).to(device)


def table_q(device) -> torch.Tensor:
    """The host model's quantized table (``[TABLE_SIZE, 5] int32``) on
    ``device``."""
    return _table_q_on(device_key(device))


def langid_scores(
    cps: torch.Tensor, lengths: torch.Tensor, table: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-document quantized language scores.

    Returns ``(scores_q [B, 5] int32, n_grams [B] int32)``; rows with
    ``n_grams == 0`` are undetectable (letterless).  ``table`` overrides the
    model table (``[TABLE_SIZE, 5] int32`` on ``cps``'s device).
    """
    _, length = cps.shape
    dev = cps.device
    iota = torch.arange(length, dtype=torch.int32, device=dev)[None, :]
    mask = iota < lengths[:, None]

    low = torch.where(mask, lowered(cps), 0).to(torch.int32)
    letter = ((classify(low) & ALPHA) != 0) & mask

    # Collapse non-letter runs to single boundary markers (value 0), keeping
    # the first char of each run.
    nonletter = mask & ~letter
    first_of_run = nonletter & ~_shift_r(nonletter, False)
    keep = letter | first_of_run
    vals = torch.where(letter, low, 0).to(torch.int32)
    norm, nlen = compact(vals, keep)

    # Leading boundary: prepend 0 unless the stream already starts with one.
    starts_with_letter = norm[:, 0] != 0
    shifted = torch.cat([torch.zeros_like(norm[:, :1]), norm[:, :-1]], dim=1)
    norm = torch.where(starts_with_letter[:, None], shifted, norm)
    nlen = nlen + (starts_with_letter & (nlen > 0)).to(torch.int32)

    # Trailing boundary: extend the length when the last element is a letter.
    last = torch.gather(norm, 1, torch.clamp(nlen[:, None] - 1, min=0).long())[:, 0]
    nlen = torch.clamp(nlen + ((last != 0) & (nlen > 0)).to(torch.int32), max=length)

    c1 = norm
    c2 = torch.cat([norm[:, 1:], torch.zeros_like(norm[:, :1])], dim=1)
    c3 = torch.cat([norm[:, 2:], torch.zeros_like(norm[:, :2])], dim=1)
    h = (c1 * 961 + c2 * 31 + c3) & (TABLE_SIZE - 1)

    tri_valid = iota < torch.clamp(nlen - 2, min=0)[:, None]
    tbl = table_q(dev) if table is None else table
    rows = tbl[h.long()]  # [B, L, 5]
    scores = torch.where(tri_valid[..., None], rows, 0).sum(dim=1, dtype=torch.int32)

    # Whole-word hash features: the rolling hash h = h*31 + c of each
    # boundary-delimited word, via the shared segmented affine scan.
    in_word = norm != 0
    word_start = in_word & ~_shift_r(in_word, False)
    word_end = in_word & ~_shift_l(in_word, False)
    wh = _poly_hash(norm, in_word, word_start) & (TABLE_SIZE - 1)
    wrows = tbl[wh.long()]
    scores = scores + torch.where(word_end[..., None], wrows, 0).sum(
        dim=1, dtype=torch.int32
    )
    n_words = word_end.sum(dim=1, dtype=torch.int32)

    n_grams = (torch.clamp(nlen - 2, min=0) + n_words).to(torch.int32)
    return scores.to(torch.int32), n_grams
