"""Per-filter statistic functions over packed codepoint batches.

The port's counterpart of ``textblaster_tpu/ops/stats.py``, restricted to
its *staged* schedule: the branches the JAX package takes when
``chain_scan_ok`` and ``fused_scan_ok`` are false (``TEXTBLAST_FUSED=off``).
Each function maps ``(cps [B, L], lengths [B])`` to per-document integer
statistics; ratios, thresholds and reason strings are computed on the host
in float64 from these integers (:mod:`.pipeline`).

Two hand-written CUDA kernels carry this path on the card: the affine scan
behind every segmented polynomial hash (:func:`_poly_hash_many`) and the
bitonic ``sort2`` behind every duplicate table (:func:`_sort_runs_many`).
The segmented add/or/max scans stay plain PyTorch, as they are lax scans in
the JAX package.  The JAX package's two ``lax.cond`` gates (the n-gram
rarity gate and the citation gate) and the pattern-candidate gate become
host ``if``s: one device-to-host sync each per batch.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils.text import _CLOSE, _PARA_SEP, _SP, _STERM
from .compact import compact
from .device import (
    ALNUM,
    ALPHA,
    DIGIT,
    EXTEND,
    LOWER,
    PUNCT,
    WS,
    classify,
    isin_sorted,
    latch_scan,
    lowered,
    rev,
    seg_scan_add,
    seg_scan_max,
    seg_scan_or,
    use_sort_tables,
    utf8_width,
    word_mask,
)
from .dfa import citation_spans, dfa_states
from .scan import affine_hash_scan
from .sort import sort2

__all__ = [
    "TextStructure",
    "structure",
    "line_info",
    "gopher_quality_stats",
    "fineweb_stats",
    "gopher_rep_stats",
    "c4_stage",
    "C4Params",
    "sentence_boundaries",
    "sentence_counts",
    "hash_string",
]

NL = ord("\n")
CR = ord("\r")

#: The exact n-gram walk's work on this process: calls, loop steps, and
#: host-clock seconds (the walk waits for the device before returning).
DUP_WALK: Dict[str, float] = {"calls": 0, "steps": 0, "seconds": 0.0}

_I32 = torch.int32
_I32_MAX = 2**31 - 1


def _iota(length: int, device) -> torch.Tensor:
    return torch.arange(length, dtype=_I32, device=device)[None, :]


def _shift_r(x: torch.Tensor, fill=0) -> torch.Tensor:
    """x[i-1] along axis 1 (``fill`` at position 0)."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _shift_l(x: torch.Tensor, fill=0) -> torch.Tensor:
    """x[i+1] along axis 1 (``fill`` at last position)."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _first_col(mask: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    out[:, 0] = True
    return out


def _pad_cols(x: torch.Tensor, k: int, fill=0) -> torch.Tensor:
    """``x[:, k:]`` right-padded back to the full width with ``fill``."""
    if k == 0:
        return x
    return torch.cat([x[:, k:], torch.full_like(x[:, :k], fill)], dim=1)


def _sum32(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=1, dtype=_I32)


def hash_string(s: str) -> int:
    """Host twin of the device polynomial hash (int32 wraparound, mul 31)."""
    h = 0
    for ch in s:
        h = (h * 31 + ord(ch)) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


def _poly_hash_many(
    values: Tuple[torch.Tensor, ...],
    in_seg: torch.Tensor,
    seg_start: torch.Tensor,
    mul: int = 31,
) -> Tuple[torch.Tensor, ...]:
    """Segmented polynomial hashes h = h*mul + v, all ``values`` streams
    sharing one affine scan (at most two per kernel launch).  Positions
    outside segments pass through; ``seg_start`` restarts."""
    m = torch.where(seg_start, 0, torch.where(in_seg, mul, 1)).to(_I32).contiguous()
    accs = tuple(torch.where(in_seg, v, 0).to(_I32).contiguous() for v in values)
    out: Tuple[torch.Tensor, ...] = ()
    for i in range(0, len(accs), 2):
        out += affine_hash_scan(m, accs[i : i + 2])
    return out


def _poly_hash(
    cps: torch.Tensor, in_seg: torch.Tensor, seg_start: torch.Tensor, mul: int = 31
) -> torch.Tensor:
    return _poly_hash_many((cps,), in_seg, seg_start, mul=mul)[0]


def _scatter(values, idx, active, m, fill=0, op="set"):
    """Scatter per-char ``values`` at ``active`` positions into ``[B, m]``
    slots keyed by ``idx``; inactive or out-of-range positions go to a
    trash slot past the table (the JAX ``mode="drop"`` scatter).  With
    op="set", callers guarantee one active position per slot."""
    b = values.shape[0]
    dev = values.device
    rows = torch.arange(b, dtype=torch.int64, device=dev)[:, None]
    ok = active & (idx >= 0) & (idx < m)
    flat_idx = torch.where(ok, rows * m + idx, b * m).reshape(-1)
    out = torch.full((b * m + 1,), fill, dtype=values.dtype, device=dev)
    src = torch.where(ok, values, torch.full_like(values, fill)).reshape(-1)
    if op == "set":
        out.scatter_(0, flat_idx, values.reshape(-1))
    elif op == "add":
        out.scatter_add_(0, flat_idx, src)
    elif op == "max":
        out.scatter_reduce_(0, flat_idx, src, reduce="amax", include_self=True)
    else:
        raise ValueError(op)
    return out[:-1].reshape(b, m)


def _rank_positions_many(actives, m):
    """For each ``[B, L]`` bool mask in ``actives``: positions of its 1st,
    2nd, ... active element per row, as ``(pos [B, m] int32, real [B, m]
    bool)``.  All masks share one stacked :func:`sort2`."""
    b, length = actives[0].shape
    pos = _iota(length, actives[0].device)
    keys = [torch.where(a, pos, _I32_MAX).to(_I32) for a in actives]
    key = keys[0] if len(keys) == 1 else torch.cat(keys, dim=0)
    padded = 1 << (length - 1).bit_length()
    if padded != length:
        key = torch.cat(
            [key, torch.full((key.shape[0], padded - length), _I32_MAX, dtype=_I32,
                             device=key.device)],
            dim=1,
        )
    key = key.contiguous()
    payload = torch.where(key == _I32_MAX, 0, key).to(_I32)
    s_key, s_pos = sort2(key, payload)
    if m > s_key.shape[1]:  # more slots than row positions: right-pad invalid
        extra = m - s_key.shape[1]
        s_key = torch.cat([s_key, torch.full((s_key.shape[0], extra), _I32_MAX,
                                              dtype=_I32, device=s_key.device)], dim=1)
        s_pos = torch.cat([s_pos, torch.zeros((s_pos.shape[0], extra), dtype=_I32,
                                              device=s_pos.device)], dim=1)
    outs = []
    for i in range(len(actives)):
        blk_key = s_key[i * b : (i + 1) * b, :m]
        blk_pos = s_pos[i * b : (i + 1) * b, :m]
        outs.append((blk_pos, blk_key != _I32_MAX))
    return outs


def _gather_table(values, pos, real, fill=0):
    v = torch.gather(values, 1, pos.long())
    return torch.where(real, v, torch.full_like(v, fill))


class TextStructure(NamedTuple):
    """Shared word-unit structure extracted once per packed batch."""

    cps: torch.Tensor  # [B, L] int32
    lengths: torch.Tensor  # [B]
    cls: torch.Tensor  # [B, L] uint8 class bits
    mask: torch.Tensor  # [B, L] bool — char belongs to the doc
    unit_end: torch.Tensor  # [B, L] bool — last char of each unit
    unit_valid: torch.Tensor  # [B, L] bool at unit_end — unit counts as a word
    unit_len: torch.Tensor  # [B, L] int32 at unit_end — chars in unit
    unit_bytes: torch.Tensor  # [B, L] int32 at unit_end — UTF-8 bytes of unit
    unit_hash: torch.Tensor  # [B, L] int32 at unit_end — content hash
    unit_lhash: torch.Tensor  # [B, L] int32 at unit_end — lowercased hash
    unit_alpha: torch.Tensor  # [B, L] bool at unit_end — has alphabetic char
    n_words: torch.Tensor  # [B] int32 — valid unit count
    word_idx: torch.Tensor  # [B, L] int32 at valid unit_end — word ordinal


def structure(
    cps: torch.Tensor, lengths: torch.Tensor, with_hashes: bool = True
) -> TextStructure:
    """Word-unit segmentation with per-unit aggregates.  ``with_hashes=False``
    skips the two polynomial-hash streams (the hash fields come back
    ``None``)."""
    _, length = cps.shape
    mask = _iota(length, cps.device) < lengths[:, None]
    cls = classify(cps)
    cls = torch.where(mask, cls, torch.zeros_like(cls))

    ws = (cls & WS) != 0
    punct = (cls & PUNCT) != 0
    ext = ((cls & EXTEND) != 0) & mask

    in_word = word_mask(cps, cls) & mask
    # Symbols: not word/ws/punct; ZWSP yields no token, bare Extend chars
    # yield no token, and an Extend run after a symbol continues its unit.
    base_symbol = ~in_word & ~ws & ~punct & mask & (cps != 0x200B) & ~ext
    held_sym = seg_scan_or(base_symbol.to(_I32), ~ext) > 0
    symbol = base_symbol | (ext & ~in_word & held_sym)

    in_unit = in_word | symbol
    prev_in_word = _shift_r(in_word, False)
    unit_start = (in_word & ~prev_in_word) | base_symbol
    next_start = _shift_l(unit_start, False)
    next_in_unit = _shift_l(in_unit, False)
    unit_end = in_unit & (~next_in_unit | next_start)

    ones = in_unit.to(_I32)
    widths = torch.where(in_unit, utf8_width(cps), 0).to(_I32)
    nonpunct = torch.where(in_unit, (~punct).to(_I32), 0).to(_I32)
    alpha = torch.where(in_unit, ((cls & ALPHA) != 0).to(_I32), 0).to(_I32)

    if length <= 8192:
        # Two packed add-scans instead of four: within a unit, chars <= 8192
        # and UTF-8 bytes <= 4*8192 (below bit 17), so len<<17|bytes and
        # nonpunct<<16|alpha add without cross-field carries.
        packed_a = seg_scan_add(ones * (1 << 17) + widths, unit_start)
        packed_b = seg_scan_add(nonpunct * (1 << 16) + alpha, unit_start)
        unit_len = packed_a >> 17
        unit_bytes = packed_a & ((1 << 17) - 1)
        unit_valid = (packed_b >> 16) > 0
        unit_alpha = (packed_b & ((1 << 16) - 1)) > 0
    else:
        unit_len = seg_scan_add(ones, unit_start)
        unit_bytes = seg_scan_add(widths, unit_start)
        unit_valid = seg_scan_or(nonpunct, unit_start) > 0
        unit_alpha = seg_scan_or(alpha, unit_start) > 0

    if with_hashes:
        low = lowered(cps)
        unit_hash, unit_lhash = _poly_hash_many((cps, low), in_unit, unit_start)
    else:
        unit_hash = unit_lhash = None

    valid_end = unit_end & unit_valid
    word_idx = torch.cumsum(valid_end.to(_I32), dim=1, dtype=_I32) - 1
    n_words = _sum32(valid_end)

    return TextStructure(
        cps=cps,
        lengths=lengths,
        cls=cls,
        mask=mask,
        unit_end=unit_end,
        unit_valid=unit_valid,
        unit_len=unit_len,
        unit_bytes=unit_bytes,
        unit_hash=unit_hash,
        unit_lhash=unit_lhash,
        unit_alpha=unit_alpha,
        n_words=n_words,
        word_idx=word_idx,
    )


def _lowered(cps: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, lowered(cps), 0).to(_I32)


def _match_pattern(src: torch.Tensor, mask: torch.Tensor, pattern: str) -> torch.Tensor:
    """[B, L] bool: fixed string ``pattern`` starts at each position."""
    hit = mask
    for k, ch in enumerate(pattern):
        shifted = _pad_cols(src, k, -1)
        mk = _pad_cols(mask, k, False)
        hit = hit & (shifted == ord(ch)) & mk
    return hit


def _to_i32(u: int) -> int:
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= (1 << 31) else u


def _pattern_union_starts(
    src: torch.Tensor, mask: torch.Tensor, patterns: Tuple[str, ...]
) -> torch.Tensor:
    """[B, L] bool: some pattern in ``patterns`` starts at each position.

    Rolling-hash window candidates first (one affine scan), then the exact
    shifted compare, run only when the batch has a candidate (a host ``if``
    where the JAX package has a ``lax.cond``).  Decisions always come from
    the exact compare, so hash collisions cannot alter semantics."""
    vals = torch.where(mask, src, 0).to(_I32)
    first = _first_col(mask)
    h_inc = _poly_hash(vals, torch.ones_like(mask), first)  # inclusive prefix hash
    h_exc = _shift_r(h_inc, 0)  # hash of chars [0, i)

    cand = torch.zeros_like(mask)
    for pat in patterns:
        n = len(pat)
        target = _to_i32(hash_string(pat))
        pw = _to_i32(pow(31, n, 1 << 32))
        # Window [i, i+n): hash = h_inc[i+n-1] - h_exc[i] * 31^n (int32 wrap).
        h_end = _pad_cols(h_inc, n - 1, 0)
        cand = cand | ((h_end - h_exc * pw == target) & mask)

    if not bool(cand.any()):
        return torch.zeros_like(mask)
    hit = torch.zeros_like(mask)
    for pat in patterns:
        hit = hit | _match_pattern(src, mask, pat)
    return hit


# --- Line structure ----------------------------------------------------------


class LineInfo(NamedTuple):
    line_id: torch.Tensor  # [B, L] int32 — rust_lines index per char
    line_start: torch.Tensor  # [B, L] bool — first char of each line (or its \n)
    content: torch.Tensor  # [B, L] bool — not \n, not \r-before-\n
    is_nl: torch.Tensor  # [B, L] bool
    n_lines: torch.Tensor  # [B] int32 — rust_lines count
    last_content: torch.Tensor  # [B, L] bool — last content char of its line


def line_info(cps: torch.Tensor, mask: torch.Tensor) -> LineInfo:
    is_nl = (cps == NL) & mask
    next_is_nl = _shift_l(is_nl, False)
    stripped_cr = (cps == CR) & next_is_nl & mask
    content = mask & ~is_nl & ~stripped_cr

    nl_i = is_nl.to(_I32)
    line_id = torch.cumsum(nl_i, dim=1, dtype=_I32) - nl_i

    prev_nl = _shift_r(is_nl, False)
    line_start = mask & (prev_nl | _first_col(mask))

    # last content char of its line: next non-content or row end.
    last_content = content & ~_shift_l(content, False)

    n_newlines = _sum32(is_nl)
    lengths = _sum32(mask)
    pos = _iota(cps.shape[1], cps.device)
    last_char_nl = ((pos == lengths[:, None] - 1) & is_nl).any(dim=1)
    n_lines = torch.where(
        lengths == 0, 0, n_newlines + torch.where(last_char_nl, 0, 1)
    ).to(_I32)
    return LineInfo(line_id, line_start, content, is_nl, n_lines, last_content)


def _line_reset(li: LineInfo, mask: torch.Tensor) -> torch.Tensor:
    """Scan-reset mask starting a fresh segment at each line's first char."""
    return _first_col(mask) | _shift_r(li.is_nl, False)


def _first_nonws_in_line(nonws, li: LineInfo, mask) -> torch.Tensor:
    cnt = seg_scan_add(nonws.to(_I32), _line_reset(li, mask))
    return nonws & (cnt == 1)


def _last_nonws_in_line(nonws, li: LineInfo, mask) -> torch.Tensor:
    r_reset = _first_col(mask) | _shift_r(rev(li.is_nl), False)
    cnt_r = seg_scan_add(rev(nonws).to(_I32), r_reset)
    return rev(rev(nonws) & (cnt_r == 1))


# --- Duplicate counting over (hash, bytes) tables ----------------------------


def _sort_runs_many(jobs):
    """Sort many same-shaped ``(hash, payload, valid)`` jobs in ONE
    :func:`sort2` (jobs stack along the batch axis), returning
    ``(is_real, s_hash, s_payload)`` per job.  Invalid slots are biased to
    ``INT32_MAX`` and valid hashes clamped to ``INT32_MAX - 1``, so one key
    carries validity."""
    b, m = jobs[0][0].shape
    keys, n_valid = [], []
    for h, _, v in jobs:
        keys.append(torch.where(v, torch.clamp(h, max=_I32_MAX - 1), _I32_MAX).to(_I32))
        n_valid.append(_sum32(v))
    if len(jobs) == 1:
        s_key, s_payload = sort2(keys[0].contiguous(), jobs[0][1].to(_I32).contiguous())
    else:
        s_key, s_payload = sort2(
            torch.cat(keys, dim=0).contiguous(),
            torch.cat([j[1].to(_I32) for j in jobs], dim=0).contiguous(),
        )
    iota = _iota(m, s_key.device)
    outs = []
    for i, nv in enumerate(n_valid):
        outs.append(
            (iota < nv[:, None], s_key[i * b : (i + 1) * b], s_payload[i * b : (i + 1) * b])
        )
    return outs


def _dup_counts_sorted(sorted_triple) -> Tuple[torch.Tensor, torch.Tensor]:
    """find_duplicates semantics over hashed segments: every occurrence after
    the first counts (text.rs:197-208)."""
    is_real, s_hash, s_bytes = sorted_triple
    same_prev = (
        torch.cat(
            [torch.zeros_like(is_real[:, :1]), s_hash[:, 1:] == s_hash[:, :-1]], dim=1
        )
        & is_real
    )
    dup_elems = _sum32(same_prev)
    dup_bytes = _sum32(torch.where(same_prev, s_bytes, 0))
    return dup_elems, dup_bytes


def _dup_counts(seg_hash, seg_bytes, seg_valid) -> Tuple[torch.Tensor, torch.Tensor]:
    return _dup_counts_sorted(_sort_runs_many([(seg_hash, seg_bytes, seg_valid)])[0])


def _run_starts(s_hash: torch.Tensor) -> torch.Tensor:
    """Run-start mask over a hash-sorted table (hash change or slot 0)."""
    return torch.cat(
        [torch.ones_like(s_hash[:, :1], dtype=torch.bool), s_hash[:, 1:] != s_hash[:, :-1]],
        dim=1,
    )


def _top_duplicate_sorted(sorted_triple) -> torch.Tensor:
    """find_top_duplicate semantics: bytes*count of the most frequent item,
    ties by larger contribution, 0 when nothing repeats (text.rs:211-238)."""
    is_real, s_hash, s_bytes = sorted_triple
    run_start = _run_starts(s_hash)
    run_len = seg_scan_add(torch.ones_like(s_hash), run_start)
    run_end = _shift_l(run_start, True)
    counts = torch.where(run_end & is_real, run_len, 0)
    max_count = counts.amax(dim=1, keepdim=True)
    contrib = torch.where(
        run_end & is_real & (run_len == max_count), s_bytes * run_len, 0
    )
    top = contrib.amax(dim=1)
    return torch.where(max_count[:, 0] > 1, top, 0).to(_I32)


# --- GopherQuality -----------------------------------------------------------


def gopher_quality_stats(
    st: TextStructure, stop_word_hashes: Sequence[int]
) -> Dict[str, torch.Tensor]:
    """Integer stats for GopherQualityFilter (gopher_quality.rs:69-295)."""
    cps, cls, mask = st.cps, st.cls, st.mask
    valid_end = st.unit_end & st.unit_valid
    n_words = st.n_words

    # Non-overlapping "..." count: dot-run lengths // 3 (str::matches parity).
    is_dot = (cps == ord(".")) & mask
    dot_start = is_dot & ~_shift_r(is_dot, False)

    li = line_info(cps, mask)
    ws = (cls & WS) != 0
    nonws = li.content & ~ws

    dot_run = seg_scan_add(is_dot.to(_I32), dot_start)
    leader = _first_nonws_in_line(nonws, li, mask)
    last_nonws = _last_nonws_in_line(nonws, li, mask)
    hash_count = _sum32((cps == ord("#")) & mask)
    ellipsis_uni = _sum32((cps == 0x2026) & mask)
    sum_len = _sum32(torch.where(valid_end, st.unit_len, 0))
    alpha_words = _sum32(valid_end & st.unit_alpha)
    if stop_word_hashes:
        sw = np.sort(np.array(stop_word_hashes, dtype=np.int32))
        stop_words = _sum32(valid_end & isin_sorted(st.unit_lhash, sw))
    else:
        stop_words = torch.zeros_like(n_words)

    dot_end = is_dot & ~_shift_l(is_dot, False)
    ellipsis_ascii = _sum32(torch.where(dot_end, dot_run // 3, 0))
    ellipsis_units = (ellipsis_ascii + ellipsis_uni).to(_I32)

    # Bullet lines: first non-ws char is '•' or '-' (trim_start semantics).
    is_bullet_char = (cps == 0x2022) | (cps == ord("-"))
    bullet_lines = _sum32(leader & is_bullet_char)

    # Ellipsis-ended lines: last non-ws char is '…' or closes a >=3 dot run.
    ell_line = last_nonws & ((cps == 0x2026) | (is_dot & (dot_run >= 3)))
    ellipsis_lines = _sum32(ell_line)

    return {
        "n_words": n_words,
        # All valid units contain a non-PUNCT char, so non_symbol == words.
        "n_non_symbol": n_words,
        "sum_word_len": sum_len,
        "hash_count": hash_count,
        "ellipsis_units": ellipsis_units,
        "n_lines": li.n_lines,
        "bullet_lines": bullet_lines,
        "ellipsis_lines": ellipsis_lines,
        "alpha_words": alpha_words,
        "stop_words": stop_words,
    }


# --- FineWeb -----------------------------------------------------------------


def fineweb_stats(
    st: TextStructure,
    stop_chars: Sequence[str],
    max_lines: int,
    short_line_length: int,
) -> Dict[str, torch.Tensor]:
    """Integer stats for FineWebQualityFilter (fineweb_quality.rs:71-225)."""
    cps, cls, mask = st.cps, st.cls, st.mask
    li = line_info(cps, mask)
    ws = (cls & WS) != 0
    nonws = li.content & ~ws
    reset = _line_reset(li, mask)

    # Per-line cumulative values, read at the line's last content char.
    char_cnt = seg_scan_add(li.content.to(_I32), reset)
    byte_cnt = seg_scan_add(torch.where(li.content, utf8_width(cps), 0).to(_I32), reset)
    has_nonws = seg_scan_or(nonws.to(_I32), reset)
    line_hash = _poly_hash(cps, li.content, reset)
    last_nonws = _last_nonws_in_line(nonws, li, mask)
    total_chars_no_nl = _sum32(mask & ~li.is_nl)
    newline_count = _sum32(li.is_nl)

    lc = li.last_content
    if use_sort_tables():
        # Slot j = the j-th line WITH content; no consumer reads slots
        # positionally, so this equals the scatter layout's verdicts.
        [(tpos, treal)] = _rank_positions_many([lc], max_lines)
        line_chars = _gather_table(char_cnt, tpos, treal)
        line_bytes = _gather_table(byte_cnt, tpos, treal)
        line_has_content = _gather_table(has_nonws, tpos, treal) > 0
        line_hash_t = _gather_table(line_hash, tpos, treal)
    else:
        line_chars = _scatter(char_cnt, li.line_id, lc, max_lines)
        line_bytes = _scatter(byte_cnt, li.line_id, lc, max_lines)
        line_has_content = _scatter(has_nonws, li.line_id, lc, max_lines) > 0
        line_hash_t = _scatter(line_hash, li.line_id, lc, max_lines)
    # Byte-length mixing, as in gopher_rep's tables (collision discrimination).
    line_hash_t = line_hash_t * 31 + line_bytes

    n_nonblank = _sum32(line_has_content)

    sc = np.sort(np.array([ord(c) for c in stop_chars], dtype=np.int32))
    ends_stop = _sum32(last_nonws & isin_sorted(cps, sc))

    _, dup_bytes = _dup_counts(line_hash_t, line_bytes, line_has_content)

    short_lines = _sum32(line_has_content & (line_chars <= short_line_length))

    return {
        "n_nonblank_lines": n_nonblank,
        "lines_ending_stop": ends_stop,
        "short_lines": short_lines,
        "dup_line_bytes": dup_bytes,
        "total_chars_no_newline": total_chars_no_nl,
        "n_words": st.n_words,
        "newline_count": newline_count,
        "line_overflow": li.n_lines > max_lines,
    }


# --- GopherRepetition --------------------------------------------------------


def gopher_rep_stats(
    st: TextStructure,
    top_ns: Sequence[int],
    dup_ns: Sequence[int],
    max_segs: int,
    max_words: int,
) -> Dict[str, torch.Tensor]:
    """Integer stats for GopherRepetitionFilter (gopher_rep.rs:52-219)."""
    cps, cls, mask = st.cps, st.cls, st.mask
    dev = cps.device
    ws = (cls & WS) != 0
    _, length = cps.shape
    pos = _iota(length, dev)

    # Trim bounds (gopher_rep.rs:57).
    nonws = mask & ~ws
    any_nonws = nonws.any(dim=1)
    t0 = torch.where(nonws, pos, length).amin(dim=1)
    t1 = torch.where(nonws, pos, -1).amax(dim=1)
    in_trim = (pos >= t0[:, None]) & (pos <= t1[:, None]) & mask
    trimmed_len = torch.where(any_nonws, t1 - t0 + 1, 0).to(_I32)

    is_nl = (cps == NL) & in_trim
    prev_nl = _shift_r(is_nl, False)
    at_t0 = pos == t0[:, None]

    # Line segments: split on \n+.
    l_content = in_trim & ~is_nl
    l_start = l_content & (prev_nl | at_t0)

    # Paragraph separators: \n chars inside runs of >= 2.
    nl_start = is_nl & ~prev_nl
    nl_run_end = is_nl & ~_shift_l(is_nl, False)
    widths = utf8_width(cps)

    nl_run = seg_scan_add(is_nl.to(_I32), nl_start)
    run_total = rev(
        seg_scan_max(rev(torch.where(nl_run_end, nl_run, 0).to(_I32)), rev(nl_run_end))
    )

    is_sep = is_nl & (run_total >= 2)
    p_content = in_trim & ~is_sep
    p_start = p_content & (_shift_r(is_sep, False) | at_t0)

    def seg_values(content, start):
        end = content & ~_shift_l(content, False)
        h = _poly_hash(cps, content, start)
        by = seg_scan_add(torch.where(content, widths, 0).to(_I32), start)
        n = _sum32(start)
        return end, h, by, n

    def seg_finish(tbl_h, tbl_b, n):
        # Mix the byte length into the run key (collision discrimination).
        tbl_h = tbl_h * 31 + tbl_b
        tbl_valid = _iota(max_segs, dev) < n[:, None]
        return tbl_h, tbl_b, tbl_valid, n

    l_end, l_h, l_by, n_l = seg_values(l_content, l_start)
    p_end, p_h, p_by, n_p = seg_values(p_content, p_start)
    if use_sort_tables():
        # Segments are non-empty char runs, so slot j == the j-th segment end.
        (lr, pr) = _rank_positions_many([l_end, p_end], max_segs)
        lh, lb, lv, n_l = seg_finish(_gather_table(l_h, *lr), _gather_table(l_by, *lr), n_l)
        ph, pb, pv, n_p = seg_finish(_gather_table(p_h, *pr), _gather_table(p_by, *pr), n_p)
    else:
        l_sid = torch.cumsum(l_start.to(_I32), dim=1, dtype=_I32) - 1
        p_sid = torch.cumsum(p_start.to(_I32), dim=1, dtype=_I32) - 1
        lh, lb, lv, n_l = seg_finish(
            _scatter(l_h, l_sid, l_end, max_segs), _scatter(l_by, l_sid, l_end, max_segs), n_l
        )
        ph, pb, pv, n_p = seg_finish(
            _scatter(p_h, p_sid, p_end, max_segs), _scatter(p_by, p_sid, p_end, max_segs), n_p
        )
    l_sorted, p_sorted = _sort_runs_many([(lh, lb, lv), (ph, pb, pv)])
    l_dup_elems, l_dup_bytes = _dup_counts_sorted(l_sorted)
    p_dup_elems, p_dup_bytes = _dup_counts_sorted(p_sorted)

    # Word tables for n-grams (word_idx enumerates valid ends gaplessly).
    valid_end = st.unit_end & st.unit_valid
    if use_sort_tables():
        [(wpos, wreal)] = _rank_positions_many([valid_end], max_words)
        whash = _gather_table(st.unit_hash, wpos, wreal)
        wbytes = _gather_table(st.unit_bytes, wpos, wreal)
    else:
        whash = _scatter(st.unit_hash, st.word_idx, valid_end, max_words)
        wbytes = _scatter(st.unit_bytes, st.word_idx, valid_end, max_words)
    n_words = st.n_words
    widx = _iota(max_words, dev)

    out: Dict[str, torch.Tensor] = {
        "trimmed_len": trimmed_len,
        "n_paragraphs": n_p,
        "para_dup_elems": p_dup_elems,
        "para_dup_bytes": p_dup_bytes,
        "n_lines": n_l,
        "line_dup_elems": l_dup_elems,
        "line_dup_bytes": l_dup_bytes,
        "seg_overflow": (n_l > max_segs) | (n_p > max_segs),
        "word_overflow": n_words > max_words,
    }

    ns = sorted(set(list(top_ns) + list(dup_ns)))
    grams = {}
    for n in ns:
        gh = torch.zeros_like(whash)
        gb = torch.zeros_like(wbytes)
        for k in range(n):
            gh = gh * 1000003 + _pad_cols(whash, k, 0)
            gb = gb + _pad_cols(wbytes, k, 0)
        gh = gh * 31 + gb  # byte-length mixing, as for the line/para tables
        win_valid = (widx + n) <= n_words[:, None]
        grams[n] = (gh, gb, win_valid)

    b, m = whash.shape
    idx = torch.broadcast_to(_iota(m, dev), (b, m))
    dup_sizes = sorted(set(dup_ns))
    min_dup = dup_sizes[0] if dup_sizes else None

    # Ungated jobs: every top-n job plus the SMALLEST dup-n job.  A truly
    # duplicated n-gram contains a duplicated (n-1)-gram at the same offset,
    # so "no dup min_dup-grams" implies no dup larger-n-grams either: the
    # larger-n sorts and the exact walk run only when this cheap gate fires.
    jobs, tags = [], []
    for n in ns:
        gh, gb, win_valid = grams[n]
        if n in top_ns:
            # " "-joined n-grams: byte length includes n-1 single-byte spaces.
            jobs.append((gh, gb + (n - 1), win_valid))
            tags.append(("top", n))
        if n == min_dup:
            jobs.append((gh, idx, win_valid))
            tags.append(("dup", n))

    dup_min_flags = dup_min_rid = None
    srts = _sort_runs_many(jobs) if jobs else []
    for (kind, n), srt in zip(tags, srts):
        if kind == "top":
            out[f"top_{n}"] = _top_duplicate_sorted(srt)
        else:
            dup_min_flags, dup_min_rid = _dup_run_info_sorted(srt, grams[n][2], idx)

    if dup_sizes:
        # The JAX package's lax.cond rarity gate, as one host sync.
        if bool(dup_min_flags.any()):
            walk = [(min_dup, dup_min_rid, grams[min_dup][2], grams[min_dup][1])]
            rest = dup_sizes[1:]
            if rest:
                rsrts = _sort_runs_many([(grams[n][0], idx, grams[n][2]) for n in rest])
                for n, srt in zip(rest, rsrts):
                    _, rid_n = _dup_run_info_sorted(srt, grams[n][2], idx)
                    walk.append((n, rid_n, grams[n][2], grams[n][1]))
            res = _find_all_dup_bytes_batched(walk)
            for n in dup_sizes:
                out[f"dup_{n}"] = res[f"dup_{n}"]
        else:
            for n in dup_sizes:
                out[f"dup_{n}"] = torch.zeros_like(n_words)
    return out


def _dup_run_info_sorted(sorted_triple, win_valid, idx) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(flags, run_first)`` from a ``(hash, idx)``-sorted window table:
    ``flags`` — "an earlier identical window exists" (the rarity gate);
    ``run_first`` — each window's run id (the minimum window index sharing
    its hash), the canonical slot for the walk's visited table."""
    is_real, s_hash, sidx = sorted_triple
    b, m = s_hash.shape
    run_start = _run_starts(s_hash)
    first_in_run = seg_scan_max(torch.where(run_start, sidx, -(2**30)).to(_I32), run_start)
    if use_sort_tables():
        # Un-sort by window index instead of scattering: real entries' sidx
        # values are exactly 0..n_valid-1, so sorting (sidx, first_in_run)
        # restores window order with slot j holding window j's run id.
        k0 = torch.where(is_real, sidx, _I32_MAX).to(_I32).contiguous()
        k1 = torch.where(is_real, first_in_run, 0).to(_I32).contiguous()
        first_occ = sort2(k0, k1)[1][:, :m]
    else:
        first_occ = _scatter(first_in_run, sidx, is_real, m)
    return win_valid & (first_occ < idx), first_occ


def _find_all_dup_bytes_batched(jobs) -> Dict[str, torch.Tensor]:
    """find_all_duplicate, EXACT: the oracle's greedy scan with its
    visited-set dynamics (text.rs:241-259) — ``seen`` holds only windows the
    scan actually visited, a hit counts the window's bytes and jumps ``n``,
    a miss inserts and steps 1.

    Every job ``(n, run_first, win_valid, gb)`` stacks along the batch axis
    and one loop over window positions walks all rows in lockstep (the JAX
    package's ``lax.scan``).  ``win_valid`` is a prefix mask per row, so the
    loop stops after the last window valid in any row: later steps change
    nothing.  It only runs under the rarity gate.
    """
    out: Dict[str, torch.Tensor] = {}
    if not jobs:
        return out
    b, m = jobs[0][1].shape
    dev = jobs[0][1].device
    n_vec = torch.cat([torch.full((b,), n, dtype=_I32, device=dev) for n, _, _, _ in jobs])
    rid = torch.cat([j[1] for j in jobs], dim=0).to(torch.int64)  # [kB, m]
    val = torch.cat([j[2] for j in jobs], dim=0)
    gbs = torch.cat([j[3] for j in jobs], dim=0).to(_I32)
    kb = rid.shape[0]
    rows = torch.arange(kb, dtype=torch.int64, device=dev)
    onehot_visited = use_sort_tables()
    lane = torch.arange(m, dtype=torch.int64, device=dev)[None, :]

    t_start = time.perf_counter()
    visited = torch.zeros((kb, m), dtype=_I32, device=dev)
    skip = torch.zeros(kb, dtype=_I32, device=dev)
    acc = torch.zeros(kb, dtype=_I32, device=dev)
    steps = int(val.sum(dim=1).max()) if kb else 0
    rid_t, gb_t, val_t = rid.t().contiguous(), gbs.t().contiguous(), val.t().contiguous()
    for t in range(steps):
        rid_c, gb_c, val_c = rid_t[t], gb_t[t], val_t[t]
        can = (skip == 0) & val_c
        if onehot_visited:
            oh = lane == rid_c[:, None]
            seen = torch.where(oh, visited, 0).sum(dim=1) > 0
            hit = can & seen
            visited = torch.maximum(visited, (oh & (can & ~seen)[:, None]).to(_I32))
        else:
            cur = visited[rows, rid_c]
            seen = cur > 0
            hit = can & seen
            visited[rows, rid_c] = torch.maximum(cur, (can & ~seen).to(_I32))
        acc = acc + torch.where(hit, gb_c, 0)
        skip = torch.where(hit, n_vec - 1, torch.clamp(skip - 1, min=0))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    DUP_WALK["calls"] += 1
    DUP_WALK["steps"] += steps
    DUP_WALK["seconds"] += time.perf_counter() - t_start
    for i, (n, _, _, _) in enumerate(jobs):
        out[f"dup_{n}"] = acc[i * b : (i + 1) * b]
    return out


# --- Sentence counting (device twin of split_into_sentences) -----------------

_TERM_SET = np.sort(np.array([ord(c) for c in ("." + _STERM)], dtype=np.int32))
_STERM_SET = np.sort(np.array([ord(c) for c in _STERM], dtype=np.int32))
_CLOSE_SET = np.sort(np.array([ord(c) for c in _CLOSE], dtype=np.int32))
_SP_SET = np.sort(np.array([ord(c) for c in _SP], dtype=np.int32))
_PSEP_SET = np.sort(np.array([ord(c) for c in _PARA_SEP], dtype=np.int32))

# Match DFA over symbols 0=other, 1=TERM, 2=CLOSE, 3=SP.
# States: 0 outside, 1 in terms, 2 in closes, 3 in spaces.
_SENT_T = np.zeros((4, 4), dtype=np.int32)
_SENT_T[0, :] = 0
_SENT_T[1, :] = 1
_SENT_T[2, :] = [0, 2, 2, 0]
_SENT_T[3, :] = [0, 3, 3, 3]


def sentence_boundaries(
    cps: torch.Tensor, mask: torch.Tensor, cls: torch.Tensor
) -> torch.Tensor:
    """[B, L] bool — a sentence boundary falls immediately BEFORE each True
    position (the device twin of utils.text._sentence_boundaries, applied to
    the chars selected by ``mask``)."""
    term = isin_sorted(cps, _TERM_SET) & mask
    sterm = isin_sorted(cps, _STERM_SET) & mask
    close = isin_sorted(cps, _CLOSE_SET) & mask
    sp = isin_sorted(cps, _SP_SET) & mask
    psep = isin_sorted(cps, _PSEP_SET) & mask

    sym = torch.zeros_like(cps)
    sym = torch.where(term, 1, sym)
    sym = torch.where(close & ~term, 2, sym)
    sym = torch.where(sp & ~close & ~term, 3, sym)
    state = dfa_states(sym, _SENT_T)
    prev_state = _shift_r(state, 0)

    # Match-start: a terminator not already inside a terminator run.
    match_start = term & (prev_state != 1)
    has_sterm = (
        seg_scan_or(torch.where(state > 0, sterm.to(_I32), 0).to(_I32), match_start) > 0
    )
    prev_has_sterm = _shift_r(has_sterm.to(_I32), 0) > 0
    dot_last = _shift_r((cps == ord(".")) & mask, False) & (prev_state == 1)

    lower = (cls & LOWER) != 0
    alnum_ = ((cls & ALNUM) != 0) | (cps == ord("_"))

    fresh_term = term & ((prev_state == 2) | (prev_state == 3))
    candidate = mask & (prev_state > 0) & ((state == 0) | fresh_term)

    no_break = ~prev_has_sterm & ((dot_last & alnum_) | lower)
    return (candidate & ~no_break) | (_shift_r(psep, False) & mask)


def sentence_counts(cps: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sentences per row — ``len(split_into_sentences(text))`` for rows whose
    content is already globally trimmed (C4's rewritten batches are)."""
    _, length = cps.shape
    mask = _iota(length, cps.device) < lengths[:, None]
    cls = classify(cps)
    cls = torch.where(mask, cls, torch.zeros_like(cls))
    ws = (cls & WS) != 0
    nonws = mask & ~ws

    boundary = sentence_boundaries(cps, mask, cls)
    seg_begin = boundary | _first_col(mask)
    cnt = seg_scan_add(nonws.to(_I32), seg_begin)
    return _sum32(nonws & (cnt == 1))


# --- C4 stage ----------------------------------------------------------------


class C4Params(NamedTuple):
    split_paragraph: bool
    remove_citations: bool
    filter_no_terminal_punct: bool
    min_num_sentences: int
    min_words_per_line: int
    max_word_length: int
    filter_lorem_ipsum: bool
    filter_javascript: bool
    filter_curly_bracket: bool
    filter_policy: bool


_END_PUNCT_SET = np.sort(
    np.array([ord(c) for c in (".", "!", "?", '"', "'", "”")], dtype=np.int32)
)

_POLICY = (
    "terms of use",
    "privacy policy",
    "cookie policy",
    "uses cookies",
    "use of cookies",
    "use cookies",
)


def c4_stage(
    cps: torch.Tensor,
    lengths: torch.Tensor,
    params: C4Params,
    max_lines: int,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """The C4 quality filter as a device stage (c4_filters.rs:147-295).

    Returns ``(stats, new_cps, new_lengths)``: the new batch is the rewritten
    content (kept lines joined by ``\\n``) for every row.  ``split_paragraph``
    segments on newlines; otherwise on sentence boundaries, synthesizing one
    ``\\n`` per kept-sentence join (rows whose boundary has no whitespace to
    host it set ``line_overflow`` and take the host fallback).
    """
    _, length = cps.shape
    dev = cps.device
    pos = _iota(length, dev)
    mask = pos < lengths[:, None]
    cls = classify(cps)
    cls = torch.where(mask, cls, torch.zeros_like(cls))
    ws = (cls & WS) != 0
    low = _lowered(cps, mask)

    has_curly = (((cps == ord("{")) | (cps == ord("}"))) & mask).any(dim=1)

    def _citation_deleted(unit_content):
        if not params.remove_citations:
            return torch.zeros_like(mask)
        # Citation machinery only runs on batches that contain a '[' at all
        # (the JAX package's lax.cond, as one host sync).
        if not bool(((cps == ord("[")) & mask).any()):
            return torch.zeros_like(mask)
        return citation_spans(
            torch.where(unit_content, cps, 0).to(_I32),
            ((cls & DIGIT) != 0) & unit_content,
            ws & unit_content,
        )

    gap_overflow = torch.zeros(cps.shape[0], dtype=torch.bool, device=dev)
    if params.split_paragraph:
        li = line_info(cps, mask)
        nonws = li.content & ~ws
        reset = _line_reset(li, mask)

        # Per-line trim: chars at/after the first non-ws, at/before the last.
        r_reset = _first_col(mask) | _shift_r(rev(li.is_nl), False)
        after_first = seg_scan_add(nonws.to(_I32), reset) >= 1
        before_last = rev(seg_scan_add(rev(nonws).to(_I32), r_reset) >= 1)
        in_line_trim = li.content & after_first & before_last

        deleted = _citation_deleted(li.content)
        keep1 = (in_line_trim & ~deleted) | li.is_nl
        c1_src = cps
        n_units = li.n_lines
    else:
        # Sentence mode: global trim, boundaries from the sentence DFA,
        # segments between boundaries, each trimmed.
        nonws_all = mask & ~ws
        t0 = torch.where(nonws_all, pos, length).amin(dim=1)
        t1 = torch.where(nonws_all, pos, -1).amax(dim=1)
        in_trim = (pos >= t0[:, None]) & (pos <= t1[:, None]) & mask

        nonws = in_trim & ~ws
        boundary = sentence_boundaries(cps, in_trim, cls)
        seg_begin = (boundary | (pos == t0[:, None])) & in_trim
        cnt = seg_scan_add(nonws.to(_I32), seg_begin)
        first_nonws_seg = nonws & (cnt == 1)
        n_units = _sum32(first_nonws_seg)

        seg_end = in_trim & (_shift_l(seg_begin, False) | ~_shift_l(in_trim, False))
        r_reset = _first_col(mask) | rev(seg_end)
        cnt_r = seg_scan_add(rev(nonws).to(_I32), r_reset)
        before_last = rev(cnt_r >= 1)
        in_sent_trim = in_trim & (cnt >= 1) & before_last
        sent_last_nonws = rev(rev(nonws) & (cnt_r == 1))

        # One synthesized '\n' per kept-sentence join.
        suffix_nonws = _shift_l(
            rev(torch.cumsum(rev(nonws).to(_I32), dim=1, dtype=_I32)) > 0, False
        )
        sep_keep = _shift_r(sent_last_nonws, False) & ~nonws & in_trim & suffix_nonws
        gap_overflow = (sent_last_nonws & _shift_l(nonws, False)).any(dim=1)

        deleted = _citation_deleted(in_trim)
        keep1 = (in_sent_trim & ~deleted) | sep_keep
        c1_src = torch.where(sep_keep, NL, cps).to(_I32)

    if params.filter_lorem_ipsum:
        has_lorem = _pattern_union_starts(low, mask, ("lorem ipsum",)).any(dim=1)
    else:
        has_lorem = torch.zeros(cps.shape[0], dtype=torch.bool, device=dev)

    c1_cps, c1_len = compact(c1_src, keep1)

    # --- per-line checks on the compacted batch ---
    m1 = pos < c1_len[:, None]
    st1 = structure(c1_cps, c1_len, with_hashes=False)
    li1 = line_info(c1_cps, m1)
    low1 = _lowered(c1_cps, m1)

    valid_end1 = st1.unit_end & st1.unit_valid
    is_dot1 = (c1_cps == ord(".")) & m1
    dot_start1 = is_dot1 & ~_shift_r(is_dot1, False)

    # Only the UNION of javascript/policy line flags affects line_keep.
    line_patterns: Tuple[str, ...] = ()
    if params.filter_javascript:
        line_patterns += ("javascript",)
    if params.filter_policy:
        line_patterns += _POLICY

    dot_run1 = seg_scan_add(is_dot1.to(_I32), dot_start1)
    starts = _pattern_union_starts(low1, m1, line_patterns) if line_patterns else None

    if use_sort_tables():
        # Slot j = line id j: every line present in the compacted batch has
        # exactly one representative char — its '\n', or the row's final
        # char — in line order.
        reset1 = _line_reset(li1, m1)
        row_last1 = m1 & ~_shift_l(m1, False)
        rep1 = (li1.is_nl | row_last1) & m1
        [(lpos1, lreal1)] = _rank_positions_many([rep1], max_lines)
        content_set1 = li1.content | reset1

        line_words = _gather_table(seg_scan_add(valid_end1.to(_I32), reset1), lpos1, lreal1)
        line_max_word = _gather_table(
            seg_scan_max(torch.where(valid_end1, st1.unit_len, 0).to(_I32), reset1),
            lpos1,
            lreal1,
        )
        line_last_char = _gather_table(
            latch_scan(torch.where(li1.content, c1_cps, 0).to(_I32), content_set1),
            lpos1,
            lreal1,
        )
        line_end_dots = _gather_table(
            latch_scan(torch.where(li1.content & is_dot1, dot_run1, 0).to(_I32), content_set1),
            lpos1,
            lreal1,
        )
        if starts is not None:
            bad_pattern_line = (
                _gather_table(seg_scan_or(starts.to(_I32), reset1), lpos1, lreal1) > 0
            )
        else:
            bad_pattern_line = torch.zeros_like(line_words, dtype=torch.bool)
    else:
        line_words = _scatter(
            torch.ones_like(c1_cps), li1.line_id, valid_end1, max_lines, op="add"
        )
        line_max_word = _scatter(st1.unit_len, li1.line_id, valid_end1, max_lines, op="max")
        # Terminal punctuation: last char of each (already trimmed) line.
        line_last_char = _scatter(c1_cps, li1.line_id, li1.last_content, max_lines)
        line_end_dots = _scatter(
            torch.where(is_dot1, dot_run1, 0).to(_I32), li1.line_id, li1.last_content,
            max_lines,
        )
        if starts is not None:
            bad_pattern_line = (
                _scatter(starts.to(_I32), li1.line_id, starts, max_lines, op="add") > 0
            )
        else:
            bad_pattern_line = torch.zeros_like(line_words, dtype=torch.bool)

    ends_terminal = isin_sorted(line_last_char, _END_PUNCT_SET) & (line_last_char > 0)
    ends_ellipsis = line_end_dots >= 3

    # Unit count comes from the ORIGINAL batch (a final line whose content
    # trimmed away entirely still exists as a droppable line).
    n_lines1 = n_units
    line_exists = _iota(max_lines, dev) < n_lines1[:, None]

    if params.max_word_length > 0:
        drop_too_long = line_exists & (line_max_word > params.max_word_length)
    else:
        drop_too_long = torch.zeros_like(line_exists)
    remaining = line_exists & ~drop_too_long
    if params.filter_no_terminal_punct:
        drop_no_term = remaining & ~(ends_terminal & ~ends_ellipsis)
    else:
        drop_no_term = torch.zeros_like(remaining)
    remaining = remaining & ~drop_no_term
    if params.min_words_per_line > 0:
        drop_few_words = remaining & (line_words < params.min_words_per_line)
    else:
        drop_few_words = torch.zeros_like(remaining)
    remaining = remaining & ~drop_few_words
    line_keep = remaining & ~bad_pattern_line

    # --- compact kept lines into the rewritten batch ---
    later = rev(torch.cumsum(rev(line_keep.to(_I32)), dim=1, dtype=_I32))
    keep_later = _shift_l(later, 0) > 0  # a kept line exists after slot l

    lid1 = torch.clamp(li1.line_id, max=max_lines - 1).long()
    char_line_keep = torch.gather(line_keep, 1, lid1)
    char_keep_later = torch.gather(keep_later, 1, lid1)
    keep2 = (li1.content & char_line_keep & m1) | (
        li1.is_nl & char_line_keep & char_keep_later
    )
    c2_cps, c2_len = compact(c1_cps, keep2)

    n_sent = sentence_counts(c2_cps, c2_len)

    # Rewrite-identity flag: the rewritten batch equals this stage's input.
    rewrite_identity = (c2_len == lengths) & (c2_cps == cps).all(dim=1)

    false_b = torch.zeros_like(has_lorem)
    stats = {
        "has_lorem": has_lorem if params.filter_lorem_ipsum else false_b,
        "has_curly": has_curly if params.filter_curly_bracket else false_b,
        "n_sentences": n_sent,
        "rewrite_identity": rewrite_identity,  # [B]
        "line_keep": line_keep,  # [B, ML]
        "n_lines": torch.clamp(n_lines1, max=max_lines).to(_I32),
        "drop_too_long": _sum32(drop_too_long),
        "drop_no_term": _sum32(drop_no_term),
        "drop_few_words": _sum32(drop_few_words),
        "line_overflow": (n_lines1 > max_lines) | gap_overflow,
    }
    return stats, c2_cps, c2_len
