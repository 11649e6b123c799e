"""C4 bad-words matching on the device: the decision, not just a prefilter.

The port's counterpart of ``textblaster_tpu/ops/badwords.py``, under the
same names.  The reference scans every document with one case-insensitive
alternation regex per language (c4_filters.rs:431-447).  The device twin is
a **parallel window test**: two prefix polynomial hashes over the lowercased
row (independent multipliers 31 and :data:`MUL2`), then for each distinct
pattern length an O(1) double window hash (prefix difference) looked up in
the per-length (h1, h2)-keyed pattern table, plus word-boundary masks for
non-CJK languages (c4_filters.rs:433-439: CJK patterns get no ``\\W``
anchors).

The two prefix hashes are the hand kernel's work: two ``affine_scan``
launches with one accumulator each (``csrc/scan.cu`` through
:func:`.stats._poly_hash`), one per multiplier, as the JAX package's
``_poly_hash`` reaches its Pallas kernel twice.  The multipliers differ, so
the two cannot share one two-accumulator launch.  The window arithmetic,
the table search and the reductions are plain PyTorch, as they are plain
XLA in the JAX package.

Exactness: a true regex match always hits (the hashes are computed from the
same code points the pattern hashes used; the boundary classes mirror
``\\w`` through the shared char table).  A spurious hit needs a collision
in two independent 32-bit hashes at once, ~2^-64 per (window, pattern)
pair, so the host trusts the device verdict: non-matching documents never
touch the host regex, and matching documents only draw the seeded keep
fraction.  Every hash wraps as int32 (the kernel computes in uint32, the
eager window arithmetic in int32 tensors), bit for bit the JAX package's.

Case folding: ``re.IGNORECASE`` equates a few code point pairs that
single-char lowercasing cannot (``ſ``/``s``, ``ı``/``i``, ``µ``/``μ``, ...),
and a few code points have multi-char lowers (``İ``) that the char -> char
table maps to themselves.  Pattern lists holding a code point whose fold
partner is common text disqualify their device tables
(``BadwordTables.build`` -> None -> host regex), and rows holding a rare
partner (``hazard_cps``) are flagged per row and re-decided by the host
regex.  Both sets come from the running interpreter's own folding tables.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import ALNUM, classify, lowered
from .stats import _first_col, _pad_cols, _poly_hash, _shift_l, _shift_r, _to_i32

__all__ = [
    "BadwordTables",
    "badwords_matches",
    "badwords_matches_multi",
    "MAX_PATTERN_CPS",
]

#: Patterns longer than this (in code points) disqualify device execution;
#: real LDNOOBW entries are far shorter.
MAX_PATTERN_CPS = 48

#: Second, independent window-hash multiplier (odd, so invertible mod 2^32).
MUL2 = 1000003

# re.IGNORECASE's extra single-char equivalences beyond str.lower (CPython
# sre; taken from the interpreter when it exposes them, so that the set
# tracks the oracle's behaviour, with the CPython 3.12 table as fallback).
_EQUIV_FALLBACK = (
    (0x69, 0x131),            # i, dotless i
    (0x73, 0x17F),            # s, long s
    (0xB5, 0x3BC),            # micro sign, greek mu
    (0x345, 0x3B9, 0x1FBE),   # ypogegrammeni, iota, prosgegrammeni
    (0x390, 0x1FD3),          # iota dialytika+tonos / +oxia
    (0x3B0, 0x1FE3),          # upsilon dialytika+tonos / +oxia
    (0x3B2, 0x3D0),           # beta / beta symbol
    (0x3B5, 0x3F5),           # epsilon / lunate epsilon
    (0x3B8, 0x3D1),           # theta / theta symbol
    (0x3BA, 0x3F0),           # kappa / kappa symbol
    (0x3C0, 0x3D6),           # pi / omega pi
    (0x3C1, 0x3F1),           # rho / rho symbol
    (0x3C2, 0x3C3),           # final sigma / sigma
    (0x3C6, 0x3D5),           # phi / phi symbol
    (0x432, 0x1C80),          # cyrillic ve / rounded ve
    (0x434, 0x1C81),          # cyrillic de / long-legged de
    (0x43E, 0x1C82),          # cyrillic o / narrow o
    (0x441, 0x1C83),          # cyrillic es / wide es
    (0x442, 0x1C84, 0x1C85),  # cyrillic te / tall te / three-legged te
    (0x44A, 0x1C86),          # cyrillic hard sign / tall hard sign
    (0x463, 0x1C87),          # cyrillic yat / tall yat
    (0x1C88, 0xA64B),         # cyrillic unblended uk / monograph uk
    (0x1E61, 0x1E9B),         # s with dot above / long s with dot above
    (0xFB05, 0xFB06),         # latin small ligature st variants
)


def _equivalence_classes():
    # 3.12+: re._casefix._EXTRA_CASES (cp -> equivalent lowered cps).
    # Older: the _equivalences tuple of the sre compiler.  Both are the
    # tables the running re module matches with.
    try:
        from re import _casefix  # type: ignore[attr-defined]

        return tuple(
            (k, *v) for k, v in sorted(_casefix._EXTRA_CASES.items())
        )
    except Exception:  # noqa: BLE001
        pass
    try:
        from re._compiler import _equivalences  # type: ignore[attr-defined]

        return tuple(_equivalences)
    except Exception:  # noqa: BLE001
        try:
            from sre_compile import _equivalences  # type: ignore[attr-defined]

            return tuple(_equivalences)
        except Exception:  # noqa: BLE001
            return _EQUIV_FALLBACK


def _table_lower(cp: int) -> int:
    """The device lower table's mapping (identity for multi-char lowers)."""
    low = chr(cp).lower()
    return ord(low) if len(low) == 1 else cp


@lru_cache(maxsize=1)
def _fold_partners() -> Tuple[Dict[int, Tuple[int, ...]], frozenset]:
    """(partner map in table-lower space, the "common" code points).

    The device lowers text through the char -> char table
    (:func:`.device.lowered`); ``re.IGNORECASE`` lowers both sides and
    applies the sre equivalence classes.  A device miss therefore needs a
    *pair*: a pattern code point and a text code point that the regex folds
    together but the table lowers differently.  ``partners[x]`` lists the
    table-lower-space code points the regex equates with ``x`` despite
    distinct table lowers, from the equivalence classes and the
    multi-char-lower code points (``İ`` is a table identity but regex-equal
    to ``i``).

    "Common" code points are ASCII or have an uppercase pre-image under
    single-char lower (``σ`` <- ``Σ``); flagging their rows would forfeit
    the fast path for ordinary text, so a pattern whose partner is common
    disqualifies its whole list instead.  Rare partners (``ſ``, ``ı``,
    ``İ``, the historic Cyrillic letterforms) are flagged per row
    (``BadwordTables.hazard_cps``).
    """
    from ..utils import chartables as ct

    max_cp = ct._MAX_CP
    partners: Dict[int, set] = {}

    def _link(a: int, b: int) -> None:
        la, lb = _table_lower(a), _table_lower(b)
        if la != lb and la < max_cp and lb < max_cp:
            partners.setdefault(la, set()).add(lb)
            partners.setdefault(lb, set()).add(la)

    for cls in _equivalence_classes():
        for i, a in enumerate(cls):
            for b in cls[i + 1 :]:
                _link(a, b)
    # Multi-char lowers: the regex folds them by simple per-char tolower
    # (the first char of the full lower); the table keeps them as they are.
    for cp in range(max_cp):
        low = chr(cp).lower()
        if len(low) != 1:
            _link(cp, ord(low[0]))

    # Common = ASCII, or some *other* code point single-char-lowers to it.
    has_preimage = np.zeros(max_cp, dtype=bool)
    for cp in range(max_cp):
        lcp = _table_lower(cp)
        if lcp != cp and lcp < max_cp:
            has_preimage[lcp] = True
    # Greek final sigma ς (U+03C2) has no uppercase pre-image, but it ends
    # nearly every Greek word: flagging it would re-decide almost every
    # Greek row on the host, so it counts as common (the σ-holding list
    # falls back to the host whole).
    common = frozenset(
        x
        for x in {p for v in partners.values() for p in v} | set(partners)
        if x < 0x80 or has_preimage[x] or x == 0x3C2
    )
    return (
        {k: tuple(sorted(v)) for k, v in partners.items()},
        common,
    )


def _hash_cps(cps: Sequence[int], mul: int) -> int:
    """Host twin of the device window hash (int32 wraparound)."""
    h = 0
    for c in cps:
        h = (h * mul + c) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


def _pow_i32(mul: int, n: int) -> int:
    return _to_i32(pow(mul, n, 1 << 32))


class BadwordTables(NamedTuple):
    """Per-length (h1, h2)-keyed pattern tables for one language's list."""

    lengths: Tuple[int, ...]
    tables1: Tuple[np.ndarray, ...]  # int32 h1, sorted, one per length
    tables2: Tuple[np.ndarray, ...]  # int32 h2, aligned with tables1
    max_dup: int  # most patterns sharing one h1 within a length
    check_boundaries: bool  # False for CJK languages (ja/th/zh)
    #: Table-lower-space code points whose presence in a TEXT row voids the
    #: device verdict for this list (see _fold_partners).
    hazard_cps: Tuple[int, ...] = ()

    @classmethod
    def build(
        cls, words: Sequence[str], check_boundaries: bool
    ) -> Optional["BadwordTables"]:
        """None if any pattern is empty or too long, holds a code point whose
        lowercase is multi-char (the hash length would diverge from the
        table's), or fold-diverges against a *common* text code point (the
        caller falls back to the host)."""
        partners, fold_common = _fold_partners()
        hazard: set = set()
        by_len: Dict[int, List[Tuple[int, int]]] = {}
        for w in words:
            if any(len(c.lower()) != 1 for c in w):
                return None
            for c in w.lower():
                for p in partners.get(_table_lower(ord(c)), ()):
                    if p in fold_common:
                        return None
                    hazard.add(p)
            cps = [ord(c) for c in w.lower()]
            if not cps or len(cps) > MAX_PATTERN_CPS:
                return None
            by_len.setdefault(len(cps), []).append(
                (_hash_cps(cps, 31), _hash_cps(cps, MUL2))
            )
        if not by_len:
            return None
        lengths = tuple(sorted(by_len))
        t1s, t2s = [], []
        max_dup = 1
        for n in lengths:
            pairs = sorted(set(by_len[n]))
            h1 = np.array([p[0] for p in pairs], dtype=np.int32)
            h2 = np.array([p[1] for p in pairs], dtype=np.int32)
            _, counts = np.unique(h1, return_counts=True)
            max_dup = max(max_dup, int(counts.max()))
            t1s.append(h1)
            t2s.append(h2)
        return cls(
            lengths=lengths,
            tables1=tuple(t1s),
            tables2=tuple(t2s),
            max_dup=max_dup,
            check_boundaries=check_boundaries,
            hazard_cps=tuple(sorted(hazard)),
        )


#: Device copies of the tables: ``(id(tables), device) -> (tables, [(t1,
#: t2), ...])``.  The entry holds the tables themselves, so the id is not
#: reused while the entry lives; each table is uploaded once per device.
_DEVICE_TABLES: "OrderedDict[Tuple[int, str], tuple]" = OrderedDict()
_DEVICE_TABLES_MAX = 32
_DEVICE_TABLES_LOCK = threading.Lock()


def _tables_on(tables: BadwordTables, device: torch.device):
    key = (id(tables), str(device))
    with _DEVICE_TABLES_LOCK:
        hit = _DEVICE_TABLES.get(key)
        if hit is not None and hit[0] is tables:
            _DEVICE_TABLES.move_to_end(key)
            return hit[1]
    pairs = [
        (torch.from_numpy(t1).to(device), torch.from_numpy(t2).to(device))
        for t1, t2 in zip(tables.tables1, tables.tables2)
    ]
    with _DEVICE_TABLES_LOCK:
        _DEVICE_TABLES[key] = (tables, pairs)
        _DEVICE_TABLES.move_to_end(key)
        while len(_DEVICE_TABLES) > _DEVICE_TABLES_MAX:
            _DEVICE_TABLES.popitem(last=False)
    return pairs


def _isin2(w1, w2, t1, t2, max_dup: int):
    """Membership of (w1, w2) pairs in the aligned (t1-sorted) pair table:
    the left insertion point of ``w1`` (``jnp.searchsorted``'s default
    side), then ``max_dup`` probes past it, clamped to the last entry."""
    m = t1.shape[0]
    idx = torch.searchsorted(t1, w1)
    hit = torch.zeros(w1.shape, dtype=torch.bool, device=w1.device)
    for k in range(max_dup):
        j = torch.clamp(idx + k, max=m - 1)
        hit = hit | ((t1[j] == w1) & (t2[j] == w2))
    return hit


def _window_context(cps: torch.Tensor, lengths: torch.Tensor) -> dict:
    """Per-row scans shared by every language's table test: lowercased
    chars, both prefix hashes (two ``affine_scan`` launches) and the ``\\w``
    boundary masks."""
    cps = cps.to(torch.int32)  # the u16 wire, widened before the gather
    lengths = lengths.to(torch.int32)
    _, length = cps.shape
    pos = torch.arange(length, dtype=torch.int32, device=cps.device)[None, :]
    mask = pos < lengths[:, None]

    low = torch.where(mask, lowered(cps), 0)

    first = _first_col(mask)
    h1 = _poly_hash(low, mask, first)
    h2 = _poly_hash(low, mask, first, mul=MUL2)

    wordch = ((classify(low) & ALNUM) != 0) | (low == ord("_"))
    return {
        "low": low,
        "mask": mask,
        "pos": pos,
        "lengths": lengths,
        "h1": h1,
        "h2": h2,
        "h1_prev": _shift_r(h1, 0),  # hash(low[0..i)) at position i
        "h2_prev": _shift_r(h2, 0),
        "nonword_before": ~_shift_r(wordch, False),  # row start => boundary
        "after_pad": _shift_l(wordch, False),
        "n_rows": cps.shape[0],
        "length": length,
    }


def _match_with_context(ctx: dict, tables: BadwordTables) -> torch.Tensor:
    pos, lengths, length = ctx["pos"], ctx["lengths"], ctx["length"]
    match = torch.zeros(ctx["n_rows"], dtype=torch.bool, device=pos.device)
    dev_tables = _tables_on(tables, pos.device)
    for n, (t1, t2) in zip(tables.lengths, dev_tables):
        if n > length:
            continue
        # Window [i, i+n): hash = h[i+n-1] - h[i-1] * mul^n  (int32 wrap).
        w1 = _pad_cols(ctx["h1"], n - 1, 0) - ctx["h1_prev"] * _pow_i32(31, n)
        w2 = _pad_cols(ctx["h2"], n - 1, 0) - ctx["h2_prev"] * _pow_i32(MUL2, n)
        ok = (pos + n) <= lengths[:, None]
        hit = _isin2(w1, w2, t1, t2, tables.max_dup) & ok
        if tables.check_boundaries:
            # Char after the window: position i+n (row end => boundary).
            after_word = _pad_cols(ctx["after_pad"], n - 1, False) & (
                (pos + n) < lengths[:, None]
            )
            hit = hit & ctx["nonword_before"] & ~after_word
        match = match | hit.any(dim=1)
    return match


def _hazard_rows(ctx: dict, hazard_cps) -> torch.Tensor:
    """``[B] bool``: rows holding any of the (few) hazard code points, in
    table-lower space; all False for an empty hazard set."""
    hz = torch.zeros(ctx["n_rows"], dtype=torch.bool, device=ctx["low"].device)
    for cp in hazard_cps:
        hz = hz | ((ctx["low"] == cp) & ctx["mask"]).any(dim=1)
    return hz


def badwords_matches(
    cps: torch.Tensor, lengths: torch.Tensor, tables: BadwordTables
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``([B] bool match, [B] bool fold_hazard)`` per document.

    The match verdict equals the reference regex's on every row whose
    hazard flag is False (module docstring: the 2^-64 collision caveat).
    Hazard rows hold a code point that IGNORECASE folds into a pattern code
    point and the char -> char lower table cannot: the caller re-decides
    them with the host regex."""
    ctx = _window_context(cps, lengths)
    return _match_with_context(ctx, tables), _hazard_rows(ctx, tables.hazard_cps)


def badwords_matches_multi(
    cps: torch.Tensor, lengths: torch.Tensor, tables_by_lang: dict
) -> Tuple[dict, dict]:
    """(per-language match verdicts, per-language ``[B] bool`` hazard rows).

    Several languages' tables share the two hash scans; the per-language
    window tests are cheap.  Hazards are per language: a row is re-decided
    on the host only against a list whose patterns fold into its code
    points.  Identical hazard sets share one computed array (every Latin
    list hazards {ſ, ı, İ})."""
    ctx = _window_context(cps, lengths)
    per_lang = {
        lang: _match_with_context(ctx, tables)
        for lang, tables in sorted(tables_by_lang.items())
    }
    by_set: Dict[Tuple[int, ...], torch.Tensor] = {}
    hazards = {}
    for lang, tables in sorted(tables_by_lang.items()):
        key = tuple(tables.hazard_cps)
        if key not in by_set:
            by_set[key] = _hazard_rows(ctx, key)
        hazards[lang] = by_set[key]
    return per_lang, hazards
