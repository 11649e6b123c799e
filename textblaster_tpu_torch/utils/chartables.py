"""Codepoint classification tables.

The reference classifies characters with ICU4X + a custom PUNCTUATION set
(``/root/reference/src/utils/text.rs:28-57``).  Here we precompute one dense
``uint8`` bitmask table over the full Unicode range so that both the CPU oracle
(numpy) and the TPU kernels (device gather over the same table) classify
characters identically.  The table is built once per process from Python's
unicodedata-backed ``str`` predicates.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "ALNUM",
    "ALPHA",
    "DIGIT",
    "WS",
    "PUNCT",
    "LOWER",
    "UPPER",
    "EXTEND",
    "char_table",
    "classify",
    "codepoints",
    "PUNCTUATION",
    "PUNCTUATION_LIT",
]

# Bit flags
ALNUM = 1 << 0  # str.isalnum()  (ICU ALetter|Numeric approximation)
ALPHA = 1 << 1  # str.isalpha()  (char::is_alphabetic parity, gopher_quality.rs:171)
DIGIT = 1 << 2  # str.isdigit()
WS = 1 << 3  # str.isspace()  (char::is_whitespace parity)
PUNCT = 1 << 4  # membership in the reference PUNCTUATION set (text.rs:40-57)
LOWER = 1 << 5  # str.islower() (sentence segmentation SB8)
UPPER = 1 << 6  # str.isupper()
EXTEND = 1 << 7  # UAX#29 WB4 attachers: combining marks (Mn/Mc/Me) + format
#                  (Cf) chars that are not already alphanumeric — they extend
#                  the preceding word instead of breaking it (NFD text parity)

# Exactly the literal punctuation characters of the reference (text.rs:28-29).
PUNCTUATION_LIT = (
    "!/—”:％１〈&(、━\\【#%「」，】；+^]~“《„';’{|∶´[=-`*．（–？！：$～«〉,><》)?）。…@_.\"}►»"
)

# Codepoint ranges included in PUNCTUATION (text.rs:32-37): half-open [start, end).
PUNCTUATION_RANGES = ((0, 9), (11, 13), (13, 32), (127, 160))

#: The reference's global punctuation set (text.rs:40-57), as a Python frozenset.
PUNCTUATION = frozenset(PUNCTUATION_LIT) | frozenset(
    chr(cp) for start, end in PUNCTUATION_RANGES for cp in range(start, end)
)

# Table covers planes 0-3 (0x0-0x3FFFF): everything assigned an alphanumeric /
# space / punctuation property lives below this bound, EXCEPT the plane-14
# tag/variation-selector block (U+E0000-E01EF, all Mn/Cf = EXTEND), which
# ``classify`` handles with a range check so emoji tag sequences attach
# instead of shattering into symbol tokens.  Planes 4+ are otherwise
# unassigned or private-use, classifying as 0 — same as Python's str
# predicates.  Lookups clip the index, so any codepoint is safe to classify.
_MAX_CP = 0x40000
_PLANE14_LO, _PLANE14_HI = 0xE0000, 0xE0200
_TABLE: np.ndarray | None = None


def _build_table() -> np.ndarray:
    import unicodedata

    table = np.zeros(_MAX_CP, dtype=np.uint8)
    for cp in range(_MAX_CP):
        c = chr(cp)
        v = 0
        if c.isalnum():
            v |= ALNUM
        if c.isalpha():
            v |= ALPHA
        if c.isdigit():
            v |= DIGIT
        if c.isspace():
            v |= WS
        if c.islower():
            v |= LOWER
        if c.isupper():
            v |= UPPER
        # UAX#29 Format excludes ZWSP (U+200B): it BREAKS words, it does not
        # join them (WordBreak=Other).  ZWNJ/ZWJ stay attachers.
        if (
            not (v & ALNUM)
            and cp != 0x200B
            and unicodedata.category(c) in ("Mn", "Mc", "Me", "Cf")
        ):
            v |= EXTEND
        if v:
            table[cp] = v
    for ch in PUNCTUATION:
        table[ord(ch)] |= PUNCT
    return table


def char_table() -> np.ndarray:
    """Return the dense ``[0x40000] uint8`` classification table (cached)."""
    global _TABLE
    if _TABLE is None:
        _TABLE = _build_table()
    return _TABLE


def classify(cps: np.ndarray) -> np.ndarray:
    """Classify a codepoint array; indices are clipped into the table.
    Plane-14 tag/variation-selector chars classify as EXTEND by range."""
    table = char_table()
    cls = table[np.minimum(cps, _MAX_CP - 1).astype(np.int64)]
    plane14 = (cps >= _PLANE14_LO) & (cps < _PLANE14_HI)
    if plane14.any():
        cls = np.where(plane14, np.uint8(EXTEND), cls)
    return cls


def codepoints(text: str) -> np.ndarray:
    """Decode a Python string to a ``uint32`` codepoint array (no copy loops)."""
    if not text:
        return np.empty(0, dtype=np.uint32)
    return np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)
