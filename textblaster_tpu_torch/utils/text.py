"""Text primitives: segmentation + duplicate detection.

Re-implements the reference's ``src/utils/text.rs`` semantics:

* ``split_into_words`` (text.rs:103-181): ICU4X UAX#29 word segmentation with a
  punctuation-only-token rejection on top.  Here the segmentation is a
  UAX#29-lite rule set computed *vectorized over codepoint arrays* — the same
  formulation the TPU kernels use — rather than a port of ICU: a word is a
  maximal run of alphanumerics/underscore joined by UAX#29 mid-characters
  (``:``, ``·``, ``'``, ``’``, ``.`` between letters; ``,``, ``;``, ``.``,
  ``'``, ``’`` between digits), and any character that is neither part of such
  a run, whitespace, nor in the reference PUNCTUATION set counts as a
  standalone symbol word (because ICU yields it as its own segment and the
  reference's rejection loop keeps it — text.rs:139-157).
  Known divergence from ICU: CJK runs are kept whole instead of
  dictionary-segmented.

* ``split_into_sentences`` (text.rs:59-101): UAX#29-lite sentence rules:
  mandatory break after paragraph separators; break after STerm (``!?…。！？``)
  + closes + spaces; break after ATerm (``.``) + closes + spaces unless the
  next character is lowercase or the ``.`` directly abuts an alphanumeric.
  Slices are trimmed and empties dropped, exactly like the reference.

* ``get_n_grams`` / ``find_duplicates`` / ``find_top_duplicate`` /
  ``find_all_duplicate`` (text.rs:184-259): note these sum **UTF-8 byte**
  lengths, not char counts — a reference quirk that parity must reproduce
  (SURVEY.md §7 "bytes-vs-chars quirks").
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .chartables import (
    ALNUM,
    ALPHA,
    DIGIT,
    EXTEND,
    PUNCT,
    WS,
    classify,
    codepoints,
)
from .chartables import PUNCTUATION  # re-export for filters  # noqa: F401
from .. import native as _native  # C++ fast path (built at first use; numpy otherwise)


def _attach_extend(word: np.ndarray, cls: np.ndarray) -> np.ndarray:
    """UAX#29 WB4 (lite): Extend/Format chars inherit the wordness of the
    nearest preceding non-Extend char, so decomposed accents stay inside
    their word instead of shattering it (``'cafe\\u0301'`` is one word).
    Leading Extend runs keep their own (non-word) class."""
    ext = (cls & EXTEND) != 0
    if not ext.any():
        return word
    n = word.shape[0]
    idx = np.arange(n)
    src = np.maximum.accumulate(np.where(~ext, idx, -1))
    ok = ext & (src >= 0)
    out = word.copy()
    out[ok] = word[src[ok]]
    return out

__all__ = [
    "DANISH_STOP_WORDS",
    "PUNCTUATION",
    "split_into_words",
    "word_spans",
    "split_into_sentences",
    "get_n_grams",
    "find_duplicates",
    "find_top_duplicate",
    "find_all_duplicate",
]

# Danish stop words (text.rs:9-25).
DANISH_STOP_WORDS = (
    "ad", "af", "aldrig", "alle", "alt", "anden", "andet", "andre", "at", "bare", "begge",
    "blev", "blive", "bliver", "da", "de", "dem", "den", "denne", "der", "deres", "det",
    "dette", "dig", "din", "dine", "disse", "dit", "dog", "du", "efter", "ej", "eller", "en",
    "end", "ene", "eneste", "enhver", "er", "et", "far", "fem", "fik", "fire", "flere",
    "fleste", "for", "fordi", "forrige", "fra", "få", "får", "før", "god", "godt", "ham",
    "han", "hans", "har", "havde", "have", "hej", "helt", "hende", "hendes", "her", "hos",
    "hun", "hvad", "hvem", "hver", "hvilken", "hvis", "hvor", "hvordan", "hvorfor",
    "hvornår", "i", "ikke", "ind", "ingen", "intet", "ja", "jeg", "jer", "jeres", "jo",
    "kan", "kom", "komme", "kommer", "kun", "kunne", "lad", "lav", "lidt", "lige", "lille",
    "man", "mand", "mange", "med", "meget", "men", "mens", "mere", "mig", "min", "mine",
    "mit", "mod", "må", "ned", "nej", "ni", "nogen", "noget", "nogle", "nu", "ny", "nyt",
    "når", "nær", "næste", "næsten", "og", "også", "okay", "om", "op", "os", "otte", "over",
    "på", "se", "seks", "selv", "ser", "ses", "sig", "sige", "sin", "sine", "sit", "skal",
    "skulle", "som", "stor", "store", "syv", "så", "sådan", "tag", "tage", "thi", "ti",
    "til", "to", "tre", "ud", "under", "var", "ved", "vi", "vil", "ville", "vor", "vores",
    "være", "været",
)

# UAX#29 word-joining characters (lite): see module docstring.
_MID_LETTER = frozenset("\u003a\u00b7\u05f4\u2027\ufe13\ufe55\uff1a")
_MID_NUM = frozenset("\u002c\u003b\u037e\u0589\u066c\ufe10\ufe14\uff0c\uff1b")
_MID_NUM_LET = frozenset("\u002e\u0027\u2019\u2024\ufe52\uff07\uff0e")

_MID_ALL = _MID_LETTER | _MID_NUM | _MID_NUM_LET
_MID_CP = np.array(sorted(ord(c) for c in _MID_ALL), dtype=np.uint32)
_MID_LETTER_CP = np.array(sorted(ord(c) for c in (_MID_LETTER | _MID_NUM_LET)), dtype=np.uint32)
_MID_NUM_CP = np.array(sorted(ord(c) for c in (_MID_NUM | _MID_NUM_LET)), dtype=np.uint32)


def _word_mask(cps: np.ndarray, cls: np.ndarray) -> np.ndarray:
    """Boolean in-word mask over a codepoint array (vectorized UAX#29-lite)."""
    n = cps.shape[0]
    word = ((cls & ALNUM) != 0) | (cps == ord("_"))
    if n < 3:
        return _attach_extend(word, cls)
    # A mid character joins two word characters when flanked by the right class.
    mid = np.isin(cps, _MID_CP)
    if mid.any():
        prev_cls = cls[:-2]
        next_cls = cls[2:]
        inner = mid[1:-1]
        letter_ok = (
            np.isin(cps[1:-1], _MID_LETTER_CP)
            & ((prev_cls & ALPHA) != 0)
            & ((next_cls & ALPHA) != 0)
        )
        num_ok = (
            np.isin(cps[1:-1], _MID_NUM_CP)
            & ((prev_cls & DIGIT) != 0)
            & ((next_cls & DIGIT) != 0)
        )
        joined = inner & (letter_ok | num_ok)
        word[1:-1] |= joined
    return _attach_extend(word, cls)


def word_spans(text: str, cjk_dict: bool = True) -> List[Tuple[int, int]]:
    """(start, end) codepoint spans of the word segments of ``text``.

    The segments returned correspond 1:1 to ``split_into_words(text)``.
    Dispatches to the native C++ core when available (identical semantics,
    asserted by tests/test_torch_native.py); this numpy path is the source
    of truth.

    ``cjk_dict`` (default on — the oracle semantics) re-segments runs in
    dictionary scripts: script-transition breaks plus greedy longest-match
    over a Han lexicon (:mod:`textblaster_tpu.utils.cjk`), approximating the
    reference's ICU dictionary segmentation (text.rs:107).  ``False`` keeps
    such runs whole — the device kernels' twin semantics (documents with
    dictionary scripts are routed to the host oracle by the device pipeline,
    so the kernels never see them).
    """
    if not text:
        return []
    spans = _word_spans_raw(text)
    if cjk_dict:
        from .cjk import DICT_SCRIPT_RE, segment_span

        if DICT_SCRIPT_RE.search(text) is not None:
            resplit: List[Tuple[int, int]] = []
            for s, e in spans:
                if DICT_SCRIPT_RE.search(text, s, e) is not None:
                    resplit.extend(segment_span(text, s, e))
                else:
                    resplit.append((s, e))
            spans = resplit
    return spans


def _word_spans_raw(text: str) -> List[Tuple[int, int]]:
    cps = codepoints(text)
    cls = classify(cps)
    spans = _native.word_spans_native(cps.astype(np.int32), cls)
    if spans is not None:
        return [(int(s), int(e)) for s, e in spans]
    in_word = _word_mask(cps, cls)
    n = cps.shape[0]

    padded = np.zeros(n + 2, dtype=bool)
    padded[1:-1] = in_word
    starts = np.flatnonzero(padded[1:-1] & ~padded[:-2])
    ends = np.flatnonzero(padded[1:-1] & ~padded[2:]) + 1

    # The reference rejects any segment whose every char is in PUNCTUATION
    # (text.rs:139-157) — e.g. a lone "_" or "１" run must not count as a word.
    non_punct = ((cls & PUNCT) == 0).astype(np.int64)
    cum = np.concatenate(([0], np.cumsum(non_punct)))
    keep = (cum[ends] - cum[starts]) > 0

    # Standalone symbol "words": not in a run, not whitespace, not reference
    # punctuation (ICU yields isolated symbols as their own segments and the
    # rejection loop keeps them).  ZWSP is WordBreak=Other AND not word-like
    # in ICU, so it produces no token at all; a trailing Extend/Format run
    # attaches to the symbol (WB4 — e.g. emoji tag sequences stay one token).
    ext = (cls & EXTEND) != 0
    sym = ~in_word & ((cls & WS) == 0) & ((cls & PUNCT) == 0)
    sym &= cps != 0x200B
    sym &= ~ext  # bare Extend after ws/punct: no token (its segment would be
    #              punctuation-only / rejected in ICU terms)
    sym_pos = np.flatnonzero(sym)

    # End of each symbol token: swallow the following Extend run.
    ext_pad = np.zeros(n + 1, dtype=bool)
    ext_pad[:-1] = ext
    nonext_idx = np.arange(n + 1)
    # next non-extend position at-or-after i (scan from the right)
    nxt = np.minimum.accumulate(
        np.where(~ext_pad, nonext_idx, n)[::-1]
    )[::-1]

    spans = [(int(s), int(e)) for s, e, k in zip(starts, ends, keep) if k]
    spans.extend((int(p), int(nxt[p + 1])) for p in sym_pos)
    spans.sort()
    return spans


def split_into_words(text: str, cjk_dict: bool = True) -> List[str]:
    """Word list with reference semantics (text.rs:103-181), including the
    dictionary-script approximation of ICU's CJK segmentation (see
    :func:`word_spans`)."""
    return [text[s:e] for s, e in word_spans(text, cjk_dict=cjk_dict)]


# Sentence segmentation -------------------------------------------------------

# Mandatory paragraph/line separators (UAX#29 SB4).
_PARA_SEP = "\n\r\x85\u2028\u2029"
# STerm-lite: unconditional sentence terminators.
_STERM = "!?\u2026\u3002\uff01\uff1f\uff61"
# Close-lite: characters that attach to the preceding sentence.
_CLOSE = ")]}\"'\u201d\u2019\u00bb\u300d\u300f\u3011\u3009\u300b\uff09"
# Sp-lite: spaces that may follow the terminator before the break.
_SP = " \t\u00a0\u2000\u2001\u2002\u2003\u2004\u2005\u2006\u2007\u2008\u2009\u200a\u202f\u205f\u3000"

_TERM = "." + _STERM


def _cc(chars: str) -> str:
    """Build a regex character class from a literal character set."""
    return "[" + "".join(re.escape(c) for c in chars) + "]"


_SENT_RE = re.compile(
    "(?:\r\n|" + _cc(_PARA_SEP) + ")"  # mandatory break, or:
    "|(?:" + _cc(_TERM) + "+"  # terminator run
    + _cc(_CLOSE) + "*"  # closers
    + _cc(_SP) + "*)"  # trailing spaces
)


def _sentence_boundaries(text: str) -> List[int]:
    """Byte-free (codepoint index) sentence boundaries, UAX#29-lite."""
    bounds: List[int] = []
    n = len(text)
    for m in _SENT_RE.finditer(text):
        end = m.end()
        if end >= n:
            break
        g = m.group(0)
        first = g[0]
        if first in _PARA_SEP:
            bounds.append(end)
            continue
        nxt = text[end]
        if "." in g and not any(c in _STERM for c in g):
            # ATerm-only runs: SB6/SB7 — no break when the period directly
            # abuts an alphanumeric ("3.5", "e.g.x"); SB8 — no break before
            # a lowercase continuation.
            if g[-1] == "." and (nxt.isalnum() or nxt == "_"):
                continue
            if nxt.islower():
                continue
        bounds.append(end)
    return bounds


def split_into_sentences(text: str) -> List[str]:
    """Sentence list with reference semantics (text.rs:59-101).

    Trims the input first, slices between boundaries, trims each slice and
    drops empties — mirroring text.rs:62-100.
    """
    trimmed = text.strip()
    if not trimmed:
        return []
    bounds = _sentence_boundaries(trimmed)
    out: List[str] = []
    prev = 0
    for b in bounds + [len(trimmed)]:
        if b > prev:
            s = trimmed[prev:b].strip()
            if s:
                out.append(s)
        prev = b
    if not out:
        return [trimmed]
    return out


# N-gram / duplicate helpers --------------------------------------------------


def get_n_grams(words: Sequence[str], n: int) -> List[str]:
    """All contiguous n-grams joined by spaces (text.rs:184-194)."""
    if n <= 0 or n > len(words):
        return []
    return [" ".join(words[i : i + n]) for i in range(len(words) - n + 1)]


def _byte_len(s: str) -> int:
    return len(s.encode("utf-8"))


def find_duplicates(items: Sequence[str]) -> Tuple[int, int]:
    """(duplicate element count, total UTF-8 byte length of duplicates)
    (text.rs:197-208 — ``elem.len()`` is a byte length in Rust)."""
    seen = set()
    dup_elems = 0
    dup_bytes = 0
    for elem in items:
        if elem in seen:
            dup_elems += 1
            dup_bytes += _byte_len(elem)
        else:
            seen.add(elem)
    return dup_elems, dup_bytes


def find_top_duplicate(items: Sequence[str]) -> int:
    """Byte length x count of the most frequent item; ties broken by the
    larger byte contribution (text.rs:211-238).  0 when nothing repeats."""
    if not items:
        return 0
    counter: Dict[str, int] = {}
    for elem in items:
        counter[elem] = counter.get(elem, 0) + 1
    max_count = max(counter.values())
    if max_count <= 1:
        return 0
    return max(
        _byte_len(gram) * max_count for gram, c in counter.items() if c == max_count
    )


def ngram_dup_stats(
    text: str, top_ns: Sequence[int], dup_ns: Sequence[int]
) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Batch n-gram duplicate statistics for one text.

    Returns ``(top, dup)`` where ``top[n]`` = ``find_top_duplicate`` of the
    space-joined n-grams and ``dup[n]`` = ``find_all_duplicate`` byte sums —
    the quantities GopherRepetition thresholds (gopher_rep.rs:163-196).
    Computed by the native core over one shared segmentation when available,
    else via the Python primitives.
    """
    from .cjk import DICT_SCRIPT_RE

    # The native core segments run-whole; texts with dictionary scripts take
    # the Python path so their word lists include the CJK re-segmentation.
    if DICT_SCRIPT_RE.search(text) is None and _native.available():
        cps = codepoints(text).astype(np.int32)
        cls = classify(cps.astype(np.uint32))
        spans = _native.word_spans_native(cps, cls)
        if spans is not None:
            top = {n: _native.top_ngram_bytes(cps, spans, n) for n in top_ns}
            dup = {n: _native.dup_ngram_bytes(cps, spans, n) for n in dup_ns}
            return top, dup
    words = split_into_words(text)
    top = {n: find_top_duplicate(get_n_grams(words, n)) for n in top_ns}
    dup = {n: find_all_duplicate(words, n) for n in dup_ns}
    return top, dup


def find_all_duplicate(words: Sequence[str], n: int) -> int:
    """Total byte length of non-overlapping repeated n-grams, advancing by n on
    a duplicate hit and by 1 otherwise (text.rs:241-259).  N-grams here are the
    words concatenated *without* separators (text.rs:250)."""
    if n <= 0 or len(words) < n:
        return 0
    seen = set()
    repeated_bytes = 0
    idx = 0
    n_words = len(words)
    while idx + n <= n_words:
        gram = "".join(words[idx : idx + n])
        if gram in seen:
            repeated_bytes += _byte_len(gram)
            idx += n
        else:
            seen.add(gram)
            idx += 1
    return repeated_bytes
