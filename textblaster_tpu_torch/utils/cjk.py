"""Dictionary-lite CJK word segmentation (VERDICT r4 item 8).

The reference's ``WordSegmenter::new_auto()``
(``/root/reference/src/utils/text.rs:107``) dictionary-segments Han/kana and
Thai runs; the UAX#29-lite splitter here previously kept such runs whole, so
every word-count-driven decision (Gopher/C4/FineWeb) diverged on CJK text.
This module closes the zh side with a real frequency lexicon and bounds the
rest:

* **Script boundaries** (Han↔Hiragana↔Katakana↔Latin…) are always breaks —
  ICU's CJ dictionary never emits a token spanning scripts.
* **Han runs** are greedy-longest-match segmented against a lexicon derived
  from the ``jieba`` package's ``dict.txt`` (≈350k entries with corpus
  frequencies; jieba ships in this image — no network).  Out-of-lexicon
  characters become single-char tokens, like ICU's fallback.  Greedy
  longest-match is chosen over jieba's own max-probability DP because it is
  deterministic, lexicon-only, and exactly reproducible by the device's
  window-hash machinery later; its boundary agreement with the DP is
  measured in ``tests/test_cjk_segmentation.py``.
* **Kana and Thai runs** stay whole within their script (no ja/th lexicon
  exists offline) — the remaining, now-isolated divergence vs ICU.

Documents containing these scripts are routed to the host oracle by the
device pipeline (``ops/pipeline.py``): word-table kernels never see
dictionary-segmented text, so host/device decision parity stays exact while
the host oracle moves closer to the reference's ICU semantics.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, List, Sequence, Set, Tuple

__all__ = [
    "DICT_SCRIPT_RE",
    "has_astral",
    "has_dict_script",
    "segment_span",
    "zh_lexicon",
]

# Supplementary-plane codepoints (emoji, rare CJK extensions, historic
# scripts).  Not a CJK concern per se, but the same routing machinery uses
# it: the device wire format is uint16 on accelerators
# (ops/pipeline.py), so astral rows take the host oracle.
_ASTRAL_RE = re.compile("[\U00010000-\U0010FFFF]")


def has_astral(text: str) -> bool:
    """True if any char of ``text`` is outside the BMP."""
    return _ASTRAL_RE.search(text) is not None

# Scripts ICU segments by dictionary: Han (+ext A, compat), Hiragana,
# Katakana (+phonetic ext), Thai.  (Lao/Khmer/Myanmar are also dictionary
# scripts in ICU; they are included in the routing class so their documents
# reach the host oracle, which keeps their runs whole — divergence for them
# is documented, not silent.)
_DICT_RANGES = (
    (0x0E00, 0x0E7F),   # Thai
    (0x0E80, 0x0EFF),   # Lao
    (0x1000, 0x109F),   # Myanmar
    (0x1780, 0x17FF),   # Khmer
    (0x3040, 0x309F),   # Hiragana
    (0x30A0, 0x30FF),   # Katakana
    (0x31F0, 0x31FF),   # Katakana phonetic extensions
    (0x3400, 0x4DBF),   # CJK ext A
    (0x4E00, 0x9FFF),   # CJK unified
    (0xF900, 0xFAFF),   # CJK compatibility
)

DICT_SCRIPT_RE = re.compile(
    "[" + "".join(f"{chr(lo)}-{chr(hi)}" for lo, hi in _DICT_RANGES) + "]"
)

_HAN = ((0x3400, 0x4DBF), (0x4E00, 0x9FFF), (0xF900, 0xFAFF))

#: Longest lexicon entry used for matching (chars).  99.9% of jieba's Han
#: entries are <=4 chars; capping keeps the device window-table design
#: (one hash table per length) small.
MAX_WORD = 4


def has_dict_script(text: str) -> bool:
    """True if any char of ``text`` is in a dictionary-segmented script."""
    return DICT_SCRIPT_RE.search(text) is not None


def _is_han(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _HAN)


def _script_key(cp: int) -> int:
    """Coarse script id used for mandatory boundaries inside an alnum run."""
    if _is_han(cp):
        return 1
    if 0x3040 <= cp <= 0x309F:
        return 2  # hiragana
    if 0x30A0 <= cp <= 0x30FF or 0x31F0 <= cp <= 0x31FF:
        return 3  # katakana
    if 0x0E00 <= cp <= 0x0E7F:
        return 4  # thai
    if 0x0E80 <= cp <= 0x0EFF:
        return 5  # lao
    if 0x1000 <= cp <= 0x109F:
        return 6  # myanmar
    if 0x1780 <= cp <= 0x17FF:
        return 7  # khmer
    return 0  # everything else (latin, digits, ...) — one class


@lru_cache(maxsize=1)
def zh_lexicon() -> Tuple[Set[str], ...]:
    """Han lexicon by length: ``lex[n]`` is the set of n-char entries
    (2 <= n <= MAX_WORD), pure-Han only, from jieba's dict.txt.

    Returns empty sets when jieba is unavailable (segmenting then falls back
    to single-char tokens for Han — still closer to ICU than run-whole,
    and the divergence test skips)."""
    by_len: Tuple[Set[str], ...] = tuple(set() for _ in range(MAX_WORD + 1))
    try:
        import jieba

        with jieba.get_dict_file() as f:
            for raw in f:
                word = raw.decode("utf-8").split(" ", 1)[0]
                n = len(word)
                if 2 <= n <= MAX_WORD and all(_is_han(ord(c)) for c in word):
                    by_len[n].add(word)
    except Exception:  # noqa: BLE001 — no jieba: empty lexicon, see docstring
        pass
    return by_len


def _segment_han(s: str, offset: int, out: List[Tuple[int, int]]) -> None:
    """Greedy longest-match over the Han lexicon; OOV chars single."""
    lex = zh_lexicon()
    i, n = 0, len(s)
    while i < n:
        for ln in range(min(MAX_WORD, n - i), 1, -1):
            if s[i : i + ln] in lex[ln]:
                out.append((offset + i, offset + i + ln))
                i += ln
                break
        else:
            out.append((offset + i, offset + i + 1))
            i += 1


def segment_span(text: str, start: int, end: int) -> List[Tuple[int, int]]:
    """Re-segment one UAX#29 alnum-run span that contains dictionary-script
    chars: break at script transitions, dictionary-split the Han stretches,
    keep other stretches whole.  Returns (start, end) spans covering
    [start, end) in order."""
    out: List[Tuple[int, int]] = []
    i = start
    while i < end:
        key = _script_key(ord(text[i]))
        j = i + 1
        while j < end and _script_key(ord(text[j])) == key:
            j += 1
        if key == 1:
            _segment_han(text[i:j], i, out)
        else:
            out.append((i, j))
        i = j
    return out
