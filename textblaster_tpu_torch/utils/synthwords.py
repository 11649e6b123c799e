"""Deterministic synthetic blocklist generator for full-scale badwords runs.

The port's copy of ``textblaster_tpu/utils/synthwords.py`` (the same
function and output).  The reference filter downloads the LDNOOBW lists at
first use (``c4_filters.rs:318-454``; the upstream ``en`` list has ~400
entries over ~20 distinct lengths, multi-word phrases among them).  Runs
with no network use *generated* lists with the same shape statistics:
entry count, length spread (one window-hash pass per distinct length is
the device cost driver, :mod:`..ops.badwords`) and a multi-word-phrase
share.  Vocabulary is irrelevant to the machinery under test; only shape
is.

Deterministic by seed, so tests, ``chip_smoke.py`` and device-table builds
all see the identical list without shipping fake "bad words" as package
data.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["synth_badwords"]

_CONS = "bcdfghjklmnpqrstvwz"
_VOW = "aeiouy"


def _syllable(rng: np.random.Generator) -> str:
    s = _CONS[int(rng.integers(len(_CONS)))] + _VOW[int(rng.integers(len(_VOW)))]
    if rng.random() < 0.4:
        s += _CONS[int(rng.integers(len(_CONS)))]
    return s


def _latin_word(rng: np.random.Generator, syllables: int) -> str:
    return "".join(_syllable(rng) for _ in range(syllables))


def synth_badwords(seed: int, n: int = 400, cjk: bool = False) -> List[str]:
    """``n`` unique entries with LDNOOBW-like shape statistics.

    Latin mode: pronounceable 1-5 syllable words (2-15 chars) plus ~15%
    two/three-word phrases (real lists contain phrases; phrases exercise the
    space-in-pattern window path).  CJK mode: 2-8 ideograph strings from the
    CJK Unified block (real zh/ja lists are short unanchored substrings).
    """
    rng = np.random.default_rng(seed)
    words = set()
    while len(words) < n:
        if cjk:
            ln = int(rng.integers(2, 9))
            cps = rng.integers(0x4E00, 0x9FA5, size=ln)
            words.add("".join(chr(int(c)) for c in cps))
        else:
            w = _latin_word(rng, int(rng.integers(1, 6)))
            r = rng.random()
            if r < 0.10:
                w = f"{w} {_latin_word(rng, int(rng.integers(1, 4)))}"
            elif r < 0.15:
                w = (
                    f"{w} {_latin_word(rng, int(rng.integers(1, 3)))}"
                    f" {_latin_word(rng, int(rng.integers(1, 3)))}"
                )
            words.add(w)
    return sorted(words)
