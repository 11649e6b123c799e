"""C4 bad-words filter.

Re-implementation of ``C4BadWordsFilter``
(``/root/reference/src/pipeline/filters/c4_filters.rs:298-552``):
language-keyed LDNOOBW blocklists with an on-disk cache, lazily compiled into
one case-insensitive alternation regex per language (CJK languages without
word-boundary anchors — c4_filters.rs:431-439), and a seeded keep-fraction.

RNG parity note: the reference draws ``f32`` from a *shared* Rust ``StdRng``
stream (ChaCha12, c4_filters.rs:306-309), which makes its keep decisions
depend on the order documents happen to reach the worker — nondeterministic
under queue delivery.  This build renegotiates to something strictly
stronger: with ``seed`` set, each document draws from
``sha256(seed, doc.id)``, so the decision is a pure function of the document
— identical across host/device backends, batch orderings, and resumed runs
(the distributional property, uniform keep at ``keep_fraction``, is
preserved; the renegotiation SURVEY.md §7 anticipates).  With ``seed`` unset
the draw falls back to an unseeded shared stream, nondeterministic like the
reference's default.

Network note: the reference downloads lists over HTTP at first use and vendors
none (c4_filters.rs:354-412) — offline, it supports zero of the 28 languages.
This build ships vendored LDNOOBW lists for ``da`` and ``en`` (authored-list
redistribution for the remaining 26 is neither possible offline nor required
for parity: the same lazy download + on-disk cache covers them exactly as the
reference's does, and ``cache_base_path`` lets deployments pre-seed every
language from a mirror).
"""

from __future__ import annotations

import hashlib
import os
import random
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

from ..data_model import TextDocument
from ..errors import DocumentFiltered
from ..executor import ProcessingStep

__all__ = [
    "C4BadWordsFilter",
    "C4BadWordsParams",
    "BADWORDS_LANGS",
    "load_local_badwords",
]

_EN_BADWORDS_URL = (
    "https://raw.githubusercontent.com/LDNOOBW/List-of-Dirty-Naughty-Obscene-"
    "and-Otherwise-Bad-Words/25e679f03d96baa721cde20db9944649e8d0a844/en"
)
_BADWORDS_URL = (
    "https://raw.githubusercontent.com/LDNOOBW/List-of-Dirty-Naughty-Obscene-"
    "and-Otherwise-Bad-Words/5faf2ba42d7b1c0977169ec3611df25a3c08eb13/"
)

# c4_filters.rs:38-67
BADWORDS_LANGS = (
    "ar", "cs", "da", "de", "en", "eo", "es", "fa", "fi", "fil", "fr",
    "fr-CA-u-sd-caqc", "hi", "hu", "it", "ja", "kab", "ko", "nl", "no", "pl",
    "pt", "ru", "sv", "th", "tlh", "tr", "zh",
)

_CJK_LANGS = ("ja", "th", "zh")  # c4_filters.rs:70

# Vendored lists shipped with the package (zero-egress environments).
_VENDORED_DIR = Path(__file__).resolve().parent.parent / "data" / "c4_badwords"


@dataclass
class C4BadWordsParams:
    """Parameters (reference ``config/pipeline.rs:260-268``)."""

    keep_fraction: float = 0.0
    fail_on_missing_language: bool = True
    seed: Optional[int] = None
    default_language: str = "en"
    cache_base_path: Optional[Path] = None
    extra: Dict[str, str] = field(default_factory=dict)


class _BadwordsError(Exception):
    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


def local_badwords_path(
    lang: str, cache_base_path: Optional[Path] = None
) -> Path:
    """The path ``load_local_badwords`` would read: the cache-dir file if it
    exists, else the vendored file (which may also not exist)."""
    cache_dir = (
        Path(cache_base_path) if cache_base_path else Path("data") / "c4_badwords"
    )
    cached = cache_dir / lang
    return cached if cached.exists() else _VENDORED_DIR / lang


def load_local_badwords(
    lang: str, cache_base_path: Optional[Path] = None
) -> Optional[list]:
    """The language's word list from local sources only (cache dir, then the
    vendored package data) — no network.  None if unavailable; [] if the list
    exists but is empty.  Used by the device kernel builder
    (:mod:`textblaster_tpu.ops.badwords`), which must not trigger downloads
    at trace time."""
    if lang not in BADWORDS_LANGS:
        return None
    candidate = local_badwords_path(lang, cache_base_path)
    if candidate.exists():
        try:
            content = candidate.read_text(encoding="utf-8")
        except OSError:
            return None
        return [w.strip() for w in content.splitlines() if w.strip()]
    return None


class C4BadWordsFilter(ProcessingStep):
    name = "C4BadWordsFilter"

    def __init__(self, params: C4BadWordsParams) -> None:
        self.params = params
        self._regex_cache: Dict[str, Optional[re.Pattern]] = {}
        self._rng = random.Random(params.seed)

    # c4_filters.rs:318-454
    def _get_badwords(self, lang: str) -> Optional[re.Pattern]:
        if lang in self._regex_cache:
            return self._regex_cache[lang]

        if lang not in BADWORDS_LANGS:
            if self.params.fail_on_missing_language:
                raise _BadwordsError(
                    f"There is no badwords list available for '{lang}'. "
                    "Set fail_on_missing_language=False to continue anyway."
                )
            return None

        # Same resolution as the device-table builder (local_badwords_path):
        # cache file first, vendored copy second, download last.
        source = local_badwords_path(lang, self.params.cache_base_path)
        if source.exists():
            try:
                words_content = source.read_text(encoding="utf-8")
            except OSError as e:
                raise _BadwordsError(f"I/O error: {e}") from e
        else:
            cache_dir = (
                Path(self.params.cache_base_path)
                if self.params.cache_base_path
                else Path("data") / "c4_badwords"
            )
            words_content = self._download(lang, cache_dir, cache_dir / lang)

        badwords = [w.strip() for w in words_content.splitlines()]
        badwords = [w for w in badwords if w]
        if not badwords:
            # Empty list: behave as if none was available (c4_filters.rs:420-426).
            self._regex_cache[lang] = None
            return None

        escaped = [re.escape(w) for w in badwords]
        if lang in _CJK_LANGS:
            pattern = "(?i)(" + "|".join(escaped) + ")"
        else:
            pattern = r"(?i)(?:\W|^)(" + "|".join(escaped) + r")(?:\W|$)"
        try:
            compiled = re.compile(pattern)
        except re.error as e:
            raise _BadwordsError(
                f"Failed to compile regex for lang '{lang}': {e}"
            ) from e
        self._regex_cache[lang] = compiled
        return compiled

    def _download(self, lang: str, cache_dir: Path, cache_file: Path) -> str:
        url = _EN_BADWORDS_URL if lang == "en" else _BADWORDS_URL + lang
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError as e:
            raise _BadwordsError(f"I/O error: {e}") from e
        try:
            from urllib.request import urlopen

            with urlopen(url, timeout=15) as resp:  # noqa: S310
                if resp.status != 200:
                    raise _BadwordsError(
                        f"Failed to download badwords for lang '{lang}' from "
                        f"'{url}'. Status: {resp.status}"
                    )
                content = resp.read().decode("utf-8")
        except _BadwordsError:
            raise
        except Exception as e:
            raise _BadwordsError(
                f"Failed to download badwords for lang '{lang}' from '{url}': {e}"
            ) from e
        try:
            cache_file.write_text(content, encoding="utf-8")
        except OSError as e:
            raise _BadwordsError(f"I/O error: {e}") from e
        return content

    def _keep_draw(self, doc_id: str) -> float:
        """Uniform [0,1) draw deciding keep-by-fraction for one document.

        Seeded runs hash (seed, doc id) so the decision is order-independent —
        a pure host run, the device-prefiltered path, and a checkpoint resume
        all agree (see the module docstring's RNG parity note)."""
        if self.params.seed is None:
            return self._rng.random()
        h = hashlib.sha256(
            f"{self.params.seed}:{doc_id}".encode("utf-8")
        ).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64

    def process(self, document: TextDocument) -> TextDocument:
        lang = document.metadata.get("language", self.params.default_language)

        try:
            badwords_re = self._get_badwords(lang)
        except _BadwordsError as e:
            document.metadata["c4_badwords_filter_status"] = "filtered"
            document.metadata["c4_badwords_filter_reason"] = e.reason
            raise DocumentFiltered(document, e.reason) from e

        if badwords_re is None:
            document.metadata["c4_badwords_filter_status"] = "passed_no_regex"
            return document

        if badwords_re.search(document.content):
            if self.params.keep_fraction > 0.0 and self._keep_draw(document.id) < self.params.keep_fraction:
                document.metadata["c4_badwords_filter_status"] = "passed_kept_by_fraction"
                return document
            reason = "document_removed_with_badwords"
            document.metadata["c4_badwords_filter_status"] = "filtered"
            document.metadata["c4_badwords_filter_reason"] = reason
            raise DocumentFiltered(document, reason)

        document.metadata["c4_badwords_filter_status"] = "passed"
        return document
