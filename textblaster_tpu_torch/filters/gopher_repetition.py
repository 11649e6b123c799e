"""Gopher repetition filter.

Re-implementation of ``GopherRepetitionFilter``
(``/root/reference/src/pipeline/filters/gopher_rep.rs:12-221``).  Reproduces
the bytes-vs-chars quirk: duplicate lengths are **UTF-8 byte** sums
(text.rs:203,230,252) while the denominator is the trimmed **char** count
clamped to 1 (gopher_rep.rs:58) — see SURVEY.md §7.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from ..data_model import TextDocument
from ..errors import DocumentFiltered
from ..executor import ProcessingStep
from ..utils.text import find_duplicates, ngram_dup_stats
from .common import fmt2

__all__ = ["GopherRepetitionFilter"]

_PARAGRAPH_RE = re.compile(r"\n{2,}")  # gopher_rep.rs:40
_LINE_RE = re.compile(r"\n+")  # gopher_rep.rs:41


class GopherRepetitionFilter(ProcessingStep):
    name = "GopherRepetitionFilter"

    def __init__(
        self,
        dup_line_frac: Optional[float] = None,
        dup_para_frac: Optional[float] = None,
        dup_line_char_frac: Optional[float] = None,
        dup_para_char_frac: Optional[float] = None,
        top_n_grams: Sequence[Tuple[int, float]] = (),
        dup_n_grams: Sequence[Tuple[int, float]] = (),
    ) -> None:
        self.dup_line_frac = dup_line_frac
        self.dup_para_frac = dup_para_frac
        self.dup_line_char_frac = dup_line_char_frac
        self.dup_para_char_frac = dup_para_char_frac
        self.top_n_grams = [(int(n), float(f)) for n, f in top_n_grams]
        self.dup_n_grams = [(int(n), float(f)) for n, f in dup_n_grams]

    def process(self, document: TextDocument) -> TextDocument:
        trimmed = document.content.strip()
        text_char_len = float(max(len(trimmed), 1))  # gopher_rep.rs:58

        if not trimmed:
            document.metadata["gopher_repetition_filter_status"] = "filtered"
            document.metadata["gopher_repetition_filter_reason"] = "skipping empty content"
            raise DocumentFiltered(document, "skipping empty content")

        reasons: List[str] = []

        paragraphs = _PARAGRAPH_RE.split(trimmed)
        para_dup_elems, para_dup_bytes = find_duplicates(paragraphs)
        para_len = float(max(len(paragraphs), 1))

        ratio = para_dup_elems / para_len
        if self.dup_para_frac is not None and ratio > self.dup_para_frac:
            reasons.append(
                f"dup_para_frac (ratio {fmt2(ratio)}, max {fmt2(self.dup_para_frac)})"
            )

        ratio = para_dup_bytes / text_char_len
        if self.dup_para_char_frac is not None and ratio > self.dup_para_char_frac:
            reasons.append(
                f"dup_para_char_frac (ratio {fmt2(ratio)}, "
                f"max {fmt2(self.dup_para_char_frac)})"
            )

        lines = _LINE_RE.split(trimmed)
        line_dup_elems, line_dup_bytes = find_duplicates(lines)
        line_len = float(max(len(lines), 1))

        ratio = line_dup_elems / line_len
        if self.dup_line_frac is not None and ratio > self.dup_line_frac:
            reasons.append(
                f"dup_line_frac (ratio {fmt2(ratio)}, max {fmt2(self.dup_line_frac)})"
            )

        ratio = line_dup_bytes / text_char_len
        if self.dup_line_char_frac is not None and ratio > self.dup_line_char_frac:
            reasons.append(
                f"dup_line_char_frac (ratio {fmt2(ratio)}, "
                f"max {fmt2(self.dup_line_char_frac)})"
            )

        top_stats, dup_stats = ngram_dup_stats(
            trimmed,
            [n for n, _ in self.top_n_grams],
            [n for n, _ in self.dup_n_grams],
        )

        for n, thr in self.top_n_grams:
            ratio = top_stats[n] / text_char_len
            if n > 0 and ratio > thr:
                reasons.append(f"top_{n}_gram (ratio {fmt2(ratio)}, max {fmt2(thr)})")

        for n, thr in self.dup_n_grams:
            ratio = dup_stats[n] / text_char_len
            if n > 0 and ratio > thr:
                reasons.append(
                    f"duplicated_{n}_n_grams (ratio {fmt2(ratio)}, max {fmt2(thr)})"
                )

        if reasons:
            document.metadata["gopher_repetition_filter_status"] = "filtered"
            reasons_string = "; ".join(reasons)
            document.metadata["gopher_repetition_filter_reasons"] = reasons_string
            raise DocumentFiltered(document, reasons_string)

        document.metadata["gopher_repetition_filter_status"] = "passed"
        return document
