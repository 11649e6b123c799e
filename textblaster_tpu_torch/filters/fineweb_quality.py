"""FineWeb quality filter.

Re-implementation of ``FineWebQualityFilter``
(``/root/reference/src/pipeline/filters/fineweb_quality.rs:29-227``).
Sequential early-exit checks whose order is observable (first failure wins —
SURVEY.md §7 quirk #6).  The default stop-char set equals the reference's C4
set, *not* the Python original's CJK set (fineweb_quality.rs:25-26).  On the
empty-document path the metadata reason is ``"empty document"`` but the
outcome reason is ``"empty"`` (fineweb_quality.rs:79-89) — reproduced as-is.
On success no metadata is stamped (fineweb_quality.rs:225).
"""

from __future__ import annotations

from typing import Optional, Set

from ..data_model import TextDocument
from ..errors import DocumentFiltered
from ..executor import ProcessingStep
from ..utils.text import find_duplicates, split_into_words
from .common import fmt4, rust_bool, rust_lines

__all__ = ["FineWebQualityFilter", "DEFAULT_STOP_CHARS"]

# fineweb_quality.rs:26 — deliberately the C4 END_PUNCTUATION set.
DEFAULT_STOP_CHARS = frozenset({".", "!", "?", '"', "'", "”"})


class FineWebQualityFilter(ProcessingStep):
    name = "FineWebQualityFilter"

    def __init__(
        self,
        line_punct_thr: float,
        line_punct_exclude_zero: bool,
        short_line_thr: float,
        short_line_length: int,
        char_duplicates_ratio: float,
        new_line_ratio: float,
        stop_chars: Optional[Set[str]] = None,
    ) -> None:
        self.line_punct_thr = line_punct_thr
        self.line_punct_exclude_zero = line_punct_exclude_zero
        self.stop_chars = (
            frozenset(stop_chars) if stop_chars is not None else DEFAULT_STOP_CHARS
        )
        self.short_line_thr = short_line_thr
        self.short_line_length = short_line_length
        self.char_duplicates_ratio = char_duplicates_ratio
        self.new_line_ratio = new_line_ratio

    def _fail(self, document: TextDocument, reason: str, outcome_reason: str = "") -> None:
        document.metadata["fineweb_filter_status"] = "filtered"
        document.metadata["fineweb_filter_reason"] = reason
        raise DocumentFiltered(document, outcome_reason or reason)

    def process(self, document: TextDocument) -> TextDocument:
        content = document.content
        lines = [l for l in rust_lines(content) if l.strip()]

        if not lines:
            # Quirk: metadata says "empty document", outcome reason is "empty".
            self._fail(document, "empty document", outcome_reason="empty")

        # 1. Ratio of lines ending with stop characters (rs:93-123).
        ending = sum(
            1
            for l in lines
            if l.rstrip() and l.rstrip()[-1] in self.stop_chars
        )
        line_punct_ratio = ending / len(lines)
        if line_punct_ratio < self.line_punct_thr and not (
            line_punct_ratio == 0.0 and self.line_punct_exclude_zero
        ):
            self._fail(
                document,
                f"line_punct_ratio: {fmt4(line_punct_ratio)} < threshold "
                f"{fmt4(self.line_punct_thr)} (exclude_zero: "
                f"{rust_bool(self.line_punct_exclude_zero)})",
            )

        # 2. Ratio of short lines (rs:126-146).
        short = sum(1 for l in lines if len(l) <= self.short_line_length)
        short_ratio = short / len(lines)
        if short_ratio > self.short_line_thr:
            self._fail(
                document,
                f"short_line_ratio: {fmt4(short_ratio)} > threshold "
                f"{fmt4(self.short_line_thr)}",
            )

        # 3. Character duplication ratio: duplicate-line *byte* length over
        #    newline-free *char* count (rs:149-185 + text.rs:203).
        total_chars = sum(1 for c in content if c != "\n")
        _, dup_bytes = find_duplicates(lines)
        char_dup_ratio = dup_bytes / total_chars if total_chars > 0 else 0.0
        if char_dup_ratio > self.char_duplicates_ratio:
            self._fail(
                document,
                f"char_dup_ratio: {fmt4(char_dup_ratio)} > threshold "
                f"{fmt4(self.char_duplicates_ratio)}",
            )

        # 4. Newline/word ratio (rs:188-223).
        words = split_into_words(content)
        new_lines = content.count("\n")
        if not words:
            if new_lines > 0:
                self._fail(document, "list_ratio_no_words (newlines present but no words)")
        else:
            list_ratio = new_lines / len(words)
            if list_ratio > self.new_line_ratio:
                self._fail(
                    document,
                    f"list_ratio: {fmt4(list_ratio)} > threshold "
                    f"{fmt4(self.new_line_ratio)}",
                )

        return document
