"""Gopher quality heuristics filter.

Decision-for-decision re-implementation of ``GopherQualityFilter``
(``/root/reference/src/pipeline/filters/gopher_quality.rs:19-319``): nine
optional heuristics (``None`` disables each), reason strings with ``{:.2}``
ratios, and the reference's quirks — ``max_non_alpha_words_ratio`` actually
tests a *minimum alphabetic-word ratio* (gopher_quality.rs:277-284), hash and
ellipsis ratios share ``max_symbol_word_ratio`` (242-256), and ratio
denominators clamp to 1 (102, 128).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set

from ..data_model import TextDocument
from ..errors import DocumentFiltered
from ..executor import ProcessingStep
from ..utils.text import PUNCTUATION, split_into_words
from .common import fmt2, rust_lines

__all__ = ["GopherQualityFilter", "DEFAULT_STOP_WORDS"]

# gopher_quality.rs:10
DEFAULT_STOP_WORDS = ("the", "be", "to", "of", "and", "that", "have", "with")


class GopherQualityFilter(ProcessingStep):
    name = "GopherQualityFilter"

    def __init__(
        self,
        min_doc_words: Optional[int] = None,
        max_doc_words: Optional[int] = None,
        min_avg_word_length: Optional[float] = None,
        max_avg_word_length: Optional[float] = None,
        max_symbol_word_ratio: Optional[float] = None,
        max_bullet_lines_ratio: Optional[float] = None,
        max_ellipsis_lines_ratio: Optional[float] = None,
        max_non_alpha_words_ratio: Optional[float] = None,
        min_stop_words: Optional[int] = None,
        stop_words: Optional[Sequence[str]] = None,
    ) -> None:
        self.min_doc_words = min_doc_words
        self.max_doc_words = max_doc_words
        self.min_avg_word_length = min_avg_word_length
        self.max_avg_word_length = max_avg_word_length
        self.max_symbol_word_ratio = max_symbol_word_ratio
        self.max_bullet_lines_ratio = max_bullet_lines_ratio
        self.max_ellipsis_lines_ratio = max_ellipsis_lines_ratio
        self.max_non_alpha_words_ratio = max_non_alpha_words_ratio
        self.min_stop_words = min_stop_words
        self.stop_words: Set[str] = set(
            stop_words if stop_words is not None else DEFAULT_STOP_WORDS
        )

    def process(self, document: TextDocument) -> TextDocument:
        text = document.content
        words = split_into_words(text)
        n_total_words = len(words)

        # Non-symbol words: >=1 char outside the PUNCTUATION set
        # (gopher_quality.rs:80-85).
        non_symbol_words = [w for w in words if any(c not in PUNCTUATION for c in w)]
        n_non_symbol = len(non_symbol_words)

        avg_word_len = (
            sum(len(w) for w in non_symbol_words) / n_non_symbol if n_non_symbol else 0.0
        )

        n_total_calc = float(max(n_total_words, 1))  # gopher_quality.rs:102

        hash_ratio = text.count("#") / n_total_calc
        ellipsis_units = text.count("...") + text.count("…")
        ellipsis_ratio = ellipsis_units / n_total_calc

        lines = rust_lines(text)
        n_lines_calc = float(max(len(lines), 1))  # gopher_quality.rs:128
        bullet_lines = sum(
            1 for l in lines if l.lstrip().startswith(("•", "-"))
        )
        bullet_ratio = bullet_lines / n_lines_calc
        ellipsis_lines = sum(
            1 for l in lines if l.rstrip().endswith(("...", "…"))
        )
        ellipsis_lines_ratio = ellipsis_lines / n_lines_calc

        alpha_words = sum(1 for w in words if any(c.isalpha() for c in w))
        alpha_ratio = alpha_words / n_total_calc

        stop_word_count = sum(1 for w in words if w.lower() in self.stop_words)

        reasons: List[str] = []

        if self.min_doc_words is not None and n_non_symbol < self.min_doc_words:
            reasons.append(
                f"gopher_short_doc ({n_non_symbol} non-symbol words, "
                f"required {self.min_doc_words})"
            )
        if self.max_doc_words is not None and n_non_symbol > self.max_doc_words:
            reasons.append(
                f"gopher_long_doc ({n_non_symbol} non-symbol words, "
                f"max {self.max_doc_words})"
            )

        if self.min_avg_word_length is not None and avg_word_len < self.min_avg_word_length:
            suffix = (
                " - 0 non-symbol words"
                if n_non_symbol == 0 and self.min_avg_word_length > 0.0
                else ""
            )
            reasons.append(
                f"gopher_below_avg_threshold (avg len {fmt2(avg_word_len)}, "
                f"required {fmt2(self.min_avg_word_length)}{suffix})"
            )
        if (
            self.max_avg_word_length is not None
            and n_non_symbol > 0
            and avg_word_len > self.max_avg_word_length
        ):
            reasons.append(
                f"gopher_above_avg_threshold (avg len {fmt2(avg_word_len)}, "
                f"max {fmt2(self.max_avg_word_length)})"
            )

        if self.max_symbol_word_ratio is not None:
            if hash_ratio > self.max_symbol_word_ratio:
                reasons.append(
                    f"gopher_too_many_hashes (ratio {fmt2(hash_ratio)}, "
                    f"max {fmt2(self.max_symbol_word_ratio)})"
                )
            # Gopher re-uses max_symbol_word_ratio for ellipsis (rs:249-255).
            if ellipsis_ratio > self.max_symbol_word_ratio:
                reasons.append(
                    f"gopher_too_many_ellipsis_units (ratio {fmt2(ellipsis_ratio)}, "
                    f"max {fmt2(self.max_symbol_word_ratio)})"
                )

        if (
            self.max_bullet_lines_ratio is not None
            and bullet_ratio > self.max_bullet_lines_ratio
        ):
            reasons.append(
                f"gopher_too_many_bullets (ratio {fmt2(bullet_ratio)}, "
                f"max {fmt2(self.max_bullet_lines_ratio)})"
            )
        if (
            self.max_ellipsis_lines_ratio is not None
            and ellipsis_lines_ratio > self.max_ellipsis_lines_ratio
        ):
            reasons.append(
                f"gopher_too_many_end_ellipsis_lines (ratio {fmt2(ellipsis_lines_ratio)}, "
                f"max {fmt2(self.max_ellipsis_lines_ratio)})"
            )

        # Inverted naming quirk: this is a minimum-alpha-ratio test (rs:277-284).
        if (
            self.max_non_alpha_words_ratio is not None
            and alpha_ratio < self.max_non_alpha_words_ratio
        ):
            reasons.append(
                f"gopher_below_alpha_threshold (alpha ratio {fmt2(alpha_ratio)}, "
                f"required min {fmt2(self.max_non_alpha_words_ratio)})"
            )

        if (
            self.min_stop_words is not None
            and self.min_stop_words > 0
            and stop_word_count < self.min_stop_words
        ):
            reasons.append(
                f"gopher_too_few_stop_words (found {stop_word_count}, "
                f"required {self.min_stop_words})"
            )

        if reasons:
            reasons_string = "; ".join(reasons)
            document.metadata["gopher_quality_filter_status"] = "filtered"
            document.metadata["gopher_quality_filter_reasons"] = reasons_string
            raise DocumentFiltered(document, reasons_string)

        document.metadata["gopher_quality_filter_status"] = "passed"
        return document
