"""C4 quality filter (mutating).

Re-implementation of ``C4QualityFilter``
(``/root/reference/src/pipeline/filters/c4_filters.rs:84-296``): document-level
early rejects (lorem ipsum / curly bracket), a per-line keep/drop loop with
citation removal, and a final sentence-count check on the *rewritten* content.
Line-drop counters are stamped into metadata keyed ``line-filter-*`` — only on
the filtered path (c4_filters.rs:281-283).
"""

from __future__ import annotations

import re
from typing import Dict, List

from ..data_model import TextDocument
from ..errors import DocumentFiltered
from ..executor import ProcessingStep
from ..utils.text import split_into_sentences, split_into_words
from .common import rust_lines

__all__ = ["C4QualityFilter", "END_PUNCTUATION", "POLICY_SUBSTRINGS", "CITATION_RE"]

# c4_filters.rs:20
END_PUNCTUATION = (".", "!", "?", '"', "'", "”")
ELLIPSIS = "..."

# c4_filters.rs:24-31
POLICY_SUBSTRINGS = (
    "terms of use",
    "privacy policy",
    "cookie policy",
    "uses cookies",
    "use of cookies",
    "use cookies",
)

# Wikipedia-style citations like [1], [2, 3], [45] (c4_filters.rs:33).
CITATION_RE = re.compile(r"\[\d+(?:,\s*\d+)*\]")


class C4QualityFilter(ProcessingStep):
    name = "C4QualityFilter"

    def __init__(
        self,
        split_paragraph: bool,
        remove_citations: bool,
        filter_no_terminal_punct: bool,
        min_num_sentences: int,
        min_words_per_line: int,
        max_word_length: int,
        filter_lorem_ipsum: bool,
        filter_javascript: bool,
        filter_curly_bracket: bool,
        filter_policy: bool,
    ) -> None:
        self.split_paragraph = split_paragraph
        self.remove_citations = remove_citations
        self.filter_no_terminal_punct = filter_no_terminal_punct
        self.min_num_sentences = min_num_sentences
        self.min_words_per_line = min_words_per_line
        self.max_word_length = max_word_length
        self.filter_lorem_ipsum = filter_lorem_ipsum
        self.filter_javascript = filter_javascript
        self.filter_curly_bracket = filter_curly_bracket
        self.filter_policy = filter_policy

    def process(self, document: TextDocument) -> TextDocument:
        original = document.content
        lines = (
            rust_lines(original)
            if self.split_paragraph
            else split_into_sentences(original)
        )

        reasons: List[str] = []

        # Document-level early rejects (c4_filters.rs:166-187).
        if self.filter_lorem_ipsum and "lorem ipsum" in original.lower():
            reasons.append("lorem_ipsum")
        if self.filter_curly_bracket and ("{" in original or "}" in original):
            reasons.append("curly_bracket")

        if reasons:
            reasons_string = "; ".join(reasons)
            document.metadata["c4_filter_status"] = "filtered"
            document.metadata["c4_filter_reasons"] = reasons_string
            raise DocumentFiltered(document, reasons_string)

        line_stats: Dict[str, int] = {}
        kept_lines: List[str] = []

        for line in lines:
            current = line.strip()
            processed = CITATION_RE.sub("", current) if self.remove_citations else current

            line_l = processed.lower()
            words = split_into_words(processed)

            # Overlong word (c4_filters.rs:207-216).
            if self.max_word_length > 0 and any(
                len(w) > self.max_word_length for w in words
            ):
                line_stats["line-filter-too_long_word"] = (
                    line_stats.get("line-filter-too_long_word", 0) + 1
                )
                continue

            # Terminal punctuation; a line ending in "..." fails even though
            # '.' is terminal (c4_filters.rs:219-232).
            if self.filter_no_terminal_punct:
                ends_terminal = bool(processed) and processed[-1] in END_PUNCTUATION
                if not ends_terminal or processed.endswith(ELLIPSIS):
                    line_stats["line-filter-no_terminal_punc"] = (
                        line_stats.get("line-filter-no_terminal_punc", 0) + 1
                    )
                    continue

            # Minimum word count (c4_filters.rs:235-240).
            if self.min_words_per_line > 0 and len(words) < self.min_words_per_line:
                line_stats["line-filter-too_few_words"] = (
                    line_stats.get("line-filter-too_few_words", 0) + 1
                )
                continue

            # Javascript / policy lines are dropped without a counter
            # (c4_filters.rs:243-250).
            if self.filter_javascript and "javascript" in line_l:
                continue
            if self.filter_policy and any(p in line_l for p in POLICY_SUBSTRINGS):
                continue

            kept_lines.append(processed)

        # Rewrite content from kept lines (c4_filters.rs:258).
        document.content = "\n".join(kept_lines).strip()

        # Sentence count on the filtered content (c4_filters.rs:261-269).
        n_sentences = len(split_into_sentences(document.content))
        if self.min_num_sentences > 0 and n_sentences < self.min_num_sentences:
            reasons.append(
                f"too_few_sentences (found {n_sentences}, "
                f"required {self.min_num_sentences})"
            )

        if reasons:
            reasons_string = "; ".join(reasons)
            document.metadata["c4_filter_status"] = "filtered"
            document.metadata["c4_filter_reasons"] = reasons_string
            for key, value in line_stats.items():
                document.metadata[key] = str(value)
            raise DocumentFiltered(document, reasons_string)

        document.metadata["c4_filter_status"] = "passed"
        return document
