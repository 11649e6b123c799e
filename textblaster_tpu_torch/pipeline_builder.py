"""Config -> step instances (host path).

Equivalent of ``build_pipeline_from_config``
(``/root/reference/src/worker_logic.rs:39-134``): a 7-arm dispatch from
:class:`~textblaster_tpu.config.pipeline.StepConfig` to constructed steps.
The device path compiles the same config into one fused XLA program instead
(:mod:`textblaster_tpu.ops.pipeline`).
"""

from __future__ import annotations

from typing import List, Optional

from .config.pipeline import PipelineConfig, StepConfig
from .errors import ConfigError
from .executor import PipelineExecutor, ProcessingStep
from .filters import (
    C4BadWordsFilter,
    C4QualityFilter,
    FineWebQualityFilter,
    GopherQualityFilter,
    GopherRepetitionFilter,
    LanguageDetectionFilter,
    TokenCounter,
)
from .filters.c4_badwords import C4BadWordsParams as _RuntimeBadWordsParams

__all__ = ["build_step", "build_pipeline_from_config"]


def build_step(step: StepConfig) -> ProcessingStep:
    p = step.params
    if step.type == "C4QualityFilter":
        return C4QualityFilter(
            split_paragraph=p.split_paragraph,
            remove_citations=p.remove_citations,
            filter_no_terminal_punct=p.filter_no_terminal_punct,
            min_num_sentences=p.min_num_sentences,
            min_words_per_line=p.min_words_per_line,
            max_word_length=p.max_word_length,
            filter_lorem_ipsum=p.filter_lorem_ipsum,
            filter_javascript=p.filter_javascript,
            filter_curly_bracket=p.filter_curly_bracket,
            filter_policy=p.filter_policy,
        )
    if step.type == "GopherRepetitionFilter":
        return GopherRepetitionFilter(
            dup_line_frac=p.dup_line_frac,
            dup_para_frac=p.dup_para_frac,
            dup_line_char_frac=p.dup_line_char_frac,
            dup_para_char_frac=p.dup_para_char_frac,
            top_n_grams=p.top_n_grams,
            dup_n_grams=p.dup_n_grams,
        )
    if step.type == "GopherQualityFilter":
        return GopherQualityFilter(
            min_doc_words=p.min_doc_words,
            max_doc_words=p.max_doc_words,
            min_avg_word_length=p.min_avg_word_length,
            max_avg_word_length=p.max_avg_word_length,
            max_symbol_word_ratio=p.max_symbol_word_ratio,
            max_bullet_lines_ratio=p.max_bullet_lines_ratio,
            max_ellipsis_lines_ratio=p.max_ellipsis_lines_ratio,
            max_non_alpha_words_ratio=p.max_non_alpha_words_ratio,
            min_stop_words=p.min_stop_words,
            stop_words=p.stop_words,
        )
    if step.type == "C4BadWordsFilter":
        return C4BadWordsFilter(
            _RuntimeBadWordsParams(
                keep_fraction=p.keep_fraction,
                fail_on_missing_language=p.fail_on_missing_language,
                seed=p.seed,
                default_language=p.default_language,
                cache_base_path=p.cache_base_path,
            )
        )
    if step.type == "LanguageDetectionFilter":
        return LanguageDetectionFilter(
            min_confidence=p.min_confidence,
            allowed_languages=p.allowed_languages,
        )
    if step.type == "FineWebQualityFilter":
        return FineWebQualityFilter(
            line_punct_thr=p.line_punct_thr,
            line_punct_exclude_zero=p.line_punct_exclude_zero,
            short_line_thr=p.short_line_thr,
            short_line_length=p.short_line_length,
            char_duplicates_ratio=p.char_duplicates_ratio,
            new_line_ratio=p.new_line_ratio,
            stop_chars=set(p.stop_chars) if p.stop_chars is not None else None,
        )
    if step.type == "TokenCounter":
        # Reference panics on tokenizer load failure (worker_logic.rs:115-122);
        # here the UnexpectedError propagates out of construction.
        return TokenCounter(p.tokenizer_name)
    raise ConfigError(f"unknown step type '{step.type}'")


def build_pipeline_from_config(
    config: PipelineConfig, steps_filter: Optional[List[str]] = None
) -> PipelineExecutor:
    """Construct the host-path executor for a validated config."""
    steps = [
        build_step(s)
        for s in config.pipeline
        if steps_filter is None or s.type in steps_filter
    ]
    return PipelineExecutor(steps)
