"""Typed, validated YAML pipeline configuration.

Re-implementation of ``/root/reference/src/config/pipeline.rs``: the same 7
step types discriminated by a ``type`` field, the same per-params validation
rules (pipeline.rs:82-367) with matching error messages, and the same loader
behavior (read file -> YAML parse -> validate, pipeline.rs:372-393).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import yaml

from ..errors import ConfigError, ConfigValidationError

#: The closed SLO objective vocabulary (the keys of the JAX package's
#: ``utils/slo.py`` ``SLO_KEYS``; the port has no SLO engine yet, so only the
#: names are kept, for config validation).
SLO_KEYS = ("availability", "p99_latency_s", "throughput_floor")

__all__ = [
    "PipelineConfig",
    "StepConfig",
    "C4QualityParams",
    "GopherRepetitionParams",
    "GopherQualityParams",
    "C4BadWordsParams",
    "LanguageDetectionParams",
    "FineWebQualityFilterParams",
    "TokenCounterParams",
    "ResilienceConfig",
    "OverlapConfig",
    "SLOConfig",
    "load_pipeline_config",
    "parse_pipeline_config",
]


def _require(d: Dict[str, Any], key: str, step: str) -> Any:
    if key not in d:
        raise ConfigError(f"missing field `{key}` for step {step}")
    return d[key]


@dataclass
class C4QualityParams:
    """pipeline.rs:67-100"""

    split_paragraph: bool
    remove_citations: bool
    filter_no_terminal_punct: bool
    min_num_sentences: int
    min_words_per_line: int
    max_word_length: int
    filter_lorem_ipsum: bool
    filter_javascript: bool
    filter_curly_bracket: bool
    filter_policy: bool

    def validate(self) -> None:
        if self.min_num_sentences == 0:
            raise ConfigValidationError(
                "C4QualityParams: min_num_sentences must be greater than 0"
            )
        if self.min_words_per_line == 0:
            raise ConfigValidationError(
                "C4QualityParams: min_words_per_line must be greater than 0"
            )
        if self.max_word_length == 0:
            raise ConfigValidationError(
                "C4QualityParams: max_word_length must be greater than 0"
            )


@dataclass
class GopherRepetitionParams:
    """pipeline.rs:102-159"""

    dup_line_frac: Optional[float] = None
    dup_para_frac: Optional[float] = None
    dup_line_char_frac: Optional[float] = None
    dup_para_char_frac: Optional[float] = None
    top_n_grams: List[Tuple[int, float]] = field(default_factory=list)
    dup_n_grams: List[Tuple[int, float]] = field(default_factory=list)

    def validate(self) -> None:
        fractions = (
            ("dup_line_frac", self.dup_line_frac),
            ("dup_para_frac", self.dup_para_frac),
            ("dup_line_char_frac", self.dup_line_char_frac),
            ("dup_para_char_frac", self.dup_para_char_frac),
        )
        for name, val in fractions:
            if val is not None and not (0.0 <= val <= 1.0):
                raise ConfigValidationError(
                    f"GopherRepetitionParams: {name} must be between 0.0 and 1.0, "
                    f"got {val}"
                )
        for name, n_grams in (
            ("top_n_grams", self.top_n_grams),
            ("dup_n_grams", self.dup_n_grams),
        ):
            for idx, (size, fraction) in enumerate(n_grams):
                if size == 0:
                    raise ConfigValidationError(
                        f"GopherRepetitionParams: n-gram size in {name} at index "
                        f"{idx} must be greater than 0"
                    )
                if not (0.0 <= fraction <= 1.0):
                    raise ConfigValidationError(
                        f"GopherRepetitionParams: n-gram fraction in {name} at "
                        f"index {idx} must be between 0.0 and 1.0, got {fraction}"
                    )


@dataclass
class GopherQualityParams:
    """pipeline.rs:161-258"""

    min_doc_words: Optional[int] = None
    max_doc_words: Optional[int] = None
    min_avg_word_length: Optional[float] = None
    max_avg_word_length: Optional[float] = None
    max_symbol_word_ratio: Optional[float] = None
    max_bullet_lines_ratio: Optional[float] = None
    max_ellipsis_lines_ratio: Optional[float] = None
    max_non_alpha_words_ratio: Optional[float] = None
    min_stop_words: Optional[int] = None
    stop_words: Optional[List[str]] = None

    def validate(self) -> None:
        if self.min_doc_words is not None and self.min_doc_words == 0:
            raise ConfigValidationError(
                "GopherQualityParams: min_doc_words must be greater than 0"
            )
        if self.max_doc_words is not None and self.max_doc_words == 0:
            raise ConfigValidationError(
                "GopherQualityParams: max_doc_words must be greater than 0"
            )
        if (
            self.min_doc_words is not None
            and self.max_doc_words is not None
            and self.min_doc_words > self.max_doc_words
        ):
            raise ConfigValidationError(
                f"GopherQualityParams: min_doc_words ({self.min_doc_words}) cannot "
                f"be greater than max_doc_words ({self.max_doc_words})"
            )
        if self.min_avg_word_length is not None and self.min_avg_word_length <= 0.0:
            raise ConfigValidationError(
                "GopherQualityParams: min_avg_word_length must be greater than 0.0"
            )
        if self.max_avg_word_length is not None and self.max_avg_word_length <= 0.0:
            raise ConfigValidationError(
                "GopherQualityParams: max_avg_word_length must be greater than 0.0"
            )
        if (
            self.min_avg_word_length is not None
            and self.max_avg_word_length is not None
            and self.min_avg_word_length > self.max_avg_word_length
        ):
            raise ConfigValidationError(
                f"GopherQualityParams: min_avg_word_length "
                f"({self.min_avg_word_length}) cannot be greater than "
                f"max_avg_word_length ({self.max_avg_word_length})"
            )
        ratio_params = (
            ("max_symbol_word_ratio", self.max_symbol_word_ratio),
            ("max_bullet_lines_ratio", self.max_bullet_lines_ratio),
            ("max_ellipsis_lines_ratio", self.max_ellipsis_lines_ratio),
            ("max_non_alpha_words_ratio", self.max_non_alpha_words_ratio),
        )
        for name, val in ratio_params:
            if val is not None and val < 0.0:
                raise ConfigValidationError(
                    f"GopherQualityParams: {name} must be non-negative, got {val}"
                )


@dataclass
class C4BadWordsParams:
    """pipeline.rs:260-285"""

    keep_fraction: float
    fail_on_missing_language: bool
    default_language: str
    seed: Optional[int] = None
    cache_base_path: Optional[Path] = None  # not deserialized from YAML (serde skip)

    def validate(self) -> None:
        if not (0.0 <= self.keep_fraction <= 1.0):
            raise ConfigValidationError(
                f"C4BadWordsParams: keep_fraction must be between 0.0 and 1.0, "
                f"got {self.keep_fraction}"
            )
        if not self.default_language:
            raise ConfigValidationError(
                "C4BadWordsParams: default_language cannot be empty"
            )


@dataclass
class LanguageDetectionParams:
    """pipeline.rs:287-309"""

    min_confidence: float
    allowed_languages: List[str]

    def validate(self) -> None:
        if not (0.0 <= self.min_confidence <= 1.0):
            raise ConfigValidationError(
                f"LanguageDetectionParams: min_confidence must be between 0.0 and "
                f"1.0, got {self.min_confidence}"
            )
        if not self.allowed_languages:
            raise ConfigValidationError(
                "LanguageDetectionParams: allowed_languages cannot be empty"
            )


@dataclass
class FineWebQualityFilterParams:
    """pipeline.rs:311-349"""

    line_punct_thr: float = 0.0
    line_punct_exclude_zero: bool = False
    short_line_thr: float = 0.0
    short_line_length: int = 0
    char_duplicates_ratio: float = 0.0
    new_line_ratio: float = 0.0
    stop_chars: Optional[List[str]] = None

    def validate(self) -> None:
        params = (
            ("line_punct_thr", self.line_punct_thr),
            ("short_line_thr", self.short_line_thr),
            ("char_duplicates_ratio", self.char_duplicates_ratio),
            ("new_line_ratio", self.new_line_ratio),
        )
        for name, value in params:
            if not (0.0 <= value <= 1.0):
                raise ConfigValidationError(
                    f"FineWebQualityFilterParams: {name} must be between 0.0 and "
                    f"1.0, got {value}"
                )
        if self.short_line_length == 0:
            raise ConfigValidationError(
                "FineWebQualityFilterParams: short_line_length must be greater than 0"
            )


@dataclass
class TokenCounterParams:
    """pipeline.rs:351-368"""

    tokenizer_name: str

    def validate(self) -> None:
        if not self.tokenizer_name:
            raise ConfigValidationError(
                "TokenCounterParams: tokenizer_name cannot be empty"
            )


_PARAM_TYPES = {
    "C4QualityFilter": C4QualityParams,
    "GopherRepetitionFilter": GopherRepetitionParams,
    "GopherQualityFilter": GopherQualityParams,
    "C4BadWordsFilter": C4BadWordsParams,
    "LanguageDetectionFilter": LanguageDetectionParams,
    "FineWebQualityFilter": FineWebQualityFilterParams,
    "TokenCounter": TokenCounterParams,
}

_REQUIRED_FIELDS = {
    "C4QualityFilter": (
        "split_paragraph",
        "remove_citations",
        "filter_no_terminal_punct",
        "min_num_sentences",
        "min_words_per_line",
        "max_word_length",
        "filter_lorem_ipsum",
        "filter_javascript",
        "filter_curly_bracket",
        "filter_policy",
    ),
    "GopherRepetitionFilter": (),
    "GopherQualityFilter": (),
    "C4BadWordsFilter": ("keep_fraction", "fail_on_missing_language", "default_language"),
    "LanguageDetectionFilter": ("min_confidence", "allowed_languages"),
    "FineWebQualityFilter": (
        "line_punct_thr",
        "line_punct_exclude_zero",
        "short_line_thr",
        "short_line_length",
        "char_duplicates_ratio",
        "new_line_ratio",
    ),
    "TokenCounter": ("tokenizer_name",),
}

# Fields serde skips during deserialization (pipeline.rs:266-267).
_SKIPPED_FIELDS = {"C4BadWordsFilter": ("cache_base_path",)}


@dataclass
class ResilienceConfig:
    """Fault-tolerance knobs for the execution layer (no reference
    equivalent — the reference leans on RabbitMQ redelivery).

    Parsed from an optional top-level ``resilience:`` mapping in the pipeline
    YAML.  Deliberately excluded from the checkpoint config fingerprint
    (checkpoint.py hashes ``config.pipeline`` only): retry budgets do not
    change outcomes, so tuning them must not invalidate a resumable run.
    """

    max_retries: int = 3          # re-attempts after the first try, per seam
    backoff_base_s: float = 0.05  # first backoff delay
    backoff_max_s: float = 2.0    # backoff cap
    backoff_multiplier: float = 2.0
    jitter: float = 0.5           # each delay widened by up to this fraction
    breaker_threshold: int = 3    # consecutive device failures before the trip
    breaker_cooldown_s: float = 30.0  # open time before a half-open probe;
    #                                   0 latches open for the run's life
    split_retry: bool = True      # enable the split-in-half OOM rung
    # Stall-watchdog deadline per host-side stage (device fetch, pack wait,
    # write queue, reader prefetch), in seconds.  0 (the default) disarms
    # the watchdog entirely — every seam keeps its historical unbounded
    # wait and pays one attribute check.  Scheduling-only like the rest of
    # this mapping: a stall degrades *where* work runs, never what it
    # decides, so it stays out of the checkpoint fingerprint and AOT keys.
    stage_deadline_s: float = 0.0

    def validate(self) -> None:
        if self.max_retries < 0:
            raise ConfigValidationError(
                "ResilienceConfig: max_retries must be non-negative"
            )
        for name, val in (
            ("backoff_base_s", self.backoff_base_s),
            ("backoff_max_s", self.backoff_max_s),
            ("jitter", self.jitter),
        ):
            if val < 0.0:
                raise ConfigValidationError(
                    f"ResilienceConfig: {name} must be non-negative, got {val}"
                )
        if self.backoff_multiplier < 1.0:
            raise ConfigValidationError(
                "ResilienceConfig: backoff_multiplier must be >= 1.0, "
                f"got {self.backoff_multiplier}"
            )
        if self.breaker_threshold < 1:
            raise ConfigValidationError(
                "ResilienceConfig: breaker_threshold must be >= 1, "
                f"got {self.breaker_threshold}"
            )
        if self.breaker_cooldown_s < 0.0:
            raise ConfigValidationError(
                "ResilienceConfig: breaker_cooldown_s must be non-negative, "
                f"got {self.breaker_cooldown_s}"
            )
        if self.stage_deadline_s < 0.0:
            raise ConfigValidationError(
                "ResilienceConfig: stage_deadline_s must be non-negative, "
                f"got {self.stage_deadline_s}"
            )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ResilienceConfig":
        if not isinstance(d, dict):
            raise ConfigError("`resilience` must be a mapping")
        known = set(cls.__dataclass_fields__)
        # serde-without-deny_unknown_fields parity: extra keys are ignored.
        fields_d = {k: v for k, v in d.items() if k in known}
        try:
            return cls(**fields_d)
        except TypeError as e:
            raise ConfigError(f"invalid resilience config: {e}") from e


@dataclass
class OverlapConfig:
    """Host-pipeline overlap knobs for the device backend (no reference
    equivalent — the reference's workers are synchronous per message).

    Parsed from an optional top-level ``overlap:`` mapping in the pipeline
    YAML.  Like ``resilience``, excluded from the checkpoint config
    fingerprint (checkpoint.py hashes ``config.pipeline`` only): overlap
    changes wall time, never outcomes, so tuning it must not invalidate a
    resumable run.
    """

    enabled: bool = True       # --no-overlap forces False
    pipeline_depth: int = 2    # device batches kept in flight (1 = serial)
    pack_workers: int = 2      # threads over the GIL-releasing pack work
    read_ahead: int = 4        # Parquet read-ahead queue, in read batches
    write_queue: int = 8       # writer-thread queue, in outcome batches
    overflow_flush: int = 64   # host-fallback docs buffered before a flush
    # Multi-host speculative cross-phase dispatch: next-phase rounds this
    # host will launch at a phase barrier before the tail verdicts resolve
    # (--speculate-depth).  None follows pipeline_depth; 0 opts out, which
    # min-negotiates the WHOLE gang onto the classic barrier — same as
    # TEXTBLAST_SPECULATE=off.  Single-host runs ignore it.
    speculate_depth: Optional[int] = None

    def validate(self) -> None:
        for name, val, lo in (
            ("pipeline_depth", self.pipeline_depth, 1),
            ("pack_workers", self.pack_workers, 1),
            ("read_ahead", self.read_ahead, 1),
            ("write_queue", self.write_queue, 1),
            ("overflow_flush", self.overflow_flush, 1),
        ):
            if val < lo:
                raise ConfigValidationError(
                    f"OverlapConfig: {name} must be >= {lo}, got {val}"
                )
        if self.speculate_depth is not None and self.speculate_depth < 0:
            raise ConfigValidationError(
                "OverlapConfig: speculate_depth must be >= 0 (0 disables "
                f"speculation), got {self.speculate_depth}"
            )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OverlapConfig":
        if not isinstance(d, dict):
            raise ConfigError("`overlap` must be a mapping")
        known = set(cls.__dataclass_fields__)
        # serde-without-deny_unknown_fields parity: extra keys are ignored.
        fields_d = {k: v for k, v in d.items() if k in known}
        try:
            return cls(**fields_d)
        except TypeError as e:
            raise ConfigError(f"invalid overlap config: {e}") from e


@dataclass
class SLOConfig:
    """Service-level objectives for the run (no reference equivalent).

    Parsed from an optional top-level ``slo:`` mapping in the pipeline
    YAML: objective keys map directly to targets, engine knobs ride in
    the same mapping::

        slo:
          availability: 0.999
          p99_latency_s: 0.25
          fast_window_s: 30

    ``--slo KEY=TARGET`` on the command line overrides per key.  Like
    ``resilience`` and ``overlap``, excluded from the checkpoint config
    fingerprint (checkpoint.py hashes ``config.pipeline`` only):
    objectives judge a run, they never change its outputs.
    """

    objectives: Dict[str, float] = field(default_factory=dict)
    fast_window_s: float = 60.0     # fast burn-rate window
    slow_window_s: float = 300.0    # slow burn-rate window
    burn_threshold: float = 1.0     # alert iff BOTH windows burn above this
    tick_s: float = 5.0             # evaluation cadence

    #: Engine knobs that live beside the objectives in the ``slo:`` block.
    _KNOBS = ("fast_window_s", "slow_window_s", "burn_threshold", "tick_s")

    def validate(self) -> None:
        for key, target in self.objectives.items():
            if key not in SLO_KEYS:
                raise ConfigValidationError(
                    f"SLOConfig: unknown objective {key!r} "
                    f"(keys: {', '.join(SLO_KEYS)})"
                )
            try:
                target = float(target)
            except (TypeError, ValueError):
                raise ConfigValidationError(
                    f"SLOConfig: target for {key} must be a number, "
                    f"got {target!r}"
                )
            if key == "availability" and not 0.0 < target <= 1.0:
                raise ConfigValidationError(
                    "SLOConfig: availability target must be in (0, 1], "
                    f"got {target}"
                )
            if key != "availability" and target <= 0:
                raise ConfigValidationError(
                    f"SLOConfig: {key} target must be > 0, got {target}"
                )
        for name in ("fast_window_s", "slow_window_s", "tick_s"):
            if getattr(self, name) <= 0:
                raise ConfigValidationError(
                    f"SLOConfig: {name} must be positive, "
                    f"got {getattr(self, name)}"
                )
        if self.burn_threshold <= 0:
            raise ConfigValidationError(
                "SLOConfig: burn_threshold must be positive, "
                f"got {self.burn_threshold}"
            )
        if self.fast_window_s > self.slow_window_s:
            raise ConfigValidationError(
                "SLOConfig: fast_window_s must not exceed slow_window_s "
                f"({self.fast_window_s} > {self.slow_window_s})"
            )

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLOConfig":
        if not isinstance(d, dict):
            raise ConfigError("`slo` must be a mapping")
        knobs = {k: v for k, v in d.items() if k in cls._KNOBS}
        objectives = {
            k: v for k, v in d.items() if k not in cls._KNOBS
        }
        try:
            return cls(
                objectives={k: float(v) for k, v in objectives.items()},
                **{k: float(v) for k, v in knobs.items()},
            )
        except (TypeError, ValueError) as e:
            raise ConfigError(f"invalid slo config: {e}") from e


@dataclass
class StepConfig:
    """One pipeline step: a type tag + typed params (pipeline.rs:26-64)."""

    type: str
    params: Any

    @property
    def name(self) -> str:
        return self.type

    def validate(self) -> None:
        self.params.validate()

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StepConfig":
        if not isinstance(d, dict) or "type" not in d:
            raise ConfigError("pipeline step is missing the `type` tag")
        step_type = d["type"]
        if step_type not in _PARAM_TYPES:
            raise ConfigError(
                f"unknown variant `{step_type}`, expected one of "
                + ", ".join(f"`{t}`" for t in _PARAM_TYPES)
            )
        fields_d = {k: v for k, v in d.items() if k != "type"}
        for skipped in _SKIPPED_FIELDS.get(step_type, ()):
            fields_d.pop(skipped, None)
        for req in _REQUIRED_FIELDS[step_type]:
            _require(fields_d, req, step_type)
        param_cls = _PARAM_TYPES[step_type]
        # serde without deny_unknown_fields silently ignores extra keys
        # (pipeline.rs:26-37) — e.g. legacy `language:` keys in FineWeb steps.
        known = set(param_cls.__dataclass_fields__)
        fields_d = {k: v for k, v in fields_d.items() if k in known}
        # Normalize [ [n, frac], ... ] lists into tuples.
        for key in ("top_n_grams", "dup_n_grams"):
            if key in fields_d and fields_d[key] is not None:
                try:
                    fields_d[key] = [(int(n), float(f)) for n, f in fields_d[key]]
                except (TypeError, ValueError) as e:
                    raise ConfigError(
                        f"invalid {key} for step {step_type}: {e}"
                    ) from e
        try:
            params = param_cls(**fields_d)
        except TypeError as e:
            raise ConfigError(f"invalid params for step {step_type}: {e}") from e
        return cls(type=step_type, params=params)


@dataclass
class PipelineConfig:
    """pipeline.rs:10-22 (+ the optional resilience section, ours only)."""

    pipeline: List[StepConfig]
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    overlap: OverlapConfig = field(default_factory=OverlapConfig)
    slo: SLOConfig = field(default_factory=SLOConfig)

    def validate(self) -> None:
        for step in self.pipeline:
            step.validate()
        self.resilience.validate()
        self.overlap.validate()
        self.slo.validate()

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PipelineConfig":
        if not isinstance(d, dict) or "pipeline" not in d:
            raise ConfigError("missing field `pipeline`")
        steps_raw = d["pipeline"]
        if steps_raw is None or not isinstance(steps_raw, list):
            raise ConfigError("`pipeline` must be a list of steps")
        resilience_raw = d.get("resilience")
        overlap_raw = d.get("overlap")
        slo_raw = d.get("slo")
        return cls(
            pipeline=[StepConfig.from_dict(s) for s in steps_raw],
            resilience=(
                ResilienceConfig.from_dict(resilience_raw)
                if resilience_raw is not None
                else ResilienceConfig()
            ),
            overlap=(
                OverlapConfig.from_dict(overlap_raw)
                if overlap_raw is not None
                else OverlapConfig()
            ),
            slo=(
                SLOConfig.from_dict(slo_raw)
                if slo_raw is not None
                else SLOConfig()
            ),
        )


def parse_pipeline_config(content: str, origin: str = "<string>") -> PipelineConfig:
    """Parse + validate YAML content (split out for broker-free tests)."""
    try:
        raw = yaml.safe_load(content)
    except yaml.YAMLError as e:
        raise ConfigError(
            f"Failed to parse pipeline config YAML from '{origin}': {e}"
        ) from e
    try:
        config = PipelineConfig.from_dict(raw if raw is not None else {})
    except ConfigError as e:
        raise ConfigError(
            f"Failed to parse pipeline config YAML from '{origin}': {e.args[0]}"
        ) from e
    config.validate()
    return config


def load_pipeline_config(config_path: str | Path) -> PipelineConfig:
    """Load and parse a pipeline YAML (pipeline.rs:372-393)."""
    path = Path(config_path)
    try:
        content = path.read_text(encoding="utf-8")
    except OSError as e:
        raise ConfigError(
            f"Failed to read pipeline config file '{path}': {e}"
        ) from e
    return parse_pipeline_config(content, origin=str(path))
