"""The device filter pipeline: config -> one eager function per (bucket, phase).

The port's counterpart of ``textblaster_tpu/ops/pipeline.py``
(``CompiledPipeline``, ``process_documents_device``).  Every step's integer
statistics are computed on the device for a packed batch; order,
short-circuiting, metadata stamps and reason strings are resolved on the
host in float64, identical to the host oracle filters.  Documents that
overflow a kernel table bound, that are longer than the largest bucket, or
that contain dictionary-segmented scripts are decided by the host oracle
(counted in :attr:`CompiledPipeline.counters`).

The statistic functions run one of the JAX package's three schedules
(:mod:`.stats`): the *chain* schedule by default, which evaluates each of
eight sites' dependent scans in one ``chain_scan`` launch at buckets up to
16384; the *fused* schedule under ``TEXTBLAST_DEPFUSE=off``, one
``fused_scan`` launch of independent scans per function; or the *staged*
schedule under ``TEXTBLAST_FUSED=off``.  All give the same statistics.
:attr:`CompiledPipeline.counters` ``["launches"]`` counts the hand-written
kernels' launches by kernel.

Batches run serially: one at a time, survivors repacked between phases.
Uploads are int32.  Not ported yet: C4BadWords on the device (it runs as a
host step), the uint16 wire, the K-deep overlap window, the
retry/split/host ladder, meshes and warmup.
"""

from __future__ import annotations

import logging
import time
from itertools import islice
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config.pipeline import PipelineConfig, StepConfig
from ..data_model import ProcessingOutcome, TextDocument
from ..errors import PipelineError
from ..filters.c4_quality import CITATION_RE
from ..filters.common import fmt2, fmt4, rust_bool, rust_float, rust_lines
from ..filters.fineweb_quality import DEFAULT_STOP_CHARS
from ..filters.gopher_quality import DEFAULT_STOP_WORDS
from ..models.langid import ISO_TO_NAME, LANGUAGES, NAME_TO_ISO, LangIdModel
from ..orchestration import execute_processing_pipeline
from ..pipeline_builder import build_pipeline_from_config
from .geometry import DeviceGeometry
from .langid_device import langid_scores
from . import scan, sort
from .packing import DEFAULT_BUCKETS, PACK_MARGIN, PackedBatch, iter_packed_batches
from .stats import (
    C4Params,
    c4_stage,
    fineweb_stats,
    gopher_quality_stats,
    gopher_rep_stats,
    hash_string,
    structure,
)

logger = logging.getLogger(__name__)

__all__ = [
    "CompiledPipeline",
    "process_documents_device",
    "default_batch_size",
    "resolve_device",
]

#: Step types with a device implementation in this slice.  C4BadWordsFilter
#: is not ported yet: where it appears it runs on the host (as a suffix, or
#: the whole pipeline falls back to the host when it precedes device steps).
_DEVICE_STEPS = {
    "LanguageDetectionFilter",
    "GopherRepetitionFilter",
    "GopherQualityFilter",
    "C4QualityFilter",
    "FineWebQualityFilter",
}

# Step types that cheaply kill many documents: a phase boundary after them
# lets the runner repack survivors and skip the expensive downstream work
# for already-filtered rows.
_PHASE_BOUNDARY_AFTER = frozenset({"LanguageDetectionFilter", "GopherQualityFilter"})

# Steps whose decisions depend on word segmentation — the steps that force
# dictionary-script documents onto the host oracle.
_WORD_TABLE_STEPS = frozenset(
    {
        "GopherRepetitionFilter",
        "GopherQualityFilter",
        "C4QualityFilter",
        "FineWebQualityFilter",
    }
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "textblaster_tpu_torch: CUDA is not available; pass device='cpu' "
            "(--device cpu) to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _table_sizes(length: int) -> Tuple[int, int]:
    """(max line/para slots, max word slots) for a bucket of ``length``.

    Word slots assume >= 4 chars per word+separator on average; denser docs
    hit ``word_overflow`` and take the (counted, bit-exact) host fallback."""
    max_lines = min(length, max(128, length // 8))
    max_words = min(16384, max(256, length // 4))
    return max_lines, max_words


def default_batch_size(buckets=DEFAULT_BUCKETS, device="cuda") -> int:
    """Rows per device batch when the caller didn't choose.

    CUDA starts from the JAX package's accelerator branch
    (``pipeline.py:255``): the round-1024 heuristic scaled down for wide
    buckets, so a batch stays ~8 MB of int32 codepoints — 64 rows at the
    default 65536-char top bucket.  The CPU keeps the JAX package's
    cache-residency branch."""
    max_bucket = max(buckets)
    if torch.device(device).type == "cpu":
        return max(8, min(256, (64 * 2048) // max_bucket))
    return max(64, min(1024, (1024 * 2048) // max_bucket))


def _split_phases(steps: List[StepConfig]) -> List[List[int]]:
    phases: List[List[int]] = []
    cur: List[int] = []
    for i, s in enumerate(steps):
        cur.append(i)
        if s.type in _PHASE_BOUNDARY_AFTER and i < len(steps) - 1:
            phases.append(cur)
            cur = []
    if cur:
        phases.append(cur)
    return phases or [[]]


class _Decision:
    """Host-side result for one step on one doc."""

    __slots__ = ("passed", "reason", "stamps", "extra")

    def __init__(self, passed: bool, reason: str = "", stamps=None, extra=None):
        self.passed = passed
        self.reason = reason
        self.stamps = stamps or []  # list[(key, value)] in stamp order
        self.extra = extra


class _StepEval:
    """Batch-vectorized verdicts for one step."""

    __slots__ = (
        "passed",
        "overflow",
        "decide",
        "pass_stamps",
        "pass_stamp_fn",
        "c4_line_keep",
        "c4_n_lines",
        "c4_rewrite_identity",
    )

    def __init__(self, passed, decide, pass_stamps, overflow=None):
        self.passed = passed
        self.overflow = overflow
        self.decide = decide
        # Constant stamps for passing rows; None means passing rows need
        # pass_stamp_fn (per-row stamps from batch-precomputed arrays).
        self.pass_stamps = pass_stamps
        self.pass_stamp_fn = None
        self.c4_line_keep = None
        self.c4_n_lines = None
        self.c4_rewrite_identity = None


def _launch_counts() -> Dict[str, int]:
    return {**scan.LAUNCHES, **sort.LAUNCHES}


def _new_counters() -> Dict[str, object]:
    return {
        "batches_by_bucket": {},  # (bucket) -> device batches, all phases
        # Hand-written kernel launches by kernel (0 on the CPU, where the
        # wrappers run their plain versions).
        "launches": {k: 0 for k in _launch_counts()},
        "device_rows": 0,  # real documents sent to the device, all phases
        "host_fallback": 0,  # over-length, dictionary-script and overflow rows
        "host_routed_dict_script": 0,
        "host_overflow": 0,
        # Host-clock seconds: upload + device functions + download per phase
        # (the download waits for the device), host assembly, host routes.
        "seconds": {"device": {}, "assemble": 0.0, "host_routes": 0.0},
    }


class CompiledPipeline:
    """A pipeline config set up for device execution on ``device``."""

    def __init__(
        self,
        config: PipelineConfig,
        buckets=DEFAULT_BUCKETS,
        batch_size: Optional[int] = None,
        device=None,
    ) -> None:
        self.config = config
        self.device = resolve_device(device)
        bs = tuple(sorted(buckets))
        if not batch_size:
            batch_size = default_batch_size(bs, self.device)
        self.geometry = DeviceGeometry.uniform(bs, batch_size)
        self.buckets = self.geometry.buckets
        self.batch_size = self.geometry.max_batch

        steps = list(config.pipeline)
        n_device = 0
        for s in steps:
            if s.type not in _DEVICE_STEPS:
                break
            n_device += 1
        self.device_steps = steps[:n_device]
        self.host_steps = steps[n_device:]
        # Host-only fallback when un-ported steps precede device steps.
        self.fully_host = any(s.type in _DEVICE_STEPS for s in self.host_steps)

        # Documents containing dictionary-segmented scripts (Han/kana/Thai…)
        # are decided by the host oracle whenever a word-table step runs on
        # the device: the host word splitter approximates ICU's dictionary
        # segmentation for them, which the run-whole device tables cannot.
        self._route_dict_scripts = any(
            s.type in _WORD_TABLE_STEPS for s in self.device_steps
        )

        self.phases = _split_phases(self.device_steps)
        # A content-rewriting step must sit in the final phase.
        if any(
            self.device_steps[i].type == "C4QualityFilter"
            for ph in self.phases[:-1]
            for i in ph
        ):
            self.phases = [list(range(len(self.device_steps)))]

        self._host_executor = None
        self._host_suffix_executor = None
        self._fns: Dict[Tuple[int, int], Callable] = {}
        self.counters = _new_counters()

    # --- host executors -----------------------------------------------------

    @property
    def host_executor(self):
        if self._host_executor is None:
            self._host_executor = build_pipeline_from_config(self.config)
        return self._host_executor

    @property
    def host_suffix_executor(self):
        if self._host_suffix_executor is None:
            from ..executor import PipelineExecutor
            from ..pipeline_builder import build_step

            self._host_suffix_executor = PipelineExecutor(
                [build_step(s) for s in self.host_steps]
            )
        return self._host_suffix_executor

    # --- device program -----------------------------------------------------

    def _build_fn(self, length: int, phase: int = 0) -> Callable:
        """The eager device function of one (bucket length, phase):
        ``fn(cps [B, L] int32, lengths [B] int32) -> {"{step}:{stat}": tensor}``
        — the same keys and values as the JAX package's ``_build_fn``."""
        max_lines, max_words = _table_sizes(length)
        plans = []
        for i in self.phases[phase]:
            step = self.device_steps[i]
            p = step.params
            if step.type == "LanguageDetectionFilter":
                plans.append(("langid", i, None))
            elif step.type == "GopherQualityFilter":
                stop_words = (
                    p.stop_words if p.stop_words is not None else list(DEFAULT_STOP_WORDS)
                )
                hashes = tuple(sorted({hash_string(w) for w in stop_words}))
                plans.append(("gopher_quality", i, hashes))
            elif step.type == "GopherRepetitionFilter":
                plans.append(
                    (
                        "gopher_rep",
                        i,
                        (
                            tuple(n for n, _ in p.top_n_grams),
                            tuple(n for n, _ in p.dup_n_grams),
                        ),
                    )
                )
            elif step.type == "C4QualityFilter":
                plans.append(
                    (
                        "c4",
                        i,
                        C4Params(
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
                        ),
                    )
                )
            elif step.type == "FineWebQualityFilter":
                stop_chars = (
                    tuple(sorted(p.stop_chars))
                    if p.stop_chars is not None
                    else tuple(sorted(DEFAULT_STOP_CHARS))
                )
                plans.append(("fineweb", i, (stop_chars, p.short_line_length)))

        # Unit hashes are consumed only by the Gopher steps.
        needs_hashes = any(kind in ("gopher_quality", "gopher_rep") for kind, _, _ in plans)

        def fn(cps: torch.Tensor, lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
            out: Dict[str, torch.Tensor] = {}
            state = {"cps": cps, "lengths": lengths, "st": None}

            def get_structure():
                if state["st"] is None:
                    state["st"] = structure(
                        state["cps"], state["lengths"], with_hashes=needs_hashes
                    )
                return state["st"]

            for kind, i, arg in plans:
                if kind == "langid":
                    scores, n_grams = langid_scores(state["cps"], state["lengths"])
                    out[f"{i}:scores"] = scores
                    out[f"{i}:n_grams"] = n_grams
                elif kind == "gopher_quality":
                    for k, v in gopher_quality_stats(get_structure(), arg).items():
                        out[f"{i}:{k}"] = v
                elif kind == "gopher_rep":
                    top_ns, dup_ns = arg
                    stats = gopher_rep_stats(
                        get_structure(), top_ns, dup_ns, max_lines, max_words
                    )
                    for k, v in stats.items():
                        out[f"{i}:{k}"] = v
                elif kind == "c4":
                    stats, new_cps, new_lengths = c4_stage(
                        state["cps"], state["lengths"], arg, max_lines
                    )
                    for k, v in stats.items():
                        out[f"{i}:{k}"] = v
                    # Downstream steps see the rewritten batch.
                    state.update(cps=new_cps, lengths=new_lengths, st=None)
                elif kind == "fineweb":
                    stop_chars, short_len = arg
                    fw = fineweb_stats(get_structure(), stop_chars, max_lines, short_len)
                    for k, v in fw.items():
                        out[f"{i}:{k}"] = v
            return out

        return fn

    def _fn_for(self, length: int, phase: int = 0) -> Callable:
        key = (length, phase)
        if key not in self._fns:
            self._fns[key] = self._build_fn(length, phase)
        return self._fns[key]

    def dispatch_batch(self, batch: PackedBatch, phase: int = 0) -> Dict[str, torch.Tensor]:
        """Upload one packed batch (int32) and run its (bucket, phase)
        function; the returned stats stay on the device."""
        fn = self._fn_for(batch.max_len, phase)
        cps = torch.from_numpy(np.ascontiguousarray(batch.cps, dtype=np.int32))
        lengths = torch.from_numpy(np.ascontiguousarray(batch.lengths, dtype=np.int32))
        if self.device.type == "cuda":
            cps = cps.pin_memory().to(self.device, non_blocking=True)
            lengths = lengths.to(self.device)
        buckets = self.counters["batches_by_bucket"]
        buckets[batch.max_len] = buckets.get(batch.max_len, 0) + 1
        self.counters["device_rows"] += len(batch.docs)
        before = _launch_counts()
        stats = fn(cps, lengths)
        launches = self.counters["launches"]
        for k, n in _launch_counts().items():
            launches[k] += n - before[k]
        return stats

    @staticmethod
    def fetch(stats: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Device stats -> host numpy arrays."""
        return {k: v.cpu().numpy() for k, v in stats.items()}

    # --- host finalizers ----------------------------------------------------
    # Each maps the integer stats of one step to batch verdicts with the
    # host oracle's float64 arithmetic; per-row Python only formats reason
    # strings and stamps for the rows that need them.

    def _eval_step(self, step: StepConfig, idx: int, stats: Dict[str, np.ndarray]):
        try:
            fn = _EVALS[step.type]
        except KeyError:
            raise PipelineError(f"no finalizer for step {step.type}") from None
        return fn(self, step, idx, stats)

    def _eval_langid(self, step: StepConfig, idx: int, stats) -> "_StepEval":
        p = step.params
        scores = np.asarray(stats[f"{idx}:scores"])
        n_grams = np.asarray(stats[f"{idx}:n_grams"]).astype(np.int64)
        best, conf = LangIdModel.decide_batch(scores, n_grams)

        valid = n_grams > 0
        allowed = [c for c in p.allowed_languages if c in ISO_TO_NAME]
        lang_allowed = np.array(
            [NAME_TO_ISO[lang] in allowed for lang in LANGUAGES], dtype=bool
        )[best]
        conf_ok = conf >= p.min_confidence
        passed = valid & lang_allowed & conf_ok
        joined = "; ".join(allowed)

        def decide(row: int, doc: TextDocument) -> _Decision:
            if not valid[row]:
                return _Decision(False, "Language could not be confidently detected")
            stamps = [
                ("Detected language", LANGUAGES[best[row]]),
                ("Detected language confidence", rust_float(conf[row])),
            ]
            if not lang_allowed[row]:
                return _Decision(
                    False,
                    f'Document is not any of the following languages: "{joined}"',
                    stamps,
                )
            if not conf_ok[row]:
                return _Decision(
                    False,
                    "Language detection confidence is not satified: "
                    f"{rust_float(conf[row])} < {rust_float(p.min_confidence)}",
                    stamps,
                )
            return _Decision(True, stamps=stamps)

        ev = _StepEval(passed=passed, decide=decide, pass_stamps=None)
        lang_names = np.asarray(LANGUAGES, dtype=object)[best]

        def pass_stamp_fn(row: int, doc: TextDocument) -> None:
            doc.metadata["Detected language"] = lang_names[row]
            doc.metadata["Detected language confidence"] = rust_float(conf[row])

        ev.pass_stamp_fn = pass_stamp_fn
        return ev

    def _eval_gopher_rep(self, step: StepConfig, idx: int, stats) -> "_StepEval":
        p = step.params
        g = lambda key: np.asarray(stats[f"{idx}:{key}"]).astype(np.int64)  # noqa: E731
        overflow = np.asarray(stats[f"{idx}:seg_overflow"], dtype=bool) | np.asarray(
            stats[f"{idx}:word_overflow"], dtype=bool
        )
        trimmed = g("trimmed_len")
        empty = trimmed == 0
        char_len = np.maximum(trimmed, 1).astype(np.float64)

        checks = []

        def add(cond, ratio, label, thr):
            checks.append((cond, ratio, label, thr))

        ratio = g("para_dup_elems") / np.maximum(g("n_paragraphs"), 1)
        if p.dup_para_frac is not None:
            add(ratio > p.dup_para_frac, ratio, "dup_para_frac", p.dup_para_frac)
        ratio = g("para_dup_bytes") / char_len
        if p.dup_para_char_frac is not None:
            add(ratio > p.dup_para_char_frac, ratio, "dup_para_char_frac",
                p.dup_para_char_frac)
        ratio = g("line_dup_elems") / np.maximum(g("n_lines"), 1)
        if p.dup_line_frac is not None:
            add(ratio > p.dup_line_frac, ratio, "dup_line_frac", p.dup_line_frac)
        ratio = g("line_dup_bytes") / char_len
        if p.dup_line_char_frac is not None:
            add(ratio > p.dup_line_char_frac, ratio, "dup_line_char_frac",
                p.dup_line_char_frac)
        for n, thr in p.top_n_grams:
            if n > 0:
                ratio = g(f"top_{n}") / char_len
                add(ratio > thr, ratio, f"top_{n}_gram", thr)
        for n, thr in p.dup_n_grams:
            if n > 0:
                ratio = g(f"dup_{n}") / char_len
                add(ratio > thr, ratio, f"duplicated_{n}_n_grams", thr)

        any_cond = empty.copy()
        for cond, _, _, _ in checks:
            any_cond |= cond
        passed = ~any_cond

        def decide(row: int, doc: TextDocument) -> _Decision:
            if empty[row]:
                return _Decision(
                    False,
                    "skipping empty content",
                    [
                        ("gopher_repetition_filter_status", "filtered"),
                        ("gopher_repetition_filter_reason", "skipping empty content"),
                    ],
                )
            reasons = [
                f"{label} (ratio {fmt2(ratio[row])}, max {fmt2(thr)})"
                for cond, ratio, label, thr in checks
                if cond[row]
            ]
            rs = "; ".join(reasons)
            return _Decision(
                False,
                rs,
                [
                    ("gopher_repetition_filter_status", "filtered"),
                    ("gopher_repetition_filter_reasons", rs),
                ],
            )

        return _StepEval(
            passed=passed,
            overflow=overflow,
            decide=decide,
            pass_stamps=(("gopher_repetition_filter_status", "passed"),),
        )

    def _eval_gopher_quality(self, step: StepConfig, idx: int, stats) -> "_StepEval":
        p = step.params
        g = lambda key: np.asarray(stats[f"{idx}:{key}"]).astype(np.int64)  # noqa: E731
        n_non_symbol = g("n_non_symbol")
        n_words = g("n_words")
        sum_len = g("sum_word_len")
        avg = np.zeros(len(n_words), dtype=np.float64)
        np.divide(sum_len, n_non_symbol, out=avg, where=n_non_symbol > 0)
        n_total = np.maximum(n_words, 1).astype(np.float64)
        hash_ratio = g("hash_count") / n_total
        ellipsis_ratio = g("ellipsis_units") / n_total
        n_lines_f = np.maximum(g("n_lines"), 1).astype(np.float64)
        bullet_ratio = g("bullet_lines") / n_lines_f
        ell_lines_ratio = g("ellipsis_lines") / n_lines_f
        alpha_ratio = g("alpha_words") / n_total
        stop_count = g("stop_words")

        # (cond [B], reason_fn(row) -> str) in the oracle's check order.
        checks = []
        if p.min_doc_words is not None:
            checks.append(
                (
                    n_non_symbol < p.min_doc_words,
                    lambda r: f"gopher_short_doc ({n_non_symbol[r]} non-symbol words, "
                    f"required {p.min_doc_words})",
                )
            )
        if p.max_doc_words is not None:
            checks.append(
                (
                    n_non_symbol > p.max_doc_words,
                    lambda r: f"gopher_long_doc ({n_non_symbol[r]} non-symbol words, "
                    f"max {p.max_doc_words})",
                )
            )
        if p.min_avg_word_length is not None:

            def _below_avg(r: int) -> str:
                suffix = (
                    " - 0 non-symbol words"
                    if n_non_symbol[r] == 0 and p.min_avg_word_length > 0.0
                    else ""
                )
                return (
                    f"gopher_below_avg_threshold (avg len {fmt2(avg[r])}, "
                    f"required {fmt2(p.min_avg_word_length)}{suffix})"
                )

            checks.append((avg < p.min_avg_word_length, _below_avg))
        if p.max_avg_word_length is not None:
            checks.append(
                (
                    (n_non_symbol > 0) & (avg > p.max_avg_word_length),
                    lambda r: f"gopher_above_avg_threshold (avg len {fmt2(avg[r])}, "
                    f"max {fmt2(p.max_avg_word_length)})",
                )
            )
        if p.max_symbol_word_ratio is not None:
            checks.append(
                (
                    hash_ratio > p.max_symbol_word_ratio,
                    lambda r: f"gopher_too_many_hashes (ratio {fmt2(hash_ratio[r])}, "
                    f"max {fmt2(p.max_symbol_word_ratio)})",
                )
            )
            checks.append(
                (
                    ellipsis_ratio > p.max_symbol_word_ratio,
                    lambda r: "gopher_too_many_ellipsis_units "
                    f"(ratio {fmt2(ellipsis_ratio[r])}, "
                    f"max {fmt2(p.max_symbol_word_ratio)})",
                )
            )
        if p.max_bullet_lines_ratio is not None:
            checks.append(
                (
                    bullet_ratio > p.max_bullet_lines_ratio,
                    lambda r: f"gopher_too_many_bullets (ratio {fmt2(bullet_ratio[r])}, "
                    f"max {fmt2(p.max_bullet_lines_ratio)})",
                )
            )
        if p.max_ellipsis_lines_ratio is not None:
            checks.append(
                (
                    ell_lines_ratio > p.max_ellipsis_lines_ratio,
                    lambda r: "gopher_too_many_end_ellipsis_lines "
                    f"(ratio {fmt2(ell_lines_ratio[r])}, "
                    f"max {fmt2(p.max_ellipsis_lines_ratio)})",
                )
            )
        if p.max_non_alpha_words_ratio is not None:
            checks.append(
                (
                    alpha_ratio < p.max_non_alpha_words_ratio,
                    lambda r: "gopher_below_alpha_threshold "
                    f"(alpha ratio {fmt2(alpha_ratio[r])}, "
                    f"required min {fmt2(p.max_non_alpha_words_ratio)})",
                )
            )
        if p.min_stop_words is not None and p.min_stop_words > 0:
            checks.append(
                (
                    stop_count < p.min_stop_words,
                    lambda r: f"gopher_too_few_stop_words (found {stop_count[r]}, "
                    f"required {p.min_stop_words})",
                )
            )

        any_cond = np.zeros(len(n_words), dtype=bool)
        for cond, _ in checks:
            any_cond |= cond
        passed = ~any_cond

        def decide(row: int, doc: TextDocument) -> _Decision:
            rs = "; ".join(fn(row) for cond, fn in checks if cond[row])
            return _Decision(
                False,
                rs,
                [
                    ("gopher_quality_filter_status", "filtered"),
                    ("gopher_quality_filter_reasons", rs),
                ],
            )

        return _StepEval(
            passed=passed,
            decide=decide,
            pass_stamps=(("gopher_quality_filter_status", "passed"),),
        )

    def _eval_c4(self, step: StepConfig, idx: int, stats) -> "_StepEval":
        p = step.params
        overflow = np.asarray(stats[f"{idx}:line_overflow"], dtype=bool)
        rewrite_identity = np.asarray(stats[f"{idx}:rewrite_identity"], dtype=bool)
        lorem = np.asarray(stats[f"{idx}:has_lorem"], dtype=bool)
        curly = np.asarray(stats[f"{idx}:has_curly"], dtype=bool)
        early = lorem | curly
        n_sent = np.asarray(stats[f"{idx}:n_sentences"]).astype(np.int64)
        n_lines = np.asarray(stats[f"{idx}:n_lines"]).astype(np.int64)
        line_keep = np.asarray(stats[f"{idx}:line_keep"])
        drops = [
            (np.asarray(stats[f"{idx}:{key}"]).astype(np.int64), name)
            for key, name in (
                ("drop_too_long", "line-filter-too_long_word"),
                ("drop_no_term", "line-filter-no_terminal_punc"),
                ("drop_few_words", "line-filter-too_few_words"),
            )
        ]
        few_sent = (
            (n_sent < p.min_num_sentences)
            if p.min_num_sentences > 0
            else np.zeros(len(n_sent), dtype=bool)
        )
        passed = ~early & ~few_sent

        def decide(row: int, doc: TextDocument) -> _Decision:
            if early[row]:
                reasons = []
                if lorem[row]:
                    reasons.append("lorem_ipsum")
                if curly[row]:
                    reasons.append("curly_bracket")
                rs = "; ".join(reasons)
                return _Decision(
                    False,
                    rs,
                    [("c4_filter_status", "filtered"), ("c4_filter_reasons", rs)],
                    extra={"rewrite": False},
                )
            rs = (
                f"too_few_sentences (found {n_sent[row]}, "
                f"required {p.min_num_sentences})"
            )
            stamps = [("c4_filter_status", "filtered"), ("c4_filter_reasons", rs)]
            stamps += [(name, str(c[row])) for c, name in drops if c[row] > 0]
            return _Decision(
                False,
                rs,
                stamps,
                extra={
                    "rewrite": not rewrite_identity[row],
                    "keep_mask": line_keep[row][: n_lines[row]],
                },
            )

        ev = _StepEval(
            passed=passed,
            overflow=overflow,
            decide=decide,
            pass_stamps=(("c4_filter_status", "passed"),),
        )
        ev.c4_line_keep = line_keep
        ev.c4_n_lines = n_lines
        ev.c4_rewrite_identity = rewrite_identity
        return ev

    def _eval_fineweb(self, step: StepConfig, idx: int, stats) -> "_StepEval":
        p = step.params
        overflow = np.asarray(stats[f"{idx}:line_overflow"], dtype=bool)
        g = lambda key: np.asarray(stats[f"{idx}:{key}"]).astype(np.int64)  # noqa: E731
        n_lines = g("n_nonblank_lines")
        empty = n_lines == 0
        nl_f = np.maximum(n_lines, 1).astype(np.float64)
        punct_ratio = g("lines_ending_stop") / nl_f
        punct_fail = (punct_ratio < p.line_punct_thr) & ~(
            (punct_ratio == 0.0) & p.line_punct_exclude_zero
        )
        short_ratio = g("short_lines") / nl_f
        short_fail = short_ratio > p.short_line_thr
        total_chars = g("total_chars_no_newline")
        dup_ratio = np.zeros(len(n_lines), dtype=np.float64)
        np.divide(g("dup_line_bytes"), total_chars, out=dup_ratio, where=total_chars > 0)
        dup_fail = dup_ratio > p.char_duplicates_ratio
        n_words = g("n_words")
        newlines = g("newline_count")
        list_ratio = np.zeros(len(n_lines), dtype=np.float64)
        np.divide(newlines, n_words, out=list_ratio, where=n_words > 0)
        list_fail = np.where(n_words == 0, newlines > 0, list_ratio > p.new_line_ratio)
        passed = ~(empty | punct_fail | short_fail | dup_fail | list_fail)

        def decide(row: int, doc: TextDocument) -> _Decision:
            def fail(reason, outcome_reason=""):
                return _Decision(
                    False,
                    outcome_reason or reason,
                    [
                        ("fineweb_filter_status", "filtered"),
                        ("fineweb_filter_reason", reason),
                    ],
                )

            # First failing check wins (fineweb_quality.rs check order).
            if empty[row]:
                return fail("empty document", outcome_reason="empty")
            if punct_fail[row]:
                return fail(
                    f"line_punct_ratio: {fmt4(punct_ratio[row])} < threshold "
                    f"{fmt4(p.line_punct_thr)} (exclude_zero: "
                    f"{rust_bool(p.line_punct_exclude_zero)})"
                )
            if short_fail[row]:
                return fail(
                    f"short_line_ratio: {fmt4(short_ratio[row])} > threshold "
                    f"{fmt4(p.short_line_thr)}"
                )
            if dup_fail[row]:
                return fail(
                    f"char_dup_ratio: {fmt4(dup_ratio[row])} > threshold "
                    f"{fmt4(p.char_duplicates_ratio)}"
                )
            if n_words[row] == 0:
                return fail("list_ratio_no_words (newlines present but no words)")
            return fail(
                f"list_ratio: {fmt4(list_ratio[row])} > threshold "
                f"{fmt4(p.new_line_ratio)}"
            )

        return _StepEval(passed=passed, overflow=overflow, decide=decide, pass_stamps=())

    # --- batch processing ---------------------------------------------------

    def _rewrite_c4(self, doc: TextDocument, step: StepConfig, keep_mask) -> None:
        """Apply the device line-keep mask to rebuild C4's rewritten content
        (the string half of c4_filters.rs:192-258; decisions came from the
        device).  Units are lines (split_paragraph) or sentences."""
        if step.params.split_paragraph:
            lines = rust_lines(doc.content)
        else:
            from ..utils.text import split_into_sentences

            lines = split_into_sentences(doc.content)
        n = len(keep_mask)
        if step.params.remove_citations:
            kept = [
                CITATION_RE.sub("", s) if "[" in s else s
                for i, line in enumerate(lines)
                if i < n and keep_mask[i]
                for s in (line.strip(),)
            ]
        else:
            kept = [line.strip() for i, line in enumerate(lines) if i < n and keep_mask[i]]
        doc.content = "\n".join(kept).strip()

    def _host_outcome(self, doc: TextDocument) -> Optional[ProcessingOutcome]:
        return execute_processing_pipeline(self.host_executor, doc)

    def assemble_phase(
        self, batch: PackedBatch, stats: Dict[str, np.ndarray], phase: int = 0
    ) -> Tuple[List[ProcessingOutcome], List[TextDocument]]:
        """Resolve order/short-circuit/reason strings per document from one
        phase's host-side stats.  Returns ``(outcomes, survivors)``: survivors
        passed a non-final phase and continue to the next."""
        n_rows = len(batch.docs)
        step_ids = self.phases[phase]
        evals = [
            (self.device_steps[i], self._eval_step(self.device_steps[i], i, stats))
            for i in step_ids
        ]
        # Rows where any step hit a kernel table bound rerun the host oracle.
        overflow_any = np.zeros(n_rows, dtype=bool)
        for _, ev in evals:
            if ev.overflow is not None:
                overflow_any |= ev.overflow[:n_rows]
        last = phase == len(self.phases) - 1
        outcomes: List[ProcessingOutcome] = []
        survivors: List[TextDocument] = []
        # Rows that pass the whole phase only take metadata pass-stamps.
        fast_mask = ~overflow_any
        for _, ev in evals:
            fast_mask &= ev.passed[:n_rows]
            if ev.c4_line_keep is not None:
                fast_mask &= ev.c4_rewrite_identity[:n_rows]
        for row, doc in enumerate(batch.docs):
            if fast_mask[row]:
                for _, ev in evals:
                    if ev.pass_stamps is not None:
                        for k, v in ev.pass_stamps:
                            doc.metadata[k] = v
                    else:
                        ev.pass_stamp_fn(row, doc)
                if not last:
                    survivors.append(doc)
                    continue
                outcome = self._finish(doc)
            elif overflow_any[row]:
                self.counters["host_fallback"] += 1
                self.counters["host_overflow"] += 1
                outcome = self._host_outcome(doc)
            else:
                outcome = self._assemble_row(evals, row, doc)
                if outcome is None:  # passed every step of this phase
                    if not last:
                        survivors.append(doc)
                        continue
                    outcome = self._finish(doc)
            if outcome is not None:  # hard error -> no outcome (reference quirk)
                outcomes.append(outcome)
        return outcomes, survivors

    def _finish(self, doc: TextDocument) -> Optional[ProcessingOutcome]:
        """A document that passed every device step: host suffix or done."""
        if self.host_steps:
            return execute_processing_pipeline(self.host_suffix_executor, doc)
        return ProcessingOutcome.success(doc)

    def _assemble_row(self, evals, row: int, doc: TextDocument) -> Optional[ProcessingOutcome]:
        """Walk one row through this phase's steps; ``None`` means it passed
        them all (the caller decides success vs next-phase survival)."""
        for step, ev in evals:
            if ev.passed[row] and ev.pass_stamps is not None:
                for k, v in ev.pass_stamps:
                    doc.metadata[k] = v
                if ev.c4_line_keep is not None and not ev.c4_rewrite_identity[row]:
                    self._rewrite_c4(doc, step, ev.c4_line_keep[row][: ev.c4_n_lines[row]])
                continue
            decision = ev.decide(row, doc)
            for k, v in decision.stamps:
                doc.metadata[k] = v
            if ev.c4_line_keep is not None and decision.extra is not None:
                if decision.extra.get("rewrite"):
                    self._rewrite_c4(doc, step, decision.extra["keep_mask"])
            if not decision.passed:
                return ProcessingOutcome.filtered(doc, decision.reason)
        return None

    def process_chunk(self, docs: List[TextDocument]) -> Iterator[ProcessingOutcome]:
        """Run one chunk of documents through every phase, one batch at a
        time, repacking the survivors between phases (the device analogue
        of the host executor's short-circuit)."""
        current: List[TextDocument] = docs
        routed: Dict[int, bool] = {}
        route_fn = None
        if self._route_dict_scripts:
            from ..utils.cjk import has_dict_script

            def route_fn(doc: TextDocument) -> bool:
                decision = has_dict_script(doc.content)
                routed[id(doc)] = decision
                return decision

        over_length = self.buckets[-1] - PACK_MARGIN
        for phase in range(len(self.phases)):
            survivors: List[TextDocument] = []
            # Every packable document runs on the device, leftover groups
            # as small batches; only over-length and dictionary-script
            # documents (phase 0) come back as fallback.
            source = iter_packed_batches(
                iter(current),
                geometry=self.geometry,
                route_fn=route_fn if phase == 0 else None,
            )
            secs = self.counters["seconds"]
            for batch, fallback in source:
                if batch is not None:
                    t0 = time.perf_counter()
                    stats = self.fetch(self.dispatch_batch(batch, phase))
                    t1 = time.perf_counter()
                    outcomes, alive = self.assemble_phase(batch, stats, phase)
                    t2 = time.perf_counter()
                    secs["device"][phase] = secs["device"].get(phase, 0.0) + (t1 - t0)
                    secs["assemble"] += t2 - t1
                    survivors.extend(alive)
                    yield from outcomes
                t0 = time.perf_counter()
                routed_out = []
                for doc in fallback:
                    assert routed.get(id(doc), False) or len(doc.content) > over_length
                    self.counters["host_fallback"] += 1
                    if routed.get(id(doc), False):
                        self.counters["host_routed_dict_script"] += 1
                    outcome = self._host_outcome(doc)
                    if outcome is not None:
                        routed_out.append(outcome)
                secs["host_routes"] += time.perf_counter() - t0
                yield from routed_out
            current = survivors
            if not current:
                break


_EVALS = {
    "LanguageDetectionFilter": CompiledPipeline._eval_langid,
    "GopherRepetitionFilter": CompiledPipeline._eval_gopher_rep,
    "GopherQualityFilter": CompiledPipeline._eval_gopher_quality,
    "C4QualityFilter": CompiledPipeline._eval_c4,
    "FineWebQualityFilter": CompiledPipeline._eval_fineweb,
}


def process_documents_device(
    config: PipelineConfig,
    docs: Iterable[Union[TextDocument, PipelineError]],
    device_batch: Optional[int] = None,
    on_read_error=None,
    buckets=DEFAULT_BUCKETS,
    pipeline: Optional[CompiledPipeline] = None,
    device=None,
) -> Iterator[ProcessingOutcome]:
    """Device-backed processing loop: packs the stream into bucketed batches,
    runs the device pipeline phase by phase, and yields outcomes.

    Outcome order is deterministic but not input order (documents are
    grouped by length bucket); tests compare outputs as id-keyed sets, as
    for the JAX package.  Pass a prebuilt ``pipeline`` to reuse it (and to
    read its :attr:`~CompiledPipeline.counters` afterwards)."""
    if pipeline is None:
        pipeline = CompiledPipeline(
            config, buckets=buckets, batch_size=device_batch, device=device
        )

    if pipeline.fully_host or not pipeline.device_steps:
        if pipeline.device_steps and pipeline.fully_host:
            logger.warning(
                "Pipeline has un-ported steps before device steps; running fully on host."
            )
        from ..orchestration import process_documents_host

        yield from process_documents_host(
            pipeline.host_executor, docs, on_read_error=on_read_error
        )
        return

    def doc_stream():
        for item in docs:
            if isinstance(item, PipelineError):
                logger.warning("Error reading document for task. Skipping. %s", item)
                if on_read_error is not None:
                    on_read_error(item)
                continue
            yield item

    # Macro-chunks through the phased pipeline: each chunk runs phase by
    # phase with survivors repacked between phases.
    chunk_size = max(4 * pipeline.batch_size, 4096)
    stream = doc_stream()
    while True:
        chunk = list(islice(stream, chunk_size))
        if not chunk:
            break
        yield from pipeline.process_chunk(chunk)
