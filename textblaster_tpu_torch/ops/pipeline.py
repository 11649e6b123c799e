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

:meth:`CompiledPipeline.process_chunk` runs the JAX package's overlapped
window: the packer runs ahead on a prefetch thread with packs on the shared
pack pool, and ``pipeline_depth`` batches are in flight on one dispatch
thread, which runs upload -> device function -> fetch for each batch on a
CUDA stream of its own while the caller's thread assembles the oldest
batch's outcomes and runs the host routes.  Outcomes leave in the packer's
FIFO order at every depth, so the serial path (``TEXTBLAST_NO_OVERLAP=1``,
``overlap.enabled: false``) gives the same sequence.  Uploads are uint16 on
``cuda`` (``TEXTBLAST_WIRE=u16|cp32`` pins the wire), with documents holding
astral code points routed to the host oracle, and small leftover groups go
to the host oracle (``TEXTBLAST_HOST_TAILS=off`` keeps them on the device).

Each batch goes through the JAX package's degradation ladder
(:meth:`CompiledPipeline._execute_packed`): a transient device fault
(CUDA out-of-memory, an I/O error, a watchdog stall) retries the batch
under the ``resilience:`` RetryPolicy, then splits it in half, then reruns
its documents on the host oracle, and a circuit breaker sends the run to
the host oracle after ``breaker_threshold`` batches in a row fell that far.
Every re-attempt runs on the dispatch thread, so launches stay on one
thread and one stream.  A fatal error (a deterministic one, or a sticky
CUDA error) propagates.  Not ported yet: warmup.

A ``mesh`` (:func:`..parallel.mesh.data_mesh`) runs each batch as row
shards, one a mesh entry, with the JAX package's mesh semantics: every
batch size is rounded to a multiple of the entries, the wire is int32,
the ladder has no split rung, there is no overlap window and no host
tails; phases stay on.  :meth:`CompiledPipeline.run_batch` uploads every
shard to its device and enqueues its phase function on that entry's
stream before it waits on any, then gathers the shards' stats in shard
order: the same dict one single-device call gives on the whole batch.

C4BadWordsFilter runs on the device wherever the JAX package runs it there
(:func:`_step_on_device`): its default language has a local word list that
compiles to device tables (:mod:`.badwords`), and so does every other
language with a local list.  Its program decides every row by the double
window hash over two ``affine_scan`` launches; the host regex re-decides
only the fold-hazard rows (counted in ``worker_fold_hazard_rows_total``)
and the documents of languages without tables, and a matching row draws
the seeded keep fraction on the host.  A default language without a list
keeps the step on the host: as a suffix when it is last, or the whole
pipeline when device steps follow it.

The JAX package's metric seams count into the port's registry
(:mod:`..utils.metrics`) under the same names: occupancy per dispatch
(:func:`record_occupancy`), the pack, dispatch, device-wait and post stage
seconds, the in-flight and pack-queue gauges, host fallbacks and tails,
and the device-side seam of the per-filter funnel.  Where a stage counter
times the same interval as a ``counters["seconds"]`` key, one pair of
clock reads feeds both.

Its trace and journal seams are the JAX package's too (:mod:`..utils.trace`,
:mod:`..utils.events`): the ``pack``, ``dispatch``, ``device_dispatch``,
``device_wait`` and ``post`` spans, the ``inflight_batches`` and
``queue_depth_pack`` counters, and the ``ladder_split`` / ``ladder_host``
instants and events.  With the trace (``--trace``) or the device trace
(``--trace-device``) armed on ``cuda``, :meth:`CompiledPipeline.run_batch`
also turns the two timing events that bracket each batch into a
``device_batch`` span on the trace's ``device`` track and resolves the
kernels' own spans, after the batch's own synchronize: no host sync is
added (one ``synchronize`` of the stream arms the pipeline's
:class:`~..utils.trace.DeviceClock`).

The profiler's seams are the JAX package's (:mod:`..utils.profiler`):
each dispatch that returned records its device seconds (the batch's two
CUDA events on ``cuda``, ``run_batch``'s host seconds on the CPU) under
its (bucket, phase) inside the caller's ``device_wait`` span, and, with
the profiler armed, :func:`process_documents_device` first runs the cost
pass (:meth:`CompiledPipeline.register_program_costs`): every program's
function once on a zero batch of its shape under the dispatch-count scope
of ``ops/scan.py``, whose recorded launches give the program's
shape-determined cost.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import traceback
from collections import deque
from contextlib import nullcontext
from concurrent.futures import Future
from functools import lru_cache
from itertools import islice
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config.pipeline import PipelineConfig, ResilienceConfig, StepConfig
from ..data_model import ProcessingOutcome, TextDocument
from ..errors import PipelineError, RetryExhaustedError, StallError
from ..filters.c4_quality import CITATION_RE
from ..filters.common import fmt2, fmt4, rust_bool, rust_float, rust_lines
from ..filters.fineweb_quality import DEFAULT_STOP_CHARS
from ..filters.gopher_quality import DEFAULT_STOP_WORDS
from ..models.langid import ISO_TO_NAME, LANGUAGES, NAME_TO_ISO, LangIdModel
from ..orchestration import execute_processing_pipeline
from ..pipeline_builder import build_pipeline_from_config
from ..resilience.breaker import CircuitBreaker
from ..resilience.faults import FAULTS
from ..resilience.retry import RetryPolicy
from ..resilience.watchdog import WATCHDOG
from ..utils.events import EVENTS
from ..utils.metrics import FILTER_DROP_PREFIX, METRICS
from ..utils.overlap import prefetch_iter, shared_pack_pool
from ..utils.profiler import PROFILER, program_key
from ..utils.telemetry import TELEMETRY
from ..utils.trace import KERNEL_SPANS, TRACER, DeviceClock
from .badwords import badwords_matches_multi
from ..parallel.mesh import DataMesh, gather_stats, shard_rows, to_device
from .geometry import DeviceGeometry
from .langid_device import langid_scores
from . import scan, sort
from .packing import (
    DEFAULT_BUCKETS,
    PACK_MARGIN,
    PackedBatch,
    iter_packed_batches,
    pack_documents,
)
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
    "record_occupancy",
    "resolve_device",
]

#: Step types with a device implementation.  C4BadWordsFilter is on the
#: device only where its default language has local tables
#: (:func:`_step_on_device`).
_DEVICE_STEPS = {
    "LanguageDetectionFilter",
    "GopherRepetitionFilter",
    "GopherQualityFilter",
    "C4QualityFilter",
    "FineWebQualityFilter",
    "C4BadWordsFilter",
}

_CJK_BADWORDS_LANGS = ("ja", "th", "zh")  # c4_filters.rs:70

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


#: Window sentinel: the breaker refused this batch's dispatch — the drain
#: sends it straight to the host rung without recording a breaker failure
#: (the device was never asked, so there is nothing new to count).
_BREAKER_OPEN = object()

#: Rows the split rung rounds each half up to (the JAX package's sublane
#: tile, ``pallas_sort.ROWS``), so both halves share one shape.
_SPLIT_ROW_TILE = 8


@lru_cache(maxsize=64)
def _badwords_tables_cached(default_language: str, cache_base_path, stat_key):
    from ..filters.c4_badwords import load_local_badwords
    from .badwords import BadwordTables

    words = load_local_badwords(default_language, cache_base_path)
    if not words:
        # Unavailable or empty: the host filter owns the semantics
        # (download, passed_no_regex, fail_on_missing_language).
        return None
    return BadwordTables.build(
        words, check_boundaries=default_language not in _CJK_BADWORDS_LANGS
    )


def _badwords_list_stat(default_language: str, cache_base_path):
    """(mtime_ns, size) of the on-disk list, or None when absent: part of
    the cache key, so that a list that appears or changes during a
    long-lived process is seen instead of a stale table (or a stale
    None)."""
    from ..filters.c4_badwords import local_badwords_path

    path = local_badwords_path(default_language, cache_base_path)
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


def _badwords_tables(step: StepConfig):
    """BadwordTables for the step's default language from local lists only,
    or None (-> host execution).  Cached per (language, cache path, file
    stat)."""
    p = step.params
    stat_key = _badwords_list_stat(p.default_language, p.cache_base_path)
    return _badwords_tables_cached(p.default_language, p.cache_base_path, stat_key)


def _badwords_all_tables(step: StepConfig) -> Dict[str, object]:
    """Tables for every language with a local list (vendored or in the cache
    dir): one device pass decides the documents of all these languages, not
    only the default's.  Languages without local lists keep the host
    semantics (download / passed_no_regex / fail_on_missing_language)."""
    from ..filters.c4_badwords import BADWORDS_LANGS

    p = step.params
    out: Dict[str, object] = {}
    for lang in BADWORDS_LANGS:
        stat_key = _badwords_list_stat(lang, p.cache_base_path)
        if stat_key is None:
            continue
        tables = _badwords_tables_cached(lang, p.cache_base_path, stat_key)
        if tables is not None:
            out[lang] = tables
    return out


def _step_on_device_base(step: StepConfig) -> bool:
    """Device eligibility from the config alone (no file consulted)."""
    return step.type in _DEVICE_STEPS


def _step_on_device(step: StepConfig) -> bool:
    if not _step_on_device_base(step):
        return False
    if step.type == "C4BadWordsFilter" and _badwords_tables(step) is None:
        return False
    return True


def _drop_frames(exc: Optional[BaseException]) -> None:
    """Clear the frames of ``exc``'s tracebacks (and of its cause, context
    and, for :class:`RetryExhaustedError`, its last error).  A failed
    attempt's frames hold its device tensors; kept alive by a future or an
    exhaustion error they would leave the next attempt a full allocator."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
        for inner in (exc.__cause__, exc.__context__):
            if inner is not None:
                _drop_frames(inner)
        exc = exc.last if isinstance(exc, RetryExhaustedError) else None


def _wire_u16(device: torch.device) -> bool:
    """uint16 device uploads (see ``CompiledPipeline.__init__``).

    ``TEXTBLAST_WIRE=u16|cp32`` pins it; the default is u16 on ``cuda``
    (halves the host-to-device transfer) and cp32 on the CPU (no transfer
    to save; the widen would be pure cost)."""
    w = os.environ.get("TEXTBLAST_WIRE", "")
    if w == "u16":
        return True
    if w == "cp32":
        return False
    return device.type == "cuda"


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


def record_occupancy(batch: PackedBatch) -> None:
    """Occupancy telemetry for one device dispatch (see utils/metrics.py):
    real codepoints vs padded lanes actually computed, plus a per-bucket
    dispatch counter.  Called where :meth:`CompiledPipeline.dispatch_batch`
    counts the batch in ``counters["batches_by_bucket"]``, so the two
    agree."""
    rows, length = batch.cps.shape
    METRICS.inc("occupancy_device_batches_total")
    METRICS.inc("occupancy_padded_lanes_total", float(rows) * float(length))
    METRICS.inc("occupancy_real_codepoints_total", float(int(batch.lengths.sum())))
    METRICS.inc(f"occupancy_dispatches_bucket_{length}")


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
        "badwords_matches",
        "badwords_default_language",
        "badwords_fold_hazard",
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
        self.badwords_matches = None
        self.badwords_default_language = None
        self.badwords_fold_hazard = None


def _launch_counts() -> Dict[str, int]:
    return {**scan.LAUNCHES, **sort.LAUNCHES}


def _new_counters() -> Dict[str, object]:
    return {
        "batches_by_bucket": {},  # (bucket) -> device batches, all phases
        # Hand-written kernel launches by kernel (0 on the CPU, where the
        # wrappers run their plain versions).
        "launches": {k: 0 for k in _launch_counts()},
        "device_rows": 0,  # real documents sent to the device, all phases
        "upload_bytes": 0,  # code points and lengths sent to the device
        # Over-length, dictionary-script, astral and overflow rows; the
        # leftover groups routed to the host oracle are counted apart.
        "host_fallback": 0,
        "host_routed_dict_script": 0,
        "host_routed_astral": 0,
        "host_overflow": 0,
        "host_tail": 0,
        # Host-clock seconds.  ``device``: per phase, upload + device
        # function + download of each batch (the download waits for the
        # device), on the dispatch thread when overlapped.  ``wait``: the
        # caller's thread blocked on the oldest in-flight batch (0 serial).
        # ``pack``: packing, summed over the pack workers.  ``drain``: the
        # caller's thread draining the window's front (wait, assembly and
        # host routes).  ``assemble``: host finalizers.  ``host_routes``:
        # the host oracle on fallback and tail documents, ``host_tails`` the
        # tail documents' share of it.  ``ladder_host``: the host oracle on
        # the documents of batches that fell to the ladder's host rung.
        # ``device_busy``:
        # CUDA-event time from each batch's upload to its download on the
        # stream that ran it, summed (0 on the CPU).
        "seconds": {
            "device": {},
            "assemble": 0.0,
            "host_routes": 0.0,
            "host_tails": 0.0,
            "ladder_host": 0.0,
            "pack": 0.0,
            "wait": 0.0,
            "drain": 0.0,
            "device_busy": 0.0,
        },
    }


class CompiledPipeline:
    """A pipeline config set up for device execution on ``device``."""

    def __init__(
        self,
        config: PipelineConfig,
        buckets=DEFAULT_BUCKETS,
        batch_size: Optional[int] = None,
        device=None,
        geometry: Optional[DeviceGeometry] = None,
        mesh: Optional[DataMesh] = None,
        phase_split: bool = True,
    ) -> None:
        self.config = config
        self.mesh = mesh
        if mesh is not None:
            if device is not None:
                raise ValueError("CompiledPipeline: pass a device or a mesh, not both")
            # Kernels, streams, the cost pass and the lane budget's device
            # type: the mesh's first entry.
            self.device = resolve_device(mesh.devices[0])
        else:
            self.device = resolve_device(device)
        if geometry is not None:
            # A calibrated (or checkpoint-recorded) geometry supersedes the
            # buckets/batch_size knobs; mesh runs need every per-bucket
            # batch divisible by the entries.
            if mesh is not None:
                geometry = geometry.with_batch_multiple(mesh.size)
            self.geometry = geometry
        else:
            bs = tuple(sorted(buckets))
            default = default_batch_size(bs, self.device)
            if not batch_size:  # None or 0, as the CLI passes them
                batch_size = default
            if mesh is not None:
                batch_size = max(mesh.size, (batch_size // mesh.size) * mesh.size)
            src = "default" if batch_size == default else "explicit"
            self.geometry = DeviceGeometry.uniform(bs, batch_size, source=src)
        self.buckets = self.geometry.buckets
        # The largest per-dispatch row count: chunk sizing keys off it.
        self.batch_size = self.geometry.max_batch

        steps = list(config.pipeline)
        n_device = 0
        # Badwords tables are resolved once here and carried on the
        # instance: _build_fn may run much later (the first batch of a new
        # bucket), when the on-disk list may have changed or vanished; the
        # program uses exactly the tables this placement saw.
        self._badwords_device_tables: Dict[int, object] = {}
        for s in steps:
            if s.type == "C4BadWordsFilter" and _step_on_device_base(s):
                if _badwords_tables(s) is None:  # default language must exist
                    break
                self._badwords_device_tables[n_device] = _badwords_all_tables(s)
            elif not _step_on_device(s):
                break
            n_device += 1
        self.device_steps = steps[:n_device]
        self.host_steps = steps[n_device:]
        # Host-only fallback when host steps precede device-capable steps.
        self.fully_host = any(_step_on_device(s) for s in self.host_steps)

        # Documents containing dictionary-segmented scripts (Han/kana/Thai…)
        # are decided by the host oracle whenever a word-table step runs on
        # the device: the host word splitter approximates ICU's dictionary
        # segmentation for them, which the run-whole device tables cannot.
        self._route_dict_scripts = any(
            s.type in _WORD_TABLE_STEPS for s in self.device_steps
        )

        # Phases stay on under a mesh, as the single-controller JAX mesh
        # keeps them; ``phase_split=False`` runs one program of every step.
        self.phases = _split_phases(self.device_steps)
        # A content-rewriting step must sit in the final phase.
        if not phase_split or any(
            self.device_steps[i].type == "C4QualityFilter"
            for ph in self.phases[:-1]
            for i in ph
        ):
            self.phases = [list(range(len(self.device_steps)))]

        # Wire format: BMP code points fit uint16 exactly, which halves the
        # upload; documents holding supplementary-plane characters (emoji
        # etc.) are routed to the host oracle instead (process_chunk), so
        # decisions stay bit-identical and the route is counted.  Meshes
        # keep int32, as the JAX package's do.
        self.wire_u16 = mesh is None and _wire_u16(self.device)

        # Overlapped host pipeline (see process_chunk): depth of the device
        # in-flight window and the pack-stage thread pool.
        self._overlap = config.overlap

        # Degradation ladder state (see _execute_packed): retry the batch ->
        # split it in half -> rerun the docs on the host oracle, with a
        # breaker that abandons the device path after N consecutive batches
        # fell all the way to the host rung.
        rc = config.resilience or ResilienceConfig()
        self._retry = RetryPolicy.from_config(rc)
        self._breaker = CircuitBreaker(
            rc.breaker_threshold, cooldown_s=rc.breaker_cooldown_s
        )
        self._split_retry = rc.split_retry

        self._host_executor = None
        self._host_suffix_executor = None
        self._badwords_steps: Dict[int, object] = {}
        self._fns: Dict[Tuple[int, int], Callable] = {}
        self.counters = _new_counters()
        self._pack_lock = threading.Lock()
        # Maps the batches' CUDA events onto the trace clock; armed by the
        # first batch run with a trace armed (run_batch).
        self.device_clock: Optional[DeviceClock] = None
        # Under a mesh: each mesh device's clock, anchored on the stream of
        # its first entry.
        self._mesh_clocks: Dict[str, DeviceClock] = {}
        self._batch_seq = 0
        if mesh is not None:
            # Launches by kernel of each shard (their sum is "launches").
            self.counters["shard_launches"] = [
                {k: 0 for k in _launch_counts()} for _ in mesh.devices
            ]
            # One stream an entry: two entries on one card run on two.
            self._mesh_streams = (
                [torch.cuda.Stream(device=d) for d in mesh.devices]
                if self.device.type == "cuda" else None
            )
            # Each shard's kernel spans of the batch being dispatched.
            self._shard_spans: List[list] = []

        if self.device.type == "cuda":
            # Build and load the kernels now, so that a failure raises here
            # (BuildError) and never inside a batch, where the ladder would
            # take it for a device fault.
            from ..kernels.build import SOURCES, load

            for name in SOURCES:
                load(name)

    def _badwords_host_step(self, idx: int):
        """The host C4BadWordsFilter of device step ``idx``: it decides only
        fold-hazard rows and uncompiled languages, and draws the keep
        fraction of matching rows (one regex cache and seed across
        documents)."""
        if idx not in self._badwords_steps:
            from ..pipeline_builder import build_step

            self._badwords_steps[idx] = build_step(self.device_steps[idx])
        return self._badwords_steps[idx]

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
            elif step.type == "C4BadWordsFilter":
                plans.append(("badwords", i, self._badwords_device_tables[i]))

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
                elif kind == "badwords":
                    # The batch as the earlier steps left it (after c4: the
                    # rewritten code points and lengths).
                    per_lang, per_hazard = badwords_matches_multi(
                        state["cps"], state["lengths"], arg
                    )
                    for lang, m in per_lang.items():
                        out[f"{i}:match:{lang}"] = m
                        out[f"{i}:hazard:{lang}"] = per_hazard[lang]
            return out

        return fn

    def _fn_for(self, length: int, phase: int = 0) -> Callable:
        key = (length, phase)
        if key not in self._fns:
            self._fns[key] = self._build_fn(length, phase)
        return self._fns[key]

    # --- dispatch accounting and the cost model ------------------------------

    def _zero_program(self, length: int, phase: int, rows: int):
        """The ``(length, phase)`` function once on a zero batch of ``rows``
        rows, on this pipeline's device, under a dispatch-count scope:
        ``(scope, stats)``.  Nothing of the run's accounting moves (no
        ``dispatch_batch``: no batch, occupancy or upload counters)."""
        fn = self._fn_for(length, phase)
        cps = torch.zeros((rows, length), dtype=torch.int32, device=self.device)
        lengths = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        guard = torch.cuda.device(self.device) if self.device.type == "cuda" else nullcontext()
        with guard, scan.count_scan_dispatches() as counts:
            stats = fn(cps, lengths)
        return counts, stats

    def scan_dispatch_counts(
        self, length: int, phase: int = 0, rows: Optional[int] = None
    ) -> Dict[str, int]:
        """Per-kind scan dispatch counts of one (bucket, phase) program, the
        JAX package's method: "fused" (a ``fused_scan`` or a whole
        ``chain_scan``), "pallas_scan" (the per-scan kernels) and
        "lax_scan" (the plain segmented scans).  The program runs once on a
        zero batch with its gates open (``ops/scan.py`` ``gates_open``), so
        the counts depend on the shapes and the schedule switches alone."""
        rows = rows or self.geometry.batch_for(length)
        counts, _ = self._zero_program(length, phase, rows)
        return dict(counts)

    def _warmup_jobs(self, include_split_rows: bool = True):
        """``(length, phase, rows)`` of every (bucket, phase) program at
        geometry rows, plus the degradation ladder's split rows (the rows
        ``_execute_packed`` packs each half to), as in the JAX package."""
        jobs = []
        for length in self.buckets:
            full = self.geometry.batch_for(length)
            variants = [full]
            sub = self._split_rows(full)
            if include_split_rows and self._split_retry and self.mesh is None and sub != full:
                variants.append(sub)
            for phase in range(len(self.phases)):
                jobs.extend((length, phase, rows) for rows in variants)
        return jobs

    def register_program_costs(
        self, include_split_rows: bool = True
    ) -> Dict[str, Dict[str, int]]:
        """The cost pass: register every program of :meth:`_warmup_jobs`
        with the PROFILER under ``source: "shape-model"`` (the port's
        counterpart of the JAX ``register_installed_costs``, with no
        compile to analyze).  Each program runs once on a zero batch of its
        shape (:meth:`_zero_program`); its cost is

        * ``flops``: the modeled integer operations of its hand-kernel
          launches (``ops/cost.py``);
        * ``argument_bytes``: the wire upload, ``rows * L`` code points of
          2 bytes (u16) or 4 (cp32), plus ``rows * 4`` of lengths;
        * ``output_bytes``: the stats dict's bytes;
        * ``bytes_accessed``: the launches' modeled bytes plus both;
        * ``launches``: its hand-kernel launches (gates open: an upper
          bound on a real batch's).

        Programs the PROFILER already holds are skipped.  Returns the
        launches by kernel of each program costed now."""
        known = PROFILER.cost_entries()
        launches: Dict[str, Dict[str, int]] = {}
        t0 = time.perf_counter()
        for length, phase, rows in self._warmup_jobs(include_split_rows):
            pk = program_key(length, phase, rows)
            if pk in known:
                continue
            counts, stats = self._zero_program(length, phase, rows)
            arg = rows * length * (2 if self.wire_u16 else 4) + rows * 4
            out = sum(v.numel() * v.element_size() for v in stats.values())
            PROFILER.record_program_cost(
                length, phase, rows,
                {
                    "flops": int(round(sum(o for _, _, o in counts.launches))),
                    "bytes_accessed": int(round(sum(b for _, b, _ in counts.launches)))
                    + arg + out,
                    "argument_bytes": arg,
                    "output_bytes": out,
                    "launches": len(counts.launches),
                },
                "shape-model",
            )
            by_kernel: Dict[str, int] = {}
            for key, _, _ in counts.launches:
                by_kernel[key[0]] = by_kernel.get(key[0], 0) + 1
            launches[pk] = by_kernel
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if launches:
            logger.info("Cost pass: %d programs in %.3f s", len(launches),
                        time.perf_counter() - t0)
        return launches

    def _record_dispatch(self, batch: PackedBatch, phase: int, result) -> dict:
        """``PROFILER.record_dispatch`` for a ``run_batch`` result that
        returned: the batch's device seconds from its two CUDA events on
        ``cuda``, ``run_batch``'s host seconds on the CPU."""
        _, host_s, dev_s = result
        return PROFILER.record_dispatch(
            batch.max_len, phase, batch.batch_size,
            dev_s if self.device.type == "cuda" else host_s,
        )

    def dispatch_batch(
        self, batch: PackedBatch, phase: int = 0, streams=None
    ) -> Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]:
        """Upload one packed batch and run its (bucket, phase) function on
        the current stream; the returned stats stay on the device.  The
        upload is uint16 under :attr:`wire_u16` (widened to int32 on the
        device before the function), int32 otherwise.  The
        ``device.execute`` fault seam fires first, inside a watchdog beat
        when the watchdog is armed, so an injected hang is rescued on the
        thread that hangs.

        Under a mesh: one stats dict a shard, in shard order, each on its
        entry's device; every shard is uploaded and its function enqueued
        (on ``streams[i]``, else its device's current stream) before the
        next shard's, and nothing here waits on a shard but the phase
        functions' own gates.  The batch counts once in the batch, row and
        upload counters; each shard's launches count in
        ``counters["shard_launches"]`` and, summed, in ``"launches"``."""
        with WATCHDOG.stage_beat("device_fetch") if WATCHDOG.enabled else nullcontext():
            FAULTS.fire("device.execute")
        fn = self._fn_for(batch.max_len, phase)
        cps = np.ascontiguousarray(batch.cps)
        if self.wire_u16:
            # Astral rows were routed to the host oracle upstream
            # (process_chunk); a slip here would truncate silently, so
            # guard with one cheap vectorized check.
            if int(cps.max(initial=0)) >= 0x10000:
                raise RuntimeError(
                    "astral codepoint reached the uint16 wire — "
                    "routing invariant broken"
                )
            cps_h = torch.from_numpy(cps.astype(np.uint16))
        else:
            cps_h = torch.from_numpy(np.ascontiguousarray(cps, dtype=np.int32))
        lengths = torch.from_numpy(np.ascontiguousarray(batch.lengths, dtype=np.int32))
        self.counters["upload_bytes"] += cps_h.nbytes + lengths.nbytes
        buckets = self.counters["batches_by_bucket"]
        buckets[batch.max_len] = buckets.get(batch.max_len, 0) + 1
        record_occupancy(batch)
        self.counters["device_rows"] += len(batch.docs)
        if self.mesh is not None:
            return self._dispatch_shards(fn, cps_h, lengths, streams)
        if self.device.type == "cuda":
            cps_d = to_device(cps_h, self.device)
            lengths = lengths.to(self.device)
        else:
            cps_d = cps_h
        # The widen is the device's first op; every function computes in
        # int32.
        cps_d = cps_d.to(torch.int32) if self.wire_u16 else cps_d
        before = _launch_counts()
        try:
            return fn(cps_d, lengths)
        finally:
            # Also the launches of a function that failed part-way (an
            # out-of-memory attempt the ladder retries).
            self._count_launches(before, self.counters["launches"])

    @staticmethod
    def _count_launches(before: Dict[str, int], *into: Dict[str, int]) -> None:
        """Add the launches since ``before`` to each of ``into``."""
        for k, n in _launch_counts().items():
            for d in into:
                d[k] += n - before[k]

    def _dispatch_shards(self, fn, cps_h, lengths, streams) -> List[Dict[str, torch.Tensor]]:
        """:meth:`dispatch_batch` under the mesh: shard *i*'s rows to entry
        *i*'s device and its function on ``streams[i]``, shard by shard.
        With ``--trace-device`` armed, each shard's kernel spans go to
        ``_shard_spans[i]`` (resolved with its device's clock)."""
        out: List[Dict[str, torch.Tensor]] = []
        self._shard_spans = []
        for i, (dev, (lo, hi)) in enumerate(
            zip(self.mesh.devices, shard_rows(self.mesh, cps_h.shape[0]))
        ):
            before = _launch_counts()
            try:
                if dev.type == "cuda":
                    s = streams[i] if streams is not None else torch.cuda.current_stream(dev)
                    with torch.cuda.device(dev), torch.cuda.stream(s):
                        out.append(fn(to_device(cps_h[lo:hi], dev),
                                      to_device(lengths[lo:hi], dev)))
                else:
                    out.append(fn(cps_h[lo:hi], lengths[lo:hi]))
            finally:
                self._count_launches(before, self.counters["launches"],
                                     self.counters["shard_launches"][i])
                if KERNEL_SPANS.enabled:
                    self._shard_spans.append(KERNEL_SPANS.take_pending())
        return out

    @staticmethod
    def fetch(stats: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Device stats -> host numpy arrays."""
        return {k: v.cpu().numpy() for k, v in stats.items()}

    def run_batch(
        self, batch: PackedBatch, phase: int = 0, stream=None
    ) -> Tuple[Dict[str, np.ndarray], float, float]:
        """Upload, device function and download of one batch:
        ``(host stats, host seconds, device seconds)``, inside a
        ``device_dispatch`` span.

        On ``cuda`` the work runs on ``stream`` (the caller's current stream
        when None), bracketed by two CUDA events whose elapsed time is the
        device seconds; the stats come back in one batch of non-blocking
        copies and one wait on the end event, which waits on that stream
        only (with the watchdog armed, a poll of the event bounded by the
        ``device_fetch`` deadline comes first).  With a trace armed, the
        two events become the batch's device span after that wait
        (:meth:`_device_spans`).  On the CPU the device seconds are 0.

        Under a mesh see :meth:`_run_mesh_batch`."""
        if self.mesh is not None:
            return self._run_mesh_batch(batch, phase)
        t0 = time.perf_counter()
        args = {"bucket": batch.max_len, "rows": batch.batch_size, "phase": phase}
        if self.device.type != "cuda":
            with TRACER.span("device_dispatch", args):
                stats = self.fetch(self.dispatch_batch(batch, phase))
            return stats, time.perf_counter() - t0, 0.0
        traced = TRACER.enabled or KERNEL_SPANS.enabled
        if traced:
            self._batch_seq += 1
            args["batch"] = self._batch_seq
        with torch.cuda.device(self.device):
            s = stream if stream is not None else torch.cuda.current_stream()
            with torch.cuda.stream(s), TRACER.span("device_dispatch", args):
                if traced and (self.device_clock is None or not self.device_clock.current()):
                    # The anchor goes on an idle stream: this one, after a
                    # synchronize (once a pipeline and trace).
                    s.synchronize()
                    self.device_clock = DeviceClock()
                    self.device_clock.anchor(s)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(s)
                dev_stats = self.dispatch_batch(batch, phase)
                host = {k: v.to("cpu", non_blocking=True) for k, v in dev_stats.items()}
                end.record(s)
                if WATCHDOG.enabled:
                    # A beat: the caller's wait on this thread leaves the
                    # bound of this poll to it (_DispatchThread.wait).
                    with WATCHDOG.stage_beat("device_fetch"):
                        WATCHDOG.wait_device_ready("device_fetch", (end,))
                end.synchronize()
            if traced:
                self._device_spans(self.device_clock, s, start, end, args)
        stats = {k: v.numpy() for k, v in host.items()}
        return stats, time.perf_counter() - t0, start.elapsed_time(end) / 1e3

    def _run_mesh_batch(self, batch: PackedBatch, phase: int):
        """:meth:`run_batch` under the mesh: every shard's upload and
        function enqueued on its entry's stream (:meth:`dispatch_batch`),
        each bracketed by two CUDA events on that stream, then the
        non-blocking downloads, then the waits, then the shards' stats
        concatenated in shard order.  The device seconds are the longest
        shard's span (events on two devices cannot be subtracted); with a
        trace armed each shard's span is a ``device_batch`` span tagged
        with its shard index, on its device's clock."""
        t0 = time.perf_counter()
        args = {"bucket": batch.max_len, "rows": batch.batch_size, "phase": phase}
        if self.device.type != "cuda":
            with TRACER.span("device_dispatch", args):
                shards = self.dispatch_batch(batch, phase)
                stats = gather_stats([self.fetch(sh) for sh in shards])
            return stats, time.perf_counter() - t0, 0.0
        traced = TRACER.enabled or KERNEL_SPANS.enabled
        if traced:
            self._batch_seq += 1
            args["batch"] = self._batch_seq
        devs, streams = self.mesh.devices, self._mesh_streams
        with TRACER.span("device_dispatch", args):
            if traced:
                self._anchor_mesh_clocks()
            starts, ends = [], []
            for dev, s in zip(devs, streams):
                with torch.cuda.device(dev):
                    starts.append(torch.cuda.Event(enable_timing=True))
                    ends.append(torch.cuda.Event(enable_timing=True))
                    starts[-1].record(s)
            shards = self.dispatch_batch(batch, phase, streams)
            hosts = []
            for dev, s, sh, end in zip(devs, streams, shards, ends):
                with torch.cuda.device(dev), torch.cuda.stream(s):
                    hosts.append({k: v.to("cpu", non_blocking=True) for k, v in sh.items()})
                    end.record(s)
            del shards
            if WATCHDOG.enabled:
                with WATCHDOG.stage_beat("device_fetch"):
                    WATCHDOG.wait_device_ready("device_fetch", tuple(ends))
            for end in ends:
                end.synchronize()
        if traced:
            spans = self._shard_spans or [None] * len(devs)
            for i, (dev, s) in enumerate(zip(devs, streams)):
                self._device_spans(self._mesh_clocks[str(dev)], s, starts[i], ends[i],
                                   {**args, "shard": i}, spans[i])
        stats = gather_stats([{k: v.numpy() for k, v in h.items()} for h in hosts])
        dev_s = max(a.elapsed_time(b) for a, b in zip(starts, ends)) / 1e3
        return stats, time.perf_counter() - t0, dev_s

    def _anchor_mesh_clocks(self) -> None:
        """A :class:`DeviceClock` for each mesh device that has none (or
        one of an earlier trace), anchored on the stream of the device's
        first entry after a synchronize of it."""
        for dev, s in zip(self.mesh.devices, self._mesh_streams):
            clock = self._mesh_clocks.get(str(dev))
            if clock is None or not clock.current():
                with torch.cuda.device(dev):
                    s.synchronize()
                    clock = self._mesh_clocks[str(dev)] = DeviceClock()
                    clock.anchor(s)

    def _device_spans(self, clock, stream, start, end, args, pending=None) -> None:
        """One batch's (or shard's) device spans, after its
        ``end.synchronize()``: the ``device_batch`` span on the trace's
        ``device`` track, and under ``--trace-device`` the batch's and its
        kernels' spans (``pending``: a shard's, from
        ``KERNEL_SPANS.take_pending``).  A CUDA event that cannot be read
        raises."""
        clock.settle(stream)
        # Between the anchors before and after the batch: the device
        # timer's drift over the batch cancels (a span mapped from the one
        # before alone has ended past its host span).
        span = clock.bracketed()
        if TRACER.enabled:
            ts = span.to_us(start)
            TRACER.device_span("device_batch", ts, span.to_us(end) - ts, args)
        if KERNEL_SPANS.enabled:
            KERNEL_SPANS.resolve(span, start, end, args, pending)

    # --- degradation ladder -------------------------------------------------

    @staticmethod
    def _split_rows(full: int) -> int:
        """Rows the split rung packs each half to: half the batch, rounded
        up to the JAX package's 8-row tile (``pack_documents`` pads the rows
        beyond the documents)."""
        half = (full + 1) // 2
        return min(full, -(-half // _SPLIT_ROW_TILE) * _SPLIT_ROW_TILE)

    def _dispatch_window(self, batch: PackedBatch, phase: int, dispatcher):
        """Breaker-gated dispatch for the in-flight window.

        Returns the dispatch thread's future (overlapped), the finished
        ``run_batch`` result (serial), ``None`` when a serial run failed
        with a retryable error (the drain's ladder re-dispatches from
        scratch), or ``_BREAKER_OPEN`` when the breaker refused the
        request.  Fatal errors propagate; a windowed batch's error waits in
        its future for the drain.

        The ``dispatch`` lineage stamp is taken here, on the caller's
        thread, when the batch is handed to the device path (the JAX
        package's asynchronous launch): the dispatch thread may run it only
        after the caller already waits on it."""
        if not self._breaker.allow_request():
            return _BREAKER_OPEN
        if TELEMETRY.enabled:
            TELEMETRY.mark("dispatch", (d.id for d in batch.docs))
        if dispatcher is not None:
            return dispatcher.submit(batch, phase)
        try:
            return self.run_batch(batch, phase)
        except Exception as e:  # noqa: BLE001 — classifier decides
            if self._retry.classify(e) != "retryable":
                raise
            self._dispatch_failed(e, phase)
            return None

    @staticmethod
    def _dispatch_failed(exc: BaseException, phase: int) -> None:
        """A failed dispatch, handed to the ladder with nothing in flight
        (its first attempt re-dispatches), as the JAX package's
        ``_dispatch_window`` hands it."""
        WATCHDOG.escalated(exc)
        logger.warning("Device dispatch failed (phase %d): %s", phase, exc)
        _drop_frames(exc)

    def _result(self, fut: Future, dispatcher) -> Tuple[Dict[str, np.ndarray], float, float]:
        """The dispatch thread's result for ``fut``, its wait bounded by the
        watchdog when armed and added to ``counters["seconds"]["wait"]``
        and ``stage_device_wait_seconds``."""
        t0 = time.perf_counter()
        try:
            dispatcher.wait(fut)
            return fut.result()
        finally:
            self._waited(time.perf_counter() - t0)

    def _waited(self, dt: float) -> None:
        """Seconds the caller's thread spent blocked on a batch of the
        dispatch thread: the device time the window did not hide."""
        self.counters["seconds"]["wait"] += dt
        METRICS.inc("stage_device_wait_seconds", dt)

    def _device_fetch(self, batch: PackedBatch, phase: int, dispatcher, first=None):
        """One batch's ``run_batch`` result under the device RetryPolicy.

        ``first`` is what the first attempt takes instead of a dispatch:
        the window's future, or the stall that waiting on it raised.  Every
        re-attempt dispatches anew, on the dispatch thread when there is
        one (so launches stay on one thread and one stream) and inline
        otherwise.  A failed attempt's frames are cleared before the next
        one starts."""
        pending = [first]

        def attempt():
            p, pending[0] = pending[0], None
            if isinstance(p, BaseException):
                raise p
            if p is None:
                if TELEMETRY.enabled:
                    TELEMETRY.mark("dispatch", (d.id for d in batch.docs))
                if dispatcher is None:
                    result = self.run_batch(batch, phase)
                    if TELEMETRY.enabled:
                        TELEMETRY.mark("device_wait", (d.id for d in batch.docs))
                    if PROFILER.enabled:
                        self._record_dispatch(batch, phase, result)
                    return result
                p = dispatcher.submit(batch, phase)
            if TELEMETRY.enabled:
                TELEMETRY.mark("device_wait", (d.id for d in batch.docs))
            with TRACER.span("device_wait", {"bucket": batch.max_len, "phase": phase}) as sp:
                result = self._result(p, dispatcher)
                if PROFILER.enabled:
                    sp.add_args(self._record_dispatch(batch, phase, result))
                return result

        return self._retry.run(
            attempt, seam="device", on_retry=lambda e, _: _drop_frames(e)
        )

    def _host_rerun(self, docs: List[TextDocument]) -> List[ProcessingOutcome]:
        """Bottom rung: the full host-oracle pipeline, bit-identical to the
        device path by the same contract the overflow fallback relies on
        (docs are re-stamped identically even mid-phase).  Counted apart
        from the routes (``resilience_ladder_host_total``)."""
        outcomes: List[ProcessingOutcome] = []
        t0 = time.perf_counter()
        for doc in docs:
            METRICS.inc("resilience_ladder_host_total")
            outcome = self._host_outcome(doc)
            if outcome is not None:
                outcomes.append(outcome)
        self.counters["seconds"]["ladder_host"] += time.perf_counter() - t0
        return outcomes

    def _assemble(self, batch: PackedBatch, result, phase: int):
        """``assemble_phase`` of one ``run_batch`` result, its seconds added
        to the counters."""
        stats, host_s, dev_s = result
        secs = self.counters["seconds"]
        secs["device"][phase] = secs["device"].get(phase, 0.0) + host_s
        secs["device_busy"] += dev_s
        t0 = time.perf_counter()
        try:
            return self.assemble_phase(batch, stats, phase)
        finally:
            secs["assemble"] += time.perf_counter() - t0

    def _execute_packed(
        self, batch: PackedBatch, phase: int, pending, dispatcher=None
    ) -> Tuple[List[ProcessingOutcome], List[TextDocument]]:
        """One window entry through the degradation ladder.

        ``pending`` is what :meth:`_dispatch_window` left in the window.
        Rungs: (1) retry the whole batch under the device RetryPolicy;
        (2) split it in half and retry each half — out-of-memory recovery,
        and a bisection that saves the healthy half of a poisoned batch;
        (3) rerun the documents on the host oracle.  Fatal errors (per the
        classifier: deterministic ones and sticky CUDA errors) propagate
        immediately.  The circuit breaker counts batches that fell to the
        host rung; once tripped, the run stays on the host oracle until
        the half-open cooldown grants a probe.

        A window future's own failure is the JAX package's failed dispatch
        (the ladder starts with nothing in flight, and no retry is
        counted); a stall while waiting on it is the first attempt's
        failure, as the JAX package's first ``_device_fetch`` attempt
        stalls in its readiness wait.
        """
        first = None
        # A serial run's finished result is recorded below; a window
        # future's inside the caller's device_wait span.
        profiled = False
        if TELEMETRY.enabled and isinstance(pending, (Future, tuple)):
            # The caller starts waiting on the batch (serially its result
            # is already here: the dispatch stage held the whole batch).
            TELEMETRY.mark("device_wait", (d.id for d in batch.docs))
        if isinstance(pending, Future):
            t0 = time.perf_counter()
            try:
                with TRACER.span("device_wait", {"bucket": batch.max_len, "phase": phase}) as sp:
                    dispatcher.wait(pending)
                    exc = pending.exception()
                    if exc is None and PROFILER.enabled:
                        sp.add_args(self._record_dispatch(batch, phase, pending.result()))
                        profiled = True
            except StallError as e:
                first = e
            else:
                if exc is None:
                    pending = pending.result()
                else:
                    if self._retry.classify(exc) != "retryable":
                        raise exc
                    self._dispatch_failed(exc, phase)
                    pending = None
            finally:
                self._waited(time.perf_counter() - t0)
        if pending is _BREAKER_OPEN or (
            pending is None and not self._breaker.allow_request()
        ):
            # The breaker refused the dispatch (window sentinel) or refuses
            # the re-dispatch now: host rung, with no breaker recording —
            # the device was never asked.
            return self._host_rerun(batch.docs), []
        if isinstance(pending, tuple):
            if PROFILER.enabled and not profiled:
                self._record_dispatch(batch, phase, pending)
            self._breaker.record_success()
            return self._assemble(batch, pending, phase)
        try:
            result = self._device_fetch(batch, phase, dispatcher, first)
        except RetryExhaustedError as e:
            _drop_frames(e)  # descend the ladder below
        else:
            self._breaker.record_success()
            return self._assemble(batch, result, phase)

        fell_to_host = False
        outcomes: List[ProcessingOutcome] = []
        survivors: List[TextDocument] = []
        if self._split_retry and self.mesh is None and len(batch.docs) > 1:
            # Split rung: both halves pack to the same padded row count (a
            # mesh has none, as in the JAX package: retry, then host).
            METRICS.inc("resilience_ladder_split_total")
            TRACER.instant(
                "ladder_split", {"bucket": batch.max_len, "phase": phase}
            )
            if EVENTS.enabled:
                EVENTS.emit("ladder_split", batch=batch.max_len,
                            depth=len(batch.docs), phase=phase)
            sub_rows = self._split_rows(batch.batch_size)
            mid = (len(batch.docs) + 1) // 2
            for part in (batch.docs[:mid], batch.docs[mid:]):
                if not part:
                    continue
                sub = self._timed_pack(part, sub_rows, batch.max_len)
                try:
                    result = self._device_fetch(sub, phase, dispatcher)
                except RetryExhaustedError as e:
                    _drop_frames(e)
                    fell_to_host = True
                    outcomes.extend(self._host_rerun(part))
                else:
                    o, alive = self._assemble(sub, result, phase)
                    outcomes.extend(o)
                    survivors.extend(alive)
        else:
            fell_to_host = True
            outcomes.extend(self._host_rerun(batch.docs))

        if fell_to_host:
            TRACER.instant(
                "ladder_host", {"bucket": batch.max_len, "phase": phase}
            )
            if EVENTS.enabled:
                EVENTS.emit("ladder_host", batch=batch.max_len, phase=phase)
            self._breaker.record_failure("device batch fell to host rung")
        else:
            self._breaker.record_success()
        return outcomes, survivors

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

    def _eval_badwords(self, step: StepConfig, idx: int, stats) -> "_StepEval":
        p = step.params
        langs = self._badwords_device_tables.get(idx, {})
        matches = {lang: np.asarray(stats[f"{idx}:match:{lang}"], dtype=bool) for lang in langs}
        hazards = {lang: np.asarray(stats[f"{idx}:hazard:{lang}"], dtype=bool) for lang in langs}

        def decide(row: int, doc: TextDocument) -> _Decision:
            # The device delivers the regex verdict for every language with
            # tables (ops/badwords.py: a spurious match needs a double
            # 32-bit collision).  Matching documents only draw the keep
            # fraction here, seeded per document (hash of seed and id), so
            # independent of batch order; documents of languages without
            # tables run the whole host filter (download / passed_no_regex
            # / fail_on_missing_language, c4_filters.rs:456-552).
            from ..errors import DocumentFiltered

            host_step = self._badwords_host_step(idx)
            doc_lang = doc.metadata.get("language", p.default_language)
            m = matches.get(doc_lang)
            if m is not None and hazards[doc_lang][row]:
                # A host regex re-decision of a fold-hazard row: host work,
                # counted under its own name.
                METRICS.inc("worker_fold_hazard_rows_total")
            if m is None or hazards[doc_lang][row]:
                # No tables for the language, or the row holds a code point
                # whose IGNORECASE folding this language's table cannot
                # express: the host regex decides.
                try:
                    host_step.process(doc)  # stamps metadata itself
                except DocumentFiltered as e:
                    return _Decision(False, e.reason)
                return _Decision(True)
            if not m[row]:
                doc.metadata["c4_badwords_filter_status"] = "passed"
                return _Decision(True)
            if p.keep_fraction > 0.0 and host_step._keep_draw(doc.id) < p.keep_fraction:
                doc.metadata["c4_badwords_filter_status"] = "passed_kept_by_fraction"
                return _Decision(True)
            reason = "document_removed_with_badwords"
            doc.metadata["c4_badwords_filter_status"] = "filtered"
            doc.metadata["c4_badwords_filter_reason"] = reason
            return _Decision(False, reason)

        # No batch verdict: the document's language is known per row, so
        # _assemble_row's badwords branch decides before ev.passed is read.
        ev = _StepEval(passed=None, decide=decide, pass_stamps=None)
        ev.badwords_matches = matches
        ev.badwords_default_language = p.default_language
        ev.badwords_fold_hazard = hazards
        return ev

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
        if TELEMETRY.enabled:
            TELEMETRY.mark("assemble", (d.id for d in batch.docs))
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
        # Rows that pass the whole phase only take metadata pass-stamps.  A
        # step without a batch verdict (badwords: the document's language
        # is known per row) sends every row down the per-row path.
        fast_mask = ~overflow_any
        for _, ev in evals:
            if ev.passed is None:
                fast_mask[:] = False
                break
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
                METRICS.inc("worker_host_fallback_total")
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

    _BADWORDS_PASS_STAMPS = (("c4_badwords_filter_status", "passed"),)

    def _assemble_row(self, evals, row: int, doc: TextDocument) -> Optional[ProcessingOutcome]:
        """Walk one row through this phase's steps; ``None`` means it passed
        them all (the caller decides success vs next-phase survival)."""
        for step, ev in evals:
            if ev.badwords_matches is not None:
                # Fast path for a non-matching, hazard-free row of a language
                # with tables (the common case: no host work); matches and
                # languages without tables go through decide().
                doc_lang = doc.metadata.get("language", ev.badwords_default_language)
                m = ev.badwords_matches.get(doc_lang)
                if m is not None and not m[row] and not ev.badwords_fold_hazard[doc_lang][row]:
                    for k, v in self._BADWORDS_PASS_STAMPS:
                        doc.metadata[k] = v
                    continue
            elif ev.passed[row] and ev.pass_stamps is not None:
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
                # Funnel attribution: the device-path twin of the host seam
                # in orchestration.execute_processing_pipeline — together
                # the only two creators of FILTERED outcomes.
                METRICS.inc(FILTER_DROP_PREFIX + step.type)
                return ProcessingOutcome.filtered(doc, decision.reason)
        return None

    def _timed_pack(
        self, docs: List[TextDocument], batch_size: int, max_len: int
    ) -> PackedBatch:
        """``pack_documents`` with the pack-stage wall clock added to
        ``counters["seconds"]["pack"]`` (pack workers run it concurrently)
        and ``stage_pack_seconds``."""
        if TELEMETRY.enabled:
            TELEMETRY.mark("pack", (d.id for d in docs))
        t0 = time.perf_counter()
        try:
            with TRACER.span("pack", {"rows": len(docs), "bucket": max_len}):
                return pack_documents(docs, batch_size=batch_size, max_len=max_len)
        finally:
            dt = time.perf_counter() - t0
            with self._pack_lock:
                self.counters["seconds"]["pack"] += dt
            METRICS.inc("stage_pack_seconds", dt)

    def _packed_source(self, docs_iter, host_tail_max, route_fn, overlapped):
        """The packer stage for one phase.

        Serial: the grouping generator inline, packing on the caller's
        thread.  Overlapped: the generator runs ahead on a prefetch thread
        and each ``pack`` is a thread-pool future (the encode/scatter work
        releases the GIL), so grouping+packing of batch i+1.. overlap the
        caller's dispatch/assembly of batch i.  Either way items arrive in
        the generator's order — the overlap changes timing, never sequence.

        Returns ``(iterable of (batch_or_future, fallback_docs), close_fn)``.
        """
        kwargs = dict(
            geometry=self.geometry,
            host_tail_max=host_tail_max,
            route_fn=route_fn,
            overflow_flush=max(1, self._overlap.overflow_flush),
        )
        if not overlapped:
            gen = iter_packed_batches(docs_iter, pack_fn=self._timed_pack, **kwargs)
            return gen, lambda: None
        # One process-wide pool: pack work releases the GIL, and every
        # caller resolves its own futures FIFO, so sharing changes no
        # ordering.
        pool = shared_pack_pool(max(1, self._overlap.pack_workers))

        def submit(docs, batch_size, max_len):
            return pool.submit(
                self._timed_pack, docs, batch_size=batch_size, max_len=max_len
            )

        gen = iter_packed_batches(docs_iter, pack_fn=submit, **kwargs)
        pf = prefetch_iter(
            gen, depth=max(2, self._overlap.pack_workers + 1), block=1
        )
        return pf, pf.close

    def process_chunk(self, docs: List[TextDocument]) -> Iterator[ProcessingOutcome]:
        """Run one chunk of documents through every phase, repacking the
        survivors between phases (device-side short-circuit).

        Batches ride a FIFO in-flight window ``pipeline_depth`` deep: the
        dispatch thread runs batches i+1..i+K on the device while this
        thread assembles batch i and runs the host routes.  Outcomes are
        emitted in the strict FIFO order of the packer's output items at
        EVERY depth — the window moves the waits, never the sequence — so
        serial (``TEXTBLAST_NO_OVERLAP=1`` or ``overlap.enabled: false``)
        and overlapped runs produce identical outcome streams by
        construction.  The dispatch thread ends with the chunk, with the
        generator's close and on any error; an error raised on it reaches
        the caller when its batch is the oldest in the window, where the
        degradation ladder (:meth:`_execute_packed`) takes it.
        """
        debug = os.environ.get("TEXTBLAST_PHASE_DEBUG") == "1"
        # A mesh has no window, as in the JAX package.
        overlapped = (
            self._overlap.enabled
            and os.environ.get("TEXTBLAST_NO_OVERLAP") != "1"
            and self.mesh is None
        )
        depth = max(1, self._overlap.pipeline_depth) if overlapped else 1
        counters = self.counters
        secs = counters["seconds"]
        current: List[TextDocument] = docs
        # Routing decisions recorded at route_fn time (the packer calls
        # route_fn once per non-over-length doc): the cause, or None.  The
        # fallback classification below reuses them.
        routed: Dict[int, Optional[str]] = {}
        _host_routed = None
        if self._route_dict_scripts or self.wire_u16:
            from ..utils.cjk import has_astral, has_dict_script

            route_dict = self._route_dict_scripts
            route_astral = self.wire_u16

            def _host_routed(doc: TextDocument) -> bool:
                if route_dict and has_dict_script(doc.content):
                    cause = "dict_script"
                elif route_astral and has_astral(doc.content):
                    cause = "astral"
                else:
                    cause = None
                routed[id(doc)] = cause
                return cause is not None

        over_length = self.buckets[-1] - PACK_MARGIN
        dispatcher = _DispatchThread(self) if overlapped else None
        try:
            for phase in range(len(self.phases)):
                t0 = time.perf_counter()
                n_in, n_batches = len(current), 0
                survivors: List[TextDocument] = []
                # FIFO window entries: ("batch", (batch, pending)) with
                # pending the dispatch thread's future (overlapped) or the
                # finished result (serial), or ("host", docs) fallback
                # groups awaiting their host-oracle pass.  ``inflight``
                # counts batch entries only.
                window: deque = deque()
                inflight = 0
                # Host-oracle threshold for leftover groups: the first
                # phase's function is cheap (it exists to kill docs early),
                # so the device wins even for small groups; later phases
                # carry the expensive statistics and the (bit-exact) host
                # oracle wins below ~half a batch.  TEXTBLAST_HOST_TAILS=off
                # keeps tails on the device (the parity suites use it so
                # the device decides every doc), and so does a mesh (shard
                # accounting, as in the JAX package).  Per bucket: the
                # cutoff tracks each bucket's own row budget.
                if self.mesh is None and os.environ.get("TEXTBLAST_HOST_TAILS") != "off":
                    div = 16 if phase == 0 else 2
                    host_tail_max = {
                        b: self.geometry.batch_for(b) // div
                        for b in self.geometry.buckets
                    }
                else:
                    host_tail_max = 0
                # Phase 0 only: later phases' survivors already passed it.
                route = _host_routed if phase == 0 else None

                def _process_fallback(fallback_docs):
                    outs = []
                    for doc in fallback_docs:
                        # Over-length and routed (dict-script/astral) docs
                        # are genuine fallbacks; leftover tail groups are
                        # deliberate routing — counted apart.
                        cause = routed.get(id(doc)) if route is not None else None
                        tail = cause is None and len(doc.content) <= over_length
                        if tail:
                            counters["host_tail"] += 1
                            METRICS.inc("worker_host_tail_total")
                        else:
                            counters["host_fallback"] += 1
                            METRICS.inc("worker_host_fallback_total")
                            if cause is not None:
                                counters[f"host_routed_{cause}"] += 1
                        ta = time.perf_counter()
                        outcome = self._host_outcome(doc)
                        dt = time.perf_counter() - ta
                        secs["host_routes"] += dt
                        if tail:
                            secs["host_tails"] += dt
                        if outcome is not None:
                            outs.append(outcome)
                    return outs

                def _drain_front():
                    nonlocal inflight
                    kind, payload = window.popleft()
                    ta = time.perf_counter()
                    with TRACER.span("post", {"kind": kind, "phase": phase}):
                        if kind == "batch":
                            inflight -= 1
                            METRICS.set("inflight_batches", inflight)
                            TRACER.counter("inflight_batches", inflight)
                            batch, pending = payload
                            del payload
                            outcomes, alive = self._execute_packed(
                                batch, phase, pending, dispatcher
                            )
                            survivors.extend(alive)
                        else:
                            outcomes = _process_fallback(payload)
                    dt = time.perf_counter() - ta
                    secs["drain"] += dt
                    METRICS.inc("stage_post_seconds", dt)
                    return outcomes

                src, src_close = self._packed_source(
                    iter(current),
                    host_tail_max=host_tail_max,
                    route_fn=route,
                    overlapped=overlapped,
                )
                try:
                    for item, fallback in src:
                        if item is not None:
                            # Overlapped items are pack futures; resolving
                            # here keeps FIFO order (futures complete out of
                            # order, but we only ever wait on the oldest).
                            if isinstance(item, Future):
                                if WATCHDOG.enabled:
                                    WATCHDOG.wait("pack_wait", item.done)
                                batch = item.result()
                            else:
                                batch = item
                            if overlapped:
                                METRICS.set("queue_depth_pack", src.qsize())
                                TRACER.counter("queue_depth_pack", src.qsize())
                            n_batches += 1
                            td = time.perf_counter()
                            with TRACER.span(
                                "dispatch",
                                {"bucket": batch.max_len,
                                 "rows": batch.batch_size, "phase": phase},
                            ):
                                pending = self._dispatch_window(batch, phase, dispatcher)
                            METRICS.inc("stage_dispatch_seconds", time.perf_counter() - td)
                            window.append(("batch", (batch, pending)))
                            inflight += 1
                            METRICS.set("inflight_batches", inflight)
                            TRACER.counter("inflight_batches", inflight)
                        if fallback:
                            window.append(("host", fallback))
                        # Host groups at the front never block on the
                        # device — draining them early IS the read/post
                        # overlap; batch entries drain once more than
                        # ``depth`` are in flight.
                        while window and (window[0][0] == "host" or inflight > depth):
                            yield from _drain_front()
                    while window:
                        yield from _drain_front()
                finally:
                    src_close()
                    METRICS.set("inflight_batches", 0)
                if debug:
                    print(
                        f"[phase {phase}] docs={n_in} batches={n_batches} "
                        f"survivors={len(survivors)} depth={depth} "
                        f"{time.perf_counter() - t0:.2f}s "
                        f"(wait {secs['wait']:.2f}s drain {secs['drain']:.2f}s)",
                        flush=True,
                    )
                current = survivors
                if not current:
                    break
        finally:
            if dispatcher is not None:
                dispatcher.close()
            if self.device_clock is not None:
                # The device clock's re-anchors so far: the drift between
                # the device's timer and the trace clock.
                TRACER.instant("device_clock", self.device_clock.stats())
            for dev, clock in self._mesh_clocks.items():
                TRACER.instant("device_clock", {**clock.stats(), "device": dev})


class _DispatchThread:
    """The window's dispatch stage: one thread that runs
    :meth:`CompiledPipeline.run_batch` for each submitted batch, in
    submission order, on one CUDA stream of its own (no stream on the CPU).

    The phase functions wait on the device inside (``.any()`` gates, the
    dup walk's step count) and the download waits for it, so a stream
    issued from the caller's thread would overlap nothing: the thread
    takes those waits instead.  One thread keeps launches in order and the
    launch counters exact, and no device tensor crosses threads.  A failed
    launch or build raises in the batch's future; the degradation ladder
    submits its re-attempts here too.

    The waits inside the phase functions block in the CUDA runtime, so
    with the watchdog armed the caller bounds them from outside
    (:meth:`wait`).  The thread is a daemon, so that a wedged one left
    behind by :meth:`close` cannot hold the interpreter at exit.
    """

    #: Poll interval of :meth:`wait` while the thread bounds its own wait.
    _POLL_S = 0.005

    def __init__(self, pipeline: CompiledPipeline) -> None:
        self._pipe = pipeline
        self._stream = (
            torch.cuda.Stream(device=pipeline.device)
            if pipeline.device.type == "cuda"
            else None
        )
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        # Bumped as each batch starts and ends: the progress the caller's
        # bounded wait watches.
        self._progress = 0
        self._thread = threading.Thread(
            target=self._loop, name="textblast-dispatch", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            fut, batch, phase = item
            if not fut.set_running_or_notify_cancel():
                continue
            self._progress += 1
            try:
                result = self._pipe.run_batch(batch, phase, self._stream)
            except BaseException as e:  # noqa: BLE001 — the caller's ladder decides
                # A failed batch waits in the window for the drain, behind
                # the batches before it; its frames would hold its device
                # tensors (an out-of-memory attempt's, up to its peak) until
                # then, and every attempt run meanwhile would find them.
                _drop_frames(e)
                fut.set_exception(e)
            else:
                fut.set_result(result)
            finally:
                self._progress += 1
                del item, fut

    def submit(self, batch: PackedBatch, phase: int) -> Future:
        fut: Future = Future()
        self._queue.put((fut, batch, phase))
        return fut

    def wait(self, fut: Future) -> None:
        """Return when ``fut`` is done.  With the watchdog armed, raise
        :class:`StallError` (stage ``device_fetch``) once this thread has
        spent the stage deadline without starting or finishing a batch,
        outside a beat of its own: inside one (the fault seam, the poll
        of a batch's end event) the thread bounds its wait itself, and the
        stall is counted once, there.  A batch queued behind others waits
        as long as the thread makes progress.  Disarmed, return at once
        (the caller's ``result()`` blocks)."""
        if fut.done() or not WATCHDOG.enabled:
            return
        if WATCHDOG.deadline_for("device_fetch") <= 0:
            return
        thread = self._thread
        while not fut.done():
            if WATCHDOG.in_beat(thread):
                time.sleep(self._POLL_S)
                continue
            mark = self._progress
            WATCHDOG.wait(
                "device_fetch",
                lambda: fut.done() or self._progress != mark or WATCHDOG.in_beat(thread),
                lambda: "the dispatch thread is stuck in one batch",
            )

    def close(self) -> None:
        """Cancel the batches not started, wait for the running one and
        join the thread.  With the watchdog armed the join is bounded: a
        thread that makes no progress for the ``device_fetch`` deadline is
        logged and left behind."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[0].cancel()
        self._queue.put(None)
        if not WATCHDOG.enabled:
            self._thread.join()
            return
        try:
            WATCHDOG.join_thread("device_fetch", self._thread, lambda: self._progress)
        except StallError as e:
            logger.error("Left the dispatch thread behind, wedged in a batch: %s", e)


_EVALS = {
    "LanguageDetectionFilter": CompiledPipeline._eval_langid,
    "GopherRepetitionFilter": CompiledPipeline._eval_gopher_rep,
    "GopherQualityFilter": CompiledPipeline._eval_gopher_quality,
    "C4QualityFilter": CompiledPipeline._eval_c4,
    "FineWebQualityFilter": CompiledPipeline._eval_fineweb,
    "C4BadWordsFilter": CompiledPipeline._eval_badwords,
}


def process_documents_device(
    config: PipelineConfig,
    docs: Iterable[Union[TextDocument, PipelineError]],
    device_batch: Optional[int] = None,
    on_read_error=None,
    buckets=DEFAULT_BUCKETS,
    pipeline: Optional[CompiledPipeline] = None,
    device=None,
    geometry: Optional[DeviceGeometry] = None,
    mesh: Optional[DataMesh] = None,
) -> Iterator[ProcessingOutcome]:
    """Device-backed processing loop: packs the stream into bucketed batches,
    runs the device pipeline phase by phase, and yields outcomes.

    Outcome order is deterministic but not input order (documents are
    grouped by length bucket); tests compare outputs as id-keyed sets, as
    for the JAX package.  Pass a prebuilt ``pipeline`` to reuse it (and to
    read its :attr:`~CompiledPipeline.counters` afterwards; the
    checkpointed runner processes one chunk per call).  A ``geometry``
    (calibrated or recorded) supersedes ``buckets`` / ``device_batch``; a
    ``mesh`` shards every batch's rows over its entries."""
    if pipeline is None:
        pipeline = CompiledPipeline(
            config, buckets=buckets, batch_size=device_batch, device=device,
            geometry=geometry, mesh=mesh,
        )
    # Nothing to warm up: the kernels were built with the pipeline, so it is
    # ready (the JAX package's maybe_warmup sets the gauge alike when it
    # skips warmup; /healthz reads it).
    METRICS.set("pipeline_warmup_done", 1)

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

    if PROFILER.enabled:
        # The cost pass, before the first dispatch (programs the PROFILER
        # already holds are skipped: the checkpointed runner calls this
        # once a chunk).
        pipeline.register_program_costs()

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
