"""End-to-end runner: Parquet in, kept/excluded Parquet out.

The port's counterpart of the device branch of
``textblaster_tpu/parallel/runner.py``.  Two backends share the
orchestration: ``device`` (the port's device pipeline on ``cuda``, or on
the CPU when asked) and ``host`` (the host oracle executor, one document at
a time — the parity baseline).
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Iterable, Iterator, List, Optional, Sequence

from .config.pipeline import PipelineConfig
from .orchestration import (
    AggregationResult,
    aggregate_results_from_stream,
    process_documents_host,
    read_documents,
)
from .ops.packing import DEFAULT_BUCKETS
from .ops.pipeline import CompiledPipeline, process_documents_device
from .pipeline_builder import build_pipeline_from_config
from .resilience.deadletter import DeadLetterSink
from .resilience.retry import RetryPolicy
from .utils.overlap import prefetch_iter

logger = logging.getLogger(__name__)

__all__ = ["run_pipeline"]


class _Progress:
    """Single-line progress display on stderr (the reference's indicatif
    bars, bin/producer.rs:31-46): only on a terminal, and throttled by
    time."""

    def __init__(self, enabled: bool, min_interval_s: float = 0.1) -> None:
        self.enabled = enabled and sys.stderr.isatty()
        self.min_interval_s = min_interval_s
        self._last_t = 0.0

    def update(self, result: AggregationResult) -> None:
        if not self.enabled:
            return
        # Throttled by TIME, not document count: at high docs/s an
        # every-N-docs refresh puts terminal IO in the hot loop.
        now = time.monotonic()
        if now - self._last_t < self.min_interval_s:
            return
        self._last_t = now
        print(
            f"\rprocessed={result.received} kept={result.success} "
            f"excluded={result.filtered} errors={result.errors}",
            end="",
            file=sys.stderr,
        )

    def finish(self) -> None:
        if self.enabled:
            print(file=sys.stderr)


def run_pipeline(
    config: PipelineConfig,
    input_file: str,
    output_file: str,
    excluded_file: str,
    text_column: str = "text",
    id_column: str = "id",
    backend: str = "device",
    device=None,
    read_batch_size: int = 1024,
    device_batch: Optional[int] = None,
    buckets: Optional[Sequence[int]] = None,
    pipeline: Optional[CompiledPipeline] = None,
    errors_file: Optional[str] = None,
    quiet: bool = False,
) -> AggregationResult:
    """Process one Parquet shard.  ``device`` defaults to ``cuda``; pass a
    prebuilt ``pipeline`` to read its counters afterwards.

    ``errors_file`` opts into the dead-letter Parquet file: every Error
    outcome and every unreadable row lands there (the kept/excluded pair
    is the same with or without it).  Row groups are read under the
    ``resilience:`` retry policy; one that stays unreadable is quarantined,
    one read error per row.

    The device backend overlaps by default (``config.overlap``): the
    reader runs ahead on its own thread, the pipeline keeps
    ``pipeline_depth`` batches in flight on its dispatch thread, and the
    kept/excluded writers drain on writer threads.  Every stage is strict
    FIFO, so the files are byte-identical to the serial path's
    (``overlap.enabled: false`` or ``TEXTBLAST_NO_OVERLAP=1``).

    Unless ``quiet``, a progress line goes to stderr when it is a
    terminal."""
    progress = _Progress(enabled=not quiet)
    read_errors = [0]
    read_seconds = [0.0]
    deadletter = DeadLetterSink(errors_file) if errors_file is not None else None

    def on_read_error(err) -> None:
        read_errors[0] += 1
        if deadletter is not None:
            deadletter.record_read_error(err)

    if backend == "device" and pipeline is None:
        pipeline = CompiledPipeline(
            config,
            buckets=tuple(buckets) if buckets else DEFAULT_BUCKETS,
            batch_size=device_batch,
            device=device,
        )
    docs = _timed_iter(
        read_documents(
            input_file, text_column=text_column, id_column=id_column,
            batch_size=read_batch_size,
            retry_policy=RetryPolicy.from_config(config.resilience),
        ),
        read_seconds,
    )
    oc = config.overlap
    overlapped = (
        backend == "device"
        and oc.enabled
        and os.environ.get("TEXTBLAST_NO_OVERLAP") != "1"
    )
    if overlapped:
        docs = prefetch_iter(
            docs, depth=oc.read_ahead, block=max(64, read_batch_size // 4)
        )
    outcomes = None
    try:
        if backend == "device":
            outcomes = process_documents_device(
                config, docs, on_read_error=on_read_error, pipeline=pipeline
            )
        elif backend == "host":
            outcomes = process_documents_host(
                build_pipeline_from_config(config), docs, on_read_error=on_read_error
            )
        else:
            raise ValueError(f"unknown backend {backend!r}")
        result = aggregate_results_from_stream(
            outcomes,
            output_file=output_file,
            excluded_file=excluded_file,
            progress=progress.update,
            deadletter=deadletter,
            write_queue=oc.write_queue if overlapped else 0,
        )
    finally:
        # Stop the pipeline's dispatch thread and the read-ahead thread, and
        # close the dead-letter file, on every exit path, not when a
        # traceback lets go of the generator.
        try:
            if outcomes is not None:
                outcomes.close()
            if overlapped:
                docs.close()
        finally:
            if deadletter is not None:
                deadletter.close()
    progress.finish()
    result.read_errors = read_errors[0]
    result.seconds["read"] = read_seconds[0]
    return result


def _timed_iter(items: Iterable, acc: List[float]) -> Iterator:
    """``items`` with the host-clock seconds spent producing them added to
    ``acc[0]`` (on whichever thread iterates)."""
    it = iter(items)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            acc[0] += time.perf_counter() - t0
            return
        acc[0] += time.perf_counter() - t0
        yield item
