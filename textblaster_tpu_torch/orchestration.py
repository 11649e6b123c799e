"""Orchestration: feed documents in, aggregate outcomes out.

The port's copy of the JAX package's ``orchestration.py``, with its metric
hooks (the ``worker_*`` and ``producer_*`` series and the host seam of the
per-filter funnel, ``filter_dropped_total_<step>``).

TPU-native re-design of the reference's producer/worker split
(``/root/reference/src/producer_logic.rs``, ``worker_logic.rs``): there is no
broker hop — documents flow straight from the Parquet reader into either the
host executor (oracle/baseline path) or the compiled device pipeline, and
outcomes flow straight into the aggregation sink.  The aggregation semantics
are the reference's exactly:

* Success -> output file, Filtered -> excluded file, batched at
  ``PARQUET_WRITE_BATCH_SIZE`` = 500 (producer_logic.rs:21, 148-167);
* **Error outcomes land in neither file** (producer_logic.rs:168-170,
  SURVEY.md §7 quirk #2);
* remainders flushed and writers closed at stream end (rs:185-193).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Optional, Tuple, Union

from .data_model import ProcessingOutcome, TextDocument
from .errors import PipelineError, StepError
from .executor import PipelineExecutor
from .io import ParquetInputConfig, ParquetReader, ParquetWriter
from .utils.metrics import FILTER_DROP_PREFIX, METRICS

logger = logging.getLogger(__name__)

PARQUET_WRITE_BATCH_SIZE = 500  # producer_logic.rs:21
DEFAULT_READ_BATCH_SIZE = 1024  # producer_logic.rs:37

__all__ = [
    "PARQUET_WRITE_BATCH_SIZE",
    "AggregationResult",
    "read_documents",
    "execute_processing_pipeline",
    "process_documents_host",
    "aggregate_results_from_stream",
]


@dataclass
class AggregationResult:
    """(received, success, filtered) counts (producer_logic.rs:195)."""

    received: int = 0
    success: int = 0
    filtered: int = 0
    errors: int = 0
    read_errors: int = 0
    #: Host-clock seconds of the Parquet stages, on whichever thread ran
    #: them: ``write`` (both writers' ``write_batch`` and ``close``) and
    #: ``read`` (the reader's, where the runner measured it).
    seconds: dict = field(default_factory=lambda: {"read": 0.0, "write": 0.0})


def read_documents(
    input_file: str,
    text_column: str = "text",
    id_column: str = "id",
    batch_size: int = DEFAULT_READ_BATCH_SIZE,
    skip_rows: int = 0,
    retry_policy=None,
) -> Iterator[Union[TextDocument, PipelineError]]:
    """Stream documents off disk (publish_tasks' reading half,
    producer_logic.rs:30-44).  ``skip_rows`` seeks past the first rows
    without decoding them (row-group cursor).  ``retry_policy`` overrides
    the reader's default guard on the row-group read seam."""
    reader = ParquetReader(
        ParquetInputConfig(
            path=input_file,
            text_column=text_column,
            id_column=id_column,
            batch_size=batch_size,
        ),
        retry_policy=retry_policy,
    )
    return reader.read_documents(skip_rows=skip_rows)


def execute_processing_pipeline(
    executor: PipelineExecutor, document: TextDocument, worker_id: str = "host-0"
) -> Optional[ProcessingOutcome]:
    """One document through the executor -> outcome
    (worker_logic.rs:140-193): ``Ok`` -> Success, ``DocumentFiltered`` ->
    Filtered, any other step error -> Error outcome.

    The reference swallows hard errors (returns ``None`` and publishes no
    outcome, surfacing only as a count mismatch — worker_logic.rs:169-179).
    This build keeps the document visible in an Error outcome; the
    aggregation sink still writes it to neither file, preserving observable
    output parity while fixing the silent-loss accounting gap.
    """
    start = time.perf_counter()
    METRICS.inc("worker_active_tasks")
    try:
        result = executor.run_single(document)
        METRICS.inc("worker_tasks_processed_total")
        return ProcessingOutcome.success(result)
    except StepError as e:
        filtered = e.filtered()
        if filtered is not None:
            METRICS.inc("worker_tasks_filtered_total")
            # Funnel attribution: this is one of exactly two seams that
            # create a FILTERED outcome (the other is _assemble_row on the
            # device path), so the per-filter counters sum to the
            # excluded-Parquet row count by construction.
            METRICS.inc(FILTER_DROP_PREFIX + e.step_name)
            return ProcessingOutcome.filtered(filtered.document, filtered.reason)
        METRICS.inc("worker_tasks_failed_total")
        logger.error("Hard error in step '%s': %s", e.step_name, e.source)
        return ProcessingOutcome.error(document, str(e), worker_id)
    finally:
        METRICS.dec("worker_active_tasks")
        METRICS.observe("worker_task_processing_duration_seconds",
                        time.perf_counter() - start)


def process_documents_host(
    executor: PipelineExecutor,
    documents: Iterable[Union[TextDocument, PipelineError]],
    worker_id: str = "host-0",
    on_read_error: Optional[Callable[[PipelineError], None]] = None,
) -> Iterator[ProcessingOutcome]:
    """The host (CPU oracle / baseline) processing loop: the broker-free
    equivalent of process_tasks_with_executor (worker_logic.rs:241-283)."""
    for item in documents:
        if isinstance(item, PipelineError):
            logger.warning("Error reading document for task. Skipping. %s", item)
            if on_read_error is not None:
                on_read_error(item)
            continue
        outcome = execute_processing_pipeline(executor, item, worker_id)
        if outcome is not None:
            yield outcome


def aggregate_results_from_stream(
    stream: Iterable[ProcessingOutcome],
    output_file: str,
    excluded_file: str,
    published_count: Optional[int] = None,
    progress: Optional[Callable[[AggregationResult], None]] = None,
    deadletter=None,
    write_queue: int = 0,
) -> AggregationResult:
    """Route outcomes to the kept/excluded Parquet pair
    (producer_logic.rs:109-196).  Broker-independent: accepts any iterable of
    outcomes — the seam the reference's fake-stream tests rely on
    (producer_tests.rs:324-573).

    ``deadletter`` (a :class:`~textblaster_tpu_torch.resilience.DeadLetterSink`)
    additionally receives every Error outcome; the kept/excluded pair still
    gets neither-file behavior for them, so the default artifacts are
    byte-identical with or without the sink.

    ``write_queue`` > 0 moves the actual Parquet writes onto a writer
    thread behind a bounded FIFO queue that deep (the overlapped pipeline's
    writer stage).  Batch boundaries and order are unchanged, so the files
    are byte-identical either way; a write error surfaces at the next
    ``write_batch`` or at close instead of at the failing call.
    """
    import os

    for f in (output_file, excluded_file):
        parent = os.path.dirname(f)
        if parent:
            os.makedirs(parent, exist_ok=True)

    result = AggregationResult()
    writers = (ParquetWriter(output_file), ParquetWriter(excluded_file))
    out_writer, excl_writer = writers
    if write_queue > 0:
        from .utils.overlap import ThreadedWriter

        out_writer = ThreadedWriter(out_writer, max_queue=write_queue)
        excl_writer = ThreadedWriter(excl_writer, max_queue=write_queue)

    out_batch: list[TextDocument] = []
    excl_batch: list[TextDocument] = []

    # Teardown discipline: each flush/close runs in its own guard so a failed
    # kept-file flush can neither mask the exception that aborted the stream
    # nor leak the excluded writer's file handle.  On a clean exit the first
    # teardown failure (if any) is re-raised; while a primary exception is
    # propagating, teardown failures are logged and suppressed.
    primary: Optional[BaseException] = None
    try:
        for outcome in stream:
            result.received += 1
            if outcome.kind == ProcessingOutcome.SUCCESS:
                result.success += 1
                METRICS.inc("producer_results_success_total")
                out_batch.append(outcome.document)
                if len(out_batch) >= PARQUET_WRITE_BATCH_SIZE:
                    out_writer.write_batch(out_batch)
                    out_batch.clear()
            elif outcome.kind == ProcessingOutcome.FILTERED:
                result.filtered += 1
                METRICS.inc("producer_results_filtered_total")
                excl_batch.append(outcome.document)
                if len(excl_batch) >= PARQUET_WRITE_BATCH_SIZE:
                    excl_writer.write_batch(excl_batch)
                    excl_batch.clear()
            else:
                # Error outcomes are counted in neither file (rs:168-170);
                # the opt-in dead-letter sink is the only place they land.
                result.errors += 1
                METRICS.inc("producer_results_error_total")
                if deadletter is not None:
                    deadletter.record_outcome(outcome)
            METRICS.inc("producer_results_received_total")
            if progress is not None:
                progress(result)
            if published_count is not None and result.received >= published_count:
                break

        if published_count is not None and result.received < published_count:
            logger.warning("Outcome stream closed before all outcomes received.")
    except BaseException as e:
        primary = e
        raise
    finally:
        teardown_error: Optional[BaseException] = None

        def guarded(step: Callable[[], None]) -> None:
            nonlocal teardown_error
            try:
                step()
            except BaseException as e:  # noqa: BLE001 — collected, not lost
                if teardown_error is None:
                    teardown_error = e
                else:
                    logger.error("Additional writer-teardown failure: %s", e)

        if out_batch:
            guarded(lambda: out_writer.write_batch(out_batch))
        if excl_batch:
            guarded(lambda: excl_writer.write_batch(excl_batch))
        guarded(out_writer.close)
        guarded(excl_writer.close)
        result.seconds["write"] = sum(w.seconds for w in writers)
        if teardown_error is not None:
            if primary is None:
                raise teardown_error
            logger.error(
                "Writer teardown failed while handling %r: %s",
                primary,
                teardown_error,
            )

    return result

