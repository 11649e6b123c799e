"""End-to-end runner: Parquet in, kept/excluded Parquet out.

The port's counterpart of the device branch of
``textblaster_tpu/parallel/runner.py``.  Two backends share the
orchestration: ``device`` (the port's device pipeline on ``cuda``, or on
the CPU when asked) and ``host`` (the host oracle executor, one document at
a time — the parity baseline).  As the JAX runner meshes every device of a
host, a run that names no device shards its batches over every visible GPU
when there is more than one (``CUDA_VISIBLE_DEVICES`` chooses them).  A
multi-host rank (``parallel/multihost.py``) runs its row stripe through the
same path (``_run_rows``), so it writes what a single-process run over the
stripe writes.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from itertools import chain, islice
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import torch

from .config.pipeline import PipelineConfig
from .errors import PipelineError
from .orchestration import (
    AggregationResult,
    aggregate_results_from_stream,
    process_documents_host,
    read_documents,
)
from .ops.geometry import CALIBRATION_SAMPLE, DeviceGeometry, calibrate_geometry
from .ops.packing import DEFAULT_BUCKETS
from .ops.pipeline import CompiledPipeline, process_documents_device, resolve_device
from .parallel.mesh import DataMesh, data_mesh
from .pipeline_builder import build_pipeline_from_config
from .resilience.deadletter import DeadLetterSink
from .resilience.retry import RetryPolicy
from .utils.overlap import prefetch_iter
from .utils.telemetry import TELEMETRY, expected_waste
from .utils.trace import TRACER

logger = logging.getLogger(__name__)

__all__ = ["run_pipeline", "run_mesh"]


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
    auto_geometry: bool = False,
    mesh: Optional[DataMesh] = None,
) -> AggregationResult:
    """Process one Parquet shard.  ``device`` defaults to ``cuda``; pass a
    prebuilt ``pipeline`` to read its counters afterwards.  ``mesh``
    shards every device batch's rows over its entries; by default
    (:func:`run_mesh`) a run that names no device uses a mesh of every
    visible GPU when there is more than one.

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

    ``auto_geometry`` calibrates the device geometry from the data (the
    CLI's ``--auto-geometry``): the head of the stream, up to
    ``CALIBRATION_SAMPLE`` documents, is buffered, its lengths choose the
    buckets and per-bucket batch sizes, and the head is replayed ahead of
    the rest, so order and content are untouched.  It builds its own
    pipeline, so it takes no ``pipeline``.

    Unless ``quiet``, a progress line goes to stderr when it is a
    terminal."""
    deadletter = DeadLetterSink(errors_file) if errors_file is not None else None
    try:
        return _run_rows(
            config, input_file, output_file, excluded_file,
            text_column=text_column, id_column=id_column, backend=backend,
            device=device, read_batch_size=read_batch_size,
            device_batch=device_batch, buckets=buckets, pipeline=pipeline,
            deadletter=deadletter, quiet=quiet, auto_geometry=auto_geometry,
            mesh=mesh,
        )
    finally:
        if deadletter is not None:
            deadletter.close()


def _run_rows(
    config: PipelineConfig,
    input_file: str,
    output_file: str,
    excluded_file: str,
    *,
    text_column: str = "text",
    id_column: str = "id",
    backend: str = "device",
    device=None,
    read_batch_size: int = 1024,
    device_batch: Optional[int] = None,
    buckets: Optional[Sequence[int]] = None,
    pipeline: Optional[CompiledPipeline] = None,
    deadletter: Optional[DeadLetterSink] = None,
    quiet: bool = False,
    auto_geometry: bool = False,
    mesh: Optional[DataMesh] = None,
    geometry: Optional[DeviceGeometry] = None,
    skip_rows: int = 0,
    take: Optional[int] = None,
) -> AggregationResult:
    """:func:`run_pipeline` over rows ``[skip_rows, skip_rows + take)`` of
    ``input_file`` (every row from ``skip_rows`` when ``take`` is None),
    into the given paths and the given dead-letter sink (left open).  A
    ``geometry`` (a multi-host run's negotiated one) builds the pipeline
    on it.  The multi-host runner runs each rank's stripe through here, so
    a rank writes what a single-process run over its stripe writes."""
    if auto_geometry and (pipeline is not None or geometry is not None):
        raise ValueError(
            "run_pipeline: auto_geometry calibrates its own pipeline; "
            "pass no pipeline"
        )
    progress = _Progress(enabled=not quiet)
    read_errors = [0]
    read_seconds = [0.0]

    def on_read_error(err) -> None:
        read_errors[0] += 1
        if deadletter is not None:
            deadletter.record_read_error(err)

    calibrate = backend == "device" and pipeline is None and auto_geometry
    if backend == "device" and pipeline is None:
        mesh = run_mesh(device, mesh)
    if calibrate:
        # Fails here without CUDA, before the reader starts, as building
        # the pipeline does.
        device = resolve_device(device if mesh is None else mesh.devices[0])
    elif backend == "device" and pipeline is None:
        pipeline = _build_pipeline(
            config, buckets, device_batch, device, geometry, mesh=mesh
        )
    rows = read_documents(
        input_file, text_column=text_column, id_column=id_column,
        batch_size=read_batch_size,
        retry_policy=RetryPolicy.from_config(config.resilience),
        skip_rows=skip_rows,
    )
    if take is not None:
        rows = islice(rows, take)  # one stream item per Parquet row
    docs = _timed_iter(rows, read_seconds)
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
    # The read-ahead thread (if any) is stopped on every exit path, also
    # after the calibration pass re-wraps ``docs`` in a chain.
    doc_source = docs
    outcomes = None
    try:
        if calibrate:
            geometry, docs = _calibrate(docs, device)
            pipeline = _build_pipeline(
                config, buckets, device_batch, device if mesh is None else None, geometry,
                mesh,
            )
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
        # Stop the pipeline's dispatch thread and the read-ahead thread on
        # every exit path, not when a traceback lets go of the generator.
        if outcomes is not None:
            outcomes.close()
        if overlapped:
            doc_source.close()
    progress.finish()
    result.read_errors = read_errors[0]
    result.seconds["read"] = read_seconds[0]
    return result


def run_mesh(device, mesh: Optional[DataMesh]) -> Optional[DataMesh]:
    """The mesh of a device run: ``mesh`` when given; else, when the caller
    names no ``device`` and more than one GPU is visible, a mesh of every
    visible GPU (the JAX runner's ``data_mesh() if len(jax.devices()) > 1``);
    else none (one device)."""
    if mesh is not None or device is not None:
        return mesh
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        return data_mesh()
    return None


def _build_pipeline(
    config, buckets, device_batch, device, geometry=None, mesh=None
) -> CompiledPipeline:
    """The device pipeline of a run: ``geometry`` when given (calibrated or
    recorded), else ``buckets`` (default ladder) at ``device_batch`` rows
    (the device's default); over ``mesh`` when given, its batch sizes
    rounded to a multiple of its entries."""
    return CompiledPipeline(
        config,
        buckets=tuple(buckets) if buckets else DEFAULT_BUCKETS,
        batch_size=device_batch,
        device=device,
        geometry=geometry,
        mesh=mesh,
    )


def _calibrate(docs: Iterable, device) -> Tuple[Optional[DeviceGeometry], Iterator]:
    """The calibration pass: buffer the head of ``docs`` (up to
    ``CALIBRATION_SAMPLE`` items), calibrate a geometry for ``device``'s
    type from its documents' lengths (None when the head holds none: the
    default ladder applies), and return it with an iterator that yields
    the head, then the rest."""
    it = iter(docs)
    geometry = None
    with TRACER.span("calibration"):
        head = list(islice(it, CALIBRATION_SAMPLE))
        lengths = [len(d.content) for d in head if not isinstance(d, PipelineError)]
        if lengths:
            geometry = calibrate_geometry(lengths, backend=device)
            logger.info(
                "Auto-calibrated device geometry from %d sampled documents: %s",
                len(lengths),
                geometry.describe(),
            )
            if TELEMETRY.enabled:
                # Drift baseline: the waste this geometry implies for the
                # calibration sample — what the live rollup windows are
                # compared against.
                TELEMETRY.set_geometry_baseline(expected_waste(lengths, geometry))
    return geometry, chain(head, it)


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
