"""End-to-end runner: Parquet in, kept/excluded Parquet out.

The port's counterpart of the device branch of
``textblaster_tpu/parallel/runner.py``.  Two backends share the
orchestration: ``device`` (the port's device pipeline on ``cuda``, or on
the CPU when asked) and ``host`` (the host oracle executor, one document at
a time — the parity baseline).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

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

logger = logging.getLogger(__name__)

__all__ = ["run_pipeline"]


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
) -> AggregationResult:
    """Process one Parquet shard.  ``device`` defaults to ``cuda``; pass a
    prebuilt ``pipeline`` to read its counters afterwards."""
    read_errors = [0]

    def on_read_error(err) -> None:
        read_errors[0] += 1

    docs = read_documents(
        input_file, text_column=text_column, id_column=id_column,
        batch_size=read_batch_size,
    )
    if backend == "device":
        if pipeline is None:
            pipeline = CompiledPipeline(
                config,
                buckets=tuple(buckets) if buckets else DEFAULT_BUCKETS,
                batch_size=device_batch,
                device=device,
            )
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
        outcomes, output_file=output_file, excluded_file=excluded_file
    )
    result.read_errors = read_errors[0]
    return result
