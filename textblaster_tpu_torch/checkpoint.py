"""Checkpoint / resume for pipeline runs.

The port's copy of ``textblaster_tpu/checkpoint.py`` without the elastic
stripe loop (``run_stripe_checkpointed`` and ``StripeLost`` come with the
multi-host path):

* the run is processed in **chunks** of documents; after each chunk the kept
  and excluded rows land in per-chunk Parquet part files and a JSON cursor
  (consumed-row count, outcome counts, part list, input + config
  fingerprints, the device geometry) is committed atomically (tmp +
  rename);
* a restart after a crash re-opens the cursor, verifies the fingerprints
  and the geometry, skips the consumed prefix of the reader stream, and
  continues from the next chunk — completed work is never recomputed;
* at stream end the parts concatenate into the reference-shaped single
  kept/excluded Parquet pair and the subsystem's files are removed.

Chunk boundaries are also device-batch flush barriers, so the consumed
prefix exactly matches the set of produced outcomes — the property the
cursor relies on (the bucketed packer holds partial batches *within* a
chunk, never across a checkpoint).  On the device each chunk's outcome
generator is closed before the chunk commits, so no dispatch thread
outlives its chunk.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from dataclasses import dataclass, field
from itertools import islice
from typing import Callable, Iterator, List, Optional

import pyarrow.parquet as pq

from .config.pipeline import PipelineConfig
from .data_model import ProcessingOutcome
from .errors import CheckpointError
from .io.parquet_writer import OUTPUT_SCHEMA, ParquetWriter
from .orchestration import (
    PARQUET_WRITE_BATCH_SIZE,
    AggregationResult,
    process_documents_host,
    read_documents,
)
from .resilience.deadletter import (
    DEADLETTER_SCHEMA,
    DeadLetterSink,
    outcome_row,
    read_error_row,
)
from .resilience.faults import FAULTS
from .resilience.retry import RetryPolicy
from .ops.geometry import DeviceGeometry
from .ops.pipeline import process_documents_device, resolve_device
from .pipeline_builder import build_pipeline_from_config
from .parallel.mesh import DataMesh
from .runner import _build_pipeline, _calibrate, run_mesh
from .utils.events import EVENTS
from .utils.metrics import METRICS

logger = logging.getLogger(__name__)

__all__ = ["CheckpointState", "run_checkpointed", "CHECKPOINT_FILE"]

CHECKPOINT_FILE = "checkpoint.json"
_VERSION = 1

_DEFAULT_COMMIT_RETRY: Optional[RetryPolicy] = None


def _default_commit_retry() -> RetryPolicy:
    global _DEFAULT_COMMIT_RETRY
    if _DEFAULT_COMMIT_RETRY is None:
        _DEFAULT_COMMIT_RETRY = RetryPolicy()
    return _DEFAULT_COMMIT_RETRY


def _input_fingerprint(path: str) -> dict:
    st = os.stat(path)
    meta = pq.read_metadata(path)
    return {
        "path": os.path.abspath(path),
        "size": st.st_size,
        "mtime_ns": st.st_mtime_ns,
        "num_rows": meta.num_rows,
    }


def _config_fingerprint(config: PipelineConfig) -> str:
    spec = [
        {"type": s.type, "params": dataclasses.asdict(s.params)}
        for s in config.pipeline
    ]
    blob = json.dumps(spec, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


@dataclass
class CheckpointState:
    """The resumable cursor, serialized to ``<dir>/checkpoint.json``."""

    input: dict
    config_hash: str
    rows_consumed: int = 0
    read_errors: int = 0
    received: int = 0
    success: int = 0
    filtered: int = 0
    errors: int = 0
    out_parts: List[str] = field(default_factory=list)
    excl_parts: List[str] = field(default_factory=list)
    # Dead-letter part files (only populated when the run has an
    # ``errors_file``); absent in pre-resilience checkpoints, so the default
    # keeps old cursors loadable.
    err_parts: List[str] = field(default_factory=list)
    # The device geometry the run was started with (DeviceGeometry.to_dict()).
    # Chunk boundaries are batch flush barriers, so resuming with a different
    # geometry would silently reshuffle batches — resume verifies this field
    # and fails fast on mismatch.  Absent in pre-geometry cursors (None), so
    # the default keeps old cursors loadable.
    geometry: Optional[dict] = None
    # Elastic-membership owner token ({"rank", "incarnation"}) for per-rank
    # stripe cursors (the multi-host ``--elastic`` path): the process named
    # here is the only one allowed to advance the cursor, and adoption
    # rewrites it (:meth:`adopt`).  Absent in single-host cursors (None), so
    # the default keeps old cursors loadable.
    owner: Optional[dict] = None
    # Coordinated-path adoption marker (the multi-host path's
    # --survive-peer-loss): True once an adopter has fully reproduced a
    # dead rank's stripe and committed its shard files, so a later
    # re-adoption (the adopter itself died) skips the stripe instead of
    # repeating it.  Absent in older cursors (False), so the default keeps
    # them loadable.
    complete: bool = False
    version: int = _VERSION

    def save(
        self, ckpt_dir: str, retry_policy: Optional["RetryPolicy"] = None
    ) -> None:
        """Commit the cursor atomically AND durably.

        tmp + fsync(file) + rename + fsync(parent dir): without the
        directory fsync the rename itself can be lost on power failure, and
        a kill test could observe a missing-or-truncated ``checkpoint.json``
        after the commit reported success.  The whole commit is one guarded
        seam — transient IO faults are retried (the tmp file is rewritten
        from scratch each attempt, so a half-written tmp never survives
        into the rename).
        """
        policy = retry_policy or _default_commit_retry()

        def commit() -> None:
            FAULTS.fire("checkpoint.commit")
            tmp = os.path.join(ckpt_dir, CHECKPOINT_FILE + ".tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(dataclasses.asdict(self), f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(ckpt_dir, CHECKPOINT_FILE))
            dir_fd = os.open(ckpt_dir, os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)

        policy.run(commit, seam="checkpoint")
        if EVENTS.enabled:
            EVENTS.emit("checkpoint_commit", chunk=len(self.out_parts),
                        rows_consumed=self.rows_consumed)

    @classmethod
    def load(cls, ckpt_dir: str) -> Optional["CheckpointState"]:
        path = os.path.join(ckpt_dir, CHECKPOINT_FILE)
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as f:
            d = json.load(f)
        if d.get("version") != _VERSION:
            raise CheckpointError(
                f"checkpoint version {d.get('version')} is not supported"
            )
        return cls(**d)

    @classmethod
    def adopt(
        cls,
        ckpt_dir: str,
        owner: dict,
        *,
        input_fingerprint: dict,
        config_hash: str,
        retry_policy: Optional["RetryPolicy"] = None,
    ) -> "CheckpointState":
        """Claim (or create) a stripe cursor for ``owner`` and commit it.

        The elastic-membership claim point (``--elastic``): a process takes
        over a stripe — its own on a fresh start or rejoin, an evicted
        peer's on adoption — by rewriting the cursor's ``owner`` token.
        Work committed by the previous owner (``rows_consumed``, parts,
        counts) is kept verbatim, so the new owner resumes at the next
        chunk, replaying nothing.  Fingerprints are validated exactly like
        a single-host resume; a mismatch means the directory belongs to a
        different input or config and the caller must remove it.
        """
        FAULTS.fire("multihost.rejoin")
        state = cls.load(ckpt_dir)
        if state is None:
            state = cls(input=input_fingerprint, config_hash=config_hash)
        else:
            if state.input != input_fingerprint:
                raise CheckpointError(
                    f"stripe cursor in '{ckpt_dir}' was created for a "
                    f"different input ({state.input.get('path')}, "
                    f"{state.input.get('num_rows')} rows); remove the "
                    "membership directory to start over"
                )
            if state.config_hash != config_hash:
                raise CheckpointError(
                    f"stripe cursor in '{ckpt_dir}' was created with a "
                    "different pipeline config; remove the membership "
                    "directory to start over"
                )
        state.owner = dict(owner)
        if EVENTS.enabled:
            EVENTS.emit("checkpoint_adopted", owner=dict(owner),
                        rows_consumed=state.rows_consumed)
        state.save(ckpt_dir, retry_policy)
        return state


class _PartWriter:
    """Lazily-created Parquet part files, one per checkpointed chunk.

    Documents buffer to ``PARQUET_WRITE_BATCH_SIZE`` before hitting the
    writer (producer_logic.rs:21 parity) so each part gets a few large row
    groups instead of one per document.
    """

    def __init__(self, ckpt_dir: str, prefix: str, existing: List[str]) -> None:
        self.ckpt_dir = ckpt_dir
        self.prefix = prefix
        self.parts = list(existing)
        self._writer: Optional[ParquetWriter] = None
        self._current: Optional[str] = None
        self._buffer: List = []

    def append(self, doc) -> None:
        self._buffer.append(doc)
        if len(self._buffer) >= PARQUET_WRITE_BATCH_SIZE:
            self._flush()

    def _flush(self) -> None:
        if not self._buffer:
            return
        if self._writer is None:
            name = f"{self.prefix}-{len(self.parts):05d}.parquet"
            self._current = name
            self._writer = ParquetWriter(os.path.join(self.ckpt_dir, name))
        self._writer.write_batch(self._buffer)
        self._buffer.clear()

    def roll(self) -> None:
        """Flush and close the current part (if any) at a chunk boundary."""
        self._flush()
        if self._writer is not None:
            self._writer.close()
            self.parts.append(self._current)
            self._writer = None
            self._current = None

    def abort(self) -> None:
        self._buffer.clear()
        if self._writer is not None:
            self._writer.close()
            self._writer = None
            # The part is NOT recorded: a crash mid-chunk discards it and the
            # resume reprocesses the whole chunk.


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def _concat_parts(
    ckpt_dir: str, parts: List[str], out_path: str, schema=None
) -> None:
    schema = OUTPUT_SCHEMA if schema is None else schema
    parent = os.path.dirname(out_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    writer = pq.ParquetWriter(out_path, schema)
    try:
        for name in parts:
            table = pq.read_table(os.path.join(ckpt_dir, name))
            if table.num_rows:
                writer.write_table(table.cast(schema))
    finally:
        writer.close()


def run_checkpointed(
    config: PipelineConfig,
    input_file: str,
    output_file: str,
    excluded_file: str,
    ckpt_dir: str,
    chunk_size: int = 8192,
    text_column: str = "text",
    id_column: str = "id",
    backend: str = "device",
    device=None,
    read_batch_size: int = 1024,
    device_batch: Optional[int] = None,
    buckets=None,
    auto_geometry: bool = False,
    mesh: Optional[DataMesh] = None,
    progress: Optional[Callable[[AggregationResult], None]] = None,
    stop_after_chunks: Optional[int] = None,
    errors_file: Optional[str] = None,
) -> AggregationResult:
    """Run the pipeline with chunk-level checkpointing (resume by default).

    ``backend`` is ``device`` (the port's device pipeline on ``device``,
    ``cuda`` unless the caller asks for the CPU) or ``host`` (the host
    oracle), as for :func:`~textblaster_tpu_torch.runner.run_pipeline`,
    whose default ``mesh`` it takes too.  The cursor records the geometry
    of the pipeline as built (a mesh's rounding included), and a resume
    under a mesh rounds a recorded geometry again, so a run on a mesh and
    its resume on one device (or the other way round) write the same files
    wherever the rounding leaves the geometry as it was.

    ``stop_after_chunks`` aborts the run after N committed chunks — the fault
    -injection hook the crash/resume tests drive (see also the finer-grained
    :data:`~textblaster_tpu_torch.resilience.FAULTS` sites at the read /
    device / commit seams).

    ``errors_file`` opts into the dead-letter sink.  Dead-letter rows are
    committed as per-chunk part files inside ``ckpt_dir`` (recorded in the
    cursor) and concatenated at finalize, so a crash/resume cycle loses no
    quarantine records and re-records none twice.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    fingerprint = _input_fingerprint(input_file)
    config_hash = _config_fingerprint(config)

    # Resilience knobs are deliberately outside the config fingerprint, so
    # tuning them between a crash and its resume never invalidates the cursor.
    rc = getattr(config, "resilience", None)
    retry_policy = RetryPolicy.from_config(rc) if rc is not None else RetryPolicy()

    state = CheckpointState.load(ckpt_dir)
    resumed = state is not None
    if state is None and os.listdir(ckpt_dir):
        # A non-empty directory without a cursor is not ours: finalization
        # deletes the subsystem's artifacts, and starting a run inside e.g.
        # `--checkpoint-dir .` must never end with user files removed.
        raise CheckpointError(
            f"checkpoint directory '{ckpt_dir}' is not empty and contains no "
            f"{CHECKPOINT_FILE}; use an empty (or new) directory"
        )
    if state is not None:
        if state.input != fingerprint:
            raise CheckpointError(
                f"checkpoint in '{ckpt_dir}' was created for a different input "
                f"({state.input.get('path')}, {state.input.get('num_rows')} rows); "
                "remove the checkpoint directory to start over"
            )
        if state.config_hash != config_hash:
            raise CheckpointError(
                f"checkpoint in '{ckpt_dir}' was created with a different "
                "pipeline config; remove the checkpoint directory to start over"
            )
        logger.info(
            "Resuming from checkpoint: %d rows consumed, %d outcomes",
            state.rows_consumed,
            state.received,
        )
    else:
        state = CheckpointState(input=fingerprint, config_hash=config_hash)

    out_parts = _PartWriter(ckpt_dir, "out", state.out_parts)
    excl_parts = _PartWriter(ckpt_dir, "excl", state.excl_parts)

    read_errors_box = [state.read_errors]
    # Dead-letter rows buffer per chunk and are committed as an err-part at
    # the same boundary as the kept/excluded parts: a crash mid-chunk
    # discards the buffer with the chunk (the resume re-derives it), so no
    # row is ever recorded twice or lost.
    dead_rows: List[dict] = []

    def on_read_error(err) -> None:
        read_errors_box[0] += 1
        if errors_file is not None:
            dead_rows.append(read_error_row(err))

    if backend == "device":
        mesh = run_mesh(device, mesh)
        pipeline = _device_pipeline(
            config, ckpt_dir, state, resumed, device, device_batch, buckets,
            auto_geometry, mesh,
        )
    elif backend != "host":
        raise ValueError(f"unknown backend {backend!r}")

    # The raw reader stream yields one item per row (document or per-row
    # error) — `rows_consumed` counts items, so the skip is exact.  The
    # consumed prefix is skipped at row-group granularity (never decoded).
    raw = read_documents(
        input_file,
        text_column=text_column,
        id_column=id_column,
        batch_size=read_batch_size,
        skip_rows=state.rows_consumed,
        retry_policy=retry_policy,
    )
    # Overlapped read-ahead (device backend): the reader thread only runs
    # AHEAD of consumption — `rows_consumed` still counts exactly the items
    # drained into chunks, part writes stay synchronous at chunk boundaries,
    # and commit semantics are untouched.
    raw_close = None
    oc = config.overlap
    if (
        backend == "device"
        and oc.enabled
        and os.environ.get("TEXTBLAST_NO_OVERLAP") != "1"
    ):
        from .utils.overlap import prefetch_iter

        raw = prefetch_iter(
            raw, depth=oc.read_ahead, block=max(64, read_batch_size // 4)
        )
        raw_close = raw.close

    result = AggregationResult(
        received=state.received,
        success=state.success,
        filtered=state.filtered,
        errors=state.errors,
    )

    chunks_done = 0
    try:
        if backend == "device":
            if pipeline is None:
                # Fresh --auto-geometry run: calibrate from the head of the
                # stream, then replay the head ahead of the rest.  The
                # result is recorded in the cursor so a resume dispatches
                # identical batches.
                geometry, raw = _calibrate(raw, device if mesh is None else mesh.devices[0])
                pipeline = _build_pipeline(
                    config, buckets, device_batch, device, geometry, mesh
                )
            # Recorded from the constructed pipeline so the resume check
            # compares like with like.
            state.geometry = pipeline.geometry.to_dict()

            def process_chunk(items) -> Iterator[ProcessingOutcome]:
                return process_documents_device(
                    config, items, on_read_error=on_read_error, pipeline=pipeline
                )

        else:
            executor = build_pipeline_from_config(config)

            def process_chunk(items) -> Iterator[ProcessingOutcome]:
                return process_documents_host(
                    executor, items, on_read_error=on_read_error
                )

        while True:
            chunk = list(islice(raw, chunk_size))
            if not chunk:
                break
            outcomes = process_chunk(iter(chunk))
            try:
                for outcome in outcomes:
                    result.received += 1
                    if outcome.kind == ProcessingOutcome.SUCCESS:
                        result.success += 1
                        METRICS.inc("producer_results_success_total")
                        out_parts.append(outcome.document)
                    elif outcome.kind == ProcessingOutcome.FILTERED:
                        result.filtered += 1
                        METRICS.inc("producer_results_filtered_total")
                        excl_parts.append(outcome.document)
                    else:
                        result.errors += 1
                        METRICS.inc("producer_results_error_total")
                        if errors_file is not None:
                            dead_rows.append(outcome_row(outcome))
                    METRICS.inc("producer_results_received_total")
                    if progress is not None:
                        progress(result)
            finally:
                # A flush barrier: the chunk's dispatch thread ends here.
                outcomes.close()

            # Chunk boundary: commit parts, then the cursor.
            out_parts.roll()
            excl_parts.roll()
            if dead_rows:
                # Same index scheme as out/excl parts.  A crash between the
                # part write and the cursor commit re-creates the same name
                # on resume (err_parts length is unchanged), so the orphan
                # is overwritten, never duplicated.
                name = f"err-{len(state.err_parts):05d}.parquet"
                with DeadLetterSink(os.path.join(ckpt_dir, name)) as sink:
                    for row in dead_rows:
                        sink.record_row(row)
                state.err_parts.append(name)
                dead_rows.clear()
            state.rows_consumed += len(chunk)
            state.read_errors = read_errors_box[0]
            state.received = result.received
            state.success = result.success
            state.filtered = result.filtered
            state.errors = result.errors
            state.out_parts = out_parts.parts
            state.excl_parts = excl_parts.parts
            state.save(ckpt_dir, retry_policy)

            chunks_done += 1
            if stop_after_chunks is not None and chunks_done >= stop_after_chunks:
                raise CheckpointError(
                    f"aborted after {chunks_done} chunks (fault injection)"
                )
    except BaseException:
        out_parts.abort()
        excl_parts.abort()
        raise
    finally:
        if raw_close is not None:
            raw_close()  # stop the read-ahead thread on every exit path

    # Finalize: single kept/excluded pair with the reference's schema.  Only
    # artifacts this subsystem created are deleted — the directory itself is
    # removed only if that leaves it empty (it may pre-exist, e.g. ".").
    _concat_parts(ckpt_dir, state.out_parts, output_file)
    _concat_parts(ckpt_dir, state.excl_parts, excluded_file)
    if errors_file is not None:
        # Empty parts list still yields a well-formed (empty) dead-letter
        # file — "no errors" stays distinguishable from "sink not wired".
        _concat_parts(
            ckpt_dir, state.err_parts, errors_file, schema=DEADLETTER_SCHEMA
        )
    for name in state.out_parts + state.excl_parts + state.err_parts:
        _unlink_quiet(os.path.join(ckpt_dir, name))
    _unlink_quiet(os.path.join(ckpt_dir, CHECKPOINT_FILE))
    _unlink_quiet(os.path.join(ckpt_dir, CHECKPOINT_FILE + ".tmp"))
    try:
        os.rmdir(ckpt_dir)
    except OSError:
        logger.warning(
            "checkpoint directory '%s' not removed (not empty)", ckpt_dir
        )

    result.read_errors = read_errors_box[0]
    return result


def _device_pipeline(
    config, ckpt_dir, state, resumed, device, device_batch, buckets, auto_geometry,
    mesh=None,
):
    """The one pipeline reused across every chunk, or None when a fresh
    ``auto_geometry`` run must calibrate it from the stream first.

    On a resume the cursor's geometry is authoritative: chunk boundaries
    are batch flush barriers, and a different geometry would batch the
    remaining rows differently than the original run would have.  The
    flags must resolve to the recorded geometry (or, for an auto run,
    ``auto_geometry`` must be passed again); otherwise this fails fast."""
    recorded = (
        DeviceGeometry.from_dict(state.geometry)
        if state.geometry is not None
        else None
    )
    if resumed and recorded is not None:
        if auto_geometry:
            if recorded.source != "auto":
                raise CheckpointError(
                    f"checkpoint in '{ckpt_dir}' was created WITHOUT "
                    f"--auto-geometry (device geometry "
                    f"{recorded.describe()}); resume without the flag, "
                    "or remove the checkpoint directory to start over"
                )
            # Under a mesh the recorded geometry is rounded again.
            return _build_pipeline(config, None, None, device, recorded, mesh)
        candidate = _build_pipeline(config, buckets, device_batch, device, mesh=mesh)
        if candidate.geometry.fingerprint() != recorded.fingerprint():
            hint = (
                "pass --auto-geometry again"
                if recorded.source == "auto"
                else "resume with the original --buckets/--device-batch"
            )
            raise CheckpointError(
                f"checkpoint in '{ckpt_dir}' was created with device "
                f"geometry {recorded.describe()}, but this invocation "
                f"resolves to {candidate.geometry.describe()}; {hint}, "
                "or remove the checkpoint directory to start over"
            )
        return candidate
    if resumed and auto_geometry:
        # Pre-geometry cursor: the original batching cannot be
        # reconstructed under a freshly calibrated geometry.
        raise CheckpointError(
            f"checkpoint in '{ckpt_dir}' predates geometry recording "
            "and cannot be resumed with --auto-geometry; resume "
            "without the flag, or remove the checkpoint directory "
            "to start over"
        )
    if auto_geometry:
        # Fails without CUDA before the reader starts.
        resolve_device(device if mesh is None else mesh.devices[0])
        return None
    return _build_pipeline(config, buckets, device_batch, device, mesh=mesh)
