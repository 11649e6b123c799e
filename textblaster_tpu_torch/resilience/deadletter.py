"""Dead-letter sink: the opt-in third Parquet file for failed rows.

The port's copy of the JAX package's ``resilience/deadletter.py``.

The reference drops Error outcomes into *neither* output file, leaving only
a count mismatch (SURVEY.md §7 quirk #2) — and this build's default
preserves that observable behavior.  ``--errors-file errors.parquet`` opts
into a durable trace instead: every Error outcome and every quarantined
unreadable row lands here with enough context (step, reason, worker) to
triage or replay it later, the quarantine discipline production pipelines
treat as first-class.

Schema (all nullable — read errors have no document):

* ``id`` / ``source`` / ``text`` — the document, when one exists;
* ``step``   — pipeline step that failed (``read`` for reader-side rows);
* ``reason`` — the error message;
* ``worker`` — worker id that observed the failure.
"""

from __future__ import annotations

import json
import re
from typing import List, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from ..data_model import ProcessingOutcome
from ..errors import ParquetError, PipelineError
from ..utils.metrics import METRICS

__all__ = [
    "DEADLETTER_SCHEMA",
    "DeadLetterSink",
    "outcome_row",
    "read_error_row",
]

DEADLETTER_SCHEMA = pa.schema(
    [
        pa.field("id", pa.string(), nullable=True),
        pa.field("source", pa.string(), nullable=True),
        pa.field("text", pa.string(), nullable=True),
        pa.field("metadata", pa.string(), nullable=True),
        pa.field("step", pa.string(), nullable=True),
        pa.field("reason", pa.string(), nullable=True),
        pa.field("worker", pa.string(), nullable=True),
    ]
)

# Error outcomes carry the StepError's rendered message
# ("Error in processing step 'X': ..."); recover the step name from it so
# the wire format of ProcessingOutcome stays untouched.
_STEP_RE = re.compile(r"processing step '([^']+)'")

_WRITE_BATCH_SIZE = 500  # producer_logic.rs:21 parity with the main writers


def outcome_row(outcome: ProcessingOutcome) -> dict:
    """Dead-letter row for one Error outcome (worker's swallowed hard error)."""
    doc = outcome.document
    m = _STEP_RE.search(outcome.error_message or "")
    return {
        "id": doc.id,
        "source": doc.source,
        "text": doc.content,
        "metadata": (
            json.dumps(doc.metadata, ensure_ascii=False, separators=(",", ":"))
            if doc.metadata
            else None
        ),
        "step": m.group(1) if m else None,
        "reason": outcome.error_message,
        "worker": outcome.worker_id or None,
    }


def read_error_row(err: PipelineError) -> dict:
    """Dead-letter row for one unreadable/quarantined row (no document)."""
    return {
        "id": None,
        "source": None,
        "text": None,
        "metadata": None,
        "step": "read",
        "reason": str(err),
        "worker": None,
    }


class DeadLetterSink:
    """Buffered Parquet writer for failed rows.

    The file is created eagerly on construction so an error-free run still
    leaves a well-formed (empty) dead-letter file — "no errors" and "sink was
    never wired" must be distinguishable from the artifact alone.
    """

    def __init__(self, path: str, batch_size: int = _WRITE_BATCH_SIZE) -> None:
        import os

        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        try:
            self._writer: Optional[pq.ParquetWriter] = pq.ParquetWriter(
                path, DEADLETTER_SCHEMA
            )
        except Exception as e:
            raise ParquetError(str(e)) from e
        self.path = path
        self.batch_size = batch_size
        self.rows_written = 0
        self._rows: List[dict] = []

    # --- recording ----------------------------------------------------------

    def record(
        self,
        id: Optional[str] = None,
        source: Optional[str] = None,
        text: Optional[str] = None,
        metadata: Optional[str] = None,
        step: Optional[str] = None,
        reason: Optional[str] = None,
        worker: Optional[str] = None,
    ) -> None:
        self.record_row(
            {
                "id": id,
                "source": source,
                "text": text,
                "metadata": metadata,
                "step": step,
                "reason": reason,
                "worker": worker,
            }
        )

    def record_row(self, row: dict) -> None:
        """Append one pre-built row dict (see :func:`outcome_row`)."""
        if self._writer is None:
            raise ParquetError(f"dead-letter sink '{self.path}' is closed")
        self._rows.append({name: row.get(name) for name in DEADLETTER_SCHEMA.names})
        self.rows_written += 1
        METRICS.inc("deadletter_rows_total")
        if len(self._rows) >= self.batch_size:
            self._flush()

    def record_outcome(self, outcome: ProcessingOutcome) -> None:
        """Route one Error outcome (worker_logic.rs's swallowed hard error)."""
        self.record_row(outcome_row(outcome))

    def record_read_error(self, err: PipelineError) -> None:
        """Route one unreadable/quarantined row (no document to attach)."""
        self.record_row(read_error_row(err))

    # --- lifecycle ----------------------------------------------------------

    def _flush(self) -> None:
        if not self._rows:
            return
        if self._writer is None:
            raise ParquetError(f"dead-letter sink '{self.path}' is closed")
        cols = {
            name: pa.array([r[name] for r in self._rows], pa.string())
            for name in DEADLETTER_SCHEMA.names
        }
        try:
            self._writer.write_batch(
                pa.record_batch(
                    [cols[n] for n in DEADLETTER_SCHEMA.names],
                    schema=DEADLETTER_SCHEMA,
                )
            )
        except Exception as e:
            raise ParquetError(str(e)) from e
        self._rows.clear()

    def close(self) -> None:
        if self._writer is not None:
            try:
                self._flush()
            finally:
                self._writer.close()
                self._writer = None

    def __enter__(self) -> "DeadLetterSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
