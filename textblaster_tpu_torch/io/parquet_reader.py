"""Parquet reader with the reference's schema handling and quirks.

Re-implementation of ``ParquetReader``
(``/root/reference/src/pipeline/readers/parquet_reader.rs:18-252``) on
pyarrow.  Reproduces:

* required, configurable text + id columns — missing column is a
  ``ConfigError``; text must be a UTF-8 type (parquet_reader.rs:27-41);
* optional fixed-name columns: ``source`` (fallback = file path,
  rs:181-190), ``added`` (Date32 or microsecond timestamp -> date,
  rs:43-63), ``created`` (struct of two timestamps; both must be non-null,
  rs:197-213), ``metadata`` (JSON string -> dict; parse errors -> warn +
  empty map, rs:215-230);
* null text/id rows yield per-row errors, not a failed read (rs:159-173);
* the text column is **HTML-entity-decoded** at read time (rs:177-179).

For the TPU feed path the reader also exposes :meth:`read_batches`, which
yields raw Arrow record batches so the packer can build device byte tensors
straight from Arrow's offsets+data buffers without per-document Python
objects.
"""

from __future__ import annotations

import html
import json
import logging
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Union

import pyarrow as pa
import pyarrow.parquet as pq

from ..data_model import TextDocument
from ..errors import ConfigError, ParquetError, PipelineError, UnexpectedError
from ..resilience.faults import FAULTS
from ..resilience.retry import RetryPolicy
from ..utils.metrics import METRICS
from ..utils.telemetry import TELEMETRY
from ..utils.trace import TRACER
from .base import BaseReader

logger = logging.getLogger(__name__)

__all__ = ["ParquetInputConfig", "ParquetReader"]


@dataclass
class ParquetInputConfig:
    """Reference ``config/parquet.rs:5-11``."""

    path: str
    text_column: str
    id_column: str
    batch_size: Optional[int] = None


def _to_date(value):
    """Date32 / timestamp cell -> date (parquet_reader.rs:43-63)."""
    if value is None:
        return None
    import datetime as _dt

    if isinstance(value, _dt.datetime):
        return value.date()
    if isinstance(value, _dt.date):
        return value
    return None


def _to_datetime(value):
    if value is None:
        return None
    import datetime as _dt

    if isinstance(value, _dt.datetime):
        return value
    if isinstance(value, _dt.date):
        return _dt.datetime(value.year, value.month, value.day)
    return None


class _QuarantinedGroup:
    """Sentinel for a row group that stayed unreadable through the retry
    budget: carries how many input rows it held so consumers can keep the
    item<->row accounting exact (the checkpoint cursor depends on it)."""

    __slots__ = ("group", "num_rows", "error")

    def __init__(self, group: int, num_rows: int, error: BaseException) -> None:
        self.group = group
        self.num_rows = num_rows
        self.error = error


class ParquetReader(BaseReader):
    def __init__(
        self,
        config: ParquetInputConfig,
        retry_policy: Optional[RetryPolicy] = None,
    ) -> None:
        self.config = config
        # Every reader is guarded, with the default read policy when the
        # caller gives none (run_pipeline gives the config's).
        self.retry_policy = retry_policy or RetryPolicy()

    def _open(self) -> pq.ParquetFile:
        try:
            return pq.ParquetFile(self.config.path)
        except FileNotFoundError as e:
            raise ParquetError(str(e)) from e
        except Exception as e:
            raise ParquetError(str(e)) from e

    def _validate_schema(self, schema: pa.Schema) -> None:
        for name in (self.config.text_column, self.config.id_column):
            if schema.get_field_index(name) == -1:
                raise ConfigError(f"Required column '{name}' not found in schema.")
        text_type = schema.field(self.config.text_column).type
        if text_type not in (pa.string(), pa.large_string()):
            raise ConfigError(
                f"Column '{self.config.text_column}' must be Utf8 or LargeUtf8, "
                f"found: {text_type}"
            )

    def _fetch_group(self, pf: pq.ParquetFile, group: int) -> pa.Table:
        """One row group off disk — the guarded read seam.  The fault site
        fires *inside* the retried callable so chaos tests drive the retry
        layer through real control flow."""
        def fetch() -> pa.Table:
            FAULTS.fire("read.batch")
            return pf.read_row_group(group)

        t0 = time.perf_counter()
        try:
            with TRACER.span("read", {"kind": "fetch", "group": group}):
                return self.retry_policy.run(fetch, seam="read")
        finally:
            METRICS.inc("stage_read_seconds", time.perf_counter() - t0)

    def _iter_group_batches(
        self, skip_rows: int = 0, on_quarantine=None
    ) -> Iterator[Union[pa.RecordBatch, _QuarantinedGroup]]:
        """Record batches row-group by row-group, each group fetched under
        the read RetryPolicy.

        ``skip_rows`` seeks past the first N rows without decoding them:
        fully-consumed row groups are never read (their ``num_rows`` come
        from the footer), and only the partially-consumed group is sliced —
        the row-group cursor the checkpoint subsystem resumes from.

        A group that stays unreadable through the retry budget is yielded as
        a :class:`_QuarantinedGroup` when ``on_quarantine`` is truthy
        (reading continues at the next group); otherwise the error
        propagates as :class:`ParquetError`.
        """
        pf = self._open()
        self._validate_schema(pf.schema_arrow)
        batch_size = self.config.batch_size or 1024

        md = pf.metadata
        groups = list(range(md.num_row_groups))
        while groups and skip_rows >= md.row_group(groups[0]).num_rows:
            skip_rows -= md.row_group(groups[0]).num_rows
            groups.pop(0)

        for g in groups:
            n_rows = md.row_group(g).num_rows
            try:
                table = self._fetch_group(pf, g)
            except Exception as e:  # noqa: BLE001 — budget already spent
                if not on_quarantine:
                    if isinstance(e, ParquetError):
                        raise
                    raise ParquetError(
                        f"failed to read row group {g} of "
                        f"'{self.config.path}': {e}"
                    ) from e
                # Quarantine: account every not-yet-consumed row of the
                # group so item<->row bookkeeping stays exact.
                lost = n_rows - skip_rows
                skip_rows = 0
                METRICS.inc("resilience_quarantined_rows_total", lost)
                logger.error(
                    "Quarantined row group %d of '%s' (%d rows): %s",
                    g, self.config.path, lost, e,
                )
                yield _QuarantinedGroup(g, lost, e)
                continue
            if skip_rows:
                table = table.slice(skip_rows)
                skip_rows = 0
            for batch in table.to_batches(max_chunksize=batch_size):
                if batch.num_rows:
                    yield batch

    def read_batches(self, skip_rows: int = 0) -> Iterator[pa.RecordBatch]:
        """Raw Arrow record batches (the zero-copy path for the TPU packer).

        Reads are guarded by the retry policy; an unreadable row group
        raises :class:`ParquetError` here (use :meth:`read_documents` for
        the quarantining form)."""
        yield from self._iter_group_batches(skip_rows=skip_rows)

    def read_documents(
        self, skip_rows: int = 0
    ) -> Iterator[Union[TextDocument, PipelineError]]:
        pf = self._open()
        schema = pf.schema_arrow
        self._validate_schema(schema)

        has = {name: schema.get_field_index(name) != -1 for name in
               ("source", "added", "created", "metadata")}
        # metadata column must be a string type to be used (rs:92-97).
        if has["metadata"]:
            md_type = schema.field("metadata").type
            if md_type not in (pa.string(), pa.large_string()):
                has["metadata"] = False

        for batch in self._iter_group_batches(
            skip_rows=skip_rows, on_quarantine=True
        ):
            if isinstance(batch, _QuarantinedGroup):
                # One error item PER LOST ROW, not per group: the stream's
                # item count must equal the input row count for the
                # checkpoint cursor's row-exact resume skip.
                q = batch
                for _ in range(q.num_rows):
                    yield ParquetError(
                        f"row quarantined: row group {q.group} of "
                        f"'{self.config.path}' unreadable: {q.error}"
                    )
                continue
            # Decode the whole batch into a list before yielding: the decode
            # wall time must exclude consumer time (a generator suspends at
            # every yield), or the read-stage counter would absorb the rest
            # of the pipeline.
            t0 = time.perf_counter()
            with TRACER.span("read", {"kind": "decode", "rows": batch.num_rows}):
                items = self._decode_batch(batch, has)
            METRICS.inc("stage_read_seconds", time.perf_counter() - t0)
            if TELEMETRY.enabled:
                TELEMETRY.mark(
                    "read",
                    (d.id for d in items if isinstance(d, TextDocument)),
                )
            yield from items

    def _decode_batch(
        self, batch: pa.RecordBatch, has: dict
    ) -> list:
        """Arrow record batch -> list of documents / per-row errors."""
        items: list = []
        cols = {name: batch.column(i) for i, name in enumerate(batch.schema.names)}
        text_col = cols[self.config.text_column]
        id_col = cols[self.config.id_column]
        n = batch.num_rows

        source_col = cols.get("source") if has["source"] else None
        added_col = cols.get("added") if has["added"] else None
        created_col = cols.get("created") if has["created"] else None
        metadata_col = cols.get("metadata") if has["metadata"] else None

        for i in range(n):
            if not text_col[i].is_valid:
                items.append(UnexpectedError(
                    f"Row {i} has null text column '{self.config.text_column}'"
                ))
                continue
            if not id_col[i].is_valid:
                items.append(UnexpectedError(
                    f"Row {i} has null id column '{self.config.id_column}'"
                ))
                continue

            doc_id = id_col[i].as_py()
            # HTML-entity decode at ingest (rs:177-179).
            content = html.unescape(text_col[i].as_py())

            source = None
            if source_col is not None and source_col[i].is_valid:
                source = source_col[i].as_py()
            if source is None:
                source = self.config.path  # fallback (rs:181-190)

            added = None
            if added_col is not None and added_col[i].is_valid:
                added = _to_date(added_col[i].as_py())

            created = None
            if created_col is not None and created_col[i].is_valid:
                cell = created_col[i].as_py()
                if isinstance(cell, dict) and len(cell) >= 2:
                    vals = list(cell.values())
                    start = _to_datetime(vals[0])
                    end = _to_datetime(vals[1])
                    if start is not None and end is not None:
                        created = (start, end)
                else:
                    logger.warning("'created' column is not a struct.")

            metadata = {}
            if metadata_col is not None and metadata_col[i].is_valid:
                raw = metadata_col[i].as_py()
                try:
                    parsed = json.loads(raw)
                    metadata = (
                        {str(k): str(v) for k, v in parsed.items()}
                        if isinstance(parsed, dict)
                        else {}
                    )
                except (json.JSONDecodeError, AttributeError) as e:
                    logger.warning(
                        "Failed to parse metadata JSON. id=%s err=%s", doc_id, e
                    )
                    metadata = {}

            items.append(TextDocument(
                id=str(doc_id),
                content=content,
                source=str(source),
                added=added,
                created=created,
                metadata=metadata,
            ))
        return items
