"""Parquet writer with the reference's fixed output schema.

Re-implementation of ``ParquetWriter``
(``/root/reference/src/pipeline/writers/parquet_writer.rs:17-165``):

* schema: ``id`` Utf8 (non-null), ``source`` Utf8 (non-null), ``text`` Utf8
  (non-null), ``added`` Date32 (nullable), ``created``
  Struct{start,end: Timestamp(us)} (nullable), ``metadata`` Utf8 JSON-or-null;
* empty metadata maps write as null (rs:104-111, SURVEY.md §7 quirk #3);
* explicit :meth:`close` finalizes the file footer (rs:159-164).

Each writer sums the host-clock seconds of its ``write_batch`` and
``close`` calls in :attr:`ParquetWriter.seconds` (one thread at a time
runs them: the caller's, or its writer thread); the ``write_batch`` share
is also the ``stage_write_seconds`` counter, from the same clock reads.
"""

from __future__ import annotations

import json
import time
from typing import List, Optional, Sequence

import pyarrow as pa
import pyarrow.parquet as pq

from ..data_model import TextDocument
from ..errors import ParquetError
from ..utils.metrics import METRICS
from .base import BaseWriter

__all__ = ["ParquetWriter", "OUTPUT_SCHEMA"]

_TS = pa.timestamp("us")

OUTPUT_SCHEMA = pa.schema(
    [
        pa.field("id", pa.string(), nullable=False),
        pa.field("source", pa.string(), nullable=False),
        pa.field("text", pa.string(), nullable=False),
        pa.field("added", pa.date32(), nullable=True),
        pa.field(
            "created",
            pa.struct(
                [pa.field("start", _TS, nullable=True), pa.field("end", _TS, nullable=True)]
            ),
            nullable=True,
        ),
        pa.field("metadata", pa.string(), nullable=True),
    ]
)


class ParquetWriter(BaseWriter):
    def __init__(self, path: str) -> None:
        try:
            self._writer: Optional[pq.ParquetWriter] = pq.ParquetWriter(
                path, OUTPUT_SCHEMA
            )
        except Exception as e:
            raise ParquetError(str(e)) from e
        self.path = path
        self.seconds = 0.0

    def write_batch(self, documents: Sequence[TextDocument]) -> None:
        if not documents:
            return
        t0 = time.perf_counter()
        try:
            self._write_batch_inner(documents)
        finally:
            # Timed here (not in callers) so every write path lands in the
            # stage counter exactly once.
            dt = time.perf_counter() - t0
            self.seconds += dt
            METRICS.inc("stage_write_seconds", dt)

    def _write_batch_inner(self, documents: Sequence[TextDocument]) -> None:
        ids: List[str] = []
        sources: List[str] = []
        texts: List[str] = []
        added: List = []
        created: List = []
        metadata: List[Optional[str]] = []
        for doc in documents:
            ids.append(doc.id)
            sources.append(doc.source)
            texts.append(doc.content)
            added.append(doc.added)
            created.append(
                {"start": doc.created[0], "end": doc.created[1]}
                if doc.created
                else None
            )
            metadata.append(
                json.dumps(doc.metadata, ensure_ascii=False, separators=(",", ":"))
                if doc.metadata
                else None  # empty map -> null (rs:104-111)
            )
        batch = pa.record_batch(
            [
                pa.array(ids, pa.string()),
                pa.array(sources, pa.string()),
                pa.array(texts, pa.string()),
                pa.array(added, pa.date32()),
                pa.array(created, OUTPUT_SCHEMA.field("created").type),
                pa.array(metadata, pa.string()),
            ],
            schema=OUTPUT_SCHEMA,
        )
        if self._writer is None:
            raise ParquetError(f"writer for '{self.path}' is closed")
        try:
            self._writer.write_batch(batch)
        except Exception as e:
            raise ParquetError(str(e)) from e

    def close(self) -> None:
        if self._writer is not None:
            t0 = time.perf_counter()
            try:
                self._writer.close()
                self._writer = None
            finally:
                self.seconds += time.perf_counter() - t0
