"""Core data model: the document record and the per-document processing outcome.

TPU-native re-design of the reference's data plane (reference:
``/root/reference/src/data_model.rs:5-34``).  The reference moves one
``TextDocument`` at a time as JSON over RabbitMQ; here the same record is the
*host-side* view of a document, while on device documents live as packed ragged
UTF-8 byte tensors (see :mod:`textblaster_tpu.ops.packing`).  ``TextDocument``
and ``ProcessingOutcome`` keep the reference's exact JSON wire format (serde
externally-tagged enums) so corpora and results interop bit-for-bit.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from datetime import date, datetime
from typing import Any, Dict, Optional, Tuple

__all__ = ["TextDocument", "ProcessingOutcome"]

# serde formats for chrono NaiveDate / NaiveDateTime (reference data_model.rs:10-11):
#   NaiveDate      -> "2024-01-31"
#   NaiveDateTime  -> "2024-01-31T12:34:56" (optionally ".%f")
_DATE_FMT = "%Y-%m-%d"


def _parse_naive_datetime(s: str) -> datetime:
    # chrono serializes NaiveDateTime as ISO-8601 without timezone.
    return datetime.fromisoformat(s)


def _fmt_naive_datetime(dt: datetime) -> str:
    """chrono ``%Y-%m-%dT%H:%M:%S%.f``: fraction trimmed to 3/6 digit groups
    (nothing when zero) so output is byte-identical to serde_json."""
    base = dt.strftime("%Y-%m-%dT%H:%M:%S")
    us = dt.microsecond
    if us == 0:
        return base
    if us % 1000 == 0:
        return f"{base}.{us // 1000:03d}"
    return f"{base}.{us:06d}"


@dataclass
class TextDocument:
    """One document flowing through the pipeline.

    Mirrors ``TextDocument`` (reference ``src/data_model.rs:5-13``): ``id``,
    ``content``, ``source``, optional ``added`` date, optional ``created``
    (start, end) datetime pair, and a flat string->string ``metadata`` map that
    filters stamp status/reason/stat entries into.
    """

    id: str = ""
    content: str = ""
    source: str = ""
    added: Optional[date] = None
    created: Optional[Tuple[datetime, datetime]] = None
    metadata: Dict[str, str] = field(default_factory=dict)

    # --- serde-compatible JSON (wire format parity with the reference) ---

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "content": self.content,
            "source": self.source,
            "added": self.added.strftime(_DATE_FMT) if self.added else None,
            "created": (
                [_fmt_naive_datetime(self.created[0]), _fmt_naive_datetime(self.created[1])]
                if self.created
                else None
            ),
            "metadata": dict(self.metadata),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TextDocument":
        added = d.get("added")
        created = d.get("created")
        return cls(
            id=d["id"],
            content=d["content"],
            source=d.get("source", ""),
            added=datetime.strptime(added, _DATE_FMT).date() if added else None,
            created=(
                (_parse_naive_datetime(created[0]), _parse_naive_datetime(created[1]))
                if created
                else None
            ),
            metadata=dict(d.get("metadata") or {}),
        )

    def to_json(self) -> str:
        # serde_json emits no whitespace; keep the bytes identical.
        return json.dumps(self.to_dict(), ensure_ascii=False, separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str | bytes) -> "TextDocument":
        return cls.from_dict(json.loads(s))

    def copy(self) -> "TextDocument":
        return TextDocument(
            id=self.id,
            content=self.content,
            source=self.source,
            added=self.added,
            created=self.created,
            metadata=dict(self.metadata),
        )


@dataclass
class ProcessingOutcome:
    """Per-document outcome (reference ``src/data_model.rs:19-34``).

    One of three kinds:
      * ``Success`` — passed every pipeline step;
      * ``Filtered`` — dropped by a step, with a human-readable ``reason``;
      * ``Error`` — a step raised a hard error (``error_message`` +
        ``worker_id``).

    JSON layout matches serde's externally-tagged enum encoding, e.g.
    ``{"Filtered": {"document": {...}, "reason": "..."}}``.
    """

    SUCCESS = "Success"
    FILTERED = "Filtered"
    ERROR = "Error"

    kind: str = SUCCESS
    document: TextDocument = field(default_factory=TextDocument)
    reason: str = ""
    error_message: str = ""
    worker_id: str = ""

    @classmethod
    def success(cls, document: TextDocument) -> "ProcessingOutcome":
        return cls(kind=cls.SUCCESS, document=document)

    @classmethod
    def filtered(cls, document: TextDocument, reason: str) -> "ProcessingOutcome":
        return cls(kind=cls.FILTERED, document=document, reason=reason)

    @classmethod
    def error(
        cls, document: TextDocument, error_message: str, worker_id: str
    ) -> "ProcessingOutcome":
        return cls(
            kind=cls.ERROR,
            document=document,
            error_message=error_message,
            worker_id=worker_id,
        )

    def to_dict(self) -> Dict[str, Any]:
        if self.kind == self.SUCCESS:
            return {"Success": self.document.to_dict()}
        if self.kind == self.FILTERED:
            return {"Filtered": {"document": self.document.to_dict(), "reason": self.reason}}
        return {
            "Error": {
                "document": self.document.to_dict(),
                "error_message": self.error_message,
                "worker_id": self.worker_id,
            }
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ProcessingOutcome":
        if "Success" in d:
            return cls.success(TextDocument.from_dict(d["Success"]))
        if "Filtered" in d:
            inner = d["Filtered"]
            return cls.filtered(TextDocument.from_dict(inner["document"]), inner["reason"])
        if "Error" in d:
            inner = d["Error"]
            return cls.error(
                TextDocument.from_dict(inner["document"]),
                inner["error_message"],
                inner["worker_id"],
            )
        raise ValueError(f"Unknown ProcessingOutcome variant: {list(d)}")

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), ensure_ascii=False, separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str | bytes) -> "ProcessingOutcome":
        return cls.from_dict(json.loads(s))
