"""Device geometry: buckets + per-bucket batch sizes.

The port's copy of ``DeviceGeometry`` from ``textblaster_tpu/ops/
geometry.py``.  Only the uniform geometry (one batch size for every
bucket) is carried over; the calibration pass (``--auto-geometry``) is not
ported yet.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from .packing import PACK_MARGIN

__all__ = ["DeviceGeometry"]


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclass(frozen=True)
class DeviceGeometry:
    """Immutable device geometry: sorted bucket lengths + aligned batch sizes.

    ``buckets[i]`` is a char capacity; a document of ``n`` chars lands in the
    smallest bucket with ``n <= bucket - PACK_MARGIN`` (same admission rule
    as the packer).  ``batch_sizes[i]`` is the row count of that bucket's
    compiled program.  ``source`` records provenance: ``default`` (seed
    heuristic), ``explicit`` (operator flags), or ``auto`` (calibrated).
    """

    buckets: Tuple[int, ...]
    batch_sizes: Tuple[int, ...]
    source: str = "default"

    def __post_init__(self) -> None:
        if not self.buckets:
            raise ValueError("DeviceGeometry: buckets cannot be empty")
        if len(self.buckets) != len(self.batch_sizes):
            raise ValueError(
                "DeviceGeometry: buckets and batch_sizes must align "
                f"({len(self.buckets)} vs {len(self.batch_sizes)})"
            )
        if tuple(sorted(self.buckets)) != tuple(self.buckets):
            raise ValueError("DeviceGeometry: buckets must be sorted ascending")
        if len(set(self.buckets)) != len(self.buckets):
            raise ValueError("DeviceGeometry: buckets must be unique")
        if any(b < 64 for b in self.buckets):
            raise ValueError("DeviceGeometry: buckets must be >= 64 chars")
        if any(n < 1 for n in self.batch_sizes):
            raise ValueError("DeviceGeometry: batch sizes must be >= 1")

    @classmethod
    def uniform(
        cls,
        buckets: Sequence[int],
        batch_size: int,
        source: str = "default",
    ) -> "DeviceGeometry":
        """The seed behavior: one batch size for every bucket."""
        bs = tuple(sorted(buckets))
        return cls(buckets=bs, batch_sizes=(int(batch_size),) * len(bs), source=source)

    # --- lookups -----------------------------------------------------------

    def bucket_for(self, n_chars: int) -> Optional[int]:
        """Smallest bucket admitting ``n_chars``, or None (host fallback)."""
        for b in self.buckets:
            if n_chars <= b - PACK_MARGIN:
                return b
        return None

    def batch_for(self, bucket: int) -> int:
        """Rows per dispatch for ``bucket`` (exact bucket length required)."""
        try:
            return self.batch_sizes[self.buckets.index(bucket)]
        except ValueError:
            raise KeyError(f"no bucket of length {bucket} in {self.buckets}") from None

    @property
    def max_batch(self) -> int:
        return max(self.batch_sizes)

    @property
    def largest(self) -> int:
        return self.buckets[-1]

    def with_batch_multiple(self, mult: int) -> "DeviceGeometry":
        """Round every batch size up to a multiple of ``mult`` (mesh runs
        need the global batch divisible by the device count)."""
        if mult <= 1:
            return self
        return DeviceGeometry(
            buckets=self.buckets,
            batch_sizes=tuple(
                max(mult, _round_up(n, mult)) for n in self.batch_sizes
            ),
            source=self.source,
        )

    # --- identity ----------------------------------------------------------

    def to_dict(self) -> Dict[str, object]:
        return {
            "buckets": list(self.buckets),
            "batch_sizes": list(self.batch_sizes),
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "DeviceGeometry":
        return cls(
            buckets=tuple(int(b) for b in d["buckets"]),
            batch_sizes=tuple(int(n) for n in d["batch_sizes"]),
            source=str(d.get("source", "default")),
        )

    def fingerprint(self) -> str:
        """Stable hash of the shape-determining fields (source excluded:
        the same shapes compile to the same programs however chosen)."""
        blob = json.dumps(
            {"buckets": list(self.buckets), "batch_sizes": list(self.batch_sizes)},
            sort_keys=True,
        ).encode("utf-8")
        return hashlib.sha256(blob).hexdigest()[:16]

    def describe(self) -> str:
        pairs = ", ".join(
            f"{b}x{n}" for b, n in zip(self.buckets, self.batch_sizes)
        )
        return f"[{pairs}] ({self.source})"
