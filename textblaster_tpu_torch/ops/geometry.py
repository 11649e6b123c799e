"""Occupancy-aware device geometry: buckets + per-bucket batch sizes.

The port's copy of ``textblaster_tpu/ops/geometry.py``: the same
functions, with the lane budget keyed on a torch device type instead of a
JAX backend.

The device executes ragged UTF-8 on fixed shapes, so two numbers govern
occupancy: the bucket ladder (how much each row is padded) and the rows per
dispatch (how much work each batch carries).

* :class:`DeviceGeometry` — an immutable (buckets, per-bucket batch sizes)
  pair every layer threads through (packer, pipeline, checkpoint cursor).
  ``DeviceGeometry.uniform`` reproduces the default ladder exactly.
* :func:`choose_buckets` — histogram-calibrated bucket boundaries that
  minimize padded-codepoint waste under a max-programs budget (dynamic
  program over quantized length candidates; exact for the sample).
* :func:`equalized_batch_sizes` — ``B_b ∝ lane_budget / L_b`` rounded to
  multiples of 8, device-aware like the default batch size, so every
  dispatch carries roughly the same padded-lane volume.
* :class:`LengthReservoir` / :func:`length_histogram` — deterministic
  sampling for the calibration pass; the fixed-bin histogram is what a
  multi-process run merges so that every process derives the identical
  geometry.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .packing import PACK_MARGIN

__all__ = [
    "DeviceGeometry",
    "LengthReservoir",
    "choose_buckets",
    "equalized_batch_sizes",
    "calibrate_geometry",
    "length_histogram",
    "geometry_from_histogram",
    "HIST_BIN_EDGES",
    "CALIBRATION_SAMPLE",
]

#: Documents sampled by the calibration pass before geometry is frozen.
CALIBRATION_SAMPLE = 8192

#: Default ceiling on the number of buckets (== kernel shapes per phase).
MAX_PROGRAMS = 6

#: Fixed log-spaced histogram bin edges (upper-inclusive), shared by every
#: process of a multi-process run: the merged payload must be shape-stable
#: and identical across processes for the merged geometry to be identical.
#: Covers 64 chars .. 1M chars in ~quarter-octave steps.
HIST_BIN_EDGES: Tuple[int, ...] = tuple(
    int(round(64 * (2 ** (i / 4)))) for i in range(57)
)


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


# --- batch sizing -----------------------------------------------------------


def _lane_budget(backend=None) -> Tuple[int, int, int]:
    """(lane budget, min rows, max rows) for the device type ``backend``
    (``"cpu"``, ``"cuda"`` or a ``torch.device``; ``None`` is ``"cuda"``,
    the port's default device).

    The JAX package's two branches: the CPU is cache-residency-bound at
    ~128k int32 lanes per batch; an accelerator amortizes per-dispatch cost
    and carries ~2M lanes (~8 MB int32).  ``cuda`` takes the accelerator
    branch as it stands (tuning it for the H100 is later work)."""
    kind = getattr(backend, "type", backend) or "cuda"
    if kind == "cpu":
        return 64 * 2048, 8, 256
    return 1024 * 2048, 64, 1024


def equalized_batch_sizes(
    buckets: Sequence[int],
    backend=None,
    lane_budget: Optional[int] = None,
) -> Tuple[int, ...]:
    """Work-equalized rows per bucket: ``B_b ∝ lane_budget / L_b``.

    Rounded down to multiples of 8 (the JAX package's row tile, which the
    split rung keeps too), clamped to the device type's row range,
    so every dispatch carries roughly the same padded-lane volume instead of
    the seed's one-row-count-for-all-widths."""
    budget, lo, hi = _lane_budget(backend)
    if lane_budget is not None:
        budget = lane_budget
    sizes = []
    for b in sorted(buckets):
        n = max(lo, min(hi, budget // int(b)))
        n = max(8, (n // 8) * 8)
        sizes.append(n)
    return tuple(sizes)


# --- bucket calibration -----------------------------------------------------


def choose_buckets(
    lengths: Sequence[int],
    weights: Optional[Sequence[float]] = None,
    max_programs: int = MAX_PROGRAMS,
    round_to: int = 64,
    min_bucket: int = 128,
    max_candidates: int = 512,
) -> Tuple[int, ...]:
    """Bucket boundaries minimizing padded-codepoint waste for a length
    sample, using at most ``max_programs`` buckets.

    Candidates are sampled lengths (plus the packer margin) rounded up to
    ``round_to``; the dynamic program is exact over that candidate set:
    ``dp[k][j]`` = minimal waste of covering every doc ≤ candidate ``j``
    with ``k`` buckets whose largest is ``j``.  ``weights`` lets a merged
    histogram stand in for raw lengths (multi-host calibration).

    Deterministic: same sample (or histogram) → same ladder, which is what
    lets every host of an SPMD job derive the geometry independently.
    """
    if max_programs < 1:
        raise ValueError("max_programs must be >= 1")
    ls = np.asarray([int(l) for l in lengths], dtype=np.int64)
    if ls.size == 0:
        raise ValueError("choose_buckets: empty length sample")
    w = (
        np.ones(ls.size, dtype=np.float64)
        if weights is None
        else np.asarray(weights, dtype=np.float64)
    )
    if w.shape != ls.shape:
        raise ValueError("choose_buckets: weights must align with lengths")
    order = np.argsort(ls, kind="stable")
    ls, w = ls[order], w[order]

    # Candidate capacities: every doc must fit under bucket - PACK_MARGIN.
    need = np.maximum(ls + PACK_MARGIN, min_bucket)
    while True:
        cands = np.unique((np.ceil(need / round_to) * round_to).astype(np.int64))
        if cands.size <= max_candidates:
            break
        round_to *= 2
    k_buckets = min(max_programs, cands.size)

    # Docs ordered by candidate assignment: doc i belongs to the smallest
    # candidate >= need[i].  Every candidate is some doc's rounded need, so
    # every candidate index has weight.  Prefix sums give O(1) segment waste.
    idx = np.searchsorted(cands, need, side="left")
    counts = np.bincount(idx, weights=w, minlength=cands.size)
    len_sums = np.bincount(idx, weights=w * ls, minlength=cands.size)
    C = np.concatenate([[0.0], np.cumsum(counts)])
    S = np.concatenate([[0.0], np.cumsum(len_sums)])

    # W[i, j] (i <= j): waste of assigning docs with candidate index in
    # [i, j] to bucket cands[j].  nC <= max_candidates so nC^2 floats fit.
    nC = cands.size
    candf = cands.astype(np.float64)
    W = (C[None, 1:] - C[:-1, None]) * candf[None, :] - (S[None, 1:] - S[:-1, None])

    # dp[j] at level k: minimal waste covering docs [0..j] with exactly k
    # buckets, the largest being cands[j].  Level 1 is W[0, :]; level k
    # extends level k-1 via dp_new[j] = min_{i<j} dp[i] + W[i+1, j].
    dp = W[0].copy()
    parents = []  # parents[k-2][j] = best i for level k ending at j
    ii = np.arange(nC - 1)[:, None]
    jj = np.arange(nC)[None, :]
    for _ in range(2, k_buckets + 1):
        total = np.where(ii + 1 <= jj, dp[:-1, None] + W[1:, :], np.inf)
        best_i = np.argmin(total, axis=0)
        dp = total[best_i, np.arange(nC)]
        parents.append(best_i)

    # The largest bucket must admit the longest doc, i.e. end at the last
    # candidate.  More distinct buckets never increase waste, so take the
    # full budget and backtrack.
    j = nC - 1
    picks = [j]
    for parent in reversed(parents):
        j = int(parent[j])
        picks.append(j)
    return tuple(int(cands[p]) for p in sorted(picks))


def calibrate_geometry(
    lengths: Sequence[int],
    weights: Optional[Sequence[float]] = None,
    max_programs: int = MAX_PROGRAMS,
    backend=None,
) -> DeviceGeometry:
    """Histogram-calibrated geometry: waste-minimizing buckets + work-
    equalized per-bucket batch sizes.  Deterministic in the sample."""
    buckets = choose_buckets(lengths, weights=weights, max_programs=max_programs)
    return DeviceGeometry(
        buckets=buckets,
        batch_sizes=equalized_batch_sizes(buckets, backend=backend),
        source="auto",
    )


# --- sampling ---------------------------------------------------------------


class LengthReservoir:
    """Seeded reservoir sampler over document lengths.

    Deterministic for a given (seed, stream): calibration must be
    reproducible so a re-run over the same corpus derives the same geometry
    (and so launches the kernels at the same shapes)."""

    def __init__(self, capacity: int = CALIBRATION_SAMPLE, seed: int = 0x6E0) -> None:
        if capacity < 1:
            raise ValueError("reservoir capacity must be >= 1")
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self._sample: list[int] = []
        self.n_seen = 0

    def add(self, length: int) -> None:
        self.n_seen += 1
        if len(self._sample) < self.capacity:
            self._sample.append(int(length))
            return
        j = int(self._rng.integers(0, self.n_seen))
        if j < self.capacity:
            self._sample[j] = int(length)

    def lengths(self) -> Tuple[int, ...]:
        return tuple(self._sample)


def length_histogram(
    lengths: Sequence[int], edges: Sequence[int] = HIST_BIN_EDGES
) -> np.ndarray:
    """Counts per fixed bin (upper-inclusive; overflow lands in the last
    bin).  The multi-host allgather payload — identical shape on every host
    by construction, so the merged histogram (elementwise sum) is the same
    array on every process."""
    e = np.asarray(edges, dtype=np.int64)
    ls = np.asarray([int(l) for l in lengths], dtype=np.int64)
    idx = np.searchsorted(e, ls, side="left")
    idx = np.minimum(idx, e.size - 1)
    return np.bincount(idx, minlength=e.size).astype(np.int64)


def geometry_from_histogram(
    hist: np.ndarray,
    edges: Sequence[int] = HIST_BIN_EDGES,
    max_programs: int = MAX_PROGRAMS,
    backend=None,
) -> DeviceGeometry:
    """Geometry from a (possibly merged) fixed-bin histogram.  Each bin is
    represented by its upper edge — the conservative choice: a bucket sized
    for the representative admits every doc in the bin."""
    hist = np.asarray(hist, dtype=np.float64)
    e = np.asarray(edges, dtype=np.int64)
    if hist.shape != e.shape:
        raise ValueError("histogram does not match the bin edges")
    nz = hist > 0
    if not nz.any():
        raise ValueError("geometry_from_histogram: empty histogram")
    return calibrate_geometry(
        e[nz].tolist(),
        weights=hist[nz].tolist(),
        max_programs=max_programs,
        backend=backend,
    )
