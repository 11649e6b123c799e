"""Per-document tail-latency telemetry: sampled lineage, HDR histograms,
windowed live rollups.

The port's copy of the JAX package's ``utils/telemetry.py``, with the
port's own registry, tracer and journal.  Three subsystems, all off (and
allocation-free on the hot path) until
``TELEMETRY.configure(sample_rate=N)`` with N > 0:

Sampled lineage
    A deterministic doc-id sampler — ``crc32(id) % rate == 0`` — picks the
    SAME documents in every process and every rerun, so sampled
    populations from separate runs concatenate into one coherent set.
    Sampled documents are stamped with a first-seen perf-counter timestamp
    at each stage seam (read → pack → dispatch → device_wait → assemble →
    write); the Parquet write seam closes the lineage, turning consecutive
    stamps into per-stage latencies fed to the ``doc_latency_*_seconds``
    HDR families (utils/metrics.py) and a ``doc_flow`` trace instant.

    In the port the seams run on four threads: the reader's prefetch
    thread (read), a pack-pool worker (pack), the caller (dispatch,
    device_wait, assemble) and the writer thread (write).  ``dispatch`` is
    stamped on the caller's thread when it hands a batch to the device
    path, not on the dispatch thread that later runs it: a batch queued
    behind others in the window would otherwise be stamped after the
    caller already waits on it.  Documents the host oracle decides get no
    dispatch or device_wait stamp.

HDR histograms
    :class:`LogLinearHistogram` wraps the pure-int log-linear bucket scheme
    (metrics.hdr_*): bounded relative error, exact bucket-wise merge.  The
    registry's families travel inside metric snapshots as flat ``::h``
    keys, so a sum-merge of snapshots gives exact merged quantiles with no
    histogram-specific exchange.

Live rollups
    A daemon ticker samples throughput counters and queue-depth gauges into
    a fixed-size ring of time windows (docs/s, chars/s, waste ratio, queue
    depths, in-flight depth, exchange-post latency).  A drift detector
    compares each window's padding-waste ratio against the calibration-time
    baseline (:func:`expected_waste`) and fires a ``geometry_drift`` trace
    instant, journal record and gauge when it deviates.  ``snapshot()``
    serves the ring as JSON on the ``/telemetry`` endpoint next to
    ``/metrics``.

Hot-path discipline mirrors the tracer's ``_NullSpan``: every seam guards
with ``if TELEMETRY.enabled:`` — one attribute read, no call, no
allocation — so sampling off costs nothing measurable.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

from .metrics import (
    DOC_LATENCY_STAGES,
    HDR_RELATIVE_ERROR,
    METRICS,
    hdr_bucket_index,
    hdr_bucket_high_us,
    hdr_quantile_us,
    latency_report,
)
from .trace import TRACER

__all__ = [
    "TELEMETRY",
    "Telemetry",
    "LogLinearHistogram",
    "doc_sampled",
    "expected_waste",
    "format_latency_summary",
    "STAGES",
]

#: Lineage stage keys in pipeline order (DOC_LATENCY_STAGES minus the
#: derived ``e2e`` rollup).
STAGES = tuple(s for s in DOC_LATENCY_STAGES if s != "e2e")

_STAGE_ORDER = {s: i for i, s in enumerate(STAGES)}

#: Open-lineage table cap: a doc that never reaches the write seam (filtered
#: upstream of sampling visibility, crashed batch, abandoned run) must not
#: leak memory forever, so the oldest lineage is evicted FIFO past this.
_LINEAGE_CAP = 65536


def doc_sampled(doc_id: str, rate: int) -> bool:
    """Deterministic 1-in-``rate`` sampler on the document id.

    crc32, not ``hash()``: Python string hashing is salted per process, so
    only a stable digest gives every host (and every rerun) the same sample
    set — the property that makes merged multi-host quantile populations
    coherent and repeated runs byte-comparable.
    """
    if rate <= 0:
        return False
    if rate == 1:
        return True
    return zlib.crc32(doc_id.encode("utf-8")) % rate == 0


class LogLinearHistogram:
    """Standalone log-linear histogram over the shared bucket scheme.

    The registry (``METRICS.observe_hdr``) is the production store; this
    class exists for composition outside it — merge experiments, tests,
    bench aggregation — with the same guarantees: bounded relative error
    (``HDR_RELATIVE_ERROR``) and exact, commutative, associative merge.
    """

    __slots__ = ("buckets", "sum_us", "count")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.sum_us = 0
        self.count = 0

    def record(self, us: int) -> None:
        v = max(0, int(us))
        idx = hdr_bucket_index(v)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.sum_us += v
        self.count += 1

    def record_seconds(self, seconds: float) -> None:
        self.record(int(seconds * 1e6))

    def merge(self, other: "LogLinearHistogram") -> "LogLinearHistogram":
        """New histogram = self + other (bucket-wise; inputs untouched)."""
        out = LogLinearHistogram()
        out.buckets = dict(self.buckets)
        for idx, c in other.buckets.items():
            out.buckets[idx] = out.buckets.get(idx, 0) + c
        out.sum_us = self.sum_us + other.sum_us
        out.count = self.count + other.count
        return out

    def quantile_us(self, q: float) -> int:
        return hdr_quantile_us(self.buckets, self.count, q)

    def quantile_s(self, q: float) -> float:
        return round(self.quantile_us(q) / 1e6, 6)

    def to_dict(self) -> Dict[str, object]:
        return {
            "buckets": {str(k): v for k, v in sorted(self.buckets.items())},
            "sum_us": self.sum_us,
            "count": self.count,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "LogLinearHistogram":
        h = cls()
        h.buckets = {int(k): int(v) for k, v in dict(d.get("buckets", {})).items()}
        h.sum_us = int(d.get("sum_us", 0))
        h.count = int(d.get("count", 0))
        return h


def expected_waste(lengths: Sequence[int], geometry) -> float:
    """Padding-waste ratio the geometry implies for a length sample.

    Each document lands in the smallest bucket that holds it (overflow
    clamps to the largest — those rows reroute to the host oracle but are
    counted at the bucket cap here, matching ``record_occupancy``'s lane
    accounting).  This is the calibration-time baseline the drift detector
    compares live windows against: same lengths + same geometry -> same
    baseline, deterministically.
    """
    buckets = tuple(geometry.buckets)
    lanes = 0
    real = 0
    for n in lengths:
        n = int(n)
        for b in buckets:
            if n <= b:
                lanes += b
                real += n
                break
        else:
            lanes += buckets[-1]
            real += buckets[-1]
    if lanes <= 0:
        return 0.0
    return round(1.0 - real / lanes, 6)


#: Monotone counters sampled per rollup window (delta over the window).
_WINDOW_COUNTERS = (
    "producer_results_received_total",
    "writer_chars_total",
    "occupancy_padded_lanes_total",
    "occupancy_real_codepoints_total",
    "multihost_exchange_posts_total",
    "multihost_exchange_post_seconds_total",
)

#: Gauges read point-in-time per window.
_WINDOW_GAUGES = (
    "queue_depth_read",
    "queue_depth_pack",
    "queue_depth_write",
    "inflight_batches",
    "multihost_negotiated_depth",
)


class Telemetry:
    """Process-wide telemetry hub (``TELEMETRY``)."""

    def __init__(self) -> None:
        #: THE hot-path guard: call sites check this one attribute and do
        #: nothing else when it is False.
        self.enabled = False
        self._lock = threading.Lock()
        self._rate = 0
        self._lineage: Dict[str, Dict[str, int]] = {}
        self._windows: deque = deque(maxlen=24)
        self._window_s = 5.0
        self._drift_threshold = 0.25
        self._baseline_waste: Optional[float] = None
        self._drift_high = False
        self._last_counters: Dict[str, float] = {}
        self._t0 = 0.0
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    def configure(
        self,
        sample_rate: int = 0,
        *,
        window_s: float = 5.0,
        window_count: int = 24,
        drift_threshold: float = 0.25,
        start_ticker: bool = True,
    ) -> None:
        """Enable telemetry with a 1-in-``sample_rate`` doc sampler.

        ``sample_rate <= 0`` keeps (or returns) everything off.  The rollup
        ticker is a daemon thread; ``start_ticker=False`` lets tests drive
        windows synchronously via :meth:`roll_window`.
        """
        self.close()
        if sample_rate <= 0:
            return
        with self._lock:
            self._rate = int(sample_rate)
            self._window_s = float(window_s)
            self._drift_threshold = float(drift_threshold)
            self._windows = deque(maxlen=max(1, int(window_count)))
            self._lineage = {}
            self._baseline_waste = None
            self._drift_high = False
            self._last_counters = {
                name: METRICS.get(name) for name in _WINDOW_COUNTERS
            }
            self._t0 = time.perf_counter()
            self._stop = threading.Event()
        self.enabled = True
        if start_ticker:
            self._ticker = threading.Thread(
                target=self._tick, name="textblast-telemetry", daemon=True
            )
            self._ticker.start()

    def close(self) -> None:
        """Disable telemetry and stop the rollup ticker (idempotent)."""
        self.enabled = False
        self._stop.set()
        t, self._ticker = self._ticker, None
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        with self._lock:
            self._rate = 0
            self._lineage = {}

    # -- sampled lineage -----------------------------------------------------

    def mark(self, stage: str, doc_ids: Iterable[str]) -> None:
        """Stamp sampled docs with a first-seen timestamp at ``stage``.

        ``setdefault`` semantics: re-marking (retry re-dispatch, the ladder
        re-fetching a split batch) never moves an existing stamp, so stage
        latencies measure first entry to next stage's first entry.
        """
        if not self.enabled:
            return
        now_us = int(time.perf_counter() * 1e6)
        rate = self._rate
        with self._lock:
            lineage = self._lineage
            for did in doc_ids:
                if not doc_sampled(did, rate):
                    continue
                rec = lineage.get(did)
                if rec is None:
                    if len(lineage) >= _LINEAGE_CAP:
                        lineage.pop(next(iter(lineage)))
                        METRICS.inc("doc_lineage_evicted_total")
                    rec = lineage[did] = {}
                    METRICS.inc("doc_sampled_total")
                rec.setdefault(stage, now_us)

    def complete(self, documents: Iterable) -> None:
        """Close lineages at the Parquet write seam.

        For each sampled document: the delta between consecutive present
        stamps is that stage's latency (a stage the doc skipped — e.g. no
        device dispatch on the host-oracle path — contributes nothing),
        the final segment ends now, and e2e spans first stamp to now.
        """
        if not self.enabled:
            return
        now_us = int(time.perf_counter() * 1e6)
        flows: List = []
        with self._lock:
            for doc in documents:
                did = getattr(doc, "id", None) or getattr(
                    getattr(doc, "document", None), "id", ""
                )
                rec = self._lineage.pop(did, None)
                if rec is None:
                    continue
                stamps = sorted(
                    ((s, t) for s, t in rec.items() if s in _STAGE_ORDER),
                    key=lambda st: (_STAGE_ORDER[st[0]], st[1]),
                )
                if not stamps:
                    continue
                flows.append((did, stamps))
        for did, stamps in flows:
            deltas: Dict[str, int] = {}
            for i, (stage, t) in enumerate(stamps):
                end = stamps[i + 1][1] if i + 1 < len(stamps) else now_us
                d = max(0, end - t)
                deltas[stage] = d
                METRICS.observe_hdr(f"doc_latency_{stage}_seconds", d)
            e2e = max(0, now_us - stamps[0][1])
            deltas["e2e"] = e2e
            METRICS.observe_hdr("doc_latency_e2e_seconds", e2e)
            TRACER.instant("doc_flow", {"id": did, "us": deltas})

    # -- geometry drift ------------------------------------------------------

    def set_geometry_baseline(self, waste_ratio: float) -> None:
        """Pin the calibration-time waste baseline the detector compares
        live windows against (otherwise the first non-empty window is
        adopted)."""
        with self._lock:
            self._baseline_waste = float(waste_ratio)

    # -- windowed rollups ----------------------------------------------------

    def _tick(self) -> None:
        while not self._stop.wait(self._window_s):
            try:
                self.roll_window()
            except Exception:  # noqa: BLE001 — telemetry must never kill a run
                pass

    def roll_window(self) -> Dict[str, object]:
        """Close one rollup window: counter deltas -> rates, gauge reads,
        waste ratio, drift check.  Called by the ticker (or directly by
        tests / bench for deterministic windows)."""
        now = {name: METRICS.get(name) for name in _WINDOW_COUNTERS}
        with self._lock:
            last = self._last_counters
            self._last_counters = dict(now)
            dt = self._window_s
            d = {k: max(0.0, now[k] - last.get(k, 0.0)) for k in now}
            lanes = d["occupancy_padded_lanes_total"]
            real = d["occupancy_real_codepoints_total"]
            waste = round(1.0 - real / lanes, 6) if lanes > 0 else None
            posts = d["multihost_exchange_posts_total"]
            post_s = d["multihost_exchange_post_seconds_total"]
            window: Dict[str, object] = {
                "t_s": round(time.perf_counter() - self._t0, 3),
                "window_s": dt,
                "docs_per_s": round(d["producer_results_received_total"] / dt, 3),
                "chars_per_s": round(d["writer_chars_total"] / dt, 1),
                "waste_ratio": waste,
                "exchange_posts_per_s": round(posts / dt, 3),
                "exchange_post_mean_s": (
                    round(post_s / posts, 6) if posts > 0 else None
                ),
            }
            for name in _WINDOW_GAUGES:
                window[name] = int(METRICS.get(name))
            drift = None
            if waste is not None:
                if self._baseline_waste is None:
                    self._baseline_waste = waste
                deviation = round(abs(waste - self._baseline_waste), 6)
                drift = deviation
                METRICS.set("geometry_drift", deviation)
                if deviation > self._drift_threshold:
                    if not self._drift_high:  # edge-trigger the instant
                        self._drift_high = True
                        from .events import EVENTS

                        if EVENTS.enabled:
                            EVENTS.emit(
                                "geometry_drift", ratio=deviation,
                                live_waste=waste,
                                baseline_waste=self._baseline_waste,
                            )
                        TRACER.instant(
                            "geometry_drift",
                            {
                                "live_waste": waste,
                                "baseline_waste": self._baseline_waste,
                                "deviation": deviation,
                            },
                        )
                else:
                    self._drift_high = False
            window["geometry_drift"] = drift
            self._windows.append(window)
            return window

    # -- snapshot / summary --------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """JSON-serializable live view: the window ring, drift state, and
        the current latency quantiles — the ``/telemetry`` endpoint body."""
        with self._lock:
            windows = list(self._windows)
            baseline = self._baseline_waste
            rate = self._rate
            window_s = self._window_s
            threshold = self._drift_threshold
            open_lineages = len(self._lineage)
        return {
            "enabled": self.enabled,
            "sample_rate": rate,
            "window_s": window_s,
            "drift_threshold": threshold,
            "baseline_waste_ratio": baseline,
            "geometry_drift": METRICS.get("geometry_drift"),
            "open_lineages": open_lineages,
            "sampled_docs": int(METRICS.get("doc_sampled_total")),
            "windows": windows,
            "latency": latency_report(),
        }


def format_latency_summary(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> str:
    """Human-readable tail-latency block for the CLI end-of-run summary."""
    rep = latency_report(baseline, values)
    stages = rep["stages"]
    if not stages:
        return "Per-document tail latency: no sampled documents completed."
    lines = [
        "Per-document tail latency (sampled, relative error <= "
        f"{rep['relative_error']:.2%}):"
    ]
    order = list(DOC_LATENCY_STAGES) + ["exchange_post"]
    for stage in order:
        s = stages.get(stage)
        if not s:
            continue
        lines.append(
            f"  {stage:<12} n={s['count']:>7}  p50={s['p50_s']:>9.6f}s  "
            f"p95={s['p95_s']:>9.6f}s  p99={s['p99_s']:>9.6f}s"
        )
    return "\n".join(lines)


#: Process-wide hub, disabled until configured.
TELEMETRY = Telemetry()
