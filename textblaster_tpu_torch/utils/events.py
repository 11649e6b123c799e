"""Structured operational event journal (JSONL, severity-leveled).

The port's copy of the JAX package's ``utils/events.py``: the same closed
vocabulary (:data:`KINDS`, :data:`SEVERITIES`), the same record schema
(:func:`validate_record`), the same journal and flight record, so the two
packages' journals and dumps can be held side by side.

The trace (utils/trace.py) answers *where did the time go*; the metrics
registry answers *how much*; the journal answers the operator's question
*what happened, in what order* when a run degrades or dies.  Every
operational transition the port has — retries, breaker trips, ladder
splits and host rungs, watchdog stalls, SLO alerts, the run's start, end
and fatal exit — lands as one record:

* **One journal per process**, JSONL, spilled incrementally from a bounded
  ring, so a killed run still leaves a readable prefix on disk.
* **Monotone sequence numbers**, so the order of events is recoverable even
  if timestamps collide.
* **Trace-clock timestamps**: ``ts_us`` comes from ``TRACER.now_us()``, so
  the journal interleaves with the trace.  With tracing off the clock
  degrades to raw ``perf_counter`` microseconds (monotone per process).
* **Rank/incarnation/epoch stamping**, as in the JAX package (rank 0,
  incarnation 0 and the registry's membership epoch on one process).
* **Near-zero cost when off.**  Disarmed, every seam is one
  ``EVENTS.enabled`` attribute check.

``emit()`` validates against :data:`KINDS`: an unknown kind or a missing
field is counted (``events_invalid_total``) and dropped.  Per-kind counts
are mirrored into the metrics registry as ``events_total_<kind>``
counters, which the run report's ``events`` section reads.

The **flight recorder** (:func:`flight_record`) is the crash-path
consumer: on a fatal exit it writes the last-N journal events, the metrics
registry, the live telemetry rollups (``telemetry``, when telemetry is on)
and the SLO state to ``<output>.flightrec/rank<r>.json`` (atomic tmp, fsync
and rename).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "KINDS",
    "SEVERITIES",
    "EventJournal",
    "EVENTS",
    "JournalLogHandler",
    "flight_record",
    "validate_record",
]

#: Severity ladder, least to most severe.  ``emit(severity=...)`` may
#: upgrade a kind's default (e.g. a retry that exhausted its budget) but
#: every value must come from this set.
SEVERITIES = ("info", "warning", "error", "critical")

#: The closed event vocabulary: ``kind -> (default severity, required
#: data fields)``.  Adding a kind here is a schema change — consumers
#: (run-report v4, the flight recorder, downstream log shippers) key on
#: these names, and the schema lint test enumerates every ``emit()`` call
#: site against this table.
KINDS: Dict[str, tuple] = {
    # -- resilience: retry ladder / circuit breaker ---------------------------
    "retry": ("warning", ("seam", "attempt", "error")),
    "retry_exhausted": ("error", ("seam", "attempts", "error")),
    "breaker_trip": ("error", ("seam", "failures")),
    "breaker_probe": ("info", ("seam",)),
    "breaker_recovery": ("info", ("seam",)),
    "breaker_reopen": ("warning", ("seam",)),
    "ladder_split": ("warning", ("batch", "depth")),
    "ladder_host": ("warning", ("batch",)),
    # -- negotiated lockstep rounds -------------------------------------------
    "negotiated_verdict": ("warning", ("bucket", "attempt")),
    "negotiated_retry": ("warning", ("bucket", "attempt")),
    "negotiated_degraded": ("warning", ("bucket",)),
    "negotiated_reformed": ("warning", ("bucket",)),
    # -- gang membership / reformation / elastic join -------------------------
    "peer_failure": ("critical", ("missing_ranks",)),
    "gang_reform_start": ("warning", ("epoch",)),
    "gang_reformation": ("warning", ("epoch", "world_size")),
    "gang_admission_start": ("info", ("epoch",)),
    "gang_admission": ("info", ("epoch", "world_size")),
    "membership_join": ("info", ("rank", "epoch")),
    "membership_rejoin": ("info", ("rank", "epoch")),
    "membership_evict": ("warning", ("rank", "epoch")),
    "rank_fenced": ("warning", ("rank",)),
    "join_request": ("info", ("rank",)),
    "stripe_adopted": ("warning", ("stripe", "adopter")),
    "autoscale_spawn": ("info", ("rank",)),
    # -- watchdog / speculation / drift ---------------------------------------
    "watchdog_stall": ("error", ("stage", "elapsed_s", "deadline_s")),
    "watchdog_escalation": ("critical", ("reason",)),
    "speculation_void": ("warning", ("voided", "cause")),
    "geometry_drift": ("warning", ("ratio",)),
    "window_depth_mismatch": ("warning", ("joint",)),
    # -- durability / startup -------------------------------------------------
    "checkpoint_commit": ("info", ("chunk",)),
    "checkpoint_adopted": ("warning", ("owner",)),
    "warmup_complete": ("info", ("programs", "total_s", "cache_hits")),
    # -- SLO engine / logging bridge / run lifecycle --------------------------
    "slo_alert": ("error", ("key", "burn_rate", "window_s")),
    "slo_resolved": ("info", ("key",)),
    "log": ("warning", ("logger", "message")),
    "run_start": ("info", ()),
    "run_end": ("info", ("exit_code",)),
    "fatal": ("critical", ("reason",)),
}


def validate_record(record: Dict[str, Any]) -> None:
    """Raise ``ValueError`` unless ``record`` is a schema-valid journal
    record: enumerated kind, legal severity, required envelope fields,
    and every kind-mandated data field present."""
    for field in ("seq", "ts_us", "kind", "severity", "rank", "incarnation",
                  "epoch", "data"):
        if field not in record:
            raise ValueError(f"journal record missing field {field!r}")
    kind = record["kind"]
    spec = KINDS.get(kind)
    if spec is None:
        raise ValueError(f"unknown event kind {kind!r}")
    if record["severity"] not in SEVERITIES:
        raise ValueError(f"illegal severity {record['severity']!r}")
    data = record["data"]
    if not isinstance(data, dict):
        raise ValueError("data must be a mapping")
    missing = [f for f in spec[1] if f not in data]
    if missing:
        raise ValueError(f"kind {kind!r} missing data fields {missing}")


class EventJournal:
    """Thread-safe, monotonically-sequenced operational event journal.

    Mirrors the Tracer's bounded-ring + incremental-spill + drop-accounting
    design (utils/trace.py) but writes JSONL and additionally keeps a
    small ``recent`` deque that survives spills — the flight recorder's
    last-N view must not go empty just because the ring flushed."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._ring: List[Dict[str, Any]] = []
        self._ring_cap = 4096
        self._recent: Deque[Dict[str, Any]] = deque(maxlen=256)
        self._counts: Dict[str, int] = {}
        self._seq = 0
        self._dropped = 0
        self._invalid = 0
        self._warned_drop = False
        self._path: Optional[str] = None
        self._fh = None
        self._rank = 0
        self._incarnation = 0

    # --- lifecycle ----------------------------------------------------------

    def configure(
        self,
        path: Optional[str] = None,
        *,
        rank: int = 0,
        incarnation: int = 0,
        ring: int = 4096,
        recent: int = 256,
    ) -> None:
        """Arm the journal.  ``path=None`` keeps events in the bounded ring
        only (test / SLO-only mode); otherwise the ring spills to ``path``
        as JSONL whenever it fills and on ``close()``."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            self._ring = []
            self._ring_cap = max(16, int(ring))
            self._recent = deque(maxlen=max(16, int(recent)))
            self._counts = {}
            self._seq = 0
            self._dropped = 0
            self._invalid = 0
            self._warned_drop = False
            self._path = path
            self._fh = None
            self._rank = int(rank)
            self._incarnation = int(incarnation)
            if path is not None:
                parent = os.path.dirname(os.path.abspath(path))
                os.makedirs(parent, exist_ok=True)
                self._fh = open(path, "w", encoding="utf-8")
            self.enabled = True

    def set_incarnation(self, incarnation: int) -> None:
        """Bump the incarnation stamp (gang reformation elected a new
        configuration); subsequent records carry the new value."""
        self._incarnation = int(incarnation)

    def close(self) -> None:
        """Flush the ring to the spill file and disarm."""
        with self._lock:
            if not self.enabled:
                return
            self.enabled = False
            if self._fh is not None:
                self._spill_locked()
                if self._fh is not None:  # spill failure closes the file
                    try:
                        self._fh.close()
                    except OSError as e:
                        logger.warning(
                            "Event journal close on %s failed: %s",
                            self._path, e,
                        )
                    self._fh = None
            if self._dropped:
                logger.warning(
                    "Event journal dropped %d events (ring overflow or "
                    "unwritable spill file)", self._dropped,
                )

    def drain(self) -> List[Dict[str, Any]]:
        """Return and clear the in-memory ring (test hook)."""
        with self._lock:
            out, self._ring = self._ring, []
            return out

    def recent(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The last-N emitted records (flight-recorder view); survives
        ring spills, newest last."""
        with self._lock:
            out = list(self._recent)
        return out if n is None else out[-int(n):]

    def counts(self) -> Dict[str, int]:
        """Per-kind emit counts since ``configure()``."""
        with self._lock:
            return dict(self._counts)

    # --- recording ----------------------------------------------------------

    def emit(self, kind: str, severity: Optional[str] = None, **data: Any) -> None:
        """Record one event.  ``severity`` defaults from :data:`KINDS`;
        schema violations are counted and dropped, never raised — the
        journal must not take down the pipeline it is documenting."""
        if not self.enabled:
            return
        spec = KINDS.get(kind)
        if spec is None or severity is not None and severity not in SEVERITIES:
            self._count_invalid(kind)
            return
        missing = [f for f in spec[1] if f not in data]
        if missing:
            self._count_invalid(kind)
            return
        # Epoch is read live so records emitted across a reformation carry
        # the membership generation they happened under.
        from .metrics import EVENT_KIND_PREFIX, METRICS
        from .trace import TRACER

        record = {
            "seq": 0,  # assigned under the lock below
            "ts_us": TRACER.now_us(),
            "kind": kind,
            "severity": severity or spec[0],
            "rank": self._rank,
            "incarnation": self._incarnation,
            "epoch": int(METRICS.get("multihost_membership_epoch")),
            "data": data,
        }
        with self._lock:
            if not self.enabled:  # closed concurrently
                return
            self._seq += 1
            record["seq"] = self._seq
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._recent.append(record)
            self._append_locked(record)
        METRICS.inc("events_emitted_total")
        METRICS.inc(EVENT_KIND_PREFIX + kind)

    # --- internals ----------------------------------------------------------

    def _count_invalid(self, kind: str) -> None:
        from .metrics import METRICS

        with self._lock:
            self._invalid += 1
            first = self._invalid == 1
        METRICS.inc("events_invalid_total")
        if first:
            logger.warning(
                "Event journal dropped a schema-invalid record (kind=%r); "
                "further violations counted in events_invalid_total", kind,
            )

    def _append_locked(self, record: Dict[str, Any]) -> None:
        self._ring.append(record)
        if len(self._ring) >= self._ring_cap:
            if self._fh is not None:
                self._spill_locked()
            else:
                # Ring-only mode: drop the oldest half, keep counting.
                drop = len(self._ring) // 2
                self._count_dropped_locked(drop)
                del self._ring[:drop]

    def _count_dropped_locked(self, n: int) -> None:
        """Account ``n`` dropped events: local counter, the
        ``events_dropped_total`` metric, and a one-line stderr warning on
        the first drop — same contract as the trace ring."""
        self._dropped += n
        first = not self._warned_drop
        self._warned_drop = True
        from .metrics import METRICS

        METRICS.inc("events_dropped_total", n)
        if first:
            print(
                f"textblast: journal events dropped ({n} so far) — ring "
                "overflow or unwritable spill file; the event journal "
                "will be incomplete",
                file=sys.stderr,
            )

    def _spill_locked(self) -> None:
        if not self._ring:
            return
        chunks = []
        for record in self._ring:
            chunks.append(json.dumps(record, separators=(",", ":")))
            chunks.append("\n")
        try:
            self._fh.write("".join(chunks))
            self._fh.flush()
        except OSError as e:
            self._count_dropped_locked(len(self._ring))
            logger.warning(
                "Event journal spill to %s failed: %s", self._path, e
            )
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        self._ring = []


#: Process-wide journal.  Import this, never construct your own — emit
#: sites across the codebase all talk to the same instance.
EVENTS = EventJournal()


class JournalLogHandler(logging.Handler):
    """Routes WARNING+ log records into the event journal when armed.

    Installed once by ``utils/logging_setup.init_logging`` on the root
    logger; per-record cost while the journal is disarmed is the
    ``EVENTS.enabled`` check.  Records from the journal's own logger are
    skipped outright (drop / invalid-record diagnostics are accounted in
    ``events_*_total``, not re-journaled), and a thread-local reentrancy
    guard prevents recursion when capture itself logs."""

    _reentrant = threading.local()

    def __init__(self) -> None:
        super().__init__(level=logging.WARNING)

    def emit(self, record: logging.LogRecord) -> None:  # noqa: A003
        if not EVENTS.enabled:
            return
        if record.name == __name__:
            # The journal's own diagnostics (drop / invalid-record
            # accounting) are already counted in events_*_total;
            # re-journaling them would feed the journal its own exhaust.
            return
        if getattr(self._reentrant, "active", False):
            return
        self._reentrant.active = True
        try:
            severity = "error" if record.levelno >= logging.ERROR else "warning"
            EVENTS.emit(
                "log",
                severity=severity,
                logger=record.name,
                level=record.levelname,
                message=record.getMessage(),
            )
        except Exception:  # pragma: no cover - never break logging
            pass
        finally:
            self._reentrant.active = False


#: Flight-recorder dump schema tag.
FLIGHTREC_SCHEMA = "textblaster-flightrec/v1"


def flight_record(
    base_path: str,
    *,
    rank: int = 0,
    reason: str = "fatal",
    exc: Optional[BaseException] = None,
) -> Optional[str]:
    """Write a crash flight-recorder dump for this rank.

    ``base_path`` is the run's output path (or any stable per-run path);
    the dump lands at ``<base_path>.flightrec/rank<r>.json`` via atomic
    tmp+fsync+rename so a concurrent scraper never sees a torn file.
    The payload bundles everything a postmortem needs without scrollback:
    the last-N journal events, per-kind counts, the full metrics registry,
    live telemetry rollups, and SLO state.  Best-effort by construction —
    returns the written path, or None if anything failed (the fatal path
    that called us must still exit cleanly)."""
    try:
        from .metrics import METRICS

        payload: Dict[str, Any] = {
            "schema": FLIGHTREC_SCHEMA,
            "reason": reason,
            "rank": int(rank),
            "incarnation": EVENTS._incarnation,
            "ts_us": None,
            "exception": None,
            "events_recent": EVENTS.recent(),
            "events_counts": EVENTS.counts(),
            "events_dropped": EVENTS._dropped,
            "metrics": METRICS.all_values(),
        }
        from .trace import TRACER

        payload["ts_us"] = TRACER.now_us()
        if exc is not None:
            payload["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
            }
        try:
            from .telemetry import TELEMETRY

            if TELEMETRY.enabled:
                payload["telemetry"] = TELEMETRY.snapshot()
        except Exception:  # pragma: no cover - rollup must not kill the dump
            pass
        try:
            from .slo import SLO

            if SLO.enabled:
                payload["slo"] = SLO.snapshot()
        except Exception:  # pragma: no cover
            pass

        out_dir = base_path + ".flightrec"
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"rank{int(rank)}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path
    except Exception as e:  # pragma: no cover - best-effort by contract
        logger.warning("Flight-recorder dump failed: %s", e)
        return None
