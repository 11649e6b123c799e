"""Declarative SLO engine: burn-rate alerting + error-budget accounting.

The port's copy of the JAX package's ``utils/slo.py``: the same objective
vocabulary (:data:`SLO_KEYS`, which the port's pipeline config validates
its ``slo:`` block against), the same evaluation, alerts, gauges and
report section, over the port's own metrics registry and event journal.

The metrics registry says what the pipeline *did*; this module says
whether that is *good enough against a target*.  Objectives are declared
as ``KEY=TARGET`` pairs (``--slo`` / the ``slo:`` config block):

* ``availability=0.999`` — fraction of documents that must not
  hard-error: bad = ``producer_results_error_total``, total = every
  document outcome reaching the aggregation sink
  (``producer_results_received_total`` — the one seam every backend path
  feeds).  Error budget = 1 − target.
* ``p99_latency_s=0.25`` — 99% of sampled documents must finish their
  end-to-end path within the target.  Evaluated from the
  ``doc_latency_e2e_seconds`` HDR histogram: bad = samples whose bucket
  upper bound exceeds the target, total = all samples.  Implied error
  budget = 1% (it's a p99).  The family is fed by the doc-latency
  telemetry (``utils/telemetry.py``), so the objective sees events only
  in a run with ``--doc-sample-rate`` above 0.
* ``throughput_floor=500`` — docs/s the run must sustain: each
  evaluation tick compares the since-last-tick document rate against the
  floor; bad = ticks below it.  Error budget = 5% of ticks.

Evaluation follows the SRE multi-window multi-burn-rate recipe: the
instantaneous burn rate (bad fraction / budget) is computed over a fast
and a slow trailing window — both clamped to the elapsed run length so
short runs still alert — and an ``slo_alert`` journal event fires
(edge-triggered, with a matching ``slo_resolved``) only when *both*
windows burn above the threshold, which suppresses one-tick blips
without missing sustained burn.

Mergeability is inherited from the metrics registry: each objective
maintains monotone ``slo_events_total_<key>`` / ``slo_bad_events_total_
<key>`` counters and publishes ``slo_target_<key>`` / ``slo_burn_rate_
<key>`` / ``slo_budget_remaining_<key>`` gauges, so the existing
multihost ``all_values()`` sum/max merge yields gang-wide SLO state and
:func:`slo_report` rebuilds burn/budget numbers from any flat snapshot
(run-report v4's ``slo`` section) — per-rank or merged, byte-identically.

Like TRACER / WATCHDOG / EVENTS, the engine is inert until armed: one
``SLO.enabled`` attribute check at every seam.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "SLO_KEYS",
    "SLO",
    "SLOEngine",
    "parse_slo_arg",
    "slo_report",
    "health_snapshot",
]

#: The closed objective vocabulary: ``key -> (error budget, help)``.
#: ``availability``'s budget is derived from the target (1 − target); the
#: listed value is only the fallback when the target is degenerate.
SLO_KEYS: Dict[str, Tuple[float, str]] = {
    "availability": (
        0.001,
        "fraction of documents that must not hard-error (bad = error "
        "outcomes, total = all outcomes); budget = 1 - target",
    ),
    "p99_latency_s": (
        0.01,
        "99th-percentile sampled end-to-end document latency ceiling, "
        "seconds (needs --doc-sample-rate > 0); budget = 1% of samples",
    ),
    "throughput_floor": (
        0.05,
        "minimum sustained docs/s; evaluated per tick against the "
        "since-last-tick rate; budget = 5% of ticks",
    ),
}


def parse_slo_arg(arg: str) -> Tuple[str, float]:
    """Parse one ``KEY=TARGET`` objective; raises ``ValueError`` with an
    operator-readable message on any malformation."""
    if "=" not in arg:
        raise ValueError(
            f"--slo expects KEY=TARGET, got {arg!r} "
            f"(keys: {', '.join(SLO_KEYS)})"
        )
    key, _, raw = arg.partition("=")
    key = key.strip()
    if key not in SLO_KEYS:
        raise ValueError(
            f"unknown SLO key {key!r} (keys: {', '.join(SLO_KEYS)})"
        )
    try:
        value = float(raw.strip())
    except ValueError:
        raise ValueError(f"--slo {key}: target {raw!r} is not a number")
    if key == "availability" and not 0.0 < value <= 1.0:
        raise ValueError("--slo availability: target must be in (0, 1]")
    if key != "availability" and value <= 0:
        raise ValueError(f"--slo {key}: target must be > 0")
    return key, value


def _budget_for(key: str, target: float) -> float:
    if key == "availability":
        return max(1e-9, 1.0 - target)
    return SLO_KEYS[key][0]


class SLOEngine:
    """Continuous SLO evaluator over the live metrics registry.

    ``evaluate()`` is the whole engine: read cumulative (bad, total) pairs
    per objective, append them to a time-stamped sample ring, derive
    fast/slow-window burn rates, publish gauges/counters, and
    edge-trigger alerts.  A daemon ticker calls it periodically in
    production; tests call it synchronously."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._objectives: Dict[str, float] = {}
        self._fast_s = 60.0
        self._slow_s = 300.0
        self._threshold = 1.0
        self._tick_s = 5.0
        self._t0 = 0.0
        self._baseline: Dict[str, Tuple[int, int]] = {}
        self._samples: List[Tuple[float, Dict[str, Tuple[int, int]]]] = []
        self._alerting: Dict[str, bool] = {}
        self._last: Dict[str, Dict[str, float]] = {}
        self._tp_prev: Optional[Tuple[float, int]] = None
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # --- lifecycle ----------------------------------------------------------

    def configure(
        self,
        objectives: Dict[str, float],
        *,
        fast_window_s: float = 60.0,
        slow_window_s: float = 300.0,
        burn_threshold: float = 1.0,
        tick_s: float = 5.0,
        start_ticker: bool = True,
    ) -> None:
        """Arm the engine with ``{key: target}`` objectives.  Publishes the
        ``slo_target_<key>`` gauges immediately (they are gang-agreed
        constants — max-merge safe) and takes the cumulative baseline so a
        re-armed engine never charges pre-run errors to the budget."""
        for key in objectives:
            if key not in SLO_KEYS:
                raise ValueError(f"unknown SLO key {key!r}")
        from .metrics import METRICS

        with self._lock:
            self._objectives = dict(objectives)
            self._fast_s = float(fast_window_s)
            self._slow_s = float(slow_window_s)
            self._threshold = float(burn_threshold)
            self._tick_s = max(0.05, float(tick_s))
            self._t0 = time.monotonic()
            self._samples = []
            self._alerting = {k: False for k in objectives}
            self._last = {}
            self._tp_prev = None
            self._baseline = {
                k: self._read_cumulative(k, self._objectives[k])
                for k in objectives
            }
            self.enabled = bool(objectives)
        for key, target in objectives.items():
            METRICS.set(f"slo_target_{key}", float(target))
        if self.enabled and start_ticker:
            self._stop.clear()
            self._ticker = threading.Thread(
                target=self._run_ticker, name="textblast-slo", daemon=True
            )
            self._ticker.start()

    def close(self) -> None:
        """Stop the ticker, run one final evaluation, and disarm."""
        if not self.enabled:
            return
        self._stop.set()
        t = self._ticker
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        self._ticker = None
        try:
            self.evaluate()
        except Exception:  # pragma: no cover - teardown must not raise
            pass
        self.enabled = False

    def reset(self) -> None:
        """Full disarm for tests (mirrors WATCHDOG.reset())."""
        self._stop.set()
        t = self._ticker
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        self._ticker = None
        with self._lock:
            self.enabled = False
            self._objectives = {}
            self._samples = []
            self._alerting = {}
            self._last = {}
            self._tp_prev = None
            self._baseline = {}

    # --- evaluation ---------------------------------------------------------

    def _read_cumulative(self, key: str, target: float) -> Tuple[int, int]:
        """Cumulative (bad, total) event counts for one objective, read
        from the live registry (absolute, not baseline-relative)."""
        from .metrics import METRICS

        if key == "availability":
            # The aggregation-sink seam (producer_results_*) counts every
            # document outcome on every backend path — host, device, and
            # multihost stripes — unlike worker_tasks_*, which only the
            # host executor feeds.
            bad = int(METRICS.get("producer_results_error_total"))
            total = int(METRICS.get("producer_results_received_total"))
            return bad, total
        if key == "p99_latency_s":
            from .metrics import hdr_bucket_high_us

            buckets, _sum_us, count = METRICS.hdr_state(
                "doc_latency_e2e_seconds"
            )
            threshold_us = int(target * 1e6)
            bad = sum(
                c for idx, c in buckets.items()
                if hdr_bucket_high_us(idx) > threshold_us
            )
            return bad, count
        # throughput_floor: tick-based — cumulative counts live in the
        # registry counters this engine itself maintains.
        return (
            int(METRICS.get("slo_bad_events_total_throughput_floor")),
            int(METRICS.get("slo_events_total_throughput_floor")),
        )

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Dict[str, float]]:
        """One evaluation tick: returns the per-key state it published."""
        if not self.enabled:
            return {}
        from .metrics import METRICS

        t = time.monotonic() if now is None else now
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            if not self.enabled:
                return {}
            objectives = dict(self._objectives)
            # The throughput objective turns the document counter into
            # per-tick pass/fail events before cumulative reads happen.
            if "throughput_floor" in objectives:
                self._tick_throughput_locked(t, objectives["throughput_floor"])
            cum = {
                k: self._read_cumulative(k, objectives[k]) for k in objectives
            }
            self._samples.append((t, cum))
            horizon = t - max(self._slow_s, self._fast_s) * 1.5
            while len(self._samples) > 2 and self._samples[0][0] < horizon:
                self._samples.pop(0)
            elapsed = max(1e-9, t - self._t0)
            for key, target in objectives.items():
                budget = _budget_for(key, target)
                base = self._baseline.get(key, (0, 0))
                bad = max(0, cum[key][0] - base[0])
                total = max(0, cum[key][1] - base[1])
                bad_frac = bad / total if total else 0.0
                burn_fast = self._window_burn_locked(
                    key, t, min(self._fast_s, elapsed), budget, base
                )
                burn_slow = self._window_burn_locked(
                    key, t, min(self._slow_s, elapsed), budget, base
                )
                remaining = max(0.0, 1.0 - (bad_frac / budget)) if total else 1.0
                state = {
                    "target": target,
                    "budget": budget,
                    "bad": float(bad),
                    "total": float(total),
                    "bad_frac": bad_frac,
                    "burn_rate": bad_frac / budget,
                    "burn_fast": burn_fast,
                    "burn_slow": burn_slow,
                    "budget_remaining": remaining,
                }
                out[key] = state
                self._last[key] = state
                firing = (
                    total > 0
                    and burn_fast > self._threshold
                    and burn_slow > self._threshold
                )
                was = self._alerting.get(key, False)
                self._alerting[key] = firing
                if firing and not was:
                    self._alert_edge_locked(key, state, resolved=False)
                elif was and not firing:
                    self._alert_edge_locked(key, state, resolved=True)
        # Publish outside the lock: METRICS has its own.
        for key, s in out.items():
            if key != "throughput_floor":
                METRICS.set(f"slo_events_total_{key}", s["total"])
                METRICS.set(f"slo_bad_events_total_{key}", s["bad"])
            METRICS.set(f"slo_burn_rate_{key}", round(s["burn_fast"], 6))
            METRICS.set(
                f"slo_budget_remaining_{key}", round(s["budget_remaining"], 6)
            )
        return out

    def _tick_throughput_locked(self, t: float, floor: float) -> None:
        from .metrics import METRICS

        done = int(METRICS.get("producer_results_received_total"))
        prev = self._tp_prev
        self._tp_prev = (t, done)
        if prev is None:
            return
        dt = t - prev[0]
        if dt <= 0:
            return
        rate = (done - prev[1]) / dt
        METRICS.inc("slo_events_total_throughput_floor")
        if rate < floor:
            METRICS.inc("slo_bad_events_total_throughput_floor")

    def _window_burn_locked(
        self,
        key: str,
        t: float,
        window_s: float,
        budget: float,
        base: Tuple[int, int],
    ) -> float:
        """Burn rate over the trailing ``window_s``: the bad fraction of
        events inside the window, over the budget.  The window anchor is
        the newest sample at or before ``t - window_s`` (falling back to
        the arm-time baseline for young runs)."""
        cutoff = t - window_s
        anchor = base
        for ts, cum in self._samples:
            if ts > cutoff:
                break
            anchor = cum.get(key, base)
        head = self._samples[-1][1].get(key, base) if self._samples else base
        bad = max(0, head[0] - anchor[0])
        total = max(0, head[1] - anchor[1])
        if total == 0:
            return 0.0
        return (bad / total) / budget

    def _alert_edge_locked(
        self, key: str, state: Dict[str, float], *, resolved: bool
    ) -> None:
        from .events import EVENTS
        from .metrics import METRICS

        if resolved:
            if EVENTS.enabled:
                EVENTS.emit("slo_resolved", key=key)
            logger.warning("SLO %s recovered (burn back under threshold)", key)
            return
        METRICS.inc("slo_alerts_total")
        if EVENTS.enabled:
            EVENTS.emit(
                "slo_alert",
                key=key,
                burn_rate=round(state["burn_fast"], 4),
                window_s=self._fast_s,
                burn_slow=round(state["burn_slow"], 4),
                budget_remaining=round(state["budget_remaining"], 4),
            )
        logger.error(
            "SLO alert: %s burning at %.2fx budget (fast) / %.2fx (slow), "
            "%.1f%% of error budget left",
            key, state["burn_fast"], state["burn_slow"],
            state["budget_remaining"] * 100.0,
        )

    def _run_ticker(self) -> None:
        while not self._stop.wait(self._tick_s):
            try:
                self.evaluate()
            except Exception as e:  # pragma: no cover - must not die
                logger.warning("SLO evaluation tick failed: %s", e)

    # --- introspection ------------------------------------------------------

    def active_alerts(self) -> List[str]:
        with self._lock:
            return sorted(k for k, v in self._alerting.items() if v)

    def objectives(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._objectives)

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready engine state (the ``/slo`` endpoint body and the
        flight recorder's ``slo`` section)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "objectives": dict(self._objectives),
                "windows": {
                    "fast_s": self._fast_s,
                    "slow_s": self._slow_s,
                    "burn_threshold": self._threshold,
                    "tick_s": self._tick_s,
                },
                "elapsed_s": round(time.monotonic() - self._t0, 3)
                if self.enabled
                else 0.0,
                "state": {k: dict(v) for k, v in self._last.items()},
                "alerting": sorted(
                    k for k, v in self._alerting.items() if v
                ),
            }


#: Process-wide engine.  Import this, never construct your own.
SLO = SLOEngine()


def slo_report(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """The run report's ``slo`` section, rebuilt from a flat snapshot.

    Objectives are discovered from the ``slo_target_<key>`` gauges inside
    the snapshot itself, and burn/budget numbers derive only from the
    monotone ``slo_events_total_*`` / ``slo_bad_events_total_*`` counters
    — so the section computed from a gang-merged snapshot equals the
    bucket-wise merge of the per-rank snapshots by construction."""
    from .metrics import METRICS

    vals = values if values is not None else METRICS.all_values()
    base = baseline or {}
    out: Dict[str, object] = {}
    for name, target in sorted(vals.items()):
        if not name.startswith("slo_target_"):
            continue
        key = name[len("slo_target_"):]
        if key not in SLO_KEYS:
            continue
        budget = _budget_for(key, float(target))
        bad = max(
            0.0,
            vals.get(f"slo_bad_events_total_{key}", 0.0)
            - base.get(f"slo_bad_events_total_{key}", 0.0),
        )
        total = max(
            0.0,
            vals.get(f"slo_events_total_{key}", 0.0)
            - base.get(f"slo_events_total_{key}", 0.0),
        )
        bad_frac = bad / total if total else 0.0
        out[key] = {
            "target": float(target),
            "budget": round(budget, 9),
            "bad_events": int(bad),
            "events": int(total),
            "bad_frac": round(bad_frac, 9),
            "burn_rate": round(bad_frac / budget, 6),
            "budget_remaining": round(
                max(0.0, 1.0 - bad_frac / budget), 6
            ) if total else 1.0,
        }
    alerts = max(
        0.0,
        vals.get("slo_alerts_total", 0.0) - base.get("slo_alerts_total", 0.0),
    )
    if not out and alerts == 0:
        return {}
    return {"objectives": out, "alerts_total": int(alerts)}


#: Most-recently-seen watchdog escalation count, so health degrades on a
#: *new* escalation and recovers on the next clean scrape instead of
#: latching degraded forever on a cumulative counter.
_health_state = {"escalations_seen": 0.0}


def health_snapshot() -> Tuple[int, Dict[str, object]]:
    """The ``/healthz`` verdict: ``(http_status, body)``.

    Live/ready semantics: the process is *live* by virtue of answering;
    it is *ready* once warmup has resolved (``pipeline_warmup_done``) and
    no degradation signal is active — circuit breaker open, liveness
    lease stale (membership-epoch freshness), a watchdog escalation since
    the previous scrape, or a firing SLO alert.  200 when ready, 503
    (starting or degraded) otherwise, always with a component breakdown
    in the JSON body."""
    from .metrics import METRICS

    warm = METRICS.get("pipeline_warmup_done") >= 1.0
    breaker_open = METRICS.get("resilience_breaker_open") >= 1.0
    lease_ratio = METRICS.get("multihost_lease_age_ratio")
    lease_stale = lease_ratio >= 1.0
    escalations = METRICS.get("watchdog_escalations_total")
    new_escalation = escalations > _health_state["escalations_seen"]
    _health_state["escalations_seen"] = escalations
    alerts = SLO.active_alerts() if SLO.enabled else []

    degraded = breaker_open or lease_stale or new_escalation or bool(alerts)
    if not warm:
        status = "starting"
    elif degraded:
        status = "degraded"
    else:
        status = "ok"
    body: Dict[str, object] = {
        "status": status,
        "live": True,
        "ready": warm and not degraded,
        "components": {
            "warmup_done": warm,
            "breaker_open": breaker_open,
            "lease_age_ratio": round(lease_ratio, 4),
            "lease_stale": lease_stale,
            "watchdog_escalations": int(escalations),
            "new_escalation": new_escalation,
            "slo_alerts": alerts,
            "membership_epoch": int(
                METRICS.get("multihost_membership_epoch")
            ),
        },
    }
    return (200 if body["ready"] else 503), body
