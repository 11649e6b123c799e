"""Circuit breaker for the device execution path.

The port's copy of the JAX package's ``resilience/breaker.py``, with its
trace instants and journal events.

A device batch that exhausts its whole degradation ladder (retry -> split ->
host-oracle rerun) still *completes* — the host rung is bit-exact — but each
such batch costs the full host pipeline.  When the device keeps failing
batch after batch (a lost or wedged GPU), paying ladder
latency per batch is strictly worse than admitting the device is gone:
after ``threshold`` consecutive failures the breaker trips and the run
degrades wholesale to the host backend.  The transition is recorded in
METRICS (``resilience_breaker_trips_total`` counter +
``resilience_breaker_open`` gauge) and logged once.

Half-open recovery: a long shard should not stay host-bound after a
transient outage (a transient device fault that cleared).  After
``cooldown_s`` of open time, the next ``allow_request()`` grants exactly one
probe batch (half-open).  If that batch succeeds the breaker closes and the
run returns to the device; if it fails the breaker reopens with a fresh
cooldown.  ``cooldown_s=0`` disables probing — the breaker latches for the
run's life (the pre-half-open behavior).
"""

from __future__ import annotations

import logging
import threading
import time

from ..utils.events import EVENTS
from ..utils.metrics import METRICS
from ..utils.trace import TRACER

logger = logging.getLogger(__name__)

__all__ = ["CircuitBreaker"]

_CLOSED = "closed"
_OPEN = "open"
_HALF_OPEN = "half_open"


class CircuitBreaker:
    """Trip after ``threshold`` *consecutive* failures; a success resets the
    streak.  While open, ``allow_request()`` is False until ``cooldown_s``
    elapses, then grants one half-open probe.  A probe success closes the
    breaker (``record_success`` closes *only* from half-open: a success
    recorded while open belongs to a dispatch that predates the trip and must
    not untrip it); a probe failure reopens with a fresh cooldown."""

    def __init__(
        self,
        threshold: int = 3,
        name: str = "device",
        cooldown_s: float = 0.0,
        clock=time.monotonic,
    ) -> None:
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        self.threshold = threshold
        self.name = name
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._consecutive_failures = 0
        self._state = _CLOSED
        self._opened_at = 0.0

    @property
    def tripped(self) -> bool:
        return self._state != _CLOSED

    @property
    def state(self) -> str:
        return self._state

    @property
    def consecutive_failures(self) -> int:
        return self._consecutive_failures

    def allow_request(self) -> bool:
        """True if the caller may dispatch to the device now.

        Closed: always.  Open: False until the cooldown elapses, then the
        first caller transitions to half-open and is granted the probe
        (subsequent callers see False until the probe resolves)."""
        with self._lock:
            if self._state == _CLOSED:
                return True
            if self._state == _HALF_OPEN:
                # A probe is already in flight; hold further traffic.
                return False
            if self.cooldown_s <= 0:
                return False
            if self._clock() - self._opened_at < self.cooldown_s:
                return False
            self._state = _HALF_OPEN
        METRICS.inc("resilience_breaker_probe_total")
        TRACER.instant("breaker_probe", {"breaker": self.name})
        if EVENTS.enabled:
            EVENTS.emit("breaker_probe", seam=self.name)
        logger.warning(
            "Circuit breaker '%s' half-open after %.1fs cooldown; probing "
            "the device with one batch.",
            self.name,
            self.cooldown_s,
        )
        return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state != _HALF_OPEN:
                return
            self._state = _CLOSED
        METRICS.inc("resilience_breaker_recoveries_total")
        TRACER.instant("breaker_recovery", {"breaker": self.name})
        if EVENTS.enabled:
            EVENTS.emit("breaker_recovery", seam=self.name)
        METRICS.set("resilience_breaker_open", 0)
        logger.warning(
            "Circuit breaker '%s' closed: half-open probe succeeded; "
            "resuming device dispatch.",
            self.name,
        )

    def record_failure(self, cause: str = "") -> None:
        with self._lock:
            if self._state == _OPEN:
                return
            if self._state == _HALF_OPEN:
                # Probe failed: reopen with a fresh cooldown.
                self._state = _OPEN
                self._opened_at = self._clock()
                reopened = True
            else:
                self._consecutive_failures += 1
                if self._consecutive_failures < self.threshold:
                    return
                self._state = _OPEN
                self._opened_at = self._clock()
                reopened = False
        if reopened:
            METRICS.set("resilience_breaker_open", 1)
            TRACER.instant("breaker_reopen", {"breaker": self.name})
            if EVENTS.enabled:
                EVENTS.emit("breaker_reopen", seam=self.name, cause=cause)
            logger.error(
                "Circuit breaker '%s' reopened: half-open probe failed%s; "
                "cooling down for %.1fs.",
                self.name,
                f" (last: {cause})" if cause else "",
                self.cooldown_s,
            )
            return
        METRICS.inc("resilience_breaker_trips_total")
        TRACER.instant("breaker_trip",
                       {"breaker": self.name, "cause": cause})
        if EVENTS.enabled:
            EVENTS.emit("breaker_trip", seam=self.name,
                        failures=self.threshold, cause=cause)
        METRICS.set("resilience_breaker_open", 1)
        logger.error(
            "Circuit breaker '%s' tripped after %d consecutive failures%s; "
            "degrading to the host backend%s.",
            self.name,
            self.threshold,
            f" (last: {cause})" if cause else "",
            (
                f" (will probe after {self.cooldown_s:.1f}s)"
                if self.cooldown_s > 0
                else " for the rest of the run"
            ),
        )
