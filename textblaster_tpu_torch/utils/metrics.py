"""The process-wide counter registry.

The port's copy of the counter half of the JAX package's
``utils/metrics.py`` (``Metrics``: ``inc``, ``dec``, ``set``, ``get``,
``prefixed``, ``all_values``, ``reset``, and the ``METRICS`` singleton).
Counters keep the JAX package's names, so the two packages' deltas can be
held side by side.  The resilience layer counts here:

* ``resilience_retries_total``, ``resilience_retries_<seam>_total``,
  ``resilience_retry_exhausted_total`` (:mod:`..resilience.retry`);
* ``resilience_ladder_split_total``, ``resilience_ladder_host_total``
  (the device ladder, ``ops/pipeline.py``);
* ``resilience_breaker_trips_total``, ``resilience_breaker_probe_total``,
  ``resilience_breaker_recoveries_total`` and the ``resilience_breaker_open``
  gauge (:mod:`..resilience.breaker`);
* ``resilience_quarantined_rows_total`` (the Parquet read seam);
* ``watchdog_stalls_total``, ``watchdog_escalations_total`` and the
  ``watchdog_deadline_seconds_<stage>`` gauges (:mod:`..resilience.watchdog`);
* ``deadletter_rows_total`` (:mod:`..resilience.deadletter`).

Not ported yet: histograms, the Prometheus rendering and HTTP exporter,
and the run reports.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict

__all__ = ["Metrics", "METRICS"]


class Metrics:
    """Thread-safe counter/gauge registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: Dict[str, float] = defaultdict(float)

    def inc(self, name: str, amount: float = 1.0) -> None:
        with self._lock:
            self._values[name] += amount

    def dec(self, name: str, amount: float = 1.0) -> None:
        with self._lock:
            self._values[name] -= amount

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._values[name] = value

    def get(self, name: str) -> float:
        with self._lock:
            return self._values.get(name, 0.0)

    def prefixed(self, prefix: str) -> Dict[str, float]:
        """All counters whose name starts with ``prefix``."""
        with self._lock:
            return {k: v for k, v in self._values.items() if k.startswith(prefix)}

    def all_values(self) -> Dict[str, float]:
        """Copy of every counter and gauge value."""
        with self._lock:
            return dict(self._values)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


#: The process-wide registry every seam counts into.
METRICS = Metrics()
