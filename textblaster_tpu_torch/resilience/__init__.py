"""Fault-tolerant execution layer (the port's copy of the JAX package's).

* :mod:`~textblaster_tpu_torch.resilience.retry` — :class:`RetryPolicy`
  with exponential backoff + jitter and an error classifier that tells
  transient faults (CUDA out-of-memory, I/O, stalls: retryable) from
  deterministic errors and sticky CUDA errors (fatal), applied at the
  Parquet row-group read and the device batch;
* :mod:`~textblaster_tpu_torch.resilience.breaker` — :class:`CircuitBreaker`
  behind the device degradation ladder (retry the batch -> split it in half
  -> rerun on the host oracle), sending the run to the host oracle after N
  consecutive batches fell to the host rung;
* :mod:`~textblaster_tpu_torch.resilience.faults` — :data:`FAULTS`, a
  process-global, test-armable :class:`FaultInjector` planted at every
  guarded seam;
* :mod:`~textblaster_tpu_torch.resilience.deadletter` —
  :class:`DeadLetterSink`, the opt-in ``--errors-file`` Parquet quarantine
  for Error outcomes and unreadable rows;
* :mod:`~textblaster_tpu_torch.resilience.watchdog` — :data:`WATCHDOG`, the
  stall watchdog over the host-side blocking waits.

Not ported yet: the multi-host arms.  The gang
(``parallel/multihost.py``) names no rank dead: the negotiated round guard
(``negotiated.py``) comes with the negotiated rounds, the liveness leases
and elastic membership (``membership.py``) after them.
"""

from .breaker import CircuitBreaker
from .deadletter import (
    DEADLETTER_SCHEMA,
    DeadLetterSink,
    outcome_row,
    read_error_row,
)
from .faults import FAULTS, FaultInjector, arm_from_env
from .retry import (
    RetryPolicy,
    classify_error,
    is_oom_error,
    is_retryable_error,
)
from .watchdog import WATCHDOG, StageWatchdog

__all__ = [
    "CircuitBreaker",
    "DEADLETTER_SCHEMA",
    "DeadLetterSink",
    "FAULTS",
    "FaultInjector",
    "RetryPolicy",
    "StageWatchdog",
    "WATCHDOG",
    "arm_from_env",
    "classify_error",
    "is_oom_error",
    "is_retryable_error",
    "outcome_row",
    "read_error_row",
]
