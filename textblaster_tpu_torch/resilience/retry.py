"""Retry policy: exponential backoff + jitter with an error classifier.

The port's copy of the JAX package's ``resilience/retry.py``, with its trace
instants and journal events.  The classifier is the
load-bearing piece: only *transient* faults — device out-of-memory, OS-level
I/O hiccups, watchdog stalls — are worth re-attempting.  Deterministic
pipeline errors (a filter decision, a config problem) repeat identically on
every attempt and must surface immediately; retrying them only delays the
failure and hides its cause.

On CUDA the classifier's device branch (the JAX package's
``XlaRuntimeError`` one) reads the CUDA error:

* ``torch.cuda.OutOfMemoryError`` ("CUDA out of memory") and the kernels'
  ``cudaErrorMemoryAllocation`` are retryable and out-of-memory, so the
  ladder's split rung reaches them;
* the *sticky* errors — an illegal address (700), a launch timeout (702),
  a device-side assert (710), the hardware faults 714–718 and a launch
  failure (719) — are fatal: after any of them the CUDA context is lost,
  every later call fails the same way, and rerunning the batch on the host
  would hide a kernel bug.  They are matched before the transient markers
  (a launch timeout's "timed out" would otherwise read as transient).

The clock is injectable (``sleep=``/``rng=``) so unit tests cover the full
backoff schedule without ever sleeping for real.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, TypeVar

from ..errors import (
    CheckpointError,
    ConfigError,
    ConfigValidationError,
    DocumentFiltered,
    PipelineError,
    RetryExhaustedError,
    StallError,
    StepError,
)
from ..kernels.build import BuildError
from ..utils.events import EVENTS
from ..utils.metrics import METRICS
from ..utils.trace import TRACER
from .watchdog import WATCHDOG

logger = logging.getLogger(__name__)

__all__ = [
    "RetryPolicy",
    "classify_error",
    "is_oom_error",
    "is_retryable_error",
]

T = TypeVar("T")

# Message markers of transient device/transport faults.
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "ABORTED",
    "CANCELLED",
    "preempt",
    "connection",
    "socket",
    "timed out",
    "timeout",
    "temporarily",
    "response body closed",
    "out of memory",
)

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "OOM", "oom")

# CUDA errors after which the context is unusable (sticky): their runtime
# names (as the kernel wrappers report them, kernels/build.py ``check``)
# and the runtime's messages for them (as torch reports them).
_STICKY_CUDA_MARKERS = (
    "cudaErrorIllegalAddress",
    "cudaErrorLaunchTimeout",
    "cudaErrorAssert",
    "cudaErrorHardwareStackError",
    "cudaErrorIllegalInstruction",
    "cudaErrorMisalignedAddress",
    "cudaErrorInvalidAddressSpace",
    "cudaErrorInvalidPc",
    "cudaErrorLaunchFailure",
    "an illegal memory access was encountered",
    "the launch timed out and was terminated",
    "device-side assert triggered",
    "an illegal instruction was encountered",
    "misaligned address",
    "unspecified launch failure",
)

# CUDA out-of-memory, by name and by the runtime's message.
_CUDA_OOM_MARKERS = ("cudaErrorMemoryAllocation", "CUDA out of memory")

# Errors no outer retry loop should re-attempt: deterministic pipeline
# errors repeat identically, RetryExhaustedError means a budget was
# already spent on this fault (nested policies must not multiply attempts),
# and a kernel library that failed to build or load (whatever the compiler
# printed) would send the whole run to the host.
_DETERMINISTIC_TYPES = (
    DocumentFiltered,
    StepError,
    ConfigError,
    ConfigValidationError,
    CheckpointError,
    RetryExhaustedError,
    BuildError,
)


def _message_transient(exc: BaseException) -> bool:
    msg = str(exc)
    return any(marker in msg for marker in _TRANSIENT_MARKERS)


def _sticky_cuda(exc: BaseException) -> bool:
    msg = str(exc)
    return any(marker in msg for marker in _STICKY_CUDA_MARKERS)


def _torch_oom(exc: BaseException) -> bool:
    """``torch.cuda.OutOfMemoryError`` (``torch.OutOfMemoryError``),
    without importing torch here."""
    return any(
        t.__name__ == "OutOfMemoryError" and t.__module__.startswith("torch")
        for t in type(exc).__mro__
    )


def is_oom_error(exc: BaseException) -> bool:
    """Device out-of-memory — the ladder's split-in-half rung targets these.
    Unwraps :class:`RetryExhaustedError` so an OOM that survived the retry
    budget still routes to the split rung."""
    if isinstance(exc, RetryExhaustedError):
        exc = exc.last
    if isinstance(exc, MemoryError) or _torch_oom(exc):
        return True
    msg = str(exc)
    return any(marker in msg for marker in _OOM_MARKERS + _CUDA_OOM_MARKERS)


def is_retryable_error(exc: BaseException) -> bool:
    return classify_error(exc) == "retryable"


def classify_error(exc: BaseException) -> str:
    """``"retryable"`` (transient device/IO fault) or ``"fatal"``
    (deterministic — do not re-attempt)."""
    if isinstance(exc, _DETERMINISTIC_TYPES):
        return "fatal"
    if isinstance(exc, StallError):
        # Watchdog stall: the stalled stage may complete on a re-attempt
        # (re-dispatch, fresh fetch), and the degradation ladder bounds the
        # damage if it never does — explicitly retryable so a hang enters
        # the same recovery machinery as a raised transient fault.
        return "retryable"
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return "fatal"
    if _sticky_cuda(exc):
        # Sticky CUDA error: the context is lost, so a retry fails the same
        # way and the host rung would hide a kernel bug.
        return "fatal"
    if _torch_oom(exc):
        return "retryable"
    if isinstance(exc, (OSError, TimeoutError, ConnectionError, MemoryError)):
        # IOError/socket/timeout family: the transient-by-construction bucket.
        return "retryable"
    msg = str(exc)
    if any(marker in msg for marker in _CUDA_OOM_MARKERS):
        return "retryable"
    if isinstance(exc, PipelineError):
        # Remaining pipeline errors (ParquetError, IoError, Unexpected…):
        # retry only when the message says transient transport/IO.
        return "retryable" if _message_transient(exc) else "fatal"
    return "retryable" if _message_transient(exc) else "fatal"


class RetryPolicy:
    """Exponential backoff + jitter around a callable.

    ``max_retries`` counts re-attempts *after* the first try (``0`` disables
    retrying while keeping classification/metrics).  Delays follow
    ``base * multiplier**k`` capped at ``max_delay``, each widened by up to
    ``jitter`` fraction of itself (seeded ``rng`` for determinism in tests).
    """

    def __init__(
        self,
        max_retries: int = 3,
        base_delay: float = 0.05,
        max_delay: float = 2.0,
        multiplier: float = 2.0,
        jitter: float = 0.5,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
        classify: Callable[[BaseException], str] = classify_error,
    ) -> None:
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.max_retries = max_retries
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self.sleep = sleep
        self.rng = rng if rng is not None else random.Random()
        self.classify = classify

    def delay_for(self, attempt: int) -> float:
        """Backoff for re-attempt ``attempt`` (0-based), jitter applied."""
        d = min(self.base_delay * (self.multiplier ** attempt), self.max_delay)
        if self.jitter > 0.0:
            d *= 1.0 + self.rng.uniform(0.0, self.jitter)
        return d

    def run(
        self,
        fn: Callable[[], T],
        seam: str = "generic",
        on_retry: Optional[Callable[[BaseException, int], None]] = None,
    ) -> T:
        """Call ``fn`` until it succeeds, a fatal error surfaces, or retries
        are exhausted.

        ``seam`` labels metrics (``resilience_retries_<seam>_total``);
        ``on_retry(exc, attempt)`` observes each re-attempt before its
        backoff.  Exhausting the budget on a *retryable* error raises
        :class:`~textblaster_tpu_torch.errors.RetryExhaustedError` (a
        ``PipelineError``) chained to the last underlying error; fatal
        errors re-raise untouched.
        """
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 — classifier decides
                if self.classify(e) != "retryable":
                    raise
                WATCHDOG.escalated(e)
                if attempt >= self.max_retries:
                    METRICS.inc("resilience_retry_exhausted_total")
                    if EVENTS.enabled:
                        EVENTS.emit("retry_exhausted", seam=seam,
                                    attempts=attempt + 1,
                                    error=type(e).__name__)
                    raise RetryExhaustedError(seam, attempt + 1, e) from e
                delay = self.delay_for(attempt)
                attempt += 1
                METRICS.inc("resilience_retries_total")
                METRICS.inc(f"resilience_retries_{seam}_total")
                TRACER.instant(
                    "retry", {"seam": seam, "attempt": attempt,
                              "error": type(e).__name__}
                )
                if EVENTS.enabled:
                    EVENTS.emit("retry", seam=seam, attempt=attempt,
                                error=type(e).__name__)
                logger.warning(
                    "Transient fault at seam '%s' (attempt %d/%d, backing off "
                    "%.3fs): %s",
                    seam, attempt, self.max_retries, delay, e,
                )
                if on_retry is not None:
                    on_retry(e, attempt)
                if delay > 0.0:
                    self.sleep(delay)

    @classmethod
    def from_config(cls, rc, **overrides) -> "RetryPolicy":
        """Build from a :class:`~textblaster_tpu_torch.config.pipeline.ResilienceConfig`."""
        kw = dict(
            max_retries=rc.max_retries,
            base_delay=rc.backoff_base_s,
            max_delay=rc.backoff_max_s,
            multiplier=rc.backoff_multiplier,
            jitter=rc.jitter,
        )
        kw.update(overrides)
        return cls(**kw)
