"""Stall watchdog: per-stage deadlines over the host-side blocking waits.

The port's copy of the JAX package's ``resilience/watchdog.py``, with its
trace instants and journal events.  The rest of the
resilience stack handles failures that *raise*; this module handles
failures that *hang*.  The overlapped pipeline has four blocking seams
where a wedged dependency stalls the run silently — the device fetch (the
dispatch thread's wait on a batch's CUDA events, and the caller's wait on
the dispatch thread's future), pack-pool futures, the write-behind queue,
and the reader prefetch queue.

:class:`StageWatchdog` deadline-bounds each stage.  Every bounded wait is a
*polling* loop with a short tick, so the wait stays interruptible: when the
stage deadline expires the watchdog raises a typed
:class:`~textblaster_tpu_torch.errors.StallError` naming the stage, the
elapsed time, and the deadline.  ``StallError`` is classified retryable, so
a device-fetch stall enters the ordinary retry → split-half → host-oracle
degradation ladder exactly like a raised fault.

A CUDA event has no blocking wait with a timeout, so
:meth:`StageWatchdog.wait_device_ready` polls ``torch.cuda.Event.query()``
(objects without ``query``, such as host arrays, are ready).  The waits
inside the phase functions (``.any()`` gates, the dup walk's step count)
block in the CUDA runtime and cannot be polled; the caller's wait on the
dispatch thread bounds them from outside
(``ops/pipeline.py`` ``_DispatchThread.wait``).

Inert by default: every production seam guards its watchdog branch with a
single ``if WATCHDOG.enabled:`` attribute check and keeps the original
unbounded wait in the ``else`` arm — a disabled watchdog (the default;
``--stage-deadline-s 0``) adds exactly one attribute read per seam and
never constructs a beat, timestamp, or closure.

The deadline knob is *scheduling-only*: it cannot change any document
decision or output byte.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, Iterator, Mapping, Optional

from ..errors import StallError
from ..utils.events import EVENTS
from ..utils.metrics import METRICS
from ..utils.trace import TRACER

__all__ = ["ENV_KNOB", "STAGES", "StageWatchdog", "WATCHDOG"]

#: The four supervised host-side stages, in pipeline order.
STAGES = ("device_fetch", "pack_wait", "write_queue", "read_prefetch")

#: Environment knob: default per-stage deadline in seconds (0 disables).
ENV_KNOB = "TEXTBLAST_STAGE_DEADLINE_S"

#: Poll interval for bounded waits.  Short enough that an expired deadline
#: surfaces promptly; long enough that the enabled-path overhead stays in
#: the noise next to real device/queue latencies.
_TICK_S = 0.02


class _Beat:
    """A heartbeat: 'this thread is inside *stage* since *start*'.  The
    fault injector's latency kinds (``delay=``/``hang``) consult the current
    beat so an injected hang can be rescued by the stage deadline on the
    hanging thread itself — no monitor thread."""

    __slots__ = ("stage", "start", "deadline_s")

    def __init__(self, stage: str, start: float, deadline_s: float) -> None:
        self.stage = stage
        self.start = start
        self.deadline_s = deadline_s


class StageWatchdog:
    """Deadline supervisor for the host-side pipeline stages.

    One process-global instance (:data:`WATCHDOG`) is shared by every seam;
    ``configure()`` arms it (CLI ``--stage-deadline-s`` or the
    ``TEXTBLAST_STAGE_DEADLINE_S`` env knob), ``reset()`` disarms for tests.
    """

    def __init__(self) -> None:
        self.enabled = False
        self._default_s = 0.0
        self._per_stage: Dict[str, float] = {}
        self._tls = threading.local()
        # Thread id -> its current beat, so that another thread can see
        # that a wait is bounded where it runs (see in_beat).
        self._beats: Dict[int, _Beat] = {}

    # -- configuration -----------------------------------------------------

    def configure(
        self,
        deadline_s: float,
        per_stage: Optional[Mapping[str, float]] = None,
    ) -> None:
        """Arm (deadline > 0) or disarm (deadline <= 0) the watchdog.

        ``per_stage`` overrides the default deadline for individual stages.
        Publishes one ``watchdog_deadline_seconds_<stage>`` gauge per stage
        when armed.
        """
        self._default_s = max(0.0, float(deadline_s))
        self._per_stage = {
            str(k): max(0.0, float(v)) for k, v in (per_stage or {}).items()
        }
        self.enabled = self._default_s > 0 or any(
            v > 0 for v in self._per_stage.values()
        )
        if self.enabled:
            for stage in STAGES:
                METRICS.set(
                    "watchdog_deadline_seconds_" + stage,
                    self.deadline_for(stage),
                )

    def configure_from_env(self, env: Optional[Mapping[str, str]] = None) -> None:
        """Arm from ``TEXTBLAST_STAGE_DEADLINE_S`` (unset/invalid → leave
        the current configuration alone)."""
        import os

        raw = (env if env is not None else os.environ).get(ENV_KNOB)
        if raw is None or not str(raw).strip():
            return
        try:
            self.configure(float(raw))
        except (TypeError, ValueError):
            return

    def reset(self) -> None:
        """Disarm and forget per-stage overrides (test hygiene)."""
        self.enabled = False
        self._default_s = 0.0
        self._per_stage = {}
        self._tls = threading.local()
        self._beats = {}

    def deadline_for(self, stage: str) -> float:
        """Effective deadline for *stage* in seconds (0 = unbounded)."""
        return self._per_stage.get(stage, self._default_s)

    # -- stall bookkeeping -------------------------------------------------

    def stall(
        self, stage: str, elapsed_s: float, deadline_s: float, detail: str = ""
    ) -> None:
        """Record a stall and raise the typed :class:`StallError`."""
        METRICS.inc("watchdog_stalls_total")
        TRACER.instant(
            "watchdog_stall",
            {
                "stage": stage,
                "elapsed_s": round(elapsed_s, 3),
                "deadline_s": deadline_s,
                "detail": detail,
            },
        )
        if EVENTS.enabled:
            EVENTS.emit("watchdog_stall", stage=stage,
                        elapsed_s=round(elapsed_s, 3),
                        deadline_s=deadline_s, detail=detail)
        raise StallError(
            stage, elapsed_s=elapsed_s, deadline_s=deadline_s, detail=detail
        )

    def escalated(self, exc: BaseException) -> None:
        """Count a stall handed to existing recovery machinery (the retry
        ladder).  No-op for non-stall errors so callers can report every
        retryable exception unconditionally."""
        if isinstance(exc, StallError):
            METRICS.inc("watchdog_escalations_total")
            TRACER.instant("watchdog_escalation", {"stage": exc.stage})
            if EVENTS.enabled:
                EVENTS.emit("watchdog_escalation", reason=exc.stage)

    # -- heartbeats (fault-injector integration) ---------------------------

    @contextmanager
    def stage_beat(self, stage: str) -> Iterator[None]:
        """Mark this thread as inside *stage* for the dynamic extent.

        The fault injector's ``delay``/``hang`` kinds poll the current beat
        so an injected hang raises ``StallError`` on its own thread when
        the stage deadline expires.  Other threads see the beat through
        :meth:`in_beat`.
        """
        ident = threading.get_ident()
        prev = getattr(self._tls, "beat", None)
        beat = _Beat(stage, time.monotonic(), self.deadline_for(stage))
        self._tls.beat = beat
        beats = self._beats
        beats[ident] = beat
        try:
            yield
        finally:
            self._tls.beat = prev
            if prev is None:
                beats.pop(ident, None)
            else:
                beats[ident] = prev

    def current_beat(self) -> Optional[_Beat]:
        return getattr(self._tls, "beat", None)

    def in_beat(self, thread: threading.Thread) -> bool:
        """True while ``thread`` is inside a :meth:`stage_beat` with a
        deadline: whatever it waits on there is bounded on that thread."""
        beat = self._beats.get(thread.ident)
        return beat is not None and beat.deadline_s > 0

    def check_beat(self, detail: str = "") -> None:
        """Raise ``StallError`` iff this thread's beat deadline expired."""
        beat = self.current_beat()
        if beat is None or beat.deadline_s <= 0:
            return
        elapsed = time.monotonic() - beat.start
        if elapsed >= beat.deadline_s:
            self.stall(beat.stage, elapsed, beat.deadline_s, detail)

    # -- bounded waits -----------------------------------------------------

    def wait(
        self,
        stage: str,
        done: Callable[[], bool],
        detail: Optional[Callable[[], str]] = None,
    ) -> None:
        """Poll ``done()`` until true; raise ``StallError`` at the stage
        deadline.  With an unbounded stage (deadline 0) returns at once so
        the caller falls through to its ordinary blocking wait."""
        deadline_s = self.deadline_for(stage)
        if deadline_s <= 0:
            return
        start = time.monotonic()
        while not done():
            elapsed = time.monotonic() - start
            if elapsed >= deadline_s:
                self.stall(
                    stage, elapsed, deadline_s, detail() if detail else ""
                )
            time.sleep(_TICK_S)

    def wait_device_ready(self, stage: str, events: Iterable[object]) -> None:
        """Bounded readiness wait over CUDA events (``torch.cuda.Event.query``),
        so that the blocking synchronize or copy after it cannot block past
        the stage deadline.  Objects without ``query`` (host arrays,
        scalars) are already ready."""
        pending = [e for e in events if hasattr(e, "query")]
        if not pending:
            return
        self.wait(
            stage,
            lambda: all(e.query() for e in pending),
            lambda: f"{len(pending)} CUDA event(s) not reached",
        )

    def queue_get(self, stage: str, q: "queue_mod.Queue") -> object:
        """``q.get()`` bounded by the stage deadline."""
        deadline_s = self.deadline_for(stage)
        if deadline_s <= 0:
            return q.get()
        start = time.monotonic()
        while True:
            try:
                return q.get(timeout=min(0.1, deadline_s))
            except queue_mod.Empty:
                elapsed = time.monotonic() - start
                if elapsed >= deadline_s:
                    self.stall(
                        stage,
                        elapsed,
                        deadline_s,
                        f"queue depth {q.qsize()}",
                    )

    def queue_put(self, stage: str, q: "queue_mod.Queue", item: object) -> None:
        """``q.put(item)`` bounded by the stage deadline."""
        deadline_s = self.deadline_for(stage)
        if deadline_s <= 0:
            q.put(item)
            return
        start = time.monotonic()
        while True:
            try:
                q.put(item, timeout=min(0.1, deadline_s))
                return
            except queue_mod.Full:
                elapsed = time.monotonic() - start
                if elapsed >= deadline_s:
                    self.stall(
                        stage,
                        elapsed,
                        deadline_s,
                        f"queue depth {q.qsize()}",
                    )

    def join_thread(
        self, stage: str, thread: "threading.Thread", progress: Callable[[], int]
    ) -> None:
        """Bounded, progress-aware ``thread.join()``.

        The deadline is a *no-progress* bound: each time ``progress()``
        moves (e.g. the write queue drains an item) the timer restarts, so
        a slow-but-live drain is never killed while a wedged one surfaces a
        typed ``StallError`` carrying the residual depth.  Falls back to a
        generous static bound when the watchdog is disarmed.
        """
        deadline_s = self.deadline_for(stage)
        if deadline_s <= 0:
            deadline_s = 60.0
        last = progress()
        start = time.monotonic()
        while thread.is_alive():
            thread.join(timeout=min(0.1, deadline_s))
            now_progress = progress()
            if now_progress != last:
                last = now_progress
                start = time.monotonic()
                continue
            elapsed = time.monotonic() - start
            if elapsed >= deadline_s:
                self.stall(
                    stage,
                    elapsed,
                    deadline_s,
                    f"queue depth {now_progress}",
                )


#: Process-global watchdog shared by every supervised seam.
WATCHDOG = StageWatchdog()
