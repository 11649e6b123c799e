"""Process-global fault injector for chaos tests.

The port's copy of the JAX package's ``resilience/faults.py``.

Every seam the retry layer guards calls :meth:`FaultInjector.fire` with its
site name; an armed fault acts through the *production* control flow, so
chaos tests exercise exactly the code paths a real failure would — no
monkeypatching of internals.

Three fault *kinds*:

* ``raise`` (the default) — the armed exception propagates from the seam;
* ``delay`` — sleep ``delay_ms`` then proceed, modelling a slow dependency
  (a delay longer than the stage deadline surfaces as a watchdog
  :class:`~textblaster_tpu_torch.errors.StallError`);
* ``hang`` — block indefinitely, modelling a wedged dependency: the hang
  only ends when the stall watchdog's stage deadline expires on the
  hanging thread (raising ``StallError`` into the seam) or the injector is
  disarmed (:meth:`FaultInjector.reset` from another thread).

Sites planted in the port (the JAX package's other ``multihost.*`` sites
come with the multi-host path):

* ``"read.batch"``        — per row-group Parquet fetch
  (:mod:`textblaster_tpu_torch.io.parquet_reader`);
* ``"device.execute"``    — per device-batch dispatch
  (:meth:`textblaster_tpu_torch.ops.pipeline.CompiledPipeline.dispatch_batch`,
  on the dispatch thread when the window is overlapped);
* ``"checkpoint.commit"`` — per checkpoint cursor commit, inside the
  retried tmp-and-rename (:meth:`textblaster_tpu_torch.checkpoint.CheckpointState.save`);
* ``"multihost.rejoin"``  — per stripe-cursor claim
  (:meth:`textblaster_tpu_torch.checkpoint.CheckpointState.adopt`).

The injector is **inert by default**: with nothing armed, :meth:`fire` is a
single attribute load + falsy check and keeps no per-call state, so
production paths pay effectively nothing (a tier-1 guard test pins this).

A run in another process (a CLI run, one rank of a multi-process run)
cannot be armed from the test process: :func:`arm_from_env` reads a
``TEXTBLAST_FAULTS`` spec from the environment inside that process (and
``TEXTBLAST_FAULTS_PROCESS`` gates it to one process id).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

__all__ = ["FaultInjector", "FAULTS", "arm_from_env"]

ExcSpec = Union[BaseException, Callable[[], BaseException]]

#: Poll interval for the latency kinds — short enough that disarm and
#: deadline expiry surface promptly inside an injected delay/hang.
_LATENCY_TICK_S = 0.01


@dataclass
class _ArmedFault:
    """One armed fault: skip ``after_calls`` fires, then trigger ``times``.

    ``kind`` selects what a trigger does: ``"raise"`` raises ``exc``,
    ``"delay"`` sleeps ``delay_ms`` then proceeds, ``"hang"`` blocks until
    the watchdog beat deadline or a disarm.  ``raised`` counts triggers of
    every kind (the name predates the latency kinds; :meth:`fired` reads
    it either way).
    """

    exc: Optional[ExcSpec]
    after_calls: int = 0
    times: int = 1
    kind: str = "raise"
    delay_ms: float = 0.0
    seen: int = 0
    raised: int = 0

    def should_raise(self) -> bool:
        return self.seen > self.after_calls and self.raised < self.times

    def make_exc(self) -> BaseException:
        if callable(self.exc) and not isinstance(self.exc, BaseException):
            return self.exc()
        return self.exc


class FaultInjector:
    """Test-armable fault hook (``inject(site, after_calls=k, exc=...)``).

    ``times`` controls how many consecutive fires raise once triggered —
    ``times=1`` models a transient blip (first retry succeeds), a large
    ``times`` models a persistent outage (the ladder degrades rung by rung).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # Falsy when nothing is armed — the only state `fire` consults on
        # the production fast path.
        self._sites: Dict[str, List[_ArmedFault]] = {}
        # Bumped by reset(): a thread blocked inside an injected hang polls
        # this and unblocks when the arming that started it is gone.
        self._generation = 0

    # --- arming (test-side) -------------------------------------------------

    def inject(
        self,
        site: str,
        exc: Optional[ExcSpec] = None,
        after_calls: int = 0,
        times: int = 1,
        kind: str = "raise",
        delay_ms: float = 0.0,
    ) -> None:
        """Arm ``site``: the ``after_calls+1``-th fire (and the ``times-1``
        following it) trigger the fault.  For the default ``kind="raise"``,
        ``exc`` may be an exception instance (re-raised each time) or a
        zero-arg factory; ``kind="delay"`` sleeps ``delay_ms`` then
        proceeds; ``kind="hang"`` blocks until the watchdog stage deadline
        or :meth:`reset`."""
        if times < 1:
            raise ValueError("times must be >= 1")
        if after_calls < 0:
            raise ValueError("after_calls must be >= 0")
        if kind not in ("raise", "delay", "hang"):
            raise ValueError(f"unknown fault kind {kind!r}")
        if kind == "raise" and exc is None:
            raise ValueError("kind='raise' requires exc")
        if kind == "delay" and delay_ms <= 0:
            raise ValueError("kind='delay' requires delay_ms > 0")
        with self._lock:
            self._sites.setdefault(site, []).append(
                _ArmedFault(
                    exc=exc,
                    after_calls=after_calls,
                    times=times,
                    kind=kind,
                    delay_ms=delay_ms,
                )
            )

    def reset(self) -> None:
        """Disarm everything (test teardown); unblocks in-flight hangs."""
        with self._lock:
            self._sites = {}
            self._generation += 1

    def active(self) -> bool:
        """True if any fault is armed (the tier-1 inertness guard)."""
        return bool(self._sites)

    def fired(self, site: str) -> int:
        """How many times ``site``'s armed faults have raised so far."""
        with self._lock:
            return sum(f.raised for f in self._sites.get(site, ()))

    # --- production side ----------------------------------------------------

    def fire(self, site: str) -> None:
        """Called by production seams.  Inert (one falsy check) unless a
        test armed a fault for ``site``.  Latency kinds (delay/hang) block
        *outside* the injector lock so other sites and the disarm path
        stay live while a seam sleeps."""
        if not self._sites:
            return
        action = None
        with self._lock:
            faults = self._sites.get(site)
            if not faults:
                return
            for f in faults:
                f.seen += 1
                if f.should_raise():
                    f.raised += 1
                    if f.kind == "raise":
                        action = ("raise", f.make_exc())
                    elif f.kind == "delay":
                        action = ("delay", f.delay_ms)
                    else:
                        action = ("hang", self._generation)
                    break
            else:
                return
        if action[0] == "raise":
            raise action[1]
        if action[0] == "delay":
            self._injected_delay(site, action[1] / 1000.0)
        else:
            self._injected_hang(site, action[1])

    def _injected_delay(self, site: str, seconds: float) -> None:
        """Sleep in watchdog-aware ticks, then let the seam proceed.  A
        delay longer than the supervised stage's deadline surfaces as a
        ``StallError`` on this thread mid-sleep."""
        from .watchdog import WATCHDOG

        end = time.monotonic() + seconds
        while True:
            WATCHDOG.check_beat(f"injected delay at {site}")
            remaining = end - time.monotonic()
            if remaining <= 0:
                return
            time.sleep(min(_LATENCY_TICK_S, remaining))

    def _injected_hang(self, site: str, generation: int) -> None:
        """Block until the watchdog stage deadline expires on this thread
        (raising ``StallError`` into the seam) or :meth:`reset` disarms the
        fault that started the hang."""
        from .watchdog import WATCHDOG

        while True:
            WATCHDOG.check_beat(f"injected hang at {site}")
            with self._lock:
                if self._generation != generation:
                    return
            time.sleep(_LATENCY_TICK_S)


#: The process-global injector every guarded seam fires into.
FAULTS = FaultInjector()

#: Exception types :func:`arm_from_env` may construct — an allowlist, not
#: ``eval``: the env var names one of these, never arbitrary code.
_ENV_EXC_TYPES = {
    "OSError": OSError,
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
    "MemoryError": MemoryError,
}


def arm_from_env(
    env: Optional[Dict[str, str]] = None,
    process_id: Optional[int] = None,
    injector: Optional[FaultInjector] = None,
) -> int:
    """Arm :data:`FAULTS` from a ``TEXTBLAST_FAULTS`` environment spec.

    Spec grammar (``;``-separated entries)::

        site[:after=N][:times=M][:exc=Name | :delay=MS | :hang]

    e.g. ``TEXTBLAST_FAULTS="multihost.round:after=1:times=2"`` arms an
    ``OSError`` (the default — classified retryable) on the second and third
    fires of the lockstep-round seam.  ``exc`` must name a type in the
    allowlist (OSError, TimeoutError, RuntimeError, MemoryError).

    The three kind options are mutually exclusive per entry: ``exc=Name``
    raises, ``delay=MS`` sleeps that many milliseconds then proceeds, and
    ``hang`` blocks until the stall watchdog's stage deadline or a disarm
    (``device.execute:hang`` is how the hang-chaos tests wedge one rank's
    device dispatch).  Entries with none of the three keep the historical
    raise-``OSError`` default, so exception-only specs parse identically
    to the pre-latency grammar.

    When ``TEXTBLAST_FAULTS_PROCESS`` is set and ``process_id`` is given,
    arming is skipped unless they match — how a multi-host chaos test faults
    exactly one rank of a real N-process run.  Returns the number of faults
    armed (0 when the spec is absent or gated off).
    """
    import os

    env = os.environ if env is None else env
    injector = FAULTS if injector is None else injector
    spec = env.get("TEXTBLAST_FAULTS", "").strip()
    if not spec:
        return 0
    only = env.get("TEXTBLAST_FAULTS_PROCESS", "").strip()
    if only and process_id is not None and int(only) != int(process_id):
        return 0
    armed = 0
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        site, after_calls, times = parts[0], 0, 1
        exc_name: Optional[str] = None
        delay_ms: Optional[float] = None
        hang = False
        for p in parts[1:]:
            key, _, val = p.partition("=")
            if key == "after":
                after_calls = int(val)
            elif key == "times":
                times = int(val)
            elif key == "exc":
                exc_name = val
            elif key == "delay":
                delay_ms = float(val)
                if delay_ms <= 0:
                    raise ValueError(
                        f"TEXTBLAST_FAULTS delay must be > 0 ms in {entry!r}"
                    )
            elif key == "hang":
                if val not in ("", "1", "true"):
                    raise ValueError(
                        f"TEXTBLAST_FAULTS hang takes no value in {entry!r}"
                    )
                hang = True
            else:
                raise ValueError(
                    f"unknown TEXTBLAST_FAULTS option {key!r} in {entry!r}"
                )
        if (exc_name is not None) + (delay_ms is not None) + hang > 1:
            raise ValueError(
                f"TEXTBLAST_FAULTS entry mixes fault kinds "
                f"(exc/delay/hang are mutually exclusive) in {entry!r}"
            )
        if delay_ms is not None:
            injector.inject(
                site,
                after_calls=after_calls,
                times=times,
                kind="delay",
                delay_ms=delay_ms,
            )
        elif hang:
            injector.inject(
                site, after_calls=after_calls, times=times, kind="hang"
            )
        else:
            try:
                exc_type = _ENV_EXC_TYPES[exc_name or "OSError"]
            except KeyError:
                raise ValueError(
                    f"TEXTBLAST_FAULTS exc must be one of "
                    f"{sorted(_ENV_EXC_TYPES)}, got {exc_name!r}"
                ) from None
            injector.inject(
                site,
                lambda site=site, exc_type=exc_type: exc_type(
                    f"injected fault at {site} (TEXTBLAST_FAULTS)"
                ),
                after_calls=after_calls,
                times=times,
            )
        armed += 1
    return armed
