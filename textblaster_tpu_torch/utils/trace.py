"""Dependency-free span tracer emitting Chrome trace-event JSON.

The port's copy of the JAX package's ``utils/trace.py``: the same
``Tracer`` (spans, instants, counters, the bounded ring and its spill, the
clock alignment), with the same event names and fields, so a trace of
either package loads the same way in Perfetto (https://ui.perfetto.dev) or
chrome://tracing:

* ``"X"`` complete events — one per span, with microsecond ``ts``/``dur``;
* ``"i"`` instant events — resilience transitions (retry, breaker
  trip/probe/recovery, ladder split/host, watchdog stalls);
* ``"C"`` counter events — queue depths, so Perfetto draws them as tracks;
* ``"M"`` metadata events — process/thread names, so each overlap thread
  (textblast-prefetch / textblast-pack-N / textblast-dispatch /
  textblast-writer / MainThread) gets its own labeled lane.

Design constraints, in order:

1. **Near-zero cost when off.**  Tracing is opt-in (``--trace out.json``).
   Disabled, ``TRACER.span()`` is one attribute check returning a shared
   no-op context manager — no allocation, no lock.  All span sites are
   per-batch (never per-document).
2. **Bounded memory.**  Events accumulate in a ring buffer; with a file
   configured the buffer spills to disk whenever it fills.  Without a file
   (in-memory mode, used by tests) the ring drops the oldest events once
   full, and counts them (``trace_events_dropped_total``).
3. **Thread safety.**  One lock guards the ring; spans capture their
   timestamps outside it.
4. **Crash tolerance.**  The file is spilled incrementally as a JSON array;
   Perfetto's importer tolerates a truncated array, and ``close()`` writes
   the terminator.

Where the JAX package bridges to ``jax.profiler.trace``, the port builds
its device timeline from CUDA events, with no profiler:

* :class:`DeviceClock` maps CUDA event times onto this trace's clock with
  an anchor event, recorded where its stream is idle and read against
  :meth:`Tracer.now_us` at the same moment, and re-anchored after every
  batch, after the synchronize the batch already makes (it reports the
  drift each re-anchor corrects); a batch's events map between the
  anchors before and after it (:meth:`DeviceClock.bracketed`).
* ``run_batch`` (``ops/pipeline.py``) turns the two timing events that
  already bracket each batch into one ``device_batch`` span on a
  ``device`` track (:meth:`Tracer.device_span`), after the batch's own
  ``end.synchronize()``.
* :data:`KERNEL_SPANS` (``--trace-device LOGDIR``, through
  :func:`device_profile`) brackets every kernel launch with a pair of
  pooled timing events, resolves them at the batch's end and writes a
  Chrome trace of per-kernel spans into ``LOGDIR``.  Off, a launch site
  pays one attribute check.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "DEVICE_TRACE_FILE",
    "DeviceClock",
    "KERNEL_SPANS",
    "KernelSpans",
    "TRACER",
    "Tracer",
    "device_profile",
]


class _NullSpan:
    """Shared no-op context manager returned by every call while tracing
    is disabled — the entire off-cost of a span site."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add_args(self, args) -> None:
        """No-op counterpart of :meth:`_Span.add_args`."""


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def add_args(self, args: Dict[str, Any]) -> None:
        """Merge args discovered mid-span (e.g. the profiler's achieved
        bytes/s, known only once the device wait resolves) into the event
        emitted at exit.  Copies — the entry dict may be caller-shared."""
        if self._args is None:
            self._args = dict(args)
        else:
            self._args = {**self._args, **args}

    def __exit__(self, *exc):
        self._tracer._complete(self._name, self._t0, time.perf_counter(), self._args)
        return False


class Tracer:
    """Thread-safe Chrome trace-event recorder (see module docstring)."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._ring: List[Dict[str, Any]] = []
        self._ring_cap = 65536
        self._dropped = 0
        self._warned_drop = False
        self._path: Optional[str] = None
        self._fh = None
        self._wrote_any = False
        self._t0 = 0.0
        self._offset_us = 0  # cross-host clock alignment (align())
        self._pid = 0
        self._process_name = "textblast"
        self._tids: Dict[Any, int] = {}  # thread ident / track -> compact tid

    # --- lifecycle ----------------------------------------------------------

    def configure(
        self,
        path: Optional[str] = None,
        *,
        ring: int = 65536,
        process_name: str = "textblast",
        pid: int = 0,
    ) -> None:
        """Enable tracing.  ``path=None`` keeps events in the bounded ring
        (test mode); otherwise the ring spills to ``path`` incrementally.
        ``pid`` labels the Perfetto process lane — multihost runs pass the
        process index so per-host traces can be concatenated."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            self._ring = []
            self._ring_cap = max(16, int(ring))
            self._dropped = 0
            self._warned_drop = False
            self._tids = {}
            self._path = path
            self._fh = None
            self._wrote_any = False
            self._t0 = time.perf_counter()
            self._offset_us = 0
            self._pid = int(pid)
            self._process_name = process_name
            if path is not None:
                parent = os.path.dirname(os.path.abspath(path))
                os.makedirs(parent, exist_ok=True)
                self._fh = open(path, "w", encoding="utf-8")
                self._fh.write("[\n")
            self.enabled = True
        self._emit(
            {
                "name": "process_name",
                "ph": "M",
                "pid": self._pid,
                "tid": 0,
                "args": {"name": process_name},
            }
        )

    def close(self) -> None:
        """Flush the ring, terminate the JSON array, and disable tracing."""
        with self._lock:
            if not self.enabled:
                return
            self.enabled = False
            if self._fh is not None:
                self._spill_locked()
                if self._fh is not None:  # spill failure closes the file
                    try:
                        self._fh.write("\n]\n")
                        self._fh.close()
                    except OSError as e:
                        logger.warning(
                            "Trace close on %s failed: %s", self._path, e
                        )
                    self._fh = None
            if self._dropped:
                logger.warning(
                    "Trace ring overflowed in-memory mode: %d events dropped",
                    self._dropped,
                )

    def drain(self) -> List[Dict[str, Any]]:
        """Return and clear the in-memory events (test hook)."""
        with self._lock:
            out, self._ring = self._ring, []
            return out

    # --- cross-host clock alignment -----------------------------------------

    def wall_at_origin_us(self) -> int:
        """This trace's time origin (``ts`` 0) as wall-clock microseconds.

        ``ts`` values are ``perf_counter`` deltas from ``configure()``; to
        put several hosts' traces on one Perfetto timeline, each host maps
        its origin onto the shared wall clock and shifts by the difference
        (:meth:`align`)."""
        return int((time.time() - (time.perf_counter() - self._t0)) * 1e6)

    def align(self, offset_us: int, args: Optional[Dict[str, Any]] = None) -> None:
        """Shift every *subsequent* event's ``ts`` by ``offset_us`` and
        record a ``trace_clock_offset`` metadata event documenting it.

        Multihost runs call this once after the startup clock handshake
        (``parallel/multihost.py _align_trace_clocks``): host ``i``'s offset
        is its origin's wall-clock distance from the earliest host's origin,
        so concatenated per-host traces share one timeline instead of each
        starting at ``ts`` 0.  Events emitted before the handshake (tracer
        setup, config loading) keep their unshifted, near-zero timestamps.
        """
        if not self.enabled:
            return
        self._offset_us = int(offset_us)
        self._emit(
            {
                "name": "trace_clock_offset",
                "ph": "M",
                "pid": self._pid,
                "tid": 0,
                "args": {"offset_us": int(offset_us), **(args or {})},
            }
        )

    # --- recording ----------------------------------------------------------

    def span(self, name: str, args: Optional[Dict[str, Any]] = None):
        """Context manager recording one ``"X"`` complete event on the
        current thread's lane."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, args: Optional[Dict[str, Any]] = None) -> None:
        """Record a zero-duration ``"i"`` event (resilience transitions)."""
        if not self.enabled:
            return
        self._emit(
            {
                "name": name,
                "ph": "i",
                "s": "t",
                "ts": self._now_us(),
                "pid": self._pid,
                "tid": self._tid(),
                **({"args": args} if args else {}),
            }
        )

    def counter(self, name: str, value: float) -> None:
        """Record a ``"C"`` counter sample (Perfetto draws a track)."""
        if not self.enabled:
            return
        self._emit(
            {
                "name": name,
                "ph": "C",
                "ts": self._now_us(),
                "pid": self._pid,
                "tid": 0,
                "args": {"value": value},
            }
        )

    def device_span(
        self,
        name: str,
        ts_us: float,
        dur_us: float,
        args: Optional[Dict[str, Any]] = None,
        track: str = "device",
    ) -> None:
        """Record an ``"X"`` event timed on the device (``ts_us`` already on
        this trace's clock, see :class:`DeviceClock`) on the lane named
        ``track``, which the first such event labels."""
        if not self.enabled:
            return
        self._emit(
            {
                "name": name,
                "ph": "X",
                "ts": round(ts_us, 3),
                "dur": round(max(0.0, dur_us), 3),
                "pid": self._pid,
                "tid": self._track_tid(track),
                **({"args": args} if args else {}),
            }
        )

    def now_us(self) -> int:
        """Current time in microseconds on this trace's clock.

        With tracing configured, the value is a ``perf_counter`` delta from
        ``configure()`` shifted by the multihost :meth:`align` offset — the
        same clock every span and instant is stamped with, so consumers
        (the event journal) interleave correctly with the trace.  With
        tracing off, ``_t0`` is 0 and the value degrades to raw
        ``perf_counter`` microseconds: still monotone within the process,
        just not cross-host aligned."""
        return self._now_us()

    # --- internals ----------------------------------------------------------

    def _now_us(self) -> int:
        return int((time.perf_counter() - self._t0) * 1e6) + self._offset_us

    def _tid(self) -> int:
        """Compact per-thread lane id; first sight emits the thread_name
        metadata event so Perfetto labels the lane."""
        t = threading.current_thread()
        tid = self._tids.get(t.ident)
        if tid is None:
            with self._lock:
                tid = self._tids.get(t.ident)
                if tid is None:
                    tid = len(self._tids) + 1
                    self._tids[t.ident] = tid
                    self._append_locked(
                        {
                            "name": "thread_name",
                            "ph": "M",
                            "pid": self._pid,
                            "tid": tid,
                            "args": {"name": t.name},
                        }
                    )
        return tid

    def _track_tid(self, track: str) -> int:
        """The lane id of a named track that no thread owns (the device),
        labelled by a ``thread_name`` metadata event on first sight."""
        key = ("track", track)
        tid = self._tids.get(key)
        if tid is None:
            with self._lock:
                tid = self._tids.get(key)
                if tid is None:
                    tid = len(self._tids) + 1
                    self._tids[key] = tid
                    self._append_locked(
                        {
                            "name": "thread_name",
                            "ph": "M",
                            "pid": self._pid,
                            "tid": tid,
                            "args": {"name": track},
                        }
                    )
        return tid

    def _complete(
        self, name: str, t0: float, t1: float, args: Optional[Dict[str, Any]]
    ) -> None:
        if not self.enabled:  # closed while the span was open
            return
        self._emit(
            {
                "name": name,
                "ph": "X",
                "ts": int((t0 - self._t0) * 1e6) + self._offset_us,
                "dur": max(0, int((t1 - t0) * 1e6)),
                "pid": self._pid,
                "tid": self._tid(),
                **({"args": args} if args else {}),
            }
        )

    def _emit(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._append_locked(event)

    def _append_locked(self, event: Dict[str, Any]) -> None:
        self._ring.append(event)
        if len(self._ring) >= self._ring_cap:
            if self._fh is not None:
                self._spill_locked()
            else:
                # In-memory mode: drop the oldest half, keep counting.
                drop = len(self._ring) // 2
                self._count_dropped_locked(drop)
                del self._ring[:drop]

    def _count_dropped_locked(self, n: int) -> None:
        """Account ``n`` dropped events: local counter, the
        ``trace_events_dropped_total`` metric, and a one-line stderr
        warning on the first drop (drops used to be silent — an unwritable
        spill path lost the whole ring with no sign anywhere)."""
        self._dropped += n
        first = not self._warned_drop
        self._warned_drop = True
        # Lazy import: metrics.py and trace.py are both leaf modules; the
        # one edge lives inside this rarely-hit path to keep it that way.
        from .metrics import METRICS

        METRICS.inc("trace_events_dropped_total", n)
        if first:
            print(
                f"textblast: trace events dropped ({n} so far) — ring "
                "overflow or unwritable spill file; trace will be "
                "incomplete",
                file=sys.stderr,
            )

    def _spill_locked(self) -> None:
        if not self._ring:
            return
        chunks = []
        for ev in self._ring:
            if self._wrote_any:
                chunks.append(",\n")
            self._wrote_any = True
            chunks.append(json.dumps(ev, separators=(",", ":")))
        try:
            self._fh.write("".join(chunks))
            self._fh.flush()
        except OSError as e:
            # Disk full / revoked path: count every event we just lost,
            # warn once, and stop spilling (the ring keeps the newest
            # events in memory so close() still has something to report).
            self._count_dropped_locked(len(self._ring))
            logger.warning("Trace spill to %s failed: %s", self._path, e)
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        self._ring = []


#: Process-wide tracer.  Import this, never construct your own — span
#: sites across the codebase all talk to the same instance.
TRACER = Tracer()




# --- the device timeline, from CUDA events ---------------------------------------

#: The Chrome trace that ``--trace-device LOGDIR`` writes into ``LOGDIR``.
DEVICE_TRACE_FILE = "device_trace.json"


#: An anchor's record is made again (at most ``_ANCHOR_TRIES`` times) when
#: more than ``_ANCHOR_READ_US`` passed between the clock read and the end
#: of the enqueue (a thread descheduled in between).
_ANCHOR_TRIES = 3
_ANCHOR_READ_US = 20


class DeviceClock:
    """Maps CUDA event times on one device onto :data:`TRACER`'s clock.

    The anchor is a timing event recorded on a stream with nothing queued
    ahead of it, so the device reaches it as it is recorded, and
    :meth:`Tracer.now_us` read just before the record: a later event's
    trace time is ``anchor_us + anchor.elapsed_time(event) * 1000``.  The
    device cannot reach the anchor before the host records it, so the
    mapping errs early by the record's latency (a few microseconds).  The
    device's timer and the host's ``perf_counter`` drift apart (by tens
    of microseconds between two anchors a batch apart on an H100 host), so
    after each batch's own synchronize (its stream is idle then)
    :meth:`settle` records a new anchor (one event and a clock read); the
    next settle that finds it complete takes it over.  What the old anchor
    predicts for the new one, minus the host's reading, is the drift that
    re-anchor corrects: :attr:`drift_us` is the largest,
    :attr:`total_drift_us` the first anchor's error at the latest
    re-anchor, :attr:`span_s` seconds after it.  An event mapped from the
    anchor before it alone can map late by the drift since; a batch's
    events are mapped by :meth:`bracketed`, between the anchors before and
    after the batch, which errs early only.  Only :meth:`bracketed` waits,
    for an anchor on an idle stream; otherwise an anchor is resolved once
    ``query()`` says the device passed it.
    """

    def __init__(self) -> None:
        self._origin = TRACER._t0
        self._lock = threading.Lock()
        self._anchor = None
        self._anchor_us = 0.0
        self._first = None
        self._first_us = 0.0
        self._pending = None
        self.reanchors = 0
        self.drift_us = 0.0
        self.total_drift_us = 0.0
        self.span_s = 0.0

    def current(self) -> bool:
        """False once :data:`TRACER` was configured anew (its clock has
        another origin, so this clock's anchors no longer map onto it)."""
        return self._origin == TRACER._t0

    def anchor(self, stream) -> None:
        """Record an anchor on ``stream``, which must have nothing queued
        (a synchronize of it just returned, or it is new)."""
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        # The first record creates the CUDA event (tens of microseconds);
        # the second, read against the clock, only enqueues.  A thread
        # descheduled between the read and the enqueue would make the
        # anchor err early by that pause: such a record is made again.
        ev.record(stream)
        for _ in range(_ANCHOR_TRIES):
            us = float(TRACER.now_us())
            ev.record(stream)
            if TRACER.now_us() - us <= _ANCHOR_READ_US:
                break
        with self._lock:
            if self._anchor is None:
                self._anchor = self._first = ev
                self._anchor_us = self._first_us = us
            else:
                self._pending = (ev, us)

    def settle(self, stream) -> None:
        """Call after a synchronize that left ``stream`` idle: take over a
        re-anchor the device has passed, and record the next one."""
        with self._lock:
            pending = self._pending
            if pending is not None and pending[0].query():
                ev, us = pending
                self._pending = None
                drift = self._anchor_us + self._anchor.elapsed_time(ev) * 1000.0 - us
                self.total_drift_us = (
                    self._first_us + self._first.elapsed_time(ev) * 1000.0 - us
                )
                self.drift_us = max(self.drift_us, abs(drift))
                self.span_s = (us - self._first_us) / 1e6
                self.reanchors += 1
                self._anchor, self._anchor_us = ev, us
            due = self._pending is None
        if due:
            self.anchor(stream)

    def to_us(self, event) -> float:
        """``event``'s time on the trace clock (the event has completed)."""
        return self._anchor_us + self._anchor.elapsed_time(event) * 1000.0

    def bracketed(self):
        """The mapping for a batch that just finished, after its
        :meth:`settle`: between the anchor in use (recorded before the
        batch) and the one ``settle`` recorded after it, device time is
        scaled to the host clock's, so whatever the device timer drifted
        against ``perf_counter`` over the batch cancels, and an event maps
        early by the anchors' record latency, never late.  It waits for
        the new anchor, which went on an idle stream (microseconds).
        Without a new anchor, this clock."""
        with self._lock:
            a, a_us, pending = self._anchor, self._anchor_us, self._pending
        if pending is None:
            return self
        b, b_us = pending
        b.synchronize()
        dev_us = a.elapsed_time(b) * 1000.0
        return _Bracket(a, a_us, (b_us - a_us) / dev_us if dev_us > 0 else 1.0)

    def stats(self) -> Dict[str, float]:
        return {
            "reanchors": self.reanchors,
            "max_drift_us": round(self.drift_us, 3),
            "total_drift_us": round(self.total_drift_us, 3),
            "total_drift_span_s": round(self.span_s, 3),
        }


class _Bracket:
    """:meth:`DeviceClock.bracketed`'s mapping: ``anchor_us`` plus device
    time since ``anchor``, scaled by ``rate``."""

    __slots__ = ("anchor", "anchor_us", "rate")

    def __init__(self, anchor, anchor_us: float, rate: float) -> None:
        self.anchor, self.anchor_us, self.rate = anchor, anchor_us, rate

    def to_us(self, event) -> float:
        return self.anchor_us + self.anchor.elapsed_time(event) * 1000.0 * self.rate


class KernelSpans:
    """Per-kernel device spans (``--trace-device``): each kernel wrapper
    brackets its launch with two timing events from a pool
    (:meth:`begin` before the launch, :meth:`end` where it counts the
    launch), and the batch that launched them resolves them after its own
    synchronize (:meth:`resolve`).  The spans, named by kernel and by the
    variant key of the wrapper's ``SHAPE_LAUNCHES``, and one span a batch
    go into a Chrome trace, :data:`DEVICE_TRACE_FILE` in the log directory,
    at :meth:`close`.  Recording or resolving an event that fails raises."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._tls = threading.local()
        # Idle events as (device, event): an event records on the device
        # it was made on only.
        self._pool: List[Tuple[str, Any]] = []
        self._events: List[Dict[str, Any]] = []
        self._dir: Optional[str] = None

    def configure(self, log_dir: str) -> None:
        """Arm: spans from now on go to ``log_dir``/:data:`DEVICE_TRACE_FILE`."""
        os.makedirs(log_dir, exist_ok=True)
        with self._lock:
            self._dir = log_dir
            self._events = [
                {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": "textblast-device"}},
                {"name": "thread_name", "ph": "M", "pid": 0, "tid": 1,
                 "args": {"name": "batches"}},
                {"name": "thread_name", "ph": "M", "pid": 0, "tid": 2,
                 "args": {"name": "kernels"}},
            ]
            self._tls = threading.local()
            self.enabled = True

    def _pending(self) -> list:
        pending = getattr(self._tls, "pending", None)
        if pending is None:
            pending = self._tls.pending = []
        return pending

    def _take(self, device: str):
        with self._lock:
            for i in range(len(self._pool) - 1, -1, -1):
                if self._pool[i][0] == device:
                    return self._pool.pop(i)[1]
        import torch

        return torch.cuda.Event(enable_timing=True)

    def begin(self, device):
        """The start event of a launch, recorded on ``device``'s current
        stream (the stream the launch goes to)."""
        import torch

        ev = self._take(str(device))
        ev.record(torch.cuda.current_stream(device))
        return ev

    def end(self, start, device, kernel: str, key: tuple) -> None:
        """Record the launch's end event and keep the pair for the batch."""
        import torch

        ev = self._take(str(device))
        ev.record(torch.cuda.current_stream(device))
        self._pending().append((start, ev, kernel, key, str(device)))

    def take_pending(self) -> list:
        """The launches this thread made since the last batch, taken out of
        its list: a mesh batch resolves each shard's launches with its own
        device's clock (:meth:`resolve`'s ``pending``)."""
        pending = self._pending()
        out = list(pending)
        pending.clear()
        return out

    def resolve(self, clock, start, end, args: Dict[str, Any], pending=None) -> None:
        """After the batch's own synchronize: one span for the batch
        (``start`` to ``end``) and one for each launch this thread made
        since the last batch (or for each of ``pending``, from
        :meth:`take_pending`), its events handed back to the pool;
        ``clock`` maps events onto the trace clock (a :class:`DeviceClock`
        or its :meth:`~DeviceClock.bracketed` mapping)."""
        if pending is None:
            pending = self._pending()
        ts = clock.to_us(start)
        events = [{"name": "device_batch", "ph": "X", "ts": round(ts, 3),
                   "dur": round(clock.to_us(end) - ts, 3), "pid": 0, "tid": 1,
                   "args": args}]
        for k_start, k_end, kernel, key, _ in pending:
            k_ts = clock.to_us(k_start)
            events.append({
                "name": f"{kernel}[{','.join(str(v) for v in key[1:])}]",
                "ph": "X", "ts": round(k_ts, 3),
                "dur": round(clock.to_us(k_end) - k_ts, 3), "pid": 0, "tid": 2,
                "args": {"kernel": kernel, "variant": list(key), "batch": args.get("batch")},
            })
        with self._lock:
            self._events.extend(events)
            self._pool.extend((p[4], ev) for p in pending for ev in p[:2])
        pending.clear()

    def close(self) -> Optional[str]:
        """Write the trace and disarm; returns its path (None when off)."""
        with self._lock:
            if not self.enabled:
                return None
            self.enabled = False
            events, self._events = self._events, []
            self._pool = []
        unresolved = len(self._pending())
        if unresolved:
            logger.warning(
                "Device trace: %d kernel launches outside a batch have no span",
                unresolved,
            )
            self._pending().clear()
        path = os.path.join(self._dir, DEVICE_TRACE_FILE)
        with open(path, "w", encoding="utf-8") as f:
            f.write("[\n")
            f.write(",\n".join(json.dumps(ev, separators=(",", ":")) for ev in events))
            f.write("\n]\n")
        return path


#: Process-wide kernel span recorder; the kernel wrappers check
#: ``KERNEL_SPANS.enabled`` once a launch.
KERNEL_SPANS = KernelSpans()


@contextmanager
def device_profile(log_dir: Optional[str], device: str = "cuda"):
    """``--trace-device LOGDIR``: per-kernel and per-batch device spans from
    CUDA events, written to ``LOGDIR``/:data:`DEVICE_TRACE_FILE` when the
    block ends.  ``log_dir=None`` is a no-op.  On a device with no CUDA
    events (``--device cpu``) the trace holds no device spans, and one
    warning says so, as the JAX package warns on a backend with no
    profiler."""
    if not log_dir:
        yield
        return
    KERNEL_SPANS.configure(log_dir)
    if device != "cuda":
        logger.warning(
            "--trace-device on %s: no CUDA events, so %s holds no device spans",
            device, os.path.join(log_dir, DEVICE_TRACE_FILE),
        )
    try:
        yield
    finally:
        KERNEL_SPANS.close()
