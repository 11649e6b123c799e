"""Bounded producer/consumer plumbing for the overlapped host pipeline.

Copy of the JAX package's ``utils/overlap.py`` with its queue-depth gauges
(``queue_depth_read``, ``queue_depth_write``) and its trace counter
(``queue_depth_write``).

The device path's host work is three independent stages — read Parquet,
pack batches, write outcomes — each of which spends most of its time in
GIL-releasing C code (pyarrow decode, ``str.encode``/numpy scatter, pyarrow
write).  Running them on their own threads behind small bounded queues
overlaps them with device compute without changing a single outcome: the
queues are strict FIFO, so ordering is identical to the serial path and
only wall time moves.

Three primitives live here:

``prefetch_iter``
    Wrap any iterator so a daemon thread runs it ahead of the consumer,
    buffering up to ``depth`` blocks of ``block`` items in a bounded queue.
    Exceptions raised by the source re-raise at the consumer's ``next()``
    in order, and abandoning the iterator (``close()`` / GC) stops the
    thread promptly.

``ThreadedWriter``
    Wrap a ParquetWriter-shaped object so ``write_batch`` enqueues and a
    single worker thread performs the actual writes in FIFO order.  The
    first write error is re-raised to the caller at the next call (or at
    ``close()``), preserving the serial path's error semantics; ``close()``
    drains the queue, joins the thread and closes the inner writer (also
    after a write error surfaced, so no thread or file handle outlives it).

Both queue seams (reader prefetch ``get``, write-behind ``put``, and the
writer's teardown) are supervised by the stall watchdog when it is armed;
disabled (the default) each seam pays a single ``WATCHDOG.enabled``
attribute check.

``shared_pack_pool``
    The process-wide pack-worker ``ThreadPoolExecutor``.  Packing releases
    the GIL (str.encode + numpy scatter), so one pool serves every
    ``CompiledPipeline``'s per-phase packer instead of a private executor
    per pipeline instance.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator, List, Optional

from ..resilience.watchdog import WATCHDOG
from .metrics import METRICS
from .trace import TRACER

__all__ = ["prefetch_iter", "ThreadedWriter", "shared_pack_pool"]

#: Queue sentinel: the producer finished cleanly.
_DONE = object()


class _PrefetchIterator:
    def __init__(self, source: Iterable, depth: int, block: int) -> None:
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._block: List[Any] = []
        self._pos = 0
        self._done = False
        self._thread = threading.Thread(
            target=self._produce,
            args=(iter(source), block),
            name="textblast-prefetch",
            daemon=True,
        )
        self._thread.start()

    def _produce(self, source: Iterator, block: int) -> None:
        try:
            buf: List[Any] = []
            for item in source:
                buf.append(item)
                if len(buf) >= block:
                    if not self._put(buf):
                        return
                    buf = []
            if buf:
                if not self._put(buf):
                    return
            self._put(_DONE)
        except BaseException as e:  # re-raised at the consumer's next()
            self._put(e)

    def _put(self, item: Any) -> bool:
        # Bounded put that gives up when the consumer abandoned us, so an
        # early break/close never leaves a thread blocked forever.
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> "_PrefetchIterator":
        return self

    def __next__(self) -> Any:
        while True:
            if self._pos < len(self._block):
                item = self._block[self._pos]
                self._pos += 1
                return item
            if self._done:
                raise StopIteration
            if WATCHDOG.enabled:
                got = WATCHDOG.queue_get("read_prefetch", self._queue)
            else:
                got = self._queue.get()
            # Per-block (never per-item).
            METRICS.set("queue_depth_read", self._queue.qsize())
            if got is _DONE:
                self._done = True
                raise StopIteration
            if isinstance(got, BaseException):
                self._done = True
                raise got
            self._block = got
            self._pos = 0

    def qsize(self) -> int:
        """Blocks buffered ahead of the consumer (approximate, like
        ``queue.Queue.qsize``)."""
        return self._queue.qsize()

    def close(self) -> None:
        self._stop.set()
        # Drain so a blocked put wakes immediately.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __del__(self) -> None:  # best effort; close() is the real path
        self._stop.set()


def prefetch_iter(source: Iterable, depth: int = 4, block: int = 256):
    """Run ``source`` on a background thread, ``depth`` blocks ahead.

    Items are forwarded in order; source exceptions re-raise at the
    consumer's ``next()`` at the position they occurred.  ``block`` items
    are handed over per queue op to keep synchronization off the per-item
    hot path.
    """
    return _PrefetchIterator(source, depth=depth, block=block)


#: Process-wide pack pools, keyed by worker count (executors cannot grow,
#: so distinct ``pack_workers`` settings get distinct pools; in practice a
#: process uses one setting and therefore one pool).
_PACK_POOLS: Dict[int, Any] = {}
_PACK_POOLS_LOCK = threading.Lock()


def shared_pack_pool(workers: int = 2):
    """The process-wide pack-worker pool for ``workers`` threads.

    Reused across every call site — pack work is short-lived and
    GIL-releasing, so sharing one executor avoids a thread-pool per
    ``CompiledPipeline`` while keeping submission order = completion
    consumption order for any caller that resolves its own futures FIFO.
    Never shut down explicitly: workers are idle between submissions and
    the interpreter joins them at exit.
    """
    from concurrent.futures import ThreadPoolExecutor

    w = max(1, int(workers))
    with _PACK_POOLS_LOCK:
        pool = _PACK_POOLS.get(w)
        if pool is None:
            pool = ThreadPoolExecutor(
                max_workers=w, thread_name_prefix="textblast-pack"
            )
            _PACK_POOLS[w] = pool
        return pool


class ThreadedWriter:
    """FIFO write-behind wrapper around a ParquetWriter-shaped object.

    Only ``write_batch(list)`` and ``close()`` are offloaded/ordered; any
    other attribute proxies to the inner writer.  The batch list is copied
    on enqueue, so callers may reuse/clear their buffer (orchestration.py
    does ``batch.clear()`` style reuse).
    """

    def __init__(self, inner: Any, max_queue: int = 8) -> None:
        self._inner = inner
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, max_queue))
        self._error: Optional[BaseException] = None
        # Set by the drain thread at the first write error: later batches
        # are dropped, also after the caller has taken the error.
        self._failed = False
        self._closed = False
        self._thread = threading.Thread(
            target=self._drain, name="textblast-writer", daemon=True
        )
        self._thread.start()

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is _DONE:
                    return
                if not self._failed:
                    try:
                        self._inner.write_batch(item)
                    except BaseException as e:
                        self._error = e
                        self._failed = True
            finally:
                self._queue.task_done()
                METRICS.set("queue_depth_write", self._queue.qsize())
                TRACER.counter("queue_depth_write", self._queue.qsize())

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            self._closed = True
            raise err

    def write_batch(self, outcomes: List[Any]) -> None:
        if self._closed:
            raise RuntimeError("ThreadedWriter is closed")
        self._raise_pending()
        if WATCHDOG.enabled:
            WATCHDOG.queue_put("write_queue", self._queue, list(outcomes))
        else:
            self._queue.put(list(outcomes))
        METRICS.set("queue_depth_write", self._queue.qsize())
        TRACER.counter("queue_depth_write", self._queue.qsize())

    def close(self) -> None:
        # Also after a write error closed the wrapper: the drain thread is
        # stopped and the inner writer closed exactly once either way.
        if self._thread is None:
            return
        self._closed = True
        # The drain thread consumes until the sentinel, so this put and the
        # join both end once the queued writes have run.  Armed, a drain
        # that stops making progress raises StallError instead (the thread
        # and the inner writer are left to it).
        if WATCHDOG.enabled:
            WATCHDOG.queue_put("write_queue", self._queue, _DONE)
            WATCHDOG.join_thread("write_queue", self._thread, self._queue.qsize)
        else:
            self._queue.put(_DONE)
            self._thread.join()
        self._thread = None
        try:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
        finally:
            self._inner.close()

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)
