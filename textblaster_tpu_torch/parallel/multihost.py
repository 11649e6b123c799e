"""Multi-host execution: a gang of processes, each running its own row stripe.

The port's counterpart of ``textblaster_tpu/parallel/multihost.py``, with
its names, over ``torch.distributed`` instead of ``jax.distributed``.
``textblast-torch run --coordinator HOST:PORT --num-processes N
--process-id i`` runs on every rank (:func:`run_multihost`):

* every rank joins one ``torch.distributed.TCPStore`` hosted by rank 0 and
  one ``gloo`` process group (:func:`initialize`);
* every exchange is a small int64 vector a rank posted under a key of the
  store and read back by every peer (:func:`host_allgather`), bounded by
  the exchange deadline: a peer that never posts, or whose store
  connection is lost, raises a typed :exc:`PeerFailure` naming it;
* each rank reads its contiguous row stripe of the input and runs it
  through the port's own device path on its GPU(s) (the runner's windowed
  path: reader thread, pack pool, dispatch thread, writer threads, host
  tails and the ladder; a mesh of every GPU the process sees when no
  device is named), writing a ``<final>.shard<i>`` pair (and a dead-letter
  shard with ``errors_file``);
* after the totals barrier, rank 0 merges the shards into the final files
  atomically (:func:`merge_shard_files`).

So a rank's shard is, by construction, what a single-process run over its
stripe writes, in that order; the merged files are the shards in rank
order.

The exchanges ride the store on every device, the route the JAX transport
takes for a multi-process CPU job: the port has no cross-process device
collective, and the gang needs none (every program is collective-free;
rows never cross ranks).  ``gloo`` is the process group's backend because
the exchanges are small host vectors and because two ranks may share one
GPU, which NCCL refuses.

Not in this slice: the negotiated per-phase rounds of the JAX package's
``run_local_shard`` (``NegotiatedGuard``, the lockstep window,
speculation), membership leases, elastic stripes and autoscale.  Until
they come, ranks meet only at the exchanges :func:`run_multihost` itself
makes: the trace clock handshake, the auto-geometry histogram, the totals
barrier and the run-report snapshots.  The options that need them raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from datetime import timedelta
from itertools import islice
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..config.pipeline import PipelineConfig
from ..errors import PeerFailure, PipelineError
from ..utils.events import EVENTS
from ..utils.metrics import METRICS
from ..utils.trace import TRACER

logger = logging.getLogger(__name__)

__all__ = [
    "DEFAULT_EXCHANGE_DEADLINE_S",
    "DEFAULT_LEASE_TTL_S",
    "ExchangeTransport",
    "KVExchangeTransport",
    "PeerFailure",
    "bump_exchange_epoch",
    "configure_exchange",
    "current_exchange_epoch",
    "detect_stale_shards",
    "host_allgather",
    "host_allgather_obj",
    "initialize",
    "merge_shard_files",
    "run_multihost",
]

#: The JAX package's defaults (``resilience/membership.py``): the budget of
#: one exchange, and the liveness-lease TTL the membership layer will use.
DEFAULT_EXCHANGE_DEADLINE_S = 300.0
DEFAULT_LEASE_TTL_S = 10.0


def detect_stale_shards(finals: Sequence[str], num_processes: int) -> List[str]:
    """``*.shard*`` siblings of ``finals`` that THIS run will not produce.

    A prior crashed run with a larger ``--num-processes`` leaves orphan
    ``<final>.shard{j}`` files (j >= num_processes) that the merge would
    silently ignore next to fresh outputs.  Returns the sorted offenders so
    callers can fail fast naming them (``--force`` removes them instead).
    Expected shards (``.shard0..shard{n-1}``) are not stale: this run
    overwrites them."""
    import glob

    expected = {f"{final}.shard{i}" for final in finals for i in range(num_processes)}
    stale = {
        path
        for final in finals
        for path in glob.glob(glob.escape(final) + ".shard*")
        if path not in expected
    }
    return sorted(stale)


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _commit_merged(final: str, shards: Sequence[str]) -> None:
    """Stream the shards' row groups into ``<final>.tmp``, then commit it
    atomically: fsync the tmp, rename over ``final``, fsync the directory,
    so a crash at any instant leaves ``final`` either absent or complete."""
    import pyarrow.parquet as pq

    tmp = final + ".tmp"
    writer = None
    try:
        for s in shards:
            pf = pq.ParquetFile(s)
            if writer is None:
                writer = pq.ParquetWriter(tmp, pf.schema_arrow)
            # Row-group streaming keeps the merge O(row-group) in memory.
            for g in range(pf.metadata.num_row_groups):
                writer.write_table(pf.read_row_group(g))
    finally:
        if writer is not None:
            writer.close()
    _fsync_path(tmp)
    os.replace(tmp, final)
    _fsync_path(os.path.dirname(os.path.abspath(final)))
    METRICS.inc("multihost_merge_commits_total")


def merge_shard_files(pairs: Sequence[Tuple[str, Sequence[str]]]) -> None:
    """Commit every ``(final, shards)`` merge atomically, THEN delete the
    shards: a kill anywhere mid-merge leaves every input shard intact."""
    for final, shards in pairs:
        _commit_merged(final, shards)
    for _final, shards in pairs:
        for s in shards:
            os.remove(s)


# --- joining ------------------------------------------------------------------


class _ExchangeState:
    """Shared round state of the exchanges: the store, the deadline, and
    keys namespaced by an exchange epoch with a sequence number that
    restarts at every epoch (so a process that re-enters at an epoch
    boundary computes its peers' key names).  Drained keys are deleted, so
    the store holds O(1) allgather keys per rank."""

    def __init__(self) -> None:
        self.deadline_s: float = DEFAULT_EXCHANGE_DEADLINE_S
        self.epoch: int = 0
        self.seq: int = 0
        # Own (epoch, seq) keys whose epoch drained but whose read-proof (a
        # peer completing a later exchange) has not landed yet.
        self.pending_delete: List[Tuple[int, int]] = []
        # ``None`` selects the store transport (:class:`KVExchangeTransport`).
        self.transport: Optional["ExchangeTransport"] = None
        # The store this process joined through (:func:`initialize`), and
        # whether :func:`initialize` made the process group.
        self.store = None
        self.owns_group = False


_EXCHANGE = _ExchangeState()

#: Timeout for the post-deadline sweep that names EVERY laggard: once the
#: budget is spent, each remaining rank gets one short probe.
_PROBE_TIMEOUT_MS = 1000


def initialize(
    coordinator: str,
    num_processes: int,
    process_id: int,
    timeout_s: float = DEFAULT_EXCHANGE_DEADLINE_S,
) -> None:
    """Join the gang (no-op if this process already joined).

    ``coordinator`` is ``host:port`` of process 0, which hosts the
    ``TCPStore``; every rank then joins one ``gloo`` process group over it.
    A rank that cannot join within ``timeout_s`` raises
    :exc:`PipelineError`."""
    if _distributed_initialized():
        return
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise PipelineError(f"--coordinator must be HOST:PORT, got {coordinator!r}")
    timeout = timedelta(seconds=timeout_s)
    try:
        store = dist.TCPStore(
            host, int(port), num_processes, is_master=process_id == 0, timeout=timeout
        )
        dist.init_process_group(
            "gloo", store=store, world_size=num_processes, rank=process_id,
            timeout=timeout,
        )
    except Exception as e:  # the store's and gloo's errors alike
        raise PipelineError(
            f"process {process_id} could not join the gang of {num_processes} at "
            f"{coordinator}: {e}"
        ) from e
    _EXCHANGE.store = store
    _EXCHANGE.owns_group = True


def _distributed_initialized() -> bool:
    """True once this process joined a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def _world() -> Tuple[int, int]:
    """(processes, this process's rank); (1, 0) outside a gang."""
    if not _distributed_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def _store():
    """The store of this process's gang: the one :func:`initialize` made, or
    the default group's when another caller joined."""
    if _EXCHANGE.store is None:
        _EXCHANGE.store = dist.distributed_c10d._get_default_store()
    return _EXCHANGE.store


def configure_exchange(
    deadline_s: Optional[float] = None,
    reset: bool = True,
    transport: Optional["ExchangeTransport"] = None,
) -> None:
    """Configure the exchange deadline and transport for this process and (by
    default) restart the epoch and sequence counters: called by
    :func:`run_multihost` on every process at run start, so the shared
    round state begins aligned."""
    if deadline_s is not None:
        _EXCHANGE.deadline_s = float(deadline_s)
    _EXCHANGE.transport = transport
    if reset:
        _EXCHANGE.epoch = 0
        _EXCHANGE.seq = 0
        _EXCHANGE.pending_delete = []


def current_exchange_epoch() -> int:
    """The epoch namespace current exchanges are keyed under."""
    return _EXCHANGE.epoch


def bump_exchange_epoch() -> int:
    """Open the next exchange epoch: the sequence restarts at 0 and the
    drained epoch's last own key is queued for deletion.  Must be called in
    lockstep on every process."""
    if _EXCHANGE.seq > 0:
        _EXCHANGE.pending_delete.append((_EXCHANGE.epoch, _EXCHANGE.seq - 1))
    _EXCHANGE.epoch += 1
    _EXCHANGE.seq = 0
    return _EXCHANGE.epoch


def _ag_key(epoch: int, seq: int, rank: int) -> str:
    return f"textblast/allgather/e{epoch}/s{seq}/{rank}"


def _validate_rows(rows: Sequence[Sequence[int]], width: int, *, seq: int, epoch: int) -> None:
    """Ragged-row guard: every peer's row must match this process's lane
    count; the offending rank is named in a typed :exc:`PeerFailure`."""
    for r, row in enumerate(rows):
        if len(row) != width:
            METRICS.inc("multihost_peer_failures_total")
            raise PeerFailure(
                f"exchange e{epoch}/s{seq}: rank {r} posted {len(row)} "
                f"lane(s) where {width} were expected — a desynchronized "
                "or corrupted peer (ragged allgather row)",
                missing_ranks=(r,),
                seq=seq,
                epoch=epoch,
            )


def _raise_peer_failure(
    missing: Sequence[int],
    *,
    seq: int,
    epoch: int,
    deadline_s: float,
    transport_error: str = "",
) -> None:
    """Deadline expired with peers unposted: raise the typed error naming
    them, with the store's own words as ``transport_error``.  (Dead against
    slow comes with the membership layer's liveness leases; until then no
    rank is named dead.)"""
    METRICS.inc("multihost_peer_failures_total")
    TRACER.instant(
        "peer_failure",
        {"seq": seq, "epoch": epoch, "missing": list(missing), "dead": []},
    )
    if EVENTS.enabled:
        EVENTS.emit("peer_failure", missing_ranks=list(missing), dead_ranks=[],
                    seq=seq, epoch=epoch)
    transport = f"; last transport error: {transport_error[:300]}" if transport_error else ""
    raise PeerFailure(
        f"exchange e{epoch}/s{seq} deadline ({deadline_s:g}s) expired; "
        f"rank(s) {list(missing)} never posted{transport}",
        missing_ranks=missing,
        seq=seq,
        epoch=epoch,
    )


class ExchangeTransport:
    """Pluggable carrier of the exchanges (:func:`host_allgather`).  The
    store transport (:class:`KVExchangeTransport`) is the one this slice
    has; the membership layer adds a file-lease one."""

    name: str = "?"

    def members(self) -> Tuple[int, ...]:
        """Current member ranks, in exchange row order."""
        raise NotImplementedError

    def allgather(self, arr: np.ndarray) -> np.ndarray:
        """Exchange one flat int64 row per member; returns
        ``[n_members, len(arr)]`` in :meth:`members` order."""
        raise NotImplementedError


class KVExchangeTransport(ExchangeTransport):
    """The store transport: each rank posts its row under
    ``_ag_key(epoch, seq, rank)`` in the gang's ``TCPStore`` and reads every
    peer's with ``wait`` then ``get``.

    The whole exchange gets :func:`configure_exchange`'s budget (default
    :data:`DEFAULT_EXCHANGE_DEADLINE_S`).  On expiry the remaining ranks are
    each probed briefly, so every laggard is named; a timeout or a lost
    store connection makes a rank missing, and a typed :exc:`PeerFailure`
    names the exchange and the missing ranks.  Rows are checked for
    raggedness (:func:`_validate_rows`).

    Hygiene: completing exchange ``s`` proves every peer has read exchange
    ``s-1`` (each peer posts ``s`` only after reading ``s-1``), so this
    process's ``s-1`` key, and any queued keys of drained epochs, are
    deleted after each completed exchange."""

    name = "kv"

    def members(self) -> Tuple[int, ...]:
        return tuple(range(_world()[0]))

    def allgather(self, arr: np.ndarray) -> np.ndarray:
        n, me = _world()
        if n == 1:
            return arr.reshape(1, -1)
        store = _store()
        epoch, seq = _EXCHANGE.epoch, _EXCHANGE.seq
        _EXCHANGE.seq += 1
        store.set(_ag_key(epoch, seq, me), ",".join(str(int(x)) for x in arr))
        deadline_s = _EXCHANGE.deadline_s
        t0 = time.monotonic()
        own_row = [int(x) for x in arr]
        rows: List[List[int]] = []
        missing: List[int] = []
        transport_error = ""
        for r in range(n):
            if r == me:
                rows.append(own_row)
                continue
            remaining_ms = int((deadline_s - (time.monotonic() - t0)) * 1000)
            timeout_ms = remaining_ms if remaining_ms > 0 else _PROBE_TIMEOUT_MS
            key = _ag_key(epoch, seq, r)
            try:
                store.wait([key], timedelta(milliseconds=timeout_ms))
                raw = store.get(key).decode("utf-8")
            except Exception as e:  # a timeout, or the store's connection lost
                missing.append(r)
                rows.append([])
                transport_error = str(e)
                continue
            rows.append([int(x) for x in raw.split(",")] if raw else [])
        if missing:
            _raise_peer_failure(
                missing, seq=seq, epoch=epoch, deadline_s=deadline_s,
                transport_error=transport_error,
            )
        _validate_rows(rows, len(own_row), seq=seq, epoch=epoch)
        drained = [_ag_key(e, s, me) for e, s in _EXCHANGE.pending_delete]
        _EXCHANGE.pending_delete.clear()
        if seq > 0:
            drained.append(_ag_key(epoch, seq - 1, me))
        for key in drained:
            try:
                store.delete_key(key)
            except Exception:  # hygiene is best-effort
                pass
        return np.asarray(rows, dtype=np.int64)


_KV_TRANSPORT = KVExchangeTransport()


def host_allgather(vec: np.ndarray) -> np.ndarray:
    """Allgather one small int vector per process; returns ``[n_proc, len]``.

    Every exchange of this module funnels through here, and from here
    through the configured :class:`ExchangeTransport`.  Callers must invoke
    it in lockstep: slots are ``(epoch, seq, rank)`` from the shared round
    state, and the blocking read doubles as the barrier — no process
    proceeds until every member has posted its row."""
    arr = np.asarray(vec, dtype=np.int64).ravel()
    transport = _EXCHANGE.transport or _KV_TRANSPORT
    # One post per process per call, whatever the vector width.
    METRICS.inc("multihost_exchange_posts_total")
    t0 = time.perf_counter()
    try:
        return transport.allgather(arr)
    finally:
        METRICS.inc("multihost_exchange_post_seconds_total", time.perf_counter() - t0)


def host_allgather_obj(obj) -> list:
    """Allgather one small JSON-serializable object per process.

    Rides :func:`host_allgather`: the object is JSON-encoded to UTF-8
    bytes, lengths are exchanged first so every process can pad its byte
    vector to the common width, then the padded vectors are exchanged and
    each row decoded back.  Two exchanges per call, in lockstep.  Sized for
    metrics snapshots (a few KiB): each byte travels as an int64 lane."""
    data = json.dumps(obj, sort_keys=True).encode("utf-8")
    lens = host_allgather(np.array([len(data)]))[:, 0]
    width = max(1, int(lens.max()))
    buf = np.zeros(width, dtype=np.int64)
    if data:
        buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    rows = host_allgather(buf)
    return [
        json.loads(bytes(rows[i, : int(lens[i])].astype(np.uint8)).decode("utf-8"))
        for i in range(rows.shape[0])
    ]


def _align_trace_clocks() -> None:
    """Cross-host trace clock handshake (one allgather at run start).

    Every process allgathers the wall-clock time of its tracer's origin;
    the minimum becomes the run's shared origin and each tracer shifts its
    timestamps by ``own_wall - min_wall`` (recorded in a
    ``trace_clock_offset`` metadata event).  The exchange is unconditional
    (a host without ``--trace`` must still take part); only the local
    ``align`` is gated on tracing."""
    wall = TRACER.wall_at_origin_us()
    walls = host_allgather(np.array([wall], dtype=np.int64))[:, 0]
    if TRACER.enabled:
        origin = int(walls.min())
        TRACER.align(
            wall - origin,
            args={"origin_wall_us": origin, "host_walls_us": [int(w) for w in walls]},
        )


def _done_key(rank: int) -> str:
    return f"textblast/done/{rank}"


def _leave_gang(num_processes: int, process_id: int) -> None:
    """Leave after the last exchange.  Rank 0 hosts the store, so it waits
    (within the exchange deadline) until every peer says it has read its
    last row before its process, and the store with it, may go; then the
    process group :func:`initialize` made is destroyed."""
    store = _EXCHANGE.store
    if store is not None and num_processes > 1:
        store.set(_done_key(process_id), "1")
        if process_id == 0:
            try:
                store.wait([_done_key(r) for r in range(num_processes)],
                           timedelta(seconds=_EXCHANGE.deadline_s))
            except Exception as e:  # the run is committed; say so, and go
                logger.warning("not every peer left the gang in time: %s", e)
    _shutdown()


def _shutdown() -> None:
    """Destroy the process group :func:`initialize` made and drop the store
    (rank 0's drop stops the store's server)."""
    if _EXCHANGE.owns_group and _distributed_initialized():
        dist.destroy_process_group()
    _EXCHANGE.owns_group = False
    _EXCHANGE.store = None


def _abandon_distributed() -> None:
    """Tear the gang down without any barrier: after a :exc:`PeerFailure`,
    or any failure of this rank, the gang is broken, so nothing may wait
    on a peer.  Peers still reading rank 0's store see its connection go
    and fail in turn."""
    try:
        _shutdown()
    except Exception as e:
        logger.warning("could not tear the process group down: %s", e)
        _EXCHANGE.store = None


# --- the run ------------------------------------------------------------------


def _stripe(n_rows: int, num_processes: int, process_id: int) -> Tuple[int, int]:
    """(skip, take) of rank ``process_id``'s contiguous row stripe."""
    stride = math.ceil(n_rows / max(num_processes, 1))
    skip = min(process_id * stride, n_rows)
    return skip, max(0, min(stride, n_rows - skip))


def run_multihost(
    config: PipelineConfig,
    input_file: str,
    output_file: str,
    excluded_file: str,
    *,
    coordinator: str,
    num_processes: int,
    process_id: int,
    text_column: str = "text",
    id_column: str = "id",
    buckets: Optional[Sequence[int]] = None,
    read_batch_size: int = 1024,
    device_batch: Optional[int] = None,
    auto_geometry: bool = False,
    errors_file: Optional[str] = None,
    force: bool = False,
    run_report: Optional[str] = None,
    provenance: Optional[dict] = None,
    device=None,
    quiet: bool = True,
    exchange_deadline_s: float = DEFAULT_EXCHANGE_DEADLINE_S,
    lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
    elastic: bool = False,
    exchange_transport: str = "auto",
    survive_peer_loss: bool = False,
    autoscale: Optional[str] = None,
):
    """Multi-host entry (``textblast-torch run --coordinator ...``).

    Each process reads its contiguous row stripe of ``input_file``, runs it
    through the port's device path on ``device`` (``cuda`` unless given;
    with no device, a mesh of every GPU this process sees, as a
    single-process run) and writes ``<output>.shard<i>`` /
    ``<excluded>.shard<i>`` (and ``<errors>.shard<i>`` with
    ``errors_file``).  ``buckets`` defaults to the runner's ladder, so a
    rank's shard is exactly a single-process run's output over its stripe.
    After the totals barrier, process 0 merges each shard set into its
    final file atomically (:func:`merge_shard_files`).  Stale ``*.shard*``
    leftovers of a run with more processes fail the run on every process,
    before it joins, unless ``force`` removes them.

    ``auto_geometry`` negotiates one geometry for the gang: each rank
    histograms its stripe's lengths, the histograms are allgathered and
    summed, and every rank derives the geometry from the same sum.

    ``run_report`` (on every process or on none: the snapshot exchange is
    collective) makes each process contribute its metrics-delta snapshot;
    process 0 writes the merged report with per-host snapshots.

    Returns an ``AggregationResult``: the gang's totals on process 0 (after
    the merge), this process's elsewhere.  A peer that never posts within
    ``exchange_deadline_s`` raises :exc:`PeerFailure` (the gang is torn
    down; the run is relaunched whole).  ``lease_ttl_s`` is kept for the
    membership layer; ``elastic``, ``survive_peer_loss``, ``autoscale`` and
    an exchange transport other than ``auto`` / ``kv`` raise
    ``NotImplementedError``."""
    import pyarrow.parquet as pq

    from ..ops.geometry import geometry_from_histogram, length_histogram
    from ..ops.pipeline import resolve_device
    from ..orchestration import AggregationResult, read_documents
    from ..resilience import DeadLetterSink
    from ..resilience.faults import arm_from_env
    from ..runner import _run_rows, run_mesh
    from ..utils.metrics import (
        build_run_report,
        is_merge_gauge,
        metrics_snapshot,
        snapshot_delta,
        write_run_report,
    )

    for flag, on in (("elastic", elastic), ("survive_peer_loss", survive_peer_loss),
                     ("autoscale", autoscale is not None)):
        if on:
            raise NotImplementedError(
                f"run_multihost: {flag} needs the membership layer (queue A item 1c), "
                "which the port does not have yet"
            )
    if exchange_transport not in ("auto", "kv"):
        raise NotImplementedError(
            f"run_multihost: exchange transport {exchange_transport!r} needs the "
            "negotiated rounds and membership layers (queue A items 1b, 1c); "
            "this slice has the store transport ('kv') only"
        )

    finals = [output_file, excluded_file]
    if errors_file is not None:
        finals.append(errors_file)
    stale = detect_stale_shards(finals, num_processes)
    if stale:
        if not force:
            # Checked on EVERY process before joining, so the whole gang
            # exits fast instead of one host finding it after the run.
            raise PipelineError(
                "stale shard files from a previous run would be ignored by "
                f"the merge: {', '.join(stale)} — remove them or pass "
                "--force to overwrite"
            )
        for s in stale:
            try:
                os.remove(s)
            except FileNotFoundError:
                pass  # a peer on a shared filesystem got there first
            else:
                METRICS.inc("multihost_stale_shards_removed_total")

    # This rank's devices, before joining: a missing GPU fails here.
    mesh = run_mesh(device, None)
    rank_device = resolve_device(device if mesh is None else mesh.devices[0])

    initialize(coordinator, num_processes, process_id, timeout_s=exchange_deadline_s)
    try:
        world = dist.get_world_size()
        if world != num_processes:
            raise PipelineError(
                f"--num-processes {num_processes} does not match the initialized "
                f"distributed runtime (torch.distributed.get_world_size()={world}); all "
                "processes must be launched with the same topology, and an existing "
                "process group cannot be re-shaped"
            )
        arm_from_env(process_id=process_id)
        configure_exchange(deadline_s=exchange_deadline_s)
        _align_trace_clocks()

        # Run-report scope starts here: everything after joining is this
        # run's work, so the snapshot deltas attribute only it.
        values_before = metrics_snapshot() if run_report is not None else {}
        wall_t0 = time.perf_counter()

        n_rows = pq.ParquetFile(input_file).metadata.num_rows
        skip, take = _stripe(n_rows, num_processes, process_id)

        # Per-host dead-letter shard, merged by process 0 like kept and
        # excluded.  Created eagerly (the sink writes the empty file up
        # front) so the merge never races a host that recorded nothing.
        deadletter = (
            DeadLetterSink(f"{errors_file}.shard{process_id}")
            if errors_file is not None
            else None
        )

        geometry = None
        if auto_geometry:
            # Each host histograms ITS stripe's lengths over the fixed bin
            # edges; the sum of every host's is the same array everywhere,
            # so every host derives the same geometry.
            lengths = [
                len(d.content)
                for d in islice(
                    read_documents(input_file, text_column=text_column, id_column=id_column,
                                   batch_size=read_batch_size, skip_rows=skip),
                    take,
                )
                if not isinstance(d, PipelineError)
            ]
            hist = host_allgather(length_histogram(lengths)).sum(axis=0)
            if hist.sum() > 0:
                geometry = geometry_from_histogram(hist, backend=rank_device)
                logger.info(
                    "Negotiated device geometry from %d documents over %d processes: %s",
                    int(hist.sum()), num_processes, geometry.describe(),
                )

        try:
            result = _run_rows(
                config,
                input_file,
                f"{output_file}.shard{process_id}",
                f"{excluded_file}.shard{process_id}",
                text_column=text_column,
                id_column=id_column,
                device=device,
                read_batch_size=read_batch_size,
                device_batch=device_batch,
                buckets=buckets,
                deadletter=deadletter,
                quiet=quiet,
                mesh=mesh,
                geometry=geometry,
                skip_rows=skip,
                take=take,
            )
        finally:
            # The shard must be complete on disk before the totals barrier
            # releases process 0 into the merge.
            if deadletter is not None:
                deadletter.close()

        counts = {
            "received": result.received,
            "success": result.success,
            "filtered": result.filtered,
            "errors": result.errors,
            "read_errors": result.read_errors,
        }
        # The barrier doubling as the totals exchange: every process has
        # closed its shard files before process 0 merges.
        all_totals = host_allgather(np.array(list(counts.values()), dtype=np.int64))

        host_reports = None
        if run_report is not None:
            # One more exchange carrying each process's metrics-delta
            # snapshot, so host 0's report covers the whole gang.
            host_reports = host_allgather_obj({
                "process": process_id,
                "wall_time_s": round(time.perf_counter() - wall_t0, 3),
                "counts": counts,
                "metrics": snapshot_delta(values_before, metrics_snapshot()),
            })

        if process_id != 0:
            _leave_gang(num_processes, process_id)
            return result
        merge_shard_files([
            (final, [f"{final}.shard{i}" for i in range(num_processes)])
            for final in finals
        ])
        totals = dict(zip(counts, (int(x) for x in all_totals.sum(axis=0))))
        merged = AggregationResult()
        for k, v in totals.items():
            setattr(merged, k, v)
        if host_reports is not None:
            summed: dict = {}
            for h in host_reports:
                for k, v in h["metrics"].items():
                    # Counters sum across hosts; gauges (gang-agreed values)
                    # merge by max so the report shows the value, not n x it.
                    if is_merge_gauge(k):
                        summed[k] = max(summed.get(k, v), v)
                    else:
                        summed[k] = summed.get(k, 0.0) + v
            report = build_run_report(
                values=summed,
                wall_time_s=max(h["wall_time_s"] for h in host_reports),
                counts=totals,
                provenance=provenance,
                hosts=host_reports,
            )
            write_run_report(run_report, report)
        _leave_gang(num_processes, process_id)
        return merged
    except BaseException:
        # A peer is gone, or this rank failed: nothing may wait on the gang
        # any more, and rank 0's store going down fails its peers fast.
        _abandon_distributed()
        raise
