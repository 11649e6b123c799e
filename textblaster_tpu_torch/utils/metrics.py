"""Prometheus-compatible metrics registry + HTTP ``/metrics`` endpoint.

The port's copy of the JAX package's ``utils/metrics.py``: the same metric
names, HELP texts and exposition, byte for byte, so the two packages'
``render()`` output and run reports can be held side by side.  A
dependency-free registry (counters, gauges, fixed-bucket and log-linear
HDR histograms), ``http.server`` in a daemon thread for ``/metrics``, and
the end-of-run reports: the stage breakdown, device occupancy, the
per-filter funnel, resilience counters and the ``--run-report`` JSON
(``textblaster-run-report/v4``).  A bind failure is logged, not fatal.

Seams that count here in the port:

* the host oracle (``orchestration.py``): ``worker_*``, ``producer_*`` and
  ``filter_dropped_total_<step>``;
* the Parquet reader and writer: ``stage_read_seconds``,
  ``stage_write_seconds``; the overlap queues: ``queue_depth_read``,
  ``queue_depth_write``;
* the device path (``ops/pipeline.py``): ``record_occupancy`` per dispatch,
  ``stage_pack_seconds``, ``stage_dispatch_seconds``,
  ``stage_device_wait_seconds``, ``stage_post_seconds``,
  ``inflight_batches``, ``queue_depth_pack``, ``worker_host_fallback_total``,
  ``worker_host_tail_total`` and the device-side funnel seam;
* TokenCounter: ``worker_tokenizer_standin_total``;
* resilience (``resilience/``): the ``resilience_*``, ``watchdog_*`` and
  ``deadletter_rows_total`` series.

The layers the port does not have yet (telemetry, the profiler, the event
journal and the SLO engine) have no seam here: their report sections
(``latency``, ``device_profile``, ``events``, ``slo``) keep the JAX
package's keys and read what the JAX package reads with those layers off,
and the HTTP handler serves ``/metrics`` only.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = [
    "Metrics",
    "METRICS",
    "setup_prometheus_metrics",
    "STAGE_COUNTERS",
    "stage_snapshot",
    "stage_breakdown",
    "format_stage_summary",
    "OCCUPANCY_BUCKET_PREFIX",
    "occupancy_snapshot",
    "occupancy_report",
    "format_occupancy_summary",
    "FILTER_DROP_PREFIX",
    "DEVICE_TIME_PREFIX",
    "DEVICE_BPS_PREFIX",
    "EVENT_KIND_PREFIX",
    "SLO_EVENTS_PREFIX",
    "SLO_BAD_EVENTS_PREFIX",
    "SLO_GAUGE_PREFIXES",
    "is_merge_gauge",
    "snapshot_delta",
    "events_report",
    "funnel_snapshot",
    "funnel_report",
    "format_funnel_summary",
    "metrics_snapshot",
    "resilience_report",
    "latency_report",
    "histogram_report",
    "build_run_report",
    "write_run_report",
    "RUN_REPORT_SCHEMA",
    "metrics_catalog_markdown",
    "HDR_SUBBUCKET_BITS",
    "HDR_RELATIVE_ERROR",
    "HDR_SPECS",
    "DOC_LATENCY_STAGES",
    "hdr_bucket_index",
    "hdr_bucket_high_us",
    "hdr_quantile_us",
]

# Histogram buckets mirroring the reference's defaults (prometheus crate).
_DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# --- log-linear (HDR-style) histograms --------------------------------------
#
# Integer-microsecond values land in log-linear buckets: each power-of-two
# octave is split into 2**HDR_SUBBUCKET_BITS linear sub-buckets, so every
# bucket's width is at most its lower bound / 2**bits — i.e. any recorded
# value is reproduced by its bucket's upper bound within a bounded RELATIVE
# error, across the full dynamic range (1 µs .. hours) with a few hundred
# buckets at most.  All index math is pure-int and deterministic, and two
# histograms over the same scheme merge by bucket-wise addition — the
# property the multi-host run-report aggregation relies on for exact
# gang-wide quantiles.

HDR_SUBBUCKET_BITS = 5
_HDR_M = 1 << HDR_SUBBUCKET_BITS  # sub-buckets per octave

#: Worst-case relative error of a bucket-high readback vs the true value.
HDR_RELATIVE_ERROR = 1.0 / _HDR_M


def hdr_bucket_index(us: int) -> int:
    """Bucket index for an integer-microsecond value (log-linear scheme)."""
    v = int(us)
    if v < 0:
        v = 0
    if v < _HDR_M:
        return v  # first buckets are exact (width 1)
    k = v.bit_length() - 1
    sub = v >> (k - HDR_SUBBUCKET_BITS)  # in [M, 2M)
    return ((k - HDR_SUBBUCKET_BITS + 1) << HDR_SUBBUCKET_BITS) + (sub - _HDR_M)


def hdr_bucket_high_us(index: int) -> int:
    """Inclusive upper bound (µs) of a bucket — the quantile readback value.

    Strictly increasing in ``index``, and ``hdr_bucket_high_us(
    hdr_bucket_index(v)) >= v`` with relative error <= HDR_RELATIVE_ERROR.
    """
    i = int(index)
    if i < _HDR_M:
        return i
    e = (i >> HDR_SUBBUCKET_BITS) - 1
    sub = (i & (_HDR_M - 1)) + _HDR_M
    return ((sub + 1) << e) - 1


def hdr_quantile_us(buckets: Dict[int, int], count: int, q: float) -> int:
    """The q-quantile (µs) of a sparse ``{bucket_index: count}`` histogram.

    Rank semantics: the value at position ``ceil(q * count)`` of the sorted
    sample (1-based) — the "inverted CDF" definition, which is exact under
    bucket-wise merge: the quantile of a merged histogram equals the
    quantile of the concatenated samples (within the bucket error bound).
    """
    if count <= 0:
        return 0
    target = max(1, int(math.ceil(q * count)))
    seen = 0
    last = 0
    for idx in sorted(buckets):
        c = buckets[idx]
        if c <= 0:
            continue
        last = idx
        seen += c
        if seen >= target:
            return hdr_bucket_high_us(idx)
    return hdr_bucket_high_us(last)


#: Doc-lineage stage keys, in pipeline order, plus the end-to-end rollup —
#: each backs a dynamic HDR family ``doc_latency_<stage>_seconds``.
DOC_LATENCY_STAGES = (
    "read", "pack", "dispatch", "device_wait", "assemble", "write", "e2e",
)

#: Dynamic HDR histogram families (populated via ``Metrics.observe_hdr``) —
#: help strings for the exposition + the generated catalog.  Like the
#: occupancy/filter families, members only exist once observed.
HDR_SPECS: Dict[str, str] = {
    **{
        f"doc_latency_{stage}_seconds": (
            "Sampled per-document latency through the "
            f"'{stage}' stage (log-linear buckets, "
            "relative error <= 1/32)"
            if stage != "e2e"
            else "Sampled per-document end-to-end latency, first stage "
            "stamp to Parquet write (log-linear buckets, relative "
            "error <= 1/32)"
        )
        for stage in DOC_LATENCY_STAGES
    },
    "exchange_post_latency_seconds": (
        "Per-collective host_allgather post latency (log-linear buckets, "
        "relative error <= 1/32)"
    ),
    "multihost_lease_renew_latency_seconds": (
        "Per-renewal liveness-lease post latency, KV and file backends "
        "(log-linear buckets, relative error <= 1/32) — a fattening tail "
        "means heartbeat starvation is approaching the TTL"
    ),
}

# Metric name -> (type, help) — prometheus_metrics.rs:16-143.
_SPECS: Dict[str, Tuple[str, str]] = {
    # Producer side
    "producer_tasks_published_total": ("counter", "Total number of tasks published"),
    "producer_task_publish_errors_total": ("counter", "Task publish errors"),
    "producer_results_received_total": ("counter", "Total outcomes received"),
    "producer_results_success_total": ("counter", "Successful outcomes received"),
    "producer_results_filtered_total": ("counter", "Filtered outcomes received"),
    "producer_results_error_total": ("counter", "Error outcomes received"),
    "producer_results_deserialization_errors_total": (
        "counter",
        "Outcome deserialization errors",
    ),
    "producer_active_tasks_in_flight": ("gauge", "Tasks in flight"),
    "producer_task_publishing_duration_seconds": (
        "histogram",
        "Task publishing latency",
    ),
    # Worker side
    "worker_tasks_processed_total": ("counter", "Documents fully processed"),
    "worker_tasks_filtered_total": ("counter", "Documents filtered"),
    "worker_tasks_failed_total": ("counter", "Documents that hard-errored"),
    "worker_task_deserialization_errors_total": (
        "counter",
        "Task deserialization errors",
    ),
    "worker_outcome_publish_errors_total": ("counter", "Outcome publish errors"),
    "worker_task_processing_duration_seconds": (
        "histogram",
        "Per-document processing duration",
    ),
    "worker_active_tasks": ("gauge", "Documents currently being processed"),
    "worker_host_fallback_total": (
        "counter",
        "Documents rerouted to the host oracle (kernel table overflow or "
        "over-length outliers)",
    ),
    "worker_host_tail_total": (
        "counter",
        "Documents deliberately routed to the host oracle as end-of-stream "
        "tail groups too small to justify a padded device batch",
    ),
    "worker_fold_hazard_rows_total": (
        "counter",
        "Bad-words rows containing an IGNORECASE fold-hazard codepoint, "
        "re-decided by the host regex during batch assembly (per-row regex "
        "work, not a full pipeline fallback)",
    ),
    "worker_tokenizer_standin_total": (
        "counter",
        "TokenCounter instances that fell back to the vendored stand-in "
        "tokenizer (counts differ from the hub tokenizer)",
    ),
    # Resilience layer (no reference equivalent — the reference leans on
    # RabbitMQ redelivery; see resilience/).
    "resilience_retries_total": (
        "counter",
        "Transient-fault re-attempts across all guarded seams",
    ),
    "resilience_retries_read_total": (
        "counter",
        "Re-attempts of Parquet row-group reads",
    ),
    "resilience_retries_device_total": (
        "counter",
        "Re-attempts of device batch execution",
    ),
    "resilience_retries_checkpoint_total": (
        "counter",
        "Re-attempts of checkpoint cursor commits",
    ),
    "resilience_retry_exhausted_total": (
        "counter",
        "Guarded operations that spent their whole retry budget",
    ),
    "resilience_ladder_split_total": (
        "counter",
        "Device batches split in half by the degradation ladder "
        "(OOM recovery rung)",
    ),
    "resilience_ladder_host_total": (
        "counter",
        "Documents rerun on the host oracle by the degradation ladder "
        "after device execution kept failing",
    ),
    "resilience_breaker_trips_total": (
        "counter",
        "Circuit-breaker trips (device path abandoned for the run)",
    ),
    "resilience_breaker_open": (
        "gauge",
        "1 while the device circuit breaker is open (run degraded to host)",
    ),
    "resilience_quarantined_rows_total": (
        "counter",
        "Input rows quarantined because their row group could not be read",
    ),
    "resilience_breaker_probe_total": (
        "counter",
        "Half-open probes granted by the device circuit breaker after a "
        "cooldown",
    ),
    "resilience_breaker_recoveries_total": (
        "counter",
        "Circuit-breaker closures via a successful half-open probe "
        "(device dispatch resumed)",
    ),
    "deadletter_rows_total": (
        "counter",
        "Rows routed to the opt-in dead-letter (--errors-file) sink",
    ),
    # Negotiated multi-host resilience (resilience/negotiated.py): fault
    # verdicts are allgathered per lockstep round, so these counters move
    # identically on every host.
    "resilience_negotiated_rounds_total": (
        "counter",
        "Multi-host lockstep rounds resolved under the negotiated guard",
    ),
    "resilience_negotiated_retries_total": (
        "counter",
        "Lockstep rounds jointly re-dispatched on every host after a "
        "negotiated fault verdict",
    ),
    "resilience_negotiated_degraded_rounds_total": (
        "counter",
        "Lockstep rounds jointly degraded to the host oracle (retry budget "
        "exhausted or bucket breaker latched)",
    ),
    "resilience_negotiated_batched_verdicts_total": (
        "counter",
        "Round fault flags that traveled piggybacked in a batched verdict "
        "vector (one allgather post for the whole window drain) instead of "
        "posting one scalar exchange each",
    ),
    "multihost_merge_commits_total": (
        "counter",
        "Final output files committed atomically (tmp+fsync+rename) by the "
        "host-0 shard merge",
    ),
    "multihost_stale_shards_removed_total": (
        "counter",
        "Stale *.shard* leftovers from prior runs removed under --force",
    ),
    # Elastic gang membership (resilience/membership.py): leased liveness,
    # deadline-bounded exchanges, and stripe adoption for multi-host runs.
    "multihost_membership_epoch": (
        "gauge",
        "Current membership epoch (starts at 1, bumps whenever the observed "
        "live set shrinks or grows)",
    ),
    "multihost_evictions_total": (
        "counter",
        "Peers evicted from the gang after their liveness lease expired",
    ),
    "multihost_rejoins_total": (
        "counter",
        "Peers observed rejoining the gang with a fresh lease (restart-in-"
        "place)",
    ),
    "multihost_adopted_stripes_total": (
        "counter",
        "Orphaned input stripes adopted from an evicted peer (--elastic)",
    ),
    "multihost_peer_failures_total": (
        "counter",
        "Lockstep exchanges aborted with a typed PeerFailure (deadline "
        "expired with peers missing, or a peer posted malformed data)",
    ),
    "multihost_lease_renewals_total": (
        "counter",
        "Liveness lease renewals posted by this process's heartbeat",
    ),
    "multihost_lease_age_ratio": (
        "gauge",
        "Own-lease age over TTL at the last self-fence/liveness check "
        "(>= 1.0 means the lease went stale — heartbeat starvation, e.g. "
        "a GIL-holding XLA compile)",
    ),
    "multihost_join_requests_total": (
        "counter",
        "Join requests this process posted next to the liveness leases "
        "(live scale-out admission)",
    ),
    "multihost_rank_joins_total": (
        "counter",
        "New ranks admitted into the running gang (live scale-out joins; "
        "counted once per join by the lowest previously-live rank, so the "
        "sum-merged run report reads joins, not member-observations)",
    ),
    "multihost_autoscale_spawned_total": (
        "counter",
        "Joiner processes spawned by the --autoscale supervisor under "
        "sustained backlog",
    ),
    # Overlapped multi-host lockstep (parallel/multihost.py): the in-flight
    # round window is negotiated once at run start (min over every host's
    # pipeline_depth); these fold into the run report's resilience section
    # like every multihost_* series.
    "multihost_negotiated_depth": (
        "gauge",
        "Joint lockstep window depth: the min over every host's "
        "--pipeline-depth, allgathered once at run start",
    ),
    "multihost_window_stall_seconds_total": (
        "counter",
        "Wall seconds blocked resolving the oldest in-flight lockstep "
        "round (window full, or the end-of-phase drain)",
    ),
    "multihost_lockstep_seconds_total": (
        "counter",
        "Wall seconds inside the negotiated lockstep phase loop "
        "(pack + dispatch + resolve), per host",
    ),
    "multihost_window_replayed_rounds_total": (
        "counter",
        "Launched-ahead lockstep rounds discarded and re-dispatched after "
        "a negotiated fault verdict drained the window",
    ),
    "multihost_gang_reformations_total": (
        "counter",
        "Gang reformations completed on the coordinated path "
        "(--survive-peer-loss): dead rank fenced, survivor set elected, "
        "interrupted exchange replayed",
    ),
    "multihost_fenced_ranks_total": (
        "counter",
        "Rank incarnations fenced during gang reformation (a fenced "
        "incarnation's late exchange posts are ignored forever)",
    ),
    "multihost_reformation_epoch": (
        "gauge",
        "Membership epoch after the most recent gang reformation on the "
        "coordinated path (gang-agreed; max-merged in the run report)",
    ),
    "multihost_file_exchange_posts_total": (
        "counter",
        "Exchange slot files posted by the file-lease transport "
        "(--exchange-transport file), one per rank per collective",
    ),
    "multihost_exchange_posts_total": (
        "counter",
        "host_allgather collectives this process posted a row into, any "
        "transport and any vector width — the batched verdict exchange "
        "drives this down by piggybacking a window's fault flags into one "
        "vector post",
    ),
    "multihost_exchange_post_seconds_total": (
        "counter",
        "Wall seconds inside host_allgather posts (transport round trip "
        "included), across all collectives this process joined",
    ),
    # Speculative cross-phase dispatch (parallel/multihost.py
    # resolve_barrier): next-phase rounds launch at each phase barrier
    # before the tail verdicts resolve, and the barrier's three classic
    # exchanges collapse into one post.  TEXTBLAST_SPECULATE=off /
    # --speculate-depth 0 zeroes all four series.
    "multihost_speculate_depth": (
        "gauge",
        "Joint speculative dispatch depth: the min over every host's "
        "--speculate-depth (default: the window depth), allgathered with "
        "the window depth at run start; 0 means the classic barrier",
    ),
    "multihost_speculated_rounds_total": (
        "counter",
        "Next-phase lockstep rounds launched at a phase barrier before "
        "the tail verdicts resolved (includes re-launches after a void)",
    ),
    "multihost_voided_rounds_total": (
        "counter",
        "Speculative launches discarded by the joint rollback — a fault "
        "verdict, bucket latch, or gang reformation voided the result and "
        "the round re-dispatched fresh (outputs stay byte-identical)",
    ),
    "multihost_barrier_elisions_total": (
        "counter",
        "Exchange posts saved at phase barriers by piggybacking the tail "
        "verdict batch, join-admission lanes, and next-phase round counts "
        "into one combined post (largest win on the file transport, "
        "where each post is a filesystem round-trip)",
    ),
    # Stall watchdog (resilience/watchdog.py): per-stage deadlines over the
    # host-side blocking waits.  --stage-deadline-s 0 (the default) disarms
    # the watchdog and zeroes every series here.
    "watchdog_stalls_total": (
        "counter",
        "Host-side stage waits that exceeded their watchdog deadline and "
        "raised a typed StallError (stage named in the trace instant) "
        "instead of blocking forever",
    ),
    "watchdog_escalations_total": (
        "counter",
        "StallErrors handed to existing recovery machinery: the "
        "retry -> split -> host ladder on the single-host path, a local "
        "fault verdict (joint window drain/retry) on the lockstep path",
    ),
    "watchdog_deadline_seconds_device_fetch": (
        "gauge",
        "Active watchdog deadline for the device-fetch stage, seconds "
        "(0 / absent = unbounded)",
    ),
    "watchdog_deadline_seconds_pack_wait": (
        "gauge",
        "Active watchdog deadline for the pack-pool future wait, seconds "
        "(0 / absent = unbounded)",
    ),
    "watchdog_deadline_seconds_write_queue": (
        "gauge",
        "Active watchdog deadline for the write-behind queue (enqueue and "
        "teardown drain), seconds (0 / absent = unbounded)",
    ),
    "watchdog_deadline_seconds_read_prefetch": (
        "gauge",
        "Active watchdog deadline for the reader-prefetch queue wait, "
        "seconds (0 / absent = unbounded)",
    ),
    # Overlapped-pipeline stage accounting (no reference equivalent).  The
    # counters are wall seconds spent *inside* each stage, summed across
    # worker threads; with overlap on, stages run concurrently, so the sum
    # can exceed end-to-end wall time — compare stages to each other, not
    # to the clock.
    "stage_read_seconds": (
        "counter",
        "Wall seconds decoding Parquet row-groups into documents",
    ),
    "stage_pack_seconds": (
        "counter",
        "Wall seconds packing documents into device batches",
    ),
    "stage_dispatch_seconds": (
        "counter",
        "Wall seconds enqueueing device programs (host-side dispatch cost)",
    ),
    "stage_device_wait_seconds": (
        "counter",
        "Wall seconds blocked on device results (device compute not hidden "
        "by host work)",
    ),
    "stage_post_seconds": (
        "counter",
        "Wall seconds in host post-passes (assembly, TokenCounter, "
        "C4BadWords re-decides, host-oracle reruns)",
    ),
    "stage_write_seconds": (
        "counter",
        "Wall seconds writing outcome batches to Parquet",
    ),
    "queue_depth_read": (
        "gauge",
        "Prefetched row-group blocks buffered ahead of the consumer",
    ),
    "queue_depth_pack": (
        "gauge",
        "Packed batches waiting in the pack-stage queue",
    ),
    "queue_depth_write": (
        "gauge",
        "Outcome batches waiting in the writer-thread queue",
    ),
    "inflight_batches": (
        "gauge",
        "Device batches currently in flight (dispatched, not yet fetched)",
    ),
    # Per-document tail-latency telemetry (utils/telemetry.py): a
    # deterministic doc-id sampler stamps sampled documents at every stage
    # seam and feeds the dynamic doc_latency_* HDR histogram families.
    "doc_sampled_total": (
        "counter",
        "Documents selected by the deterministic lineage sampler "
        "(--doc-sample-rate)",
    ),
    "doc_lineage_evicted_total": (
        "counter",
        "Sampled document lineages evicted before reaching the write "
        "stage (lineage table at capacity)",
    ),
    "writer_chars_total": (
        "counter",
        "Document characters written to Parquet output (telemetry runs "
        "only; feeds the live chars/s rollup window)",
    ),
    "geometry_drift": (
        "gauge",
        "Relative deviation of the live padding-waste window from the "
        "calibration-time baseline (max-merged across hosts)",
    ),
    "trace_events_dropped_total": (
        "counter",
        "Trace events dropped: ring overflow with no spill file, or a "
        "spill write that failed (disk full / unwritable path)",
    ),
    # Operational event journal (utils/events.py): severity-leveled JSONL
    # record of every resilience/membership/watchdog/SLO transition.
    "events_emitted_total": (
        "counter",
        "Operational events recorded by the journal (per-kind counts in "
        "the dynamic events_total_<kind> families)",
    ),
    "events_dropped_total": (
        "counter",
        "Journal events dropped: ring overflow with no spill file, or a "
        "spill write that failed (disk full / unwritable path)",
    ),
    "events_invalid_total": (
        "counter",
        "Journal emit() calls rejected for schema violations (unknown "
        "kind or missing required data fields)",
    ),
    # SLO engine (utils/slo.py): burn-rate alerting over declared
    # objectives; per-objective state lives in the dynamic slo_* families.
    "slo_alerts_total": (
        "counter",
        "Edge-triggered SLO alerts: both the fast and slow burn-rate "
        "windows exceeded the threshold for an objective",
    ),
    "pipeline_warmup_done": (
        "gauge",
        "1 once the warmup decision has resolved for this process (warmed "
        "or deliberately skipped) — the /healthz readiness gate",
    ),
    # Device-occupancy accounting (ops/pipeline.py record_occupancy): a
    # compiled program computes every padded lane of its fixed shape, so
    # real/padded is the fraction of device work spent on actual text.
    "occupancy_device_batches_total": (
        "counter",
        "Device batches dispatched (every backend: CPU, TPU, mesh)",
    ),
    "occupancy_padded_lanes_total": (
        "counter",
        "Codepoint lanes computed by the device across all dispatches "
        "(rows x bucket length, padding included)",
    ),
    "occupancy_real_codepoints_total": (
        "counter",
        "Real document codepoints carried by those lanes",
    ),
}

#: Per-bucket dispatch counters are dynamic — one counter per bucket length
#: actually dispatched (``occupancy_dispatches_bucket_<L>``); ``render`` and
#: the occupancy report discover them by this prefix.
OCCUPANCY_BUCKET_PREFIX = "occupancy_dispatches_bucket_"

#: Per-filter drop counters are dynamic too — one counter per filter name
#: (``filter_dropped_total_<name>``), incremented at the exact two seams
#: that create a FILTERED outcome (orchestration.execute_processing_pipeline
#: and ops/pipeline._assemble_row), so their sum equals the excluded-Parquet
#: row count by construction.
FILTER_DROP_PREFIX = "filter_dropped_total_"

#: Per-(bucket, phase) device-time HDR histogram families are dynamic —
#: one family per (bucket length, phase) actually dispatched
#: (``device_time_bucket_<L>_phase_<P>_seconds``, fed by
#: ``utils.profiler.PROFILER.record_dispatch``); ``render`` and the
#: ``device_profile`` report section discover them by this prefix.
DEVICE_TIME_PREFIX = "device_time_bucket_"

#: Roofline-style achieved-bandwidth gauges are dynamic too — one gauge
#: per (bucket, phase) (``device_achieved_bytes_per_s_bucket_<L>_phase_
#: <P>``): the program's modeled bytes accessed divided by the latest
#: dispatch's blocked-on-device seconds.
DEVICE_BPS_PREFIX = "device_achieved_bytes_per_s_bucket_"

#: Per-kind journal counters are dynamic — one counter per event kind
#: actually emitted (``events_total_<kind>``, fed by
#: ``utils.events.EVENTS.emit``); counters, so the multihost sum-merge
#: aggregates gang-wide event counts and run-report v4 reads them from
#: any flat snapshot.
EVENT_KIND_PREFIX = "events_total_"

#: Per-objective SLO families are dynamic too (one member per declared
#: ``--slo`` key): monotone event/bad-event counters plus the target /
#: burn-rate / budget-remaining gauges published by ``utils.slo.SLO``.
SLO_EVENTS_PREFIX = "slo_events_total_"
SLO_BAD_EVENTS_PREFIX = "slo_bad_events_total_"
SLO_GAUGE_PREFIXES = (
    "slo_target_", "slo_burn_rate_", "slo_budget_remaining_",
)


def is_merge_gauge(name: str) -> bool:
    """True when a flat-snapshot key must merge by max (a gauge), not by
    sum.  The multihost merge used to consult ``_SPECS`` alone, which
    silently summed *dynamic* gauges; every dynamic gauge family prefix
    is enumerated here so new ones can't regress the merge."""
    spec = _SPECS.get(name)
    if spec is not None:
        return spec[0] == "gauge"
    return name.startswith(SLO_GAUGE_PREFIXES)


def _dynamic_hdr_help(name: str) -> str:
    """HELP text for a dynamic HDR family not listed in ``HDR_SPECS``."""
    if name.startswith(DEVICE_TIME_PREFIX):
        body = name[len(DEVICE_TIME_PREFIX):]
        return (
            f"Per-dispatch blocked-on-device wall time at bucket_phase "
            f"{body.replace('_seconds', '')} (log-linear buckets, "
            "relative error <= 1/32)"
        )
    return "Log-linear latency histogram (microsecond base)"


#: The per-stage wall-time counters, in pipeline order.
STAGE_COUNTERS = (
    "stage_read_seconds",
    "stage_pack_seconds",
    "stage_dispatch_seconds",
    "stage_device_wait_seconds",
    "stage_post_seconds",
    "stage_write_seconds",
)


def stage_snapshot() -> Dict[str, float]:
    """Current values of the stage wall-time counters."""
    return {name: METRICS.get(name) for name in STAGE_COUNTERS}


def _delta_fn(baseline, values):
    """Shared resolver for the report helpers: with ``values`` (an already
    materialized name->value dict, e.g. a summed cross-host snapshot) read
    from it and apply ``baseline``; otherwise read the live registry."""
    base = baseline or {}
    if values is not None:
        return lambda name: max(0.0, float(values.get(name, 0.0)) - base.get(name, 0.0))
    return lambda name: max(0.0, METRICS.get(name) - base.get(name, 0.0))


def _prefixed_from(values: Optional[Dict[str, float]], prefix: str) -> Dict[str, float]:
    if values is not None:
        return {k: float(v) for k, v in values.items() if k.startswith(prefix)}
    return METRICS.prefixed(prefix)


def stage_breakdown(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """Per-stage seconds (optionally relative to a snapshot) plus a
    host-bound vs device-bound verdict.

    Host seconds are read+pack+dispatch+write plus the post-pass time not
    already accounted as device wait (the serial path blocks inside the
    post/assembly phase, so ``post`` includes ``device_wait``; clamp at 0).
    Device seconds are the explicit device-wait counter.  ``verdict`` is
    "host-bound" when host work dominates, "device-bound" when the device
    wait does, "balanced" within 20%.
    """
    delta = _delta_fn(baseline, values)
    stages = {name: delta(name) for name in STAGE_COUNTERS}
    device_s = stages["stage_device_wait_seconds"]
    post_host = max(0.0, stages["stage_post_seconds"] - device_s)
    host_s = (
        stages["stage_read_seconds"]
        + stages["stage_pack_seconds"]
        + stages["stage_dispatch_seconds"]
        + post_host
        + stages["stage_write_seconds"]
    )
    if host_s > device_s * 1.2:
        verdict = "host-bound"
    elif device_s > host_s * 1.2:
        verdict = "device-bound"
    else:
        verdict = "balanced"
    return {
        "stages_s": {k: round(v, 3) for k, v in stages.items()},
        "host_s": round(host_s, 3),
        "device_s": round(device_s, 3),
        "verdict": verdict,
    }


def format_stage_summary(
    baseline: Optional[Dict[str, float]] = None,
) -> str:
    """End-of-run, human-readable stage summary (one line per stage)."""
    b = stage_breakdown(baseline)
    lines = ["Stage breakdown (wall seconds inside each stage):"]
    for name in STAGE_COUNTERS:
        label = name[len("stage_"):-len("_seconds")]
        lines.append(f"  {label:<12} {b['stages_s'][name]:>9.3f}s")
    lines.append(
        f"  host {b['host_s']:.3f}s vs device-wait {b['device_s']:.3f}s "
        f"-> {b['verdict']}"
    )
    return "\n".join(lines)


def occupancy_snapshot() -> Dict[str, float]:
    """Current values of every occupancy counter (per-bucket ones included)
    — the ``baseline`` argument for a scoped ``occupancy_report``."""
    snap = {
        name: METRICS.get(name)
        for name in (
            "occupancy_device_batches_total",
            "occupancy_padded_lanes_total",
            "occupancy_real_codepoints_total",
        )
    }
    snap.update(METRICS.prefixed(OCCUPANCY_BUCKET_PREFIX))
    return snap


def occupancy_report(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """Device-occupancy summary, optionally relative to a snapshot.

    ``waste_ratio`` is the fraction of computed codepoint lanes that carried
    padding rather than document text — the quantity the calibrated
    geometry minimizes."""
    base = baseline or {}
    delta = _delta_fn(baseline, values)

    lanes = delta("occupancy_padded_lanes_total")
    real = delta("occupancy_real_codepoints_total")
    per_bucket = {}
    for name, value in sorted(
        _prefixed_from(values, OCCUPANCY_BUCKET_PREFIX).items(),
        key=lambda kv: int(kv[0][len(OCCUPANCY_BUCKET_PREFIX):]),
    ):
        d = value - base.get(name, 0.0)
        if d > 0:
            per_bucket[int(name[len(OCCUPANCY_BUCKET_PREFIX):])] = int(d)
    return {
        "device_batches": int(delta("occupancy_device_batches_total")),
        "real_codepoints": int(real),
        "padded_lanes": int(lanes),
        "waste_ratio": round(1.0 - real / lanes, 4) if lanes > 0 else 0.0,
        "per_bucket_dispatches": per_bucket,
    }


def format_occupancy_summary(
    baseline: Optional[Dict[str, float]] = None,
) -> str:
    """One-line, human-readable occupancy report for the CLI summary."""
    occ = occupancy_report(baseline)
    buckets = ", ".join(
        f"{length}x{n}" for length, n in occ["per_bucket_dispatches"].items()
    )
    return (
        f"Device occupancy: {occ['real_codepoints']:,} real of "
        f"{occ['padded_lanes']:,} computed codepoint lanes "
        f"({occ['waste_ratio']:.1%} padding waste) across "
        f"{occ['device_batches']} dispatches"
        + (f" [bucket x dispatches: {buckets}]." if buckets else ".")
    )


def funnel_snapshot() -> Dict[str, float]:
    """Current values of every per-filter drop counter — the ``baseline``
    argument for a scoped ``funnel_report``."""
    return METRICS.prefixed(FILTER_DROP_PREFIX)


def funnel_report(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """Per-filter drop attribution.  ``dropped_total`` equals the number of
    FILTERED outcomes (= excluded-Parquet rows) because the counters are
    incremented at the exact seams that create those outcomes."""
    base = baseline or {}
    per_filter: Dict[str, int] = {}
    for name, value in _prefixed_from(values, FILTER_DROP_PREFIX).items():
        d = value - base.get(name, 0.0)
        if d > 0:
            per_filter[name[len(FILTER_DROP_PREFIX):]] = int(d)
    per_filter = dict(
        sorted(per_filter.items(), key=lambda kv: (-kv[1], kv[0]))
    )
    return {
        "per_filter_dropped": per_filter,
        "dropped_total": int(sum(per_filter.values())),
    }


def format_funnel_summary(
    baseline: Optional[Dict[str, float]] = None,
    order: Optional[List[str]] = None,
) -> str:
    """Human-readable per-filter drop funnel for the CLI tail.  ``order``
    (the pipeline's step sequence) pins the display order; filters that
    dropped nothing are listed with 0 so the funnel reads as the config."""
    rep = funnel_report(baseline)
    per = dict(rep["per_filter_dropped"])
    names = list(order) if order else []
    names += [n for n in per if n not in names]
    total = rep["dropped_total"]
    lines = [f"Filter funnel ({total:,} documents dropped):"]
    for name in names:
        n = per.get(name, 0)
        share = f" ({n / total:.1%})" if total else ""
        lines.append(f"  {name:<24} {n:>9,}{share if n else ''}")
    if not names:
        lines.append("  (no filter drops recorded)")
    return "\n".join(lines)


def metrics_snapshot() -> Dict[str, float]:
    """Full copy of every counter/gauge (dynamic families included) —
    the unit of cross-host exchange and the run-report baseline.
    Histogram state rides along as flat ``name::b<i>`` / ``name::h<i>`` /
    ``name::sum`` / ``name::count`` keys: every one is a monotone count, so
    the cross-host sum-merge aggregates histograms bucket-wise exactly like
    counters (the keys can't collide with real metric names — '::' never
    appears in one).  (The JAX package flushes its SLO engine first; the
    port has none yet.)"""
    return METRICS.all_values()


#: Counter families surfaced in the run report's resilience section.
_RESILIENCE_REPORT_PREFIXES = (
    "resilience_", "deadletter_", "multihost_", "watchdog_",
)


def resilience_report(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Dict[str, int]:
    """Every resilience/dead-letter/multihost counter as an int delta.

    ``multihost_`` gauges (e.g. the negotiated window depth) ride along as
    plain ints: they hold gang-agreed values, identical on every host, so
    the merged report carries them without a delta interpretation."""
    delta = _delta_fn(baseline, values)
    out: Dict[str, int] = {}
    for name, (mtype, _help) in _SPECS.items():
        if name.startswith(_RESILIENCE_REPORT_PREFIXES) and (
            mtype == "counter"
            or (mtype == "gauge" and name.startswith("multihost_"))
        ):
            out[name] = int(delta(name))
    return out


def _hdr_delta(
    vals: Dict[str, float], base: Dict[str, float], name: str
) -> Tuple[Dict[int, int], int, int]:
    """Decode one HDR family from a flat snapshot, relative to a baseline.

    Returns ``(sparse buckets, sum_us, count)`` with every count clamped at
    zero — the inverse of the ``name::h<i>`` encoding ``all_values`` emits.
    """
    prefix = name + "::h"
    buckets: Dict[int, int] = {}
    for k, v in vals.items():
        if k.startswith(prefix):
            d = int(v) - int(base.get(k, 0))
            if d > 0:
                buckets[int(k[len(prefix):])] = d
    sum_us = max(0, int(vals.get(name + "::sum", 0)) - int(base.get(name + "::sum", 0)))
    count = max(0, int(vals.get(name + "::count", 0)) - int(base.get(name + "::count", 0)))
    return buckets, sum_us, count


def latency_report(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """Per-stage + end-to-end sampled-latency quantiles (the run report's
    ``latency`` section).

    Reads the encoded HDR families out of ``values`` (or the live registry)
    relative to ``baseline``.  All math is pure-int bucket walking, so the
    same merged snapshot always produces byte-identical quantile blocks —
    the determinism the multi-host merged report relies on.
    """
    vals = values if values is not None else METRICS.all_values()
    base = baseline or {}
    stages: Dict[str, object] = {}
    families = [(s, f"doc_latency_{s}_seconds") for s in DOC_LATENCY_STAGES]
    families.append(("exchange_post", "exchange_post_latency_seconds"))
    families.append(("lease_renew", "multihost_lease_renew_latency_seconds"))
    for stage, fam in families:
        buckets, sum_us, count = _hdr_delta(vals, base, fam)
        if count <= 0:
            continue
        stages[stage] = {
            "count": count,
            "mean_s": round(sum_us / count / 1e6, 6),
            "p50_s": round(hdr_quantile_us(buckets, count, 0.50) / 1e6, 6),
            "p95_s": round(hdr_quantile_us(buckets, count, 0.95) / 1e6, 6),
            "p99_s": round(hdr_quantile_us(buckets, count, 0.99) / 1e6, 6),
            "max_le_s": round(
                hdr_bucket_high_us(max(buckets)) / 1e6, 6
            ) if buckets else 0.0,
        }
    return {"relative_error": HDR_RELATIVE_ERROR, "stages": stages}


def histogram_report(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """Fixed-bucket histogram deltas (the run report's ``histograms``
    section) — the families ``observe`` feeds, which earlier report
    versions silently dropped because snapshots excluded histogram state.

    Buckets are per-bucket (non-cumulative) counts keyed by upper bound, so
    a merged multi-host report's buckets equal the bucket-wise sum of the
    per-host snapshots by construction."""
    vals = values if values is not None else METRICS.all_values()
    base = baseline or {}
    out: Dict[str, object] = {}
    for name, (mtype, _help) in _SPECS.items():
        if mtype != "histogram":
            continue
        count = max(
            0,
            int(vals.get(f"{name}::count", 0)) - int(base.get(f"{name}::count", 0)),
        )
        if count <= 0:
            continue
        bucket_counts: Dict[str, int] = {}
        for i in range(len(_DEFAULT_BUCKETS) + 1):
            key = f"{name}::b{i}"
            d = int(vals.get(key, 0)) - int(base.get(key, 0))
            if d > 0:
                le = "+Inf" if i == len(_DEFAULT_BUCKETS) else f"{_DEFAULT_BUCKETS[i]:g}"
                bucket_counts[le] = d
        total = max(
            0.0,
            float(vals.get(f"{name}::sum", 0.0)) - float(base.get(f"{name}::sum", 0.0)),
        )
        out[name] = {
            "count": count,
            "sum_s": round(total, 6),
            "buckets": bucket_counts,
        }
    return out


#: Schema identifier stamped into every run report (bump on breaking shape
#: changes; consumers should match on it, not on key presence).  v2 adds
#: the ``latency`` (per-stage HDR quantile blocks) and ``histograms``
#: (fixed-bucket histogram deltas) sections; v3 adds ``device_profile``
#: (static cost model, per-(bucket, phase) device-time quantiles, roofline
#: gauges, top-K dispatches, lockstep decomposition); v4 adds ``events``
#: (per-kind operational journal counts + drop/invalid accounting) and
#: ``slo`` (per-objective burn-rate / error-budget state).
RUN_REPORT_SCHEMA = "textblaster-run-report/v4"


def events_report(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """The run report's ``events`` section: per-kind journal counts as int
    deltas, plus the emitted/dropped/invalid totals.  Pure counter reads,
    so the section built from a gang-merged snapshot carries the summed
    gang-wide event counts by construction."""
    base = baseline or {}
    delta = _delta_fn(baseline, values)
    per_kind: Dict[str, int] = {}
    for name, value in _prefixed_from(values, EVENT_KIND_PREFIX).items():
        d = value - base.get(name, 0.0)
        if d > 0:
            per_kind[name[len(EVENT_KIND_PREFIX):]] = int(d)
    emitted = int(delta("events_emitted_total"))
    if not per_kind and emitted == 0:
        return {}
    return {
        "emitted_total": emitted,
        "dropped_total": int(delta("events_dropped_total")),
        "invalid_total": int(delta("events_invalid_total")),
        "by_kind": dict(
            sorted(per_kind.items(), key=lambda kv: (-kv[1], kv[0]))
        ),
    }


def _slo_section(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """The ``slo`` report section: empty, as the JAX package's is with no
    objective declared (the port has no SLO engine yet)."""
    return {}


def snapshot_delta(
    before: Dict[str, float], now: Dict[str, float]
) -> Dict[str, float]:
    """A run-scoped metrics snapshot for report shards: counters as
    ``now - before``, merge-gauges (:func:`is_merge_gauge`) at their
    *current* value.  A gauge armed before the run window opened — the
    ``slo_target_*`` triple, watchdog deadlines — deltas to zero and
    would silently vanish from the merged report otherwise; the max-merge
    the gang applies downstream wants the level, not the movement."""
    out: Dict[str, float] = {}
    for k in set(now) | set(before):
        if is_merge_gauge(k):
            v = round(now.get(k, 0.0), 6)
            if v != 0.0:
                out[k] = v
        else:
            d = round(now.get(k, 0.0) - before.get(k, 0.0), 6)
            if d != 0.0:
                out[k] = d
    return out


def _device_profile_section(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """The ``device_profile`` report section in the shape the JAX package
    gives with its profiler off and no lockstep loop: no cost model, no
    per-(bucket, phase) device-time family, no top-K table (the port has
    no profiler yet)."""
    return {
        "cost_fingerprint": None,
        "cost_model": {},
        "dispatch": {},
        "top_dispatches": [],
    }


def build_run_report(
    *,
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
    wall_time_s: Optional[float] = None,
    counts: Optional[Dict[str, int]] = None,
    provenance: Optional[Dict[str, object]] = None,
    hosts: Optional[List[Dict[str, object]]] = None,
) -> Dict[str, object]:
    """Machine-readable end-of-run artifact (the ``--run-report`` payload).

    Reads the live registry relative to ``baseline`` by default; pass
    ``values`` (e.g. per-host deltas summed across an allgather) to build
    the same report from a materialized snapshot instead.  ``hosts``
    attaches the per-host snapshots on the multihost merged report."""
    report: Dict[str, object] = {
        "schema": RUN_REPORT_SCHEMA,
        "wall_time_s": round(wall_time_s, 3) if wall_time_s is not None else None,
        "counts": dict(counts or {}),
        "stages": stage_breakdown(baseline, values),
        "latency": latency_report(baseline, values),
        "histograms": histogram_report(baseline, values),
        "occupancy": occupancy_report(baseline, values),
        "resilience": resilience_report(baseline, values),
        "funnel": funnel_report(baseline, values),
        "device_profile": _device_profile_section(baseline, values),
        "events": events_report(baseline, values),
        "slo": _slo_section(baseline, values),
        "config": dict(provenance or {}),
    }
    if hosts is not None:
        report["hosts"] = hosts
        report["num_hosts"] = len(hosts)
    return report


def write_run_report(path: str, report: Dict[str, object]) -> None:
    """Write the report as pretty-printed JSON (parents created)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=False)
        f.write("\n")


def metrics_catalog_markdown() -> str:
    """Markdown table of every metric — the README catalog is generated
    from this (``python -m textblaster_tpu_torch.utils.metrics``) so the docs
    cannot drift from ``_SPECS``."""
    lines = [
        "| Metric | Type | Description |",
        "| --- | --- | --- |",
    ]
    for name, (mtype, help_text) in _SPECS.items():
        lines.append(f"| `{name}` | {mtype} | {help_text} |")
    lines.append(
        f"| `{OCCUPANCY_BUCKET_PREFIX}<L>` | counter | Dynamic family: "
        "device dispatches at bucket length `<L>` |"
    )
    lines.append(
        f"| `{FILTER_DROP_PREFIX}<name>` | counter | Dynamic family: "
        "documents dropped by filter `<name>` |"
    )
    for name, help_text in HDR_SPECS.items():
        lines.append(f"| `{name}` | histogram | Dynamic family: {help_text} |")
    lines.append(
        f"| `{DEVICE_TIME_PREFIX}<L>_phase_<P>_seconds` | histogram | "
        "Dynamic family: per-dispatch blocked-on-device wall time at "
        "bucket length `<L>`, phase `<P>` (log-linear buckets, relative "
        "error <= 1/32; fed by the profiler) |"
    )
    lines.append(
        f"| `{DEVICE_BPS_PREFIX}<L>_phase_<P>` | gauge | Dynamic family: "
        "achieved device bytes/s (modeled bytes accessed / last dispatch "
        "wait) at bucket length `<L>`, phase `<P>` |"
    )
    lines.append(
        f"| `{EVENT_KIND_PREFIX}<kind>` | counter | Dynamic family: "
        "operational journal events of kind `<kind>` (enumerated in "
        "`utils.events.KINDS`) |"
    )
    lines.append(
        f"| `{SLO_EVENTS_PREFIX}<key>` | counter | Dynamic family: SLO "
        "events evaluated for objective `<key>` |"
    )
    lines.append(
        f"| `{SLO_BAD_EVENTS_PREFIX}<key>` | counter | Dynamic family: "
        "SLO budget-consuming (bad) events for objective `<key>` |"
    )
    lines.append(
        "| `slo_target_<key>` | gauge | Dynamic family: declared SLO "
        "target for objective `<key>` |"
    )
    lines.append(
        "| `slo_burn_rate_<key>` | gauge | Dynamic family: fast-window "
        "error-budget burn rate for objective `<key>` (1.0 = consuming "
        "exactly the budget) |"
    )
    lines.append(
        "| `slo_budget_remaining_<key>` | gauge | Dynamic family: "
        "fraction of the error budget left for objective `<key>` |"
    )
    return "\n".join(lines)


class Metrics:
    """Thread-safe counter/gauge/histogram registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: Dict[str, float] = defaultdict(float)
        self._hist_counts: Dict[str, List[int]] = {}
        self._hist_sum: Dict[str, float] = defaultdict(float)
        self._hist_total: Dict[str, int] = defaultdict(int)
        # Log-linear histograms: sparse {bucket_index: count} per family,
        # sums kept in integer microseconds so merges stay exact.
        self._hdr: Dict[str, Dict[int, int]] = {}
        self._hdr_sum_us: Dict[str, int] = defaultdict(int)
        self._hdr_count: Dict[str, int] = defaultdict(int)

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
        """All dynamic counters whose name starts with ``prefix``."""
        with self._lock:
            return {
                k: v for k, v in self._values.items() if k.startswith(prefix)
            }

    def all_values(self) -> Dict[str, float]:
        """Copy of every counter/gauge value, with histogram state encoded
        as flat mergeable keys.

        Fixed-bucket histograms contribute ``name::b<i>`` (per-bucket,
        non-cumulative count) for every populated bucket plus ``name::sum``
        / ``name::count``; HDR families contribute ``name::h<idx>`` plus
        ``name::sum`` (µs) / ``name::count``.  Every encoded key is a
        monotone count, so the multi-host snapshot merge (which sums
        anything not declared a gauge) aggregates histograms bucket-wise
        with no special casing — run reports no longer drop them."""
        with self._lock:
            out = dict(self._values)
            for name, counts in self._hist_counts.items():
                for i, c in enumerate(counts):
                    if c:
                        out[f"{name}::b{i}"] = float(c)
                out[f"{name}::sum"] = self._hist_sum.get(name, 0.0)
                out[f"{name}::count"] = float(self._hist_total.get(name, 0))
            for name, buckets in self._hdr.items():
                for idx, c in buckets.items():
                    if c:
                        out[f"{name}::h{idx}"] = float(c)
                out[f"{name}::sum"] = float(self._hdr_sum_us.get(name, 0))
                out[f"{name}::count"] = float(self._hdr_count.get(name, 0))
            return out

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            if name not in self._hist_counts:
                self._hist_counts[name] = [0] * (len(_DEFAULT_BUCKETS) + 1)
            counts = self._hist_counts[name]
            for i, b in enumerate(_DEFAULT_BUCKETS):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._hist_sum[name] += value
            self._hist_total[name] += 1

    def observe_hdr(self, name: str, us: int) -> None:
        """Record one integer-microsecond value into a log-linear family."""
        v = max(0, int(us))
        idx = hdr_bucket_index(v)
        with self._lock:
            fam = self._hdr.get(name)
            if fam is None:
                fam = self._hdr[name] = {}
            fam[idx] = fam.get(idx, 0) + 1
            self._hdr_sum_us[name] += v
            self._hdr_count[name] += 1

    def hdr_state(self, name: str) -> Tuple[Dict[int, int], int, int]:
        """``(sparse buckets, sum_us, count)`` snapshot of one HDR family."""
        with self._lock:
            return (
                dict(self._hdr.get(name, {})),
                self._hdr_sum_us.get(name, 0),
                self._hdr_count.get(name, 0),
            )

    def reset(self) -> None:
        with self._lock:
            self._values.clear()
            self._hist_counts.clear()
            self._hist_sum.clear()
            self._hist_total.clear()
            self._hdr.clear()
            self._hdr_sum_us.clear()
            self._hdr_count.clear()

    def render(self) -> str:
        """Prometheus text exposition format."""
        with self._lock:
            lines: List[str] = []
            for name, (mtype, help_text) in _SPECS.items():
                if mtype in ("counter", "gauge"):
                    lines.append(f"# HELP {name} {help_text}")
                    lines.append(f"# TYPE {name} {mtype}")
                    lines.append(f"{name} {self._values.get(name, 0.0):g}")
                else:
                    lines.append(f"# HELP {name} {help_text}")
                    lines.append(f"# TYPE {name} histogram")
                    counts = self._hist_counts.get(
                        name, [0] * (len(_DEFAULT_BUCKETS) + 1)
                    )
                    cumulative = 0
                    for i, b in enumerate(_DEFAULT_BUCKETS):
                        cumulative += counts[i]
                        lines.append(f'{name}_bucket{{le="{b:g}"}} {cumulative}')
                    cumulative += counts[-1]
                    lines.append(f'{name}_bucket{{le="+Inf"}} {cumulative}')
                    lines.append(f"{name}_sum {self._hist_sum.get(name, 0.0):g}")
                    lines.append(f"{name}_count {self._hist_total.get(name, 0)}")
            # Dynamic HDR histogram families — exposed as ordinary
            # Prometheus histograms: populated buckets become cumulative
            # counts at their upper bound (seconds), closed by +Inf, with
            # _sum/_count alongside.  Only buckets that received a sample
            # are listed; bucket highs are strictly increasing in the
            # index, so the le series is ascending by construction.
            for name in sorted(self._hdr):
                help_text = HDR_SPECS.get(name) or _dynamic_hdr_help(name)
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} histogram")
                fam = self._hdr[name]
                cumulative = 0
                for idx in sorted(fam):
                    cumulative += fam[idx]
                    le = hdr_bucket_high_us(idx) / 1e6
                    lines.append(
                        f'{name}_bucket{{le="{le:.6f}"}} {cumulative}'
                    )
                lines.append(f'{name}_bucket{{le="+Inf"}} {cumulative}')
                lines.append(
                    f"{name}_sum {self._hdr_sum_us.get(name, 0) / 1e6:.6f}"
                )
                lines.append(f"{name}_count {self._hdr_count.get(name, 0)}")
            # Dynamic counter families — the member sets are only known at
            # runtime (buckets actually dispatched, filters that dropped).
            dyn = sorted(
                (k for k in self._values if k.startswith(OCCUPANCY_BUCKET_PREFIX)),
                key=lambda k: int(k[len(OCCUPANCY_BUCKET_PREFIX):]),
            )
            for name in dyn:
                lines.append(
                    f"# HELP {name} Device dispatches at bucket length "
                    f"{name[len(OCCUPANCY_BUCKET_PREFIX):]}"
                )
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {self._values[name]:g}")
            for name in sorted(
                k for k in self._values if k.startswith(FILTER_DROP_PREFIX)
            ):
                lines.append(
                    f"# HELP {name} Documents dropped by filter "
                    f"{name[len(FILTER_DROP_PREFIX):]}"
                )
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {self._values[name]:g}")
            for name in sorted(
                k for k in self._values if k.startswith(DEVICE_BPS_PREFIX)
            ):
                lines.append(
                    f"# HELP {name} Achieved device bytes/s (modeled bytes "
                    f"accessed / last dispatch wait) at bucket_phase "
                    f"{name[len(DEVICE_BPS_PREFIX):]}"
                )
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {self._values[name]:g}")
            for name in sorted(
                k for k in self._values if k.startswith(EVENT_KIND_PREFIX)
            ):
                lines.append(
                    f"# HELP {name} Operational journal events of kind "
                    f"{name[len(EVENT_KIND_PREFIX):]}"
                )
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {self._values[name]:g}")
            # SLO dynamic families: events/bad-events counters, then the
            # target / burn-rate / budget-remaining gauges.  slo_events_
            # is a prefix of slo_events_total_ members only, so the two
            # counter loops can't overlap the gauge loop.
            for prefix, help_fmt in (
                (SLO_EVENTS_PREFIX, "SLO events evaluated for objective "),
                (SLO_BAD_EVENTS_PREFIX, "SLO budget-consuming events for objective "),
            ):
                for name in sorted(
                    k for k in self._values if k.startswith(prefix)
                ):
                    lines.append(f"# HELP {name} {help_fmt}{name[len(prefix):]}")
                    lines.append(f"# TYPE {name} counter")
                    lines.append(f"{name} {self._values[name]:g}")
            for prefix, help_fmt in (
                ("slo_target_", "Declared SLO target for objective "),
                ("slo_burn_rate_", "Fast-window error-budget burn rate for objective "),
                (
                    "slo_budget_remaining_",
                    "Fraction of the error budget left for objective ",
                ),
            ):
                for name in sorted(
                    k for k in self._values if k.startswith(prefix)
                ):
                    lines.append(f"# HELP {name} {help_fmt}{name[len(prefix):]}")
                    lines.append(f"# TYPE {name} gauge")
                    lines.append(f"{name} {self._values[name]:g}")
            return "\n".join(lines) + "\n"


#: Process-wide registry (the reference's lazy statics, rs:16-143).
METRICS = Metrics()


class _Handler(BaseHTTPRequestHandler):
    def _is_metrics_path(self) -> bool:
        # Strict scrapers send query strings (GET /metrics?timeout=5) —
        # match on the path component only.
        return self.path.split("?", 1)[0] == "/metrics"

    def _respond(self, send_body: bool) -> None:
        # /metrics only: the JAX package's /telemetry, /healthz and /slo
        # belong to layers the port does not have yet.
        if not self._is_metrics_path():
            self.send_response(404)
            self.end_headers()
            return
        body = METRICS.render().encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if send_body:
            self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        self._respond(send_body=True)

    def do_HEAD(self):  # noqa: N802 — probes (curl -I, LB health checks)
        self._respond(send_body=False)

    def log_message(self, fmt, *args):  # silence request logging
        logger.debug("metrics: " + fmt, *args)


def setup_prometheus_metrics(port: Optional[int]) -> Optional[ThreadingHTTPServer]:
    """Serve ``/metrics`` on the given port in a daemon thread
    (prometheus_metrics.rs:148-201).  Returns the server, or None if no port
    was requested or the bind failed (bind failure only logged, rs:186-195).
    """
    if port is None:
        return None
    try:
        server = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
    except OSError as e:
        logger.error("Failed to bind metrics server on port %s: %s", port, e)
        return None
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    logger.info("Metrics server listening on port %s", port)
    return server


if __name__ == "__main__":  # README catalog generator
    print(metrics_catalog_markdown())
