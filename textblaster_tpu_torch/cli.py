"""Command-line interface: ``python -m textblaster_tpu_torch run|validate-config``.

The port's counterpart of ``textblaster_tpu/cli.py``, with the flags of its
``run`` command that the port supports (``--batch-size``, ``--buckets``,
``--device-batch`` and ``--auto-geometry``, ``--pipeline-depth`` and
``--no-overlap``, ``--errors-file``, ``--stage-deadline-s``,
``--metrics-port``, ``--run-report``, ``--trace``, ``--trace-device``,
``--events-file``, ``--slo``, ``--doc-sample-rate``, ``--profile``,
``--checkpoint-dir`` and ``--checkpoint-every``, and the multi-host
``--coordinator``, ``--num-processes``, ``--process-id`` and ``--force``
among them), spelled the same way and refused in the same combinations,
plus ``--backend device|host`` and ``--device cuda|cpu``
(``cuda`` is the default; the run fails rather than fall back when CUDA is
absent).  Without ``--device``, a host with more than one visible GPU runs
a mesh of all of them (``CUDA_VISIBLE_DEVICES`` chooses them), as the JAX
CLI meshes every device of a host; ``--device cuda`` names one.  A run prints the JAX package's summary line and the tail lines
whose layers the port has (dead-letter rows, the breaker warning, host
fallbacks, read errors; unless ``--quiet``, the stage, occupancy and
funnel summaries, the trace, journal and SLO lines, with
``--doc-sample-rate`` the per-document latency block, and with
``--profile`` the device-profile line, on stderr).

``--trace-device LOGDIR`` is where the ports differ in means: the JAX
package captures ``jax.profiler.trace``; the port writes per-kernel and
per-batch device spans from CUDA events (``utils/trace.py``
``device_profile``) to ``LOGDIR/device_trace.json``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import __version__
from .config.pipeline import load_pipeline_config
from .errors import PipelineError
from .utils.events import EVENTS, flight_record
from .utils.logging_setup import init_logging
from .utils.metrics import (
    METRICS,
    STAGE_COUNTERS,
    build_run_report,
    format_funnel_summary,
    format_occupancy_summary,
    format_stage_summary,
    funnel_report,
    funnel_snapshot,
    metrics_snapshot,
    occupancy_report,
    occupancy_snapshot,
    setup_prometheus_metrics,
    stage_snapshot,
    write_run_report,
)
from .utils.profiler import PROFILER
from .utils.slo import SLO, parse_slo_arg
from .utils.telemetry import TELEMETRY, format_latency_summary
from .utils.trace import TRACER, device_profile

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="textblast-torch",
        description="Text-dataset cleaning pipeline (PyTorch/CUDA port)",
    )
    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="Process a Parquet shard through the pipeline")
    run.add_argument("-i", "--input-file", required=True,
                     help="Path to the input Parquet file")
    run.add_argument("--text-column", default="text",
                     help="Text column name in the Parquet file")
    run.add_argument("--id-column", default="id",
                     help="ID column name in the Parquet file")
    run.add_argument("-c", "--pipeline-config",
                     default="configs/pipeline_config.yaml",
                     help="Path to the pipeline configuration YAML file")
    run.add_argument("-o", "--output-file", default="output_processed.parquet",
                     help="Path to the output Parquet file")
    run.add_argument("-e", "--excluded-file", default="excluded.parquet",
                     help="Path to the excluded output Parquet file")
    run.add_argument("--errors-file", default=None,
                     help="Opt-in dead-letter Parquet file: every Error "
                          "outcome and every unreadable/quarantined row "
                          "lands here with step/reason/worker columns.  "
                          "Default: no file (the reference's behavior — "
                          "errored rows appear in neither output)")
    run.add_argument("--backend", choices=("device", "host"), default="device",
                     help="The device pipeline (device) or the host oracle (host)")
    run.add_argument("--device", choices=("cuda", "cpu"), default=None,
                     help="Where the device pipeline runs (default cuda: a mesh "
                          "of every visible GPU when there is more than one)")
    run.add_argument("--batch-size", type=int, default=1024,
                     help="Parquet read batch size")
    run.add_argument("--buckets", default=None,
                     help="Comma-separated codepoint length buckets for the device "
                          "path (e.g. 512,2048,8192); docs past the largest bucket "
                          "take the bit-exact host fallback")
    run.add_argument("--device-batch", type=int, default=None,
                     help="Documents per device batch")
    run.add_argument("--auto-geometry", action="store_true",
                     help="Calibrate device geometry from the data: sample "
                          "document lengths from the head of the stream, "
                          "choose bucket boundaries minimizing padded-"
                          "codepoint waste, and give each bucket a work-"
                          "equalized batch size (B ∝ lane_budget / bucket).  "
                          "Off by default (the built-in geometry is used); "
                          "mutually exclusive with --buckets and "
                          "--device-batch.  Checkpointed runs record the "
                          "calibrated geometry and resume with it")
    run.add_argument("--pipeline-depth", type=int, default=None,
                     help="Device batches kept in flight by the overlapped "
                          "host pipeline (default: the config's "
                          "overlap.pipeline_depth, 2).  Higher values hide "
                          "more host time behind device compute at the cost "
                          "of one packed batch of host memory each")
    run.add_argument("--stage-deadline-s", type=float, default=None,
                     metavar="S",
                     help="Arm the stall watchdog: deadline-bound every "
                          "host-side stage (device fetch, pack wait, "
                          "write-behind queue, reader prefetch) at S "
                          "seconds.  A stalled stage raises a typed "
                          "StallError and escalates through the ordinary "
                          "retry -> split -> host ladder, so hangs degrade "
                          "instead of wedging the run.  0 (the default) "
                          "disarms the watchdog entirely; scheduling-only — "
                          "outputs are byte-identical with any value.  "
                          "TEXTBLAST_STAGE_DEADLINE_S sets the same knob "
                          "from the environment")
    run.add_argument("--no-overlap", action="store_true",
                     help="Disable the overlapped host pipeline (reader "
                          "thread, pack pool, in-flight window, writer "
                          "thread) and run the serial path.  Outputs are "
                          "byte-identical either way; this is the "
                          "escape hatch and A/B baseline")
    run.add_argument("--metrics-port", type=int, default=None,
                     help="Port for the Prometheus metrics HTTP endpoint "
                          "(GET /metrics)")
    run.add_argument("--trace", default=None, metavar="OUT.JSON",
                     help="Record a Chrome trace-event JSON of the run "
                          "(per-batch spans for every pipeline stage across "
                          "the overlap threads, instant events for "
                          "resilience transitions, and on cuda one span a "
                          "batch on a 'device' track, timed by the batch's "
                          "CUDA events).  Load it at https://ui.perfetto.dev "
                          "or chrome://tracing.  Near-zero cost when off")
    run.add_argument("--trace-device", default=None, metavar="LOGDIR",
                     help="Also record the device timeline: a span for every "
                          "kernel launch and every batch, from CUDA events, "
                          "written to LOGDIR/device_trace.json (Perfetto-"
                          "loadable).  Opt-in and independent of --trace; "
                          "on the CPU the file holds no device spans")
    run.add_argument("--events-file", default=None, metavar="OUT.JSONL",
                     help="Write the structured operational event journal: "
                          "every retry/breaker/ladder transition, watchdog "
                          "stall, SLO alert, and the run's start and end as "
                          "one schema-validated JSONL record, "
                          "sequence-numbered and stamped on the trace clock.  "
                          "Near-zero cost when off.  TEXTBLAST_EVENTS sets "
                          "the same path from the environment")
    run.add_argument("--slo", action="append", default=None,
                     metavar="KEY=TARGET",
                     help="Declare a service-level objective (repeatable): "
                          "availability=0.999, p99_latency_s=0.25, "
                          "throughput_floor=500.  The engine evaluates "
                          "multi-window burn rates against the error budget, "
                          "publishes slo_* gauges on /metrics and /slo, fires "
                          "edge-triggered slo_alert journal events, and "
                          "lands an `slo` section in the run report.  "
                          "Overrides the config's `slo:` block per key; "
                          "TEXTBLAST_SLO takes comma-separated pairs from the "
                          "environment.  Arms the event journal (ring buffer "
                          "only unless --events-file is also given)")
    run.add_argument("--run-report", default=None, metavar="REPORT.JSON",
                     help="Write a machine-readable end-of-run report "
                          "(stage breakdown, occupancy, resilience "
                          "counters, per-filter drop funnel, wall time, "
                          "config provenance)")
    run.add_argument("--doc-sample-rate", type=int, default=0, metavar="N",
                     help="Sample 1-in-N documents for per-document "
                          "tail-latency lineage: sampled docs are stamped "
                          "at every stage seam and feed the "
                          "doc_latency_* HDR histograms (p50/p95/p99 in "
                          "the run report, /metrics, and the end-of-run "
                          "summary) plus the live rollup windows on "
                          "/telemetry.  Deterministic on the doc id, so "
                          "every run samples the same documents.  "
                          "0 = off (zero hot-path cost)")
    run.add_argument("--profile", action="store_true",
                     help="Device-time attribution: a cost pass models each "
                          "(bucket, phase) program's bytes and integer "
                          "operations from its hand-kernel launches (a "
                          "shape model, fingerprinted), then each dispatch "
                          "feeds per-(bucket, phase) device-time histograms "
                          "(CUDA-event seconds on cuda) with achieved-"
                          "bytes/s gauges against the model, and a top-K "
                          "slowest-dispatch table.  Lands in the run "
                          "report's device_profile section, /metrics, and "
                          "--trace span args.  Off by default (the hot path "
                          "then pays a single attribute check)")
    run.add_argument("--quiet", action="store_true", help="Suppress progress output")
    run.add_argument("--checkpoint-dir", default=None,
                     help="Enable chunk-level checkpointing in this directory; "
                          "an interrupted run resumes from the last committed "
                          "chunk (the reference cannot do this)")
    run.add_argument("--checkpoint-every", type=int, default=8192,
                     help="Documents per checkpointed chunk")
    run.add_argument("--coordinator", default=None,
                     help="host:port of process 0 — enables the multi-host "
                          "path: every process runs this same command "
                          "with its own --process-id, reads its row stripe, "
                          "and process 0 merges the per-host output shards "
                          "(the AMQP-address analogue, utils/common.rs:15)")
    run.add_argument("--num-processes", type=int, default=1,
                     help="Total participating processes (with --coordinator)")
    run.add_argument("--process-id", type=int, default=0,
                     help="This process's rank (with --coordinator)")
    run.add_argument("--force", action="store_true",
                     help="With --coordinator: remove stale *.shard* "
                          "leftovers from a previous crashed run instead of "
                          "failing fast when they would be silently ignored "
                          "by the final merge")

    val = sub.add_parser("validate-config", help="Validate a pipeline configuration and exit")
    val.add_argument("-c", "--pipeline-config", default="configs/pipeline_config.yaml")
    return p


def _cmd_validate(args: argparse.Namespace) -> int:
    try:
        config = load_pipeline_config(args.pipeline_config)
    except PipelineError as e:
        print(f"Configuration is invalid: {e}", file=sys.stderr)
        return 1
    print(
        f"Configuration at '{args.pipeline_config}' is valid "
        f"({len(config.pipeline)} steps: "
        + ", ".join(s.type for s in config.pipeline)
        + ")"
    )
    return 0


def _cmd_run(args: argparse.Namespace) -> int:
    init_logging("textblast")
    metrics_port = args.metrics_port
    if metrics_port is not None and args.coordinator:
        # Co-located processes (several ranks on one host) would collide on
        # the bind; rank-offset ports keep every /metrics reachable.
        metrics_port += args.process_id
    setup_prometheus_metrics(metrics_port)
    try:
        config = load_pipeline_config(args.pipeline_config)
    except PipelineError as e:
        print(f"Failed to load pipeline config: {e}", file=sys.stderr)
        return 1
    if args.no_overlap:
        config.overlap.enabled = False
    if args.pipeline_depth is not None:
        if args.pipeline_depth < 1:
            print(f"Invalid --pipeline-depth value: {args.pipeline_depth}",
                  file=sys.stderr)
            return 1
        config.overlap.pipeline_depth = args.pipeline_depth
    if args.stage_deadline_s is not None:
        if args.stage_deadline_s < 0:
            print(f"Invalid --stage-deadline-s value: {args.stage_deadline_s}",
                  file=sys.stderr)
            return 1
        config.resilience.stage_deadline_s = args.stage_deadline_s
    elif os.environ.get("TEXTBLAST_STAGE_DEADLINE_S", "").strip():
        try:
            env_deadline = float(os.environ["TEXTBLAST_STAGE_DEADLINE_S"])
        except ValueError:
            print("Invalid TEXTBLAST_STAGE_DEADLINE_S value: "
                  f"{os.environ['TEXTBLAST_STAGE_DEADLINE_S']!r}",
                  file=sys.stderr)
            return 1
        if env_deadline < 0:
            print(f"Invalid TEXTBLAST_STAGE_DEADLINE_S value: {env_deadline}",
                  file=sys.stderr)
            return 1
        config.resilience.stage_deadline_s = env_deadline
    buckets = None
    if args.buckets:
        try:
            buckets = tuple(sorted(int(x) for x in args.buckets.split(",") if x.strip()))
        except ValueError:
            buckets = ()
        if not buckets or any(b < 64 for b in buckets):
            print(f"Invalid --buckets value: {args.buckets!r}", file=sys.stderr)
            return 1
    if args.auto_geometry and (buckets or args.device_batch):
        print("--auto-geometry chooses buckets and batch sizes itself; "
              "it cannot be combined with --buckets or --device-batch",
              file=sys.stderr)
        return 1
    if args.auto_geometry and args.backend == "host":
        print("--auto-geometry tunes the device geometry; it has no effect "
              "on --backend host", file=sys.stderr)
        return 1
    if args.doc_sample_rate < 0:
        print(f"Invalid --doc-sample-rate value: {args.doc_sample_rate}",
              file=sys.stderr)
        return 1
    if args.coordinator and args.checkpoint_dir:
        print("--coordinator and --checkpoint-dir are mutually exclusive "
              "(multihost runs restart per shard; use smaller input stripes "
              "for resumability)", file=sys.stderr)
        return 1
    if args.coordinator and args.backend == "host":
        print("--coordinator requires the device pipeline "
              "(--backend device, not host)", file=sys.stderr)
        return 1

    # SLO objectives: config block first, --slo overrides per key, the env
    # fallback only when no flag was passed (mirrors TEXTBLAST_STAGE_DEADLINE_S).
    slo_pairs = list(args.slo or [])
    if not slo_pairs and os.environ.get("TEXTBLAST_SLO", "").strip():
        slo_pairs = [
            s for s in os.environ["TEXTBLAST_SLO"].split(",") if s.strip()
        ]
    slo_objectives = dict(config.slo.objectives)
    for raw in slo_pairs:
        try:
            key, target = parse_slo_arg(raw)
        except ValueError as e:
            print(f"Invalid --slo value: {e}", file=sys.stderr)
            return 1
        slo_objectives[key] = target

    from .checkpoint import run_checkpointed
    from .errors import PeerFailure
    from .parallel.multihost import run_multihost
    from .resilience.watchdog import WATCHDOG
    from .runner import _Progress, run_mesh, run_pipeline

    # Armed after every check that can end the run early: from here on,
    # every exit path closes what it arms (the finally below).
    if args.trace:
        trace_path = args.trace
        if args.coordinator and args.process_id:
            trace_path = f"{args.trace}.host{args.process_id}"
        TRACER.configure(
            trace_path,
            process_name=f"textblast-host{args.process_id}"
            if args.coordinator else "textblast",
            pid=args.process_id,
        )
    if args.doc_sample_rate > 0:
        TELEMETRY.configure(args.doc_sample_rate)
    if args.profile:
        # The cost pass runs in the device loop, after the pipeline is built
        # (and calibrated) and before its first dispatch.
        PROFILER.configure()
    WATCHDOG.configure(config.resilience.stage_deadline_s)
    events_path = args.events_file or (
        os.environ.get("TEXTBLAST_EVENTS", "").strip() or None
    )
    if events_path or slo_objectives:
        # Objectives without a journal path still arm the ring buffer:
        # slo_alert events must land somewhere the flight recorder can see.
        journal_path = events_path
        if journal_path and args.coordinator and args.process_id:
            journal_path = f"{events_path}.host{args.process_id}"
        EVENTS.configure(journal_path, rank=args.process_id)
    if slo_objectives:
        SLO.configure(
            slo_objectives,
            fast_window_s=config.slo.fast_window_s,
            slow_window_s=config.slo.slow_window_s,
            burn_threshold=config.slo.burn_threshold,
            tick_s=config.slo.tick_s,
        )
    # The JAX package's provenance keys (the flags the port does not have
    # yet keep their "off" values), and the port's "device": the devices
    # this process ran on (a mesh's entries, else the one device).
    if args.backend == "host":
        devices = "host"
    else:
        mesh = run_mesh(args.device, None)
        devices = (
            [str(d) for d in mesh.devices] if mesh is not None else args.device or "cuda"
        )
    provenance = {
        "entry": "textblast-torch run",
        "version": __version__,
        "pipeline_config": args.pipeline_config,
        "steps": [s.type for s in config.pipeline],
        "input_file": args.input_file,
        "backend": args.backend,
        "device": devices,
        "buckets": list(buckets) if buckets else None,
        "device_batch": args.device_batch,
        "auto_geometry": bool(args.auto_geometry),
        "overlap_enabled": bool(config.overlap.enabled),
        "pipeline_depth": int(config.overlap.pipeline_depth),
        "speculate_depth": None,
        "num_processes": args.num_processes,
        "doc_sample_rate": int(args.doc_sample_rate),
        "profile": bool(args.profile),
        "stage_deadline_s": float(config.resilience.stage_deadline_s),
        "events_file": args.events_file,
        "slo": dict(sorted(slo_objectives.items())) or None,
    }
    report_baseline = metrics_snapshot() if args.run_report else None
    # The summaries cover this run, also when main() runs more than once in
    # a process (the JAX package prints the process's stage and occupancy
    # totals, the same thing for a process that runs once).
    stages_before = stage_snapshot()
    occupancy_before = occupancy_snapshot()
    funnel_before = funnel_snapshot()
    latency_before = METRICS.all_values() if args.doc_sample_rate > 0 else None
    if EVENTS.enabled:
        # After the baseline snapshot, so the report's events section
        # charges run_start to this run rather than to history.
        EVENTS.emit(
            "run_start",
            input=args.input_file,
            backend=args.backend,
            num_processes=args.num_processes,
        )
    start = time.perf_counter()
    fallbacks_before = METRICS.get("worker_host_fallback_total")
    try:
        with device_profile(
            args.trace_device, (args.device or "cuda") if args.backend == "device" else "host"
        ):
            if args.coordinator:
                result = run_multihost(
                    config,
                    args.input_file,
                    args.output_file,
                    args.excluded_file,
                    coordinator=args.coordinator,
                    num_processes=args.num_processes,
                    process_id=args.process_id,
                    text_column=args.text_column,
                    id_column=args.id_column,
                    buckets=buckets,
                    read_batch_size=args.batch_size,
                    device_batch=args.device_batch,
                    auto_geometry=args.auto_geometry,
                    errors_file=args.errors_file,
                    force=args.force,
                    run_report=args.run_report,
                    provenance=provenance,
                    device=args.device,
                    quiet=args.quiet,
                )
            elif args.checkpoint_dir:
                progress = _Progress(enabled=not args.quiet)
                result = run_checkpointed(
                    config=config,
                    input_file=args.input_file,
                    output_file=args.output_file,
                    excluded_file=args.excluded_file,
                    ckpt_dir=args.checkpoint_dir,
                    chunk_size=args.checkpoint_every,
                    text_column=args.text_column,
                    id_column=args.id_column,
                    backend=args.backend,
                    device=args.device,
                    read_batch_size=args.batch_size,
                    device_batch=args.device_batch,
                    buckets=buckets,
                    auto_geometry=args.auto_geometry,
                    progress=progress.update,
                    errors_file=args.errors_file,
                )
                progress.finish()
            else:
                result = run_pipeline(
                    config,
                    input_file=args.input_file,
                    output_file=args.output_file,
                    excluded_file=args.excluded_file,
                    text_column=args.text_column,
                    id_column=args.id_column,
                    backend=args.backend,
                    device=args.device,
                    read_batch_size=args.batch_size,
                    device_batch=args.device_batch,
                    buckets=buckets,
                    errors_file=args.errors_file,
                    quiet=args.quiet,
                    auto_geometry=args.auto_geometry,
                )
        if EVENTS.enabled:
            EVENTS.emit("run_end", exit_code=0)
    except PeerFailure as e:
        # A broken gang: run_multihost already tore the process group down
        # without a barrier, so no thread of the store holds this process
        # and the ordinary return exits at once.
        print(f"Pipeline run failed: {e}", file=sys.stderr, flush=True)
        if EVENTS.enabled:
            # Journal the diagnosis and leave a flight-recorder dump beside
            # the output: the post-mortem when the gang dies faster than
            # any scrape.
            EVENTS.emit(
                "fatal",
                reason="peer_failure",
                missing_ranks=list(e.missing_ranks),
                dead_ranks=list(e.dead_ranks),
                seq=e.seq,
            )
            EVENTS.emit("run_end", exit_code=1)
            flight_record(
                args.output_file, rank=args.process_id, reason="peer_failure", exc=e
            )
        if args.run_report:
            # A partial, schema-tagged report naming the failed exchange.
            # Best-effort: the abort path must never mask the diagnosis.
            try:
                report = build_run_report(
                    baseline=report_baseline,
                    wall_time_s=time.perf_counter() - start,
                    counts={},
                    provenance=provenance,
                )
                report["aborted"] = True
                report["peer_failure"] = {
                    "message": str(e),
                    "missing_ranks": list(e.missing_ranks),
                    "dead_ranks": list(e.dead_ranks),
                    "seq": e.seq,
                    "epoch": e.epoch,
                }
                write_run_report(args.run_report, report)
            except Exception:
                pass
        return 1
    except PipelineError as e:
        print(f"Pipeline run failed: {e}", file=sys.stderr)
        if EVENTS.enabled:
            EVENTS.emit("fatal", reason="pipeline_error", error=str(e))
            EVENTS.emit("run_end", exit_code=1)
            flight_record(
                args.output_file, rank=args.process_id, reason="pipeline_error", exc=e
            )
        return 1
    except BaseException as e:
        # Anything else escaping here (KeyboardInterrupt, MemoryError, a
        # plain bug) unwinds the interpreter: leave the flight-recorder
        # dump behind first, then let it propagate.
        if EVENTS.enabled:
            EVENTS.emit("fatal", reason=type(e).__name__)
            flight_record(
                args.output_file, rank=args.process_id, reason="unhandled", exc=e
            )
        raise
    finally:
        TRACER.close()
        TELEMETRY.close()  # stops the rollup ticker; HDR state stays in METRICS
        PROFILER.close()  # stops recording; captured state stays for the report
        SLO.close()  # final evaluation tick, then disarm
        EVENTS.close()  # flushes the journal spill; counters stay in METRICS

    elapsed = time.perf_counter() - start
    total = result.received
    rate = total / elapsed if elapsed > 0 else 0.0
    # Final summary (bin/producer.rs:169-181), printed under --quiet too.
    print(
        f"Processed {total} documents in {elapsed:.2f}s ({rate:.1f} docs/sec): "
        f"{result.success} kept -> {args.output_file}, "
        f"{result.filtered} excluded -> {args.excluded_file}, "
        f"{result.errors} errored "
        + (
            f"-> {args.errors_file}."
            if args.errors_file
            else "(in neither file)."
        )
    )
    deadlettered = int(METRICS.get("deadletter_rows_total"))
    if args.errors_file and deadlettered:
        print(
            f"Dead-letter rows: {deadlettered} -> {args.errors_file} "
            "(errored + unreadable)."
        )
    if int(METRICS.get("resilience_breaker_trips_total")):
        print(
            "Warning: device circuit breaker tripped — the run degraded to "
            "the host backend after repeated device failures "
            f"(retries={int(METRICS.get('resilience_retries_total'))}, "
            f"host-rung docs="
            f"{int(METRICS.get('resilience_ladder_host_total'))}).",
            file=sys.stderr,
        )
    fallbacks = int(
        METRICS.get("worker_host_fallback_total") - fallbacks_before
    )
    if fallbacks:
        # Outlier documents (over-length, table overflow, dictionary
        # scripts, astral code points on the u16 wire) re-ran the host
        # oracle: bit-exact outcomes, but a high rate means the device path
        # is not carrying the load it appears to.
        print(
            f"Host-fallback documents: {fallbacks} "
            f"({fallbacks / max(total, 1):.1%} of stream)."
        )
    if result.read_errors:
        print(f"Warning: {result.read_errors} rows could not be read.",
              file=sys.stderr)
    if not args.quiet:
        if any(METRICS.get(name) > stages_before[name] for name in STAGE_COUNTERS):
            print(format_stage_summary(stages_before), file=sys.stderr)
        if occupancy_report(occupancy_before)["device_batches"] > 0:
            print(format_occupancy_summary(occupancy_before), file=sys.stderr)
        if funnel_report(funnel_before)["dropped_total"] > 0:
            print(
                format_funnel_summary(
                    funnel_before, order=[s.type for s in config.pipeline]
                ),
                file=sys.stderr,
            )
        if args.doc_sample_rate > 0:
            print(format_latency_summary(latency_before), file=sys.stderr)
        if args.profile:
            fp = PROFILER.cost_fingerprint()
            top = PROFILER.top_dispatches()
            line = f"Device profile: cost fingerprint {str(fp)[:12]}"
            if top:
                worst = top[0]
                line += (
                    f"; slowest dispatch {worst['seconds'] * 1e3:.1f} ms "
                    f"(bucket {worst['bucket']}, phase {worst['phase']})"
                )
            print(line, file=sys.stderr)
        if args.trace:
            print(f"Trace written -> {args.trace} "
                  "(load at https://ui.perfetto.dev)", file=sys.stderr)
        if args.events_file:
            emitted = int(METRICS.get("events_emitted_total"))
            dropped = int(METRICS.get("events_dropped_total"))
            line = f"Event journal -> {args.events_file} ({emitted} events"
            if dropped:
                line += f", {dropped} dropped"
            print(line + ")", file=sys.stderr)
        if slo_objectives:
            alerts = int(METRICS.get("slo_alerts_total"))
            worst = min(
                (
                    METRICS.get(f"slo_budget_remaining_{k}")
                    for k in slo_objectives
                ),
                default=1.0,
            )
            print(
                f"SLO: {len(slo_objectives)} objective(s), {alerts} "
                f"alert(s), {worst * 100.0:.1f}% of the tightest error "
                "budget left.",
                file=sys.stderr,
            )

    if args.run_report and not args.coordinator:
        # Coordinator runs write the merged report from run_multihost
        # (process 0, after the snapshot exchange) instead.
        report = build_run_report(
            baseline=report_baseline,
            wall_time_s=elapsed,
            counts={
                "received": result.received,
                "success": result.success,
                "filtered": result.filtered,
                "errors": result.errors,
                "read_errors": result.read_errors,
            },
            provenance=provenance,
        )
        write_run_report(args.run_report, report)
        if not args.quiet:
            print(f"Run report -> {args.run_report}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "validate-config":
        return _cmd_validate(args)
    return _cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
