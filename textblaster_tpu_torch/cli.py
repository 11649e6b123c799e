"""Command-line interface: ``python -m textblaster_tpu_torch run|validate-config``.

The port's counterpart of ``textblaster_tpu/cli.py``, with the flags of its
``run`` command that the port supports (``--batch-size``,
``--pipeline-depth`` and ``--no-overlap``, ``--errors-file``,
``--stage-deadline-s``, ``--metrics-port`` and ``--run-report`` among
them), spelled the same way, plus ``--backend device|host`` and
``--device cuda|cpu`` (``cuda`` is the default; the run fails rather than
fall back when CUDA is absent).  A run prints the JAX package's summary
line and the tail lines whose layers the port has (dead-letter rows, the
breaker warning, host fallbacks, read errors; unless ``--quiet``, the
stage, occupancy and funnel summaries on stderr).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import __version__
from .config.pipeline import load_pipeline_config
from .errors import PipelineError
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
    run.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="Where the device pipeline runs (default cuda)")
    run.add_argument("--batch-size", type=int, default=1024,
                     help="Parquet read batch size")
    run.add_argument("--buckets", default=None,
                     help="Comma-separated codepoint length buckets for the device "
                          "path (e.g. 512,2048,8192); docs past the largest bucket "
                          "take the bit-exact host fallback")
    run.add_argument("--device-batch", type=int, default=None,
                     help="Documents per device batch")
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
    run.add_argument("--run-report", default=None, metavar="REPORT.JSON",
                     help="Write a machine-readable end-of-run report "
                          "(stage breakdown, occupancy, resilience "
                          "counters, per-filter drop funnel, wall time, "
                          "config provenance)")
    run.add_argument("--quiet", action="store_true", help="Suppress progress output")

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
    setup_prometheus_metrics(args.metrics_port)
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

    from .resilience.watchdog import WATCHDOG
    from .runner import run_pipeline

    WATCHDOG.configure(config.resilience.stage_deadline_s)
    # The JAX package's provenance keys; the flags the port does not have
    # yet keep their "off" values.
    provenance = {
        "entry": "textblast-torch run",
        "version": __version__,
        "pipeline_config": args.pipeline_config,
        "steps": [s.type for s in config.pipeline],
        "input_file": args.input_file,
        "backend": args.backend,
        "device": args.device,
        "buckets": list(buckets) if buckets else None,
        "device_batch": args.device_batch,
        "auto_geometry": False,
        "overlap_enabled": bool(config.overlap.enabled),
        "pipeline_depth": int(config.overlap.pipeline_depth),
        "speculate_depth": None,
        "num_processes": 1,
        "doc_sample_rate": 0,
        "profile": False,
        "stage_deadline_s": float(config.resilience.stage_deadline_s),
        "events_file": None,
        "slo": None,
    }
    report_baseline = metrics_snapshot() if args.run_report else None
    # The summaries cover this run, also when main() runs more than once in
    # a process (the JAX package prints the process's stage and occupancy
    # totals, the same thing for a process that runs once).
    stages_before = stage_snapshot()
    occupancy_before = occupancy_snapshot()
    funnel_before = funnel_snapshot()
    start = time.perf_counter()
    fallbacks_before = METRICS.get("worker_host_fallback_total")
    try:
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
        )
    except PipelineError as e:
        print(f"Pipeline run failed: {e}", file=sys.stderr)
        return 1

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

    if args.run_report:
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
