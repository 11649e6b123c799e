"""Command-line interface: ``python -m textblaster_tpu_torch run|validate-config``.

The port's counterpart of ``textblaster_tpu/cli.py``, with the flags of its
``run`` command that the port supports (``--pipeline-depth`` and
``--no-overlap``, ``--errors-file`` and ``--stage-deadline-s`` among
them), spelled the same way, plus ``--backend device|host`` and
``--device cuda|cpu`` (``cuda`` is the default; the run fails rather than
fall back when CUDA is absent).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from . import __version__
from .config.pipeline import load_pipeline_config
from .errors import PipelineError

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
    run.add_argument("--quiet", action="store_true", help="Suppress the summary line")

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
    logging.basicConfig(level=logging.WARNING)
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
    start = time.perf_counter()
    result = run_pipeline(
        config,
        input_file=args.input_file,
        output_file=args.output_file,
        excluded_file=args.excluded_file,
        text_column=args.text_column,
        id_column=args.id_column,
        backend=args.backend,
        device=args.device,
        device_batch=args.device_batch,
        buckets=buckets,
        errors_file=args.errors_file,
    )
    elapsed = time.perf_counter() - start
    if not args.quiet:
        print(
            f"processed={result.received} kept={result.success} "
            f"excluded={result.filtered} errors={result.errors} "
            f"read_errors={result.read_errors} seconds={elapsed:.3f}"
        )
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "validate-config":
        return _cmd_validate(args)
    return _cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
