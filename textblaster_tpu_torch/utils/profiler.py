"""Device-time attribution: a shape-determined per-program cost model,
dispatch-level device-time histograms, the lockstep stall decomposition,
and a machine-independent perf-regression sentinel.

The port's counterpart of ``textblaster_tpu/utils/profiler.py``, with its
public names, its report shape and its sentinel.  Four subsystems, all off
(one attribute check per seam) until ``PROFILER.configure()``:

Static cost model
    The card runs no compiled program to analyze, so the cost model is a
    shape model (``source: "shape-model"``): the cost pass
    (``CompiledPipeline.register_program_costs``) runs every (bucket,
    phase, rows) program once on a zero batch of its shape under the
    dispatch-count scope of ``ops/scan.py``, with the gates that stand for
    the JAX package's ``lax.cond`` open, and sums the modeled bytes and
    integer operations of the hand-kernel launches it recorded
    (``ops/cost.py``, the model behind ``chip_smoke.py``'s bound column).
    :data:`COST_FIELDS` holds only what the shapes determine; device
    memory is measured, never modeled.  :func:`cost_fingerprint` folds the
    sorted per-program table into one sha256, bit-equal on ``cpu`` and
    ``cuda`` for a given config, geometry and trace-shaping knobs (the
    wire among them: its default differs by device, so the sentinel pins
    it).

Dispatch-level device timing
    ``CompiledPipeline`` feeds each dispatch that returned into
    per-(bucket, phase) HDR families
    (``device_time_bucket_<L>_phase_<P>_seconds``, the same mergeable
    log-linear scheme as the doc-latency families): on ``cuda`` the
    batch's device seconds from the two CUDA events that bracket its
    upload, function and download; on the CPU ``run_batch``'s host
    seconds.  Each dispatch also updates an achieved-bytes/s gauge against
    the modeled bytes and the top-K slowest-dispatch table.  All of it
    lands in the run report's ``device_profile`` section; the modeled cost
    and achieved rate also ride the ``device_wait`` span's args.

Lockstep decomposition
    :func:`lockstep_decomposition` splits a multi-host lockstep loop's wall
    time from counters in the snapshot.  The port has no multi-host path
    yet, so it returns None on every run of the port.

Regression sentinel
    ``python -m textblaster_tpu_torch.utils.profiler --baseline/--check``
    diffs the cost fingerprint and per-(bucket, phase) scan dispatch
    counts of the embedded workload against a recorded baseline JSON.
    ``--check`` of the JAX package's own baseline compares the dispatch
    counts alone (its cost fields are XLA's, not comparable with the shape
    model), which holds the port's schedule to the JAX package's, program
    by program.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import logging
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from .metrics import (
    DEVICE_BPS_PREFIX,
    DEVICE_TIME_PREFIX,
    METRICS,
    _hdr_delta,
    hdr_bucket_high_us,
    hdr_quantile_us,
)

logger = logging.getLogger(__name__)

__all__ = [
    "PROFILER",
    "Profiler",
    "program_key",
    "cost_fingerprint",
    "device_profile_report",
    "lockstep_decomposition",
    "collect_sentinel_profile",
    "compare_profiles",
    "SENTINEL_SCHEMA",
    "main",
]

#: Sentinel baseline file schema tag (bump on breaking shape changes); the
#: port's own, since its cost fields are not the JAX package's.
SENTINEL_SCHEMA = "textblaster-torch-cost-baseline/v1"

#: The JAX package's schema tag: ``--check`` of such a baseline compares
#: the dispatch counts only.
JAX_SENTINEL_SCHEMA = "textblaster-cost-baseline/v1"

#: Cost fields carried per program and compared by the sentinel's
#: tolerance bands, in display order: what the shapes determine.
COST_FIELDS = (
    "flops",
    "bytes_accessed",
    "argument_bytes",
    "output_bytes",
    "launches",
)

_FAMILY_RE = re.compile(
    rf"^{DEVICE_TIME_PREFIX}(\d+)_phase_(\d+)_seconds$"
)


def program_key(length: int, phase: int, rows: int) -> str:
    """Canonical per-program key — ``b<bucket>/p<phase>/r<rows>`` — used by
    the cost table, the fingerprint, and the sentinel baseline."""
    return f"b{int(length)}/p{int(phase)}/r{int(rows)}"


def device_time_family(length: int, phase: int) -> str:
    """HDR family name for one (bucket, phase) dispatch population."""
    return f"{DEVICE_TIME_PREFIX}{int(length)}_phase_{int(phase)}_seconds"


def cost_fingerprint(table: Dict[str, Dict[str, int]]) -> Optional[str]:
    """sha256 over the canonical (sorted-key, separators-free) JSON of a
    ``{program_key: cost}`` table — THE config-level cost fingerprint."""
    if not table:
        return None
    blob = json.dumps(table, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


class Profiler:
    """Process-wide performance observatory (``PROFILER``).

    Hot-path discipline mirrors ``TELEMETRY``/``TRACER``: every seam
    guards with ``if PROFILER.enabled:`` — one attribute read, nothing
    else, when profiling is off."""

    def __init__(self) -> None:
        #: THE hot-path guard.
        self.enabled = False
        self._lock = threading.Lock()
        # program_key -> {"cost": {...} | None, "source": str,
        #                 "length": int, "phase": int, "rows": int}
        self._programs: Dict[str, Dict[str, Any]] = {}
        # (length, phase) -> cost dict of the largest-rows program, the
        # denominator for per-dispatch roofline math (split-rung rows get
        # their own exact entry when present).
        self._by_bucket_phase: Dict[Tuple[int, int], Dict[str, int]] = {}
        self._top: List[Tuple[float, int, Dict[str, Any]]] = []
        self._top_k = 8
        self._seq = 0

    # -- lifecycle -----------------------------------------------------------

    def configure(self, top_k: int = 8) -> None:
        """Enable profiling with a fresh state (idempotent re-arms)."""
        with self._lock:
            self._programs = {}
            self._by_bucket_phase = {}
            self._top = []
            self._top_k = max(1, int(top_k))
            self._seq = 0
        self.enabled = True

    def close(self) -> None:
        """Disable the hot-path seams.  Captured state is kept so an
        end-of-run report built after teardown still has the cost model."""
        self.enabled = False

    # -- static cost model ---------------------------------------------------

    def record_program_cost(
        self,
        length: int,
        phase: int,
        rows: int,
        cost: Optional[Dict[str, int]],
        source: str = "shape-model",
    ) -> None:
        """Register one program's static cost (``source``: the port's cost
        pass records "shape-model")."""
        pk = program_key(length, phase, rows)
        with self._lock:
            self._programs[pk] = {
                "cost": dict(cost) if cost else None,
                "source": source,
                "length": int(length),
                "phase": int(phase),
                "rows": int(rows),
            }
            if cost:
                bp = (int(length), int(phase))
                cur = self._by_bucket_phase.get(bp)
                if cur is None or int(rows) >= cur.get("_rows", -1):
                    self._by_bucket_phase[bp] = {**cost, "_rows": int(rows)}

    def cost_table(self) -> Dict[str, Dict[str, int]]:
        """``{program_key: cost}`` for every program with a model — the
        fingerprint input (sources and row metadata excluded)."""
        with self._lock:
            return {
                pk: dict(rec["cost"])
                for pk, rec in self._programs.items()
                if rec["cost"]
            }

    def cost_entries(self) -> Dict[str, Dict[str, Any]]:
        """Cost table with provenance (``source``) for the report."""
        with self._lock:
            out = {}
            for pk, rec in sorted(self._programs.items()):
                out[pk] = {
                    **(rec["cost"] or {}),
                    "source": rec["source"],
                }
            return out

    def cost_fingerprint(self) -> Optional[str]:
        return cost_fingerprint(self.cost_table())

    def modeled_cost(
        self, length: int, phase: int, rows: Optional[int] = None
    ) -> Optional[Dict[str, int]]:
        """The cost model for one dispatch shape: exact (bucket, phase,
        rows) entry when present, else the bucket/phase's full-rows one."""
        with self._lock:
            if rows is not None:
                rec = self._programs.get(program_key(length, phase, rows))
                if rec is not None and rec["cost"]:
                    return rec["cost"]
            return self._by_bucket_phase.get((int(length), int(phase)))

    # -- dispatch timing -----------------------------------------------------

    def record_dispatch(
        self, length: int, phase: int, rows: int, seconds: float
    ) -> Dict[str, Any]:
        """Record one dispatch's device seconds.

        Feeds the per-(bucket, phase) HDR family, updates the achieved
        bytes/s roofline gauge against the modeled bytes, and keeps the
        top-K slowest-dispatch table.  Returns the attribution dict the
        caller may attach to its span."""
        seconds = max(0.0, float(seconds))
        METRICS.observe_hdr(
            device_time_family(length, phase), int(seconds * 1e6)
        )
        info: Dict[str, Any] = {
            "bucket": int(length),
            "phase": int(phase),
            "rows": int(rows),
            "seconds": round(seconds, 6),
        }
        cost = self.modeled_cost(length, phase, rows)
        if cost:
            info["modeled_flops"] = int(cost.get("flops", 0))
            info["modeled_bytes"] = int(cost.get("bytes_accessed", 0))
            if seconds > 0:
                bps = cost.get("bytes_accessed", 0) / seconds
                info["achieved_bytes_per_s"] = int(bps)
                METRICS.set(
                    f"{DEVICE_BPS_PREFIX}{int(length)}_phase_{int(phase)}",
                    bps,
                )
        with self._lock:
            self._seq += 1
            heapq.heappush(self._top, (seconds, self._seq, info))
            if len(self._top) > self._top_k:
                heapq.heappop(self._top)
        return info

    def top_dispatches(self) -> List[Dict[str, Any]]:
        """The K slowest dispatches seen, slowest first (per-process — the
        table does not travel through snapshot merges; the HDR families
        carry the mergeable population)."""
        with self._lock:
            return [
                info
                for _, _, info in sorted(self._top, key=lambda t: -t[0])
            ]


#: Process-wide observatory, disabled until configured.
PROFILER = Profiler()


# --- report builders ---------------------------------------------------------


def _discover_families(vals: Dict[str, float]) -> List[Tuple[str, int, int]]:
    """(family, bucket, phase) for every device-time HDR family present in
    a flat snapshot (discovered via the ``::count`` key)."""
    out = []
    for key in vals:
        if not key.endswith("::count"):
            continue
        m = _FAMILY_RE.match(key[: -len("::count")])
        if m:
            out.append((m.group(0), int(m.group(1)), int(m.group(2))))
    return sorted(out, key=lambda t: (t[1], t[2]))


def lockstep_decomposition(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Optional[Dict[str, object]]:
    """Attribute a multi-host lockstep loop's wall time, from counters
    that ride the snapshot sum-merge (the JAX package's function):

    * ``device_s`` — blocked fetching device results
      (``stage_device_wait_seconds``);
    * ``exchange_post_s`` — inside the host allgather posts;
    * ``stall_s`` — resolve-blocked time not explained by the device
      fetch or the posts;
    * ``other_s`` — the loop's remainder (pack, launch, scheduling).

    Returns None when no lockstep loop ran in the window — on every run of
    the port until it has a multi-host path."""
    from .metrics import _delta_fn

    delta = _delta_fn(baseline, values)
    total = delta("multihost_lockstep_seconds_total")
    if total <= 0:
        return None
    stall = min(total, delta("multihost_window_stall_seconds_total"))
    device = min(total, delta("stage_device_wait_seconds"))
    exchange = min(total, delta("multihost_exchange_post_seconds_total"))
    residual_stall = max(0.0, stall - device - exchange)
    other = max(0.0, total - device - exchange - residual_stall)
    shares = {
        "device": device,
        "exchange_post": exchange,
        "stall": residual_stall,
        "other": other,
    }
    return {
        "lockstep_s": round(total, 3),
        "window_stall_s": round(stall, 3),
        "device_s": round(device, 3),
        "exchange_post_s": round(exchange, 3),
        "stall_residual_s": round(residual_stall, 3),
        "other_s": round(other, 3),
        "shares": {k: round(v / total, 4) for k, v in shares.items()},
    }


def device_profile_report(
    baseline: Optional[Dict[str, float]] = None,
    values: Optional[Dict[str, float]] = None,
) -> Dict[str, object]:
    """The run report's ``device_profile`` section.

    Dual-mode like the other report helpers: reads the live registry
    relative to ``baseline``, or a materialized ``values`` snapshot (the
    HDR families merge bucket-wise, so merged quantiles are exact).  The
    cost model and top-K table are process-local."""
    vals = values if values is not None else METRICS.all_values()
    base = baseline or {}
    dispatch: Dict[str, object] = {}
    for fam, length, phase in _discover_families(vals):
        buckets, sum_us, count = _hdr_delta(vals, base, fam)
        if count <= 0:
            continue
        mean_s = sum_us / count / 1e6
        entry: Dict[str, object] = {
            "count": count,
            "mean_s": round(mean_s, 6),
            "p50_s": round(hdr_quantile_us(buckets, count, 0.50) / 1e6, 6),
            "p95_s": round(hdr_quantile_us(buckets, count, 0.95) / 1e6, 6),
            "p99_s": round(hdr_quantile_us(buckets, count, 0.99) / 1e6, 6),
            "max_le_s": round(
                hdr_bucket_high_us(max(buckets)) / 1e6, 6
            ) if buckets else 0.0,
        }
        cost = PROFILER.modeled_cost(length, phase)
        if cost and mean_s > 0:
            entry["modeled_flops"] = int(cost.get("flops", 0))
            entry["modeled_bytes"] = int(cost.get("bytes_accessed", 0))
            entry["achieved_bytes_per_s"] = int(
                cost.get("bytes_accessed", 0) / mean_s
            )
            entry["achieved_flops_per_s"] = int(
                cost.get("flops", 0) / mean_s
            )
        dispatch[f"b{length}/p{phase}"] = entry
    # Roofline-style self-normalization: each (bucket, phase)'s achieved
    # bytes/s against the best achieved anywhere in the run — a program
    # far below 1.0 is stalling on something other than memory bandwidth.
    best = max(
        (
            e["achieved_bytes_per_s"]
            for e in dispatch.values()
            if "achieved_bytes_per_s" in e
        ),
        default=0,
    )
    if best > 0:
        for e in dispatch.values():
            if "achieved_bytes_per_s" in e:
                e["utilization_vs_best"] = round(
                    e["achieved_bytes_per_s"] / best, 4
                )
    report: Dict[str, object] = {
        "cost_fingerprint": PROFILER.cost_fingerprint(),
        "cost_model": PROFILER.cost_entries(),
        "dispatch": dispatch,
        "top_dispatches": PROFILER.top_dispatches(),
    }
    lockstep = lockstep_decomposition(baseline, values)
    if lockstep is not None:
        report["lockstep"] = lockstep
    return report


# --- regression sentinel -----------------------------------------------------

#: Default sentinel workload — the JAX package's (one program family per
#: device-stat kind), small enough for a CPU run yet broad enough that a
#: flipped schedule switch moves its dispatch counts.
_SENTINEL_YAML = """
pipeline:
  - type: GopherRepetitionFilter
    dup_line_frac: 0.3
    top_n_grams: [[2, 0.25], [3, 0.28]]
    dup_n_grams: [[5, 0.15], [6, 0.16]]
  - type: GopherQualityFilter
    min_doc_words: 4
    min_stop_words: 1
    stop_words: [ "og", "the", "er", "i" ]
  - type: C4QualityFilter
    split_paragraph: false
    remove_citations: true
    filter_no_terminal_punct: true
    min_num_sentences: 1
    min_words_per_line: 2
    max_word_length: 1000
    filter_lorem_ipsum: true
    filter_javascript: true
    filter_curly_bracket: true
    filter_policy: true
"""

#: The port's trace-shaping knobs: each may change a program's launches,
#: its dispatch counts or its cost, so a baseline records them.
_TRACE_ENV_KNOBS = (
    "TEXTBLAST_DEPFUSE",
    "TEXTBLAST_FUSED",
    "TEXTBLAST_TABLE_IMPL",
    "TEXTBLAST_WIRE",
    "TEXTBLAST_HOST_TAILS",
)


def collect_sentinel_profile(
    config=None,
    buckets: Tuple[int, ...] = (256, 512),
    batch_size: int = 16,
    costs: bool = True,
    device=None,
) -> Dict[str, object]:
    """Build the sentinel profile for one config + geometry on ``device``
    (``cuda`` unless the caller asks for the CPU).

    Per (bucket, phase) program: the scan dispatch counts of one run on a
    zero batch (gates open: exact and machine-independent) and, with
    ``costs=True``, the shape-determined cost model of the cost pass."""
    import torch

    from ..config.pipeline import parse_pipeline_config
    from ..ops.pipeline import CompiledPipeline

    if config is None:
        config = parse_pipeline_config(_SENTINEL_YAML)
    pipeline = CompiledPipeline(
        config, buckets=tuple(buckets), batch_size=batch_size, device=device
    )
    fp = None
    table: Dict[str, Dict[str, int]] = {}
    if costs:
        was = PROFILER.enabled
        PROFILER.configure()
        try:
            pipeline.register_program_costs(include_split_rows=False)
            table = PROFILER.cost_table()
            fp = PROFILER.cost_fingerprint()
        finally:
            PROFILER.enabled = was
    programs: Dict[str, object] = {}
    for length, phase, rows in pipeline._warmup_jobs(include_split_rows=False):
        pk = program_key(length, phase, rows)
        entry: Dict[str, object] = {
            "dispatch_counts": dict(
                sorted(pipeline.scan_dispatch_counts(length, phase, rows).items())
            )
        }
        if pk in table:
            entry["cost"] = table[pk]
        programs[pk] = entry
    return {
        "schema": SENTINEL_SCHEMA,
        "torch": torch.__version__,
        "device": pipeline.device.type,
        "buckets": list(buckets),
        "batch_size": int(batch_size),
        "env": {
            k: os.environ.get(k, "")
            for k in (*_TRACE_ENV_KNOBS, *_SCHEDULING_ENV_KNOBS)
        },
        "cost_fingerprint": fp,
        "programs": programs,
    }


def compare_profiles(
    base: Dict[str, object],
    current: Dict[str, object],
    warn_tol: float = 0.01,
    fail_tol: float = 0.05,
) -> Tuple[str, List[str]]:
    """Diff two sentinel profiles.  Returns ``(status, findings)`` with
    status "pass" / "warn" / "fail".

    Dispatch counts are exact: any difference fails, naming the drifted
    (bucket, phase) entries.  Cost fields get relative tolerance bands:
    within ``warn_tol`` passes silently, within ``fail_tol`` warns,
    beyond fails.  A program present on only one side fails."""
    findings: List[str] = []
    status = "pass"

    def worse(new: str) -> None:
        nonlocal status
        order = {"pass": 0, "warn": 1, "fail": 2}
        if order[new] > order[status]:
            status = new

    base_programs = dict(base.get("programs", {}))
    cur_programs = dict(current.get("programs", {}))
    for pk in sorted(set(base_programs) | set(cur_programs)):
        b, c = base_programs.get(pk), cur_programs.get(pk)
        if b is None or c is None:
            worse("fail")
            findings.append(
                f"FAIL {pk}: program {'appeared' if b is None else 'vanished'}"
            )
            continue
        bc = dict(b.get("dispatch_counts", {}))
        cc = dict(c.get("dispatch_counts", {}))
        if bc != cc:
            worse("fail")
            findings.append(
                f"FAIL {pk}: dispatch counts drifted {bc} -> {cc}"
            )
        b_cost = b.get("cost")
        c_cost = c.get("cost")
        if not b_cost or not c_cost:
            continue  # counts-only side: cost bands don't apply
        for field in COST_FIELDS:
            bv = int(b_cost.get(field, 0))
            cv = int(c_cost.get(field, 0))
            if bv == cv:
                continue
            rel = abs(cv - bv) / max(1, abs(bv))
            if rel > fail_tol:
                worse("fail")
                findings.append(
                    f"FAIL {pk}: {field} {bv} -> {cv} "
                    f"({rel:+.2%} > fail tolerance {fail_tol:.2%})"
                )
            elif rel > warn_tol:
                worse("warn")
                findings.append(
                    f"WARN {pk}: {field} {bv} -> {cv} "
                    f"({rel:+.2%} > warn tolerance {warn_tol:.2%})"
                )
    b_fp = base.get("cost_fingerprint")
    c_fp = current.get("cost_fingerprint")
    if b_fp and c_fp and b_fp != c_fp and status == "pass":
        # Every field inside tolerance but the table is not bit-identical:
        # surface it without failing.
        findings.append(
            f"NOTE cost fingerprint drifted within tolerance: "
            f"{b_fp[:12]} -> {c_fp[:12]}"
        )
    return status, findings


#: Scheduling-only knobs the drift note also names: they must NEVER change
#: per-(bucket, phase) dispatch counts, so they are not trace-shaping — but
#: if counts ever drift with one set, the note points straight at it.
_SCHEDULING_ENV_KNOBS = (
    "TEXTBLAST_SPECULATE",
    "TEXTBLAST_NO_OVERLAP",
    "TEXTBLAST_STAGE_DEADLINE_S",
    "TEXTBLAST_EVENTS",
    "TEXTBLAST_SLO",
)


def _env_drift_note(base: Dict[str, object]) -> List[str]:
    """Informational lines when the check environment's trace-shaping
    knobs differ from the baseline's record — the usual root cause when
    dispatch counts drift (e.g. TEXTBLAST_DEPFUSE=off).  Scheduling knobs
    absent from a baseline compare against "" (their recorded-empty
    default)."""
    notes = []
    env = dict(base.get("env", {}))
    for k in _SCHEDULING_ENV_KNOBS:
        env.setdefault(k, "")
    for k, bv in sorted(env.items()):
        cv = os.environ.get(k, "")
        if cv != bv:
            notes.append(f"NOTE env {k}={cv!r} (baseline recorded {bv!r})")
    return notes


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m textblaster_tpu_torch.utils.profiler",
        description=(
            "Machine-independent perf-regression sentinel: record or check "
            "the per-program cost fingerprint + scan dispatch counts."
        ),
    )
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument(
        "--baseline", metavar="OUT.JSON",
        help="Profile the sentinel workload and write the baseline profile",
    )
    mode.add_argument(
        "--check", metavar="BASELINE.JSON",
        help="Re-profile and diff against a recorded baseline (the JAX "
             "package's baseline: dispatch counts only)",
    )
    ap.add_argument(
        "--config", default=None,
        help="Pipeline YAML (default: the embedded sentinel workload)",
    )
    ap.add_argument("--buckets", default="256,512")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--warn-tol", type=float, default=0.01)
    ap.add_argument("--fail-tol", type=float, default=0.05)
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="Where the programs run (default cuda); the counts and the "
             "fingerprint are the same on both",
    )
    ap.add_argument(
        "--counts-only", action="store_true",
        help="With --check: diff only the dispatch counts",
    )
    args = ap.parse_args(argv)

    if args.check and not os.path.exists(args.check):
        print(
            f"SKIP: no baseline at {args.check} — generate one with "
            f"--baseline {args.check}"
        )
        return 0

    # The wire's default differs by device; pinning it keeps the argument
    # bytes, and the fingerprint, device-independent.  setdefault so a
    # deliberate TEXTBLAST_WIRE=cp32 stays visible to the check.
    os.environ.setdefault("TEXTBLAST_WIRE", "u16")

    # Honor the watchdog env knob (scheduling-only: the counts must not
    # move with it armed).
    from ..resilience.watchdog import WATCHDOG

    WATCHDOG.configure_from_env()

    config = None
    if args.config:
        from ..config.pipeline import load_pipeline_config

        config = load_pipeline_config(args.config)
    buckets = tuple(
        sorted(int(x) for x in args.buckets.split(",") if x.strip())
    )
    batch = int(args.batch_size)

    if args.baseline:
        profile = collect_sentinel_profile(
            config, buckets=buckets, batch_size=batch, costs=True,
            device=args.device,
        )
        parent = os.path.dirname(os.path.abspath(args.baseline))
        os.makedirs(parent, exist_ok=True)
        with open(args.baseline, "w", encoding="utf-8") as f:
            json.dump(profile, f, indent=2, sort_keys=True)
            f.write("\n")
        print(
            f"BASELINE {args.baseline}: {len(profile['programs'])} programs, "
            f"cost fingerprint {str(profile['cost_fingerprint'])[:12]}"
        )
        return 0

    with open(args.check, "r", encoding="utf-8") as f:
        base = json.load(f)
    foreign = base.get("schema") == JAX_SENTINEL_SCHEMA
    if base.get("schema") != SENTINEL_SCHEMA and not foreign:
        print(
            f"FAIL: baseline schema {base.get('schema')!r} != "
            f"{SENTINEL_SCHEMA!r} — regenerate with --baseline"
        )
        return 1
    buckets = tuple(base.get("buckets", buckets))
    batch = int(base.get("batch_size", batch))
    # Two-stage check: the dispatch counts are cheap — if they already
    # drifted, fail before the cost pass.
    counts_only = collect_sentinel_profile(
        config, buckets=buckets, batch_size=batch, costs=False,
        device=args.device,
    )
    status, findings = compare_profiles(
        base, counts_only, args.warn_tol, args.fail_tol
    )
    if status == "fail":
        findings.append(
            "NOTE cost comparison skipped: dispatch counts already failed"
        )
    elif foreign:
        findings.append(
            f"NOTE cost comparison skipped: the baseline is the JAX "
            f"package's ({JAX_SENTINEL_SCHEMA}); its XLA cost fields are not "
            "comparable with the port's shape model, so dispatch counts only"
        )
    elif args.counts_only:
        findings.append("NOTE cost comparison skipped: --counts-only")
    else:
        full = collect_sentinel_profile(
            config, buckets=buckets, batch_size=batch, costs=True,
            device=args.device,
        )
        status, findings = compare_profiles(
            base, full, args.warn_tol, args.fail_tol
        )
    if status != "pass":
        findings.extend(_env_drift_note(base))
    for line in findings:
        print(line)
    n = len(base.get("programs", {}))
    print(
        f"{status.upper()}: {n} programs checked against {args.check} "
        f"(warn tol {args.warn_tol:.2%}, fail tol {args.fail_tol:.2%})"
    )
    return 1 if status == "fail" else 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    import sys

    # Under ``python -m`` this file runs as ``__main__`` — a SECOND module
    # instance with its own PROFILER singleton, distinct from the one the
    # pipeline seams import.  Delegate to the canonical module so
    # configure() arms the instance the cost pass records into.
    from textblaster_tpu_torch.utils.profiler import main as _main

    sys.exit(_main())
