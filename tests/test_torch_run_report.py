"""The port's run report and end-of-run summaries against the JAX package's,
on the CPU.

* ``build_run_report`` gives equal dicts in both packages from the same
  seeded ``values`` and ``baseline`` (the sections of layers the port does
  not have yet in the JAX package's "off" shape), and the stage, occupancy
  and funnel summaries give equal text from the same counters.
* On a 60-document Parquet file, through each package's CLI:
  - the port's ``--backend host`` counter deltas (``worker_*``,
    ``producer_*``, ``filter_dropped_total_*``) equal the JAX package's
    ``--backend host`` run's;
  - the port's device path on ``--device cpu`` drops the same documents
    per step as the JAX host run, and its funnel sums to its excluded rows;
  - the summary line is the JAX package's, but for the times;
  - the ``--run-report`` file has schema v4, the run's counts, its funnel
    and occupancy, and the JAX package's sections and provenance keys.
"""

import contextlib
import io
import json
import logging
import re

import numpy as np
import pyarrow.parquet as pq
import pytest

from textblaster_tpu.cli import main as jax_main
from textblaster_tpu.utils import metrics as jm
from textblaster_tpu.utils import profiler as jax_profiler
from textblaster_tpu_torch.cli import main as port_main
from textblaster_tpu_torch.utils import metrics as pm

from test_torch_pipeline import _write_parquet, make_corpus

pytestmark = pytest.mark.torch_port

CONFIG = "configs/pipeline_config_offline.yaml"
FILTERS = ("LanguageDetectionFilter", "GopherRepetitionFilter", "GopherQualityFilter",
           "C4QualityFilter", "FineWebQualityFilter")


@pytest.fixture
def jax_profiler_off(monkeypatch):
    """The JAX package's profiler as a process that never enabled it (an
    earlier test in the same worker may have)."""
    monkeypatch.setattr(jax_profiler, "PROFILER", jax_profiler.Profiler())


def _values(rng, scale):
    """A flat snapshot with every family a report reads."""
    v = {name: float(np.round(rng.uniform(0, 9) * scale, 3)) for name in jm.STAGE_COUNTERS}
    v["occupancy_device_batches_total"] = float(rng.integers(1, 50) * scale)
    v["occupancy_padded_lanes_total"] = float(rng.integers(10_000, 90_000) * scale)
    v["occupancy_real_codepoints_total"] = float(rng.integers(1_000, 9_000) * scale)
    for length in (512, 2048, 8192):
        v[jm.OCCUPANCY_BUCKET_PREFIX + str(length)] = float(rng.integers(0, 20) * scale)
    for name in FILTERS:
        v[jm.FILTER_DROP_PREFIX + name] = float(rng.integers(0, 30) * scale)
    for name in ("resilience_retries_total", "resilience_ladder_split_total",
                 "deadletter_rows_total", "watchdog_stalls_total",
                 "multihost_negotiated_depth"):
        v[name] = float(rng.integers(0, 5) * scale)
    v[jm.EVENT_KIND_PREFIX + "breaker_trip"] = float(rng.integers(0, 3) * scale)
    v["events_emitted_total"] = float(rng.integers(0, 9) * scale)
    for fam in ("doc_latency_e2e_seconds", "doc_latency_write_seconds"):
        count = 0
        for us in rng.integers(1, 10**6, size=5):
            idx = jm.hdr_bucket_index(int(us))
            v[f"{fam}::h{idx}"] = v.get(f"{fam}::h{idx}", 0.0) + scale
            count += 1
        v[f"{fam}::sum"] = float(rng.integers(10, 10**6) * scale)
        v[f"{fam}::count"] = float(count * scale)
    hist = "worker_task_processing_duration_seconds"
    for i in range(len(jm._DEFAULT_BUCKETS) + 1):
        v[f"{hist}::b{i}"] = float(rng.integers(0, 6) * scale)
    v[f"{hist}::count"] = sum(v[f"{hist}::b{i}"] for i in range(len(jm._DEFAULT_BUCKETS) + 1))
    v[f"{hist}::sum"] = float(np.round(rng.uniform(0, 5) * scale, 4))
    return v


@pytest.mark.parametrize("seed", range(4))
def test_build_run_report_is_equal_from_the_same_values(seed, jax_profiler_off):
    rng = np.random.default_rng(seed)
    values = _values(rng, 2)
    baseline = {k: v / 2 for k, v in _values(np.random.default_rng(seed), 1).items()
                if rng.random() < 0.5}
    kw = dict(
        values=values,
        baseline=baseline if seed % 2 else None,
        wall_time_s=float(rng.uniform(1, 100)),
        counts={"received": 60, "success": 44, "filtered": 16},
        provenance={"entry": "test", "seed": seed},
        hosts=[{"process": 0}] if seed == 3 else None,
    )
    want = jm.build_run_report(**kw)
    got = pm.build_run_report(**kw)
    assert got == want
    assert got["schema"] == "textblaster-run-report/v4"
    assert got["device_profile"] == {"cost_fingerprint": None, "cost_model": {},
                                     "dispatch": {}, "top_dispatches": []}
    assert got["slo"] == {}
    assert got["latency"]["stages"]  # the HDR families decoded


@pytest.mark.parametrize("summary", ["stage", "occupancy", "funnel"])
def test_summaries_are_equal_from_the_same_counters(summary, monkeypatch):
    rng = np.random.default_rng(7)
    values = _values(rng, 1)
    text = []
    for mod in (jm, pm):
        reg = mod.Metrics()
        monkeypatch.setattr(mod, "METRICS", reg)
        baseline = {k: v / 4 for k, v in values.items()} if summary != "stage" else None
        for k, v in values.items():
            if "::" not in k:
                reg.set(k, v)
        if summary == "stage":
            text.append(mod.format_stage_summary(baseline))
        elif summary == "occupancy":
            text.append(mod.format_occupancy_summary(baseline))
        else:
            text.append(mod.format_funnel_summary(baseline, order=list(FILTERS[::-1])))
    assert text[0] == text[1]
    assert text[1].splitlines()[0].startswith(
        {"stage": "Stage breakdown", "occupancy": "Device occupancy",
         "funnel": "Filter funnel"}[summary])


# --- one 60-document file through both CLIs ---------------------------------------------


def _cli(main, argv, reg):
    """``main(argv)`` with stdout and stderr captured, the root logger's
    handlers restored after (the CLI sets up logging), and the registry's
    deltas over the run."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    before = reg.all_values()
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        for h in handlers:
            if h not in root.handlers:
                root.addHandler(h)
        root.setLevel(level)
    now = reg.all_values()
    delta = {k: now[k] - before.get(k, 0.0) for k in now if now[k] != before.get(k, 0.0)}
    return rc, out.getvalue(), err.getvalue(), delta


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli60")
    inp = tmp / "in.parquet"
    _write_parquet(inp, make_corpus(60, seed=11))
    got = {}
    for tag, main, reg, extra in (
        ("jax_host", jax_main, jm.METRICS, ["--backend", "host"]),
        ("port_host", port_main, pm.METRICS, ["--backend", "host"]),
        ("port_device", port_main, pm.METRICS,
         ["--device", "cpu", "--buckets", "512,2048", "--device-batch", "16"]),
    ):
        d = tmp / tag
        argv = ["run", "-i", str(inp), "-c", CONFIG, "-o", str(d / "kept.parquet"),
                "-e", str(d / "excl.parquet"), "--run-report", str(d / "report.json"),
                *extra]
        rc, out, err, delta = _cli(main, argv, reg)
        assert rc == 0, err
        got[tag] = {
            "out": out, "err": err, "delta": delta, "dir": str(d),
            "report": json.loads((d / "report.json").read_text()),
            "excluded": pq.read_table(str(d / "excl.parquet")).num_rows,
            "kept": pq.read_table(str(d / "kept.parquet")).num_rows,
        }
    return got


def _host_counters(delta):
    keep = ("worker_", "producer_", jm.FILTER_DROP_PREFIX)
    return {k: v for k, v in delta.items()
            if k.startswith(keep) and ("::" not in k or k.endswith("::count"))}


def test_host_run_counter_deltas_equal_the_jax_packages(runs):
    want = _host_counters(runs["jax_host"]["delta"])
    got = _host_counters(runs["port_host"]["delta"])
    assert got == want
    assert got["producer_results_received_total"] == 60
    assert got["worker_task_processing_duration_seconds::count"] == 60
    assert 0 < got["producer_results_filtered_total"] < 60


def test_device_run_funnel_equals_the_jax_host_run(runs):
    want = {k: v for k, v in runs["jax_host"]["delta"].items()
            if k.startswith(jm.FILTER_DROP_PREFIX)}
    got = {k: v for k, v in runs["port_device"]["delta"].items()
           if k.startswith(jm.FILTER_DROP_PREFIX)}
    assert got == want
    assert sum(got.values()) == runs["port_device"]["excluded"] == runs["jax_host"]["excluded"]
    funnel = runs["port_device"]["report"]["funnel"]
    assert funnel["dropped_total"] == runs["port_device"]["excluded"]
    assert sum(funnel["per_filter_dropped"].values()) == funnel["dropped_total"]


def _masked(run):
    line = run["out"].splitlines()[0]
    line = line.replace(run["dir"], "<dir>")
    return re.sub(r"in \d+\.\d\ds \(\d+\.\d docs/sec\)", "in <t>s (<r> docs/sec)", line)


def test_summary_line_is_the_jax_packages_but_for_times(runs):
    want = _masked(runs["jax_host"])
    assert want.startswith("Processed 60 documents in <t>s (<r> docs/sec): ")
    assert _masked(runs["port_host"]) == want
    assert _masked(runs["port_device"]) == want
    # The tail: the stage and funnel summaries on stderr, then the report.
    for tag in ("port_host", "port_device"):
        err = runs[tag]["err"]
        assert "Stage breakdown (wall seconds inside each stage):" in err
        assert "Filter funnel (" in err
        assert err.rstrip().endswith(f"Run report -> {runs[tag]['dir']}/report.json")
    assert "Device occupancy: " in runs["port_device"]["err"]


def test_run_report_has_schema_v4_and_the_runs_numbers(runs):
    want, got = runs["jax_host"]["report"], runs["port_device"]["report"]
    assert got["schema"] == want["schema"] == "textblaster-run-report/v4"
    assert list(got) == list(want)
    assert set(got["config"]) == set(want["config"]) | {"device"}
    assert got["config"]["backend"] == "device" and got["config"]["device"] == "cpu"
    assert got["config"]["steps"] == list(FILTERS)
    assert got["counts"] == {"received": 60, "success": runs["port_device"]["kept"],
                             "filtered": runs["port_device"]["excluded"],
                             "errors": 0, "read_errors": 0}
    assert got["counts"] == want["counts"]
    occ = got["occupancy"]
    assert occ["device_batches"] > 0
    assert occ["device_batches"] == sum(occ["per_bucket_dispatches"].values())
    assert 0 < occ["real_codepoints"] < occ["padded_lanes"]
    assert got["stages"]["stages_s"]["stage_post_seconds"] > 0
    assert got["stages"]["verdict"] in ("host-bound", "device-bound", "balanced")
    assert runs["port_host"]["report"]["occupancy"]["device_batches"] == 0
