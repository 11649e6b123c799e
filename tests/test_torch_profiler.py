"""The port's profiler (``textblaster_tpu_torch/utils/profiler.py``) against
the JAX package's, on the CPU.

* The same seeded cost and dispatch sequence gives the same
  ``device_profile`` report, top-K table and fingerprint in both packages;
  the two-host HDR merge, ``compare_profiles`` and
  ``lockstep_decomposition`` agree case by case.
* The port's dispatch counts for the sentinel's four programs equal the
  JAX package's checked-in baseline (``profiles/sentinel_baseline.json``),
  and under a flipped schedule switch equal the JAX package's
  ``scan_dispatch_counts`` (one ``eval_shape``, no compile).
* The cost pass: one fingerprint for one geometry, another for another,
  nothing of the run's accounting moved, the port's own baseline
  (``profiles/sentinel_baseline_torch.json``) passing its full check.
* ``ops/cost.py`` gives the kernel table's bounds; ``run --profile`` on the
  CPU writes the unprofiled run's files and a filled ``device_profile``
  section.
"""

import contextlib
import copy
import io
import json
import logging
import os
import threading

import numpy as np
import pytest
import torch

from textblaster_tpu.utils import metrics as jm
from textblaster_tpu.utils import profiler as jp
from textblaster_tpu_torch.cli import main as port_main
from textblaster_tpu_torch.config.pipeline import load_pipeline_config, parse_pipeline_config
from textblaster_tpu_torch.ops import cost, scan, stats
from textblaster_tpu_torch.ops.pipeline import CompiledPipeline
from textblaster_tpu_torch.utils import metrics as pm
from textblaster_tpu_torch.utils import profiler as pp

from test_torch_pipeline import _write_parquet, make_corpus, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BASELINE = os.path.join(ROOT, "profiles", "sentinel_baseline.json")
TORCH_BASELINE = os.path.join(ROOT, "profiles", "sentinel_baseline_torch.json")
CONFIG = os.path.join(ROOT, "configs", "pipeline_config_offline.yaml")
SCHEDULE_KNOBS = ("TEXTBLAST_DEPFUSE", "TEXTBLAST_FUSED", "TEXTBLAST_TABLE_IMPL")


@pytest.fixture(autouse=True)
def port_profiler_reset(monkeypatch):
    """Each test starts from the default schedule and u16 wire pin unset,
    and leaves the port's PROFILER disarmed with no captured state (a later
    run report in the same worker reads it)."""
    for k in SCHEDULE_KNOBS + ("TEXTBLAST_WIRE",):
        monkeypatch.delenv(k, raising=False)
    yield
    pp.PROFILER.configure()
    pp.PROFILER.close()


@pytest.fixture
def fresh(monkeypatch):
    """Fresh profilers and registries in both packages."""
    for mod, metrics in ((jp, jm), (pp, pm)):
        monkeypatch.setattr(mod, "PROFILER", mod.Profiler())
        monkeypatch.setattr(mod, "METRICS", metrics.Metrics())


def _sequence(seed):
    """A seeded record_program_cost / record_dispatch sequence."""
    rng = np.random.default_rng(seed)
    costs, dispatches = [], []
    for length in (256, 512, 2048):
        for phase in range(2):
            for rows in (16, 8):
                cost_ = {f: int(rng.integers(1, 10**9)) for f in pp.COST_FIELDS}
                costs.append((length, phase, rows, cost_ if rng.random() < 0.9 else None))
    for _ in range(40):
        length = int(rng.choice([256, 512, 2048, 8192]))
        dispatches.append((length, int(rng.integers(0, 2)), int(rng.choice([16, 8])),
                           float(rng.uniform(0, 0.3))))
    return costs, dispatches


@pytest.mark.parametrize("seed", range(3))
def test_report_is_the_jax_packages_from_the_same_sequence(seed, fresh):
    costs, dispatches = _sequence(seed)
    infos = []
    for mod in (jp, pp):
        mod.PROFILER.configure(top_k=5)
        for length, phase, rows, c in costs:
            mod.PROFILER.record_program_cost(length, phase, rows, c, "shape-model")
        infos.append([mod.PROFILER.record_dispatch(*d) for d in dispatches])
    assert infos[0] == infos[1]
    assert pp.device_profile_report() == jp.device_profile_report()
    assert pp.PROFILER.top_dispatches() == jp.PROFILER.top_dispatches()
    assert len(pp.PROFILER.top_dispatches()) == 5
    assert pp.PROFILER.cost_fingerprint() == jp.PROFILER.cost_fingerprint() is not None
    assert pp.METRICS.render() == jp.METRICS.render()


def test_two_host_hdr_merge_matches_single_registry():
    fam = pp.device_time_family(256, 0)
    host_a, host_b, single = pm.Metrics(), pm.Metrics(), pm.Metrics()
    for us in (120, 3_500, 80_000):
        host_a.observe_hdr(fam, us)
        single.observe_hdr(fam, us)
    for us in (90, 5_000):
        host_b.observe_hdr(fam, us)
        single.observe_hdr(fam, us)
    merged = {}
    for vals in (host_a.all_values(), host_b.all_values()):
        for k, v in vals.items():
            merged[k] = merged.get(k, 0) + v
    rep_merged = pp.device_profile_report(values=merged)
    rep_single = pp.device_profile_report(values=single.all_values())
    assert rep_merged["dispatch"] == rep_single["dispatch"]
    assert rep_merged["dispatch"]["b256/p0"]["count"] == 5
    assert rep_merged["dispatch"]["b256/p0"]["p99_s"] >= 0.08


def _profile(counts, cost_=None):
    entry = {"dispatch_counts": dict(counts)}
    if cost_ is not None:
        entry["cost"] = dict(cost_)
    return {"cost_fingerprint": "f" * 64, "programs": {"b256/p0/r8": entry}}


# (base, current, kwargs): the JAX package's cases (tests/test_profiler.py).
COMPARE_CASES = {
    "identical": (_profile({"fused": 5}, {"flops": 1000}),
                  _profile({"fused": 5}, {"flops": 1000}), {}),
    "warn_band": (_profile({"fused": 5}, {"flops": 1000}),
                  _profile({"fused": 5}, {"flops": 1030}), dict(warn_tol=0.01, fail_tol=0.05)),
    "fail_band": (_profile({"fused": 5}, {"flops": 1000}),
                  _profile({"fused": 5}, {"flops": 1100}), dict(warn_tol=0.01, fail_tol=0.05)),
    "count_drift": (_profile({"fused": 5}), _profile({"fused": 2, "lax_scan": 10}), {}),
    "missing_program": (_profile({"fused": 5}), dict(_profile({"fused": 5}), programs={}), {}),
    "counts_only_side": (_profile({"fused": 5}, {"flops": 1000}), _profile({"fused": 5}), {}),
    "fingerprint_within_tolerance": (
        _profile({"fused": 5}, {"flops": 1000}),
        dict(_profile({"fused": 5}, {"flops": 1000}), cost_fingerprint="e" * 64), {}),
    "launches_field": (_profile({"fused": 5}, {"flops": 1000, "launches": 8}),
                       _profile({"fused": 5}, {"flops": 1000, "launches": 9}), {}),
}


@pytest.mark.parametrize("case", list(COMPARE_CASES))
def test_compare_profiles_is_the_jax_packages(case):
    base, cur, kw = COMPARE_CASES[case]
    got = pp.compare_profiles(base, cur, **kw)
    if case == "launches_field":
        # A field the JAX package does not carry: the port's bands apply.
        assert got[0] == "fail" and any("launches 8 -> 9" in f for f in got[1])
        return
    assert got == jp.compare_profiles(base, cur, **kw)
    assert got[0] == {"identical": "pass", "warn_band": "warn", "fail_band": "fail",
                      "count_drift": "fail", "missing_program": "fail",
                      "counts_only_side": "pass",
                      "fingerprint_within_tolerance": "pass"}[case]


@pytest.mark.parametrize("seed", range(4))
def test_lockstep_decomposition_is_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    names = ("multihost_lockstep_seconds_total", "multihost_window_stall_seconds_total",
             "stage_device_wait_seconds", "multihost_exchange_post_seconds_total")
    values = {n: float(rng.uniform(0, 50)) for n in names}
    if seed == 0:
        values["multihost_lockstep_seconds_total"] = 0.0  # no lockstep loop ran
    baseline = {n: v * float(rng.uniform(0, 0.5)) for n, v in values.items()} if seed % 2 else None
    got = pp.lockstep_decomposition(baseline, values)
    assert got == jp.lockstep_decomposition(baseline, values)
    assert (got is None) == (seed == 0)
    assert pp.lockstep_decomposition() is None  # the port's own registry: never


def _sentinel(capsys, argv):
    rc = pp.main(argv)
    return rc, capsys.readouterr().out


def test_sentinel_counts_equal_the_jax_baseline(capsys, monkeypatch, one_torch_thread):
    monkeypatch.setenv("TEXTBLAST_WIRE", "u16")  # main() pins it; undone after
    with open(JAX_BASELINE) as f:
        base = json.load(f)
    got = pp.collect_sentinel_profile(costs=False, device="cpu")
    assert {pk: p["dispatch_counts"] for pk, p in got["programs"].items()} == {
        pk: p["dispatch_counts"] for pk, p in base["programs"].items()}
    assert sorted(got["programs"]) == ["b256/p0/r16", "b256/p1/r16", "b512/p0/r16",
                                       "b512/p1/r16"]
    rc, out = _sentinel(capsys, ["--check", JAX_BASELINE, "--counts-only", "--device", "cpu"])
    assert rc == 0, out
    assert out.strip().splitlines()[-1].startswith("PASS")
    assert "not comparable" in out


def test_sentinel_check_fails_on_depfuse_off(capsys, monkeypatch, one_torch_thread):
    monkeypatch.setenv("TEXTBLAST_WIRE", "u16")
    monkeypatch.setenv("TEXTBLAST_DEPFUSE", "off")
    rc, out = _sentinel(capsys, ["--check", JAX_BASELINE, "--counts-only", "--device", "cpu"])
    assert rc == 1, out
    assert "dispatch counts drifted" in out
    assert "FAIL b256/p0/r16" in out
    assert "TEXTBLAST_DEPFUSE" in out  # the env drift note


@pytest.mark.parametrize("knob", ["TEXTBLAST_DEPFUSE", "TEXTBLAST_FUSED"])
def test_flipped_schedule_counts_equal_the_jax_packages(knob, monkeypatch, one_torch_thread):
    from textblaster_tpu.config.pipeline import parse_pipeline_config as jax_parse
    from textblaster_tpu.ops.pipeline import CompiledPipeline as JaxPipeline

    monkeypatch.setenv(knob, "off")
    monkeypatch.setenv("TEXTBLAST_PALLAS_INTERPRET", "1")
    jax_pipe = JaxPipeline(jax_parse(jp._SENTINEL_YAML), buckets=(256,), batch_size=16)
    want = jax_pipe.scan_dispatch_counts(256, 0, 16)
    port_pipe = CompiledPipeline(parse_pipeline_config(pp._SENTINEL_YAML), buckets=(256,),
                                 batch_size=16, device="cpu")
    got = port_pipe.scan_dispatch_counts(256, 0, 16)
    assert got == want
    assert "lax_scan" in got  # the schedule really moved


def test_counting_scope_is_thread_local(one_torch_thread):
    x = torch.ones((2, 8), dtype=torch.int32)
    groups = [scan.add_group((x,))]
    seen = {}
    with scan.count_scan_dispatches() as counts:
        t = threading.Thread(target=lambda: seen.update(r=scan.fused_scan(groups)))
        t.start()
        t.join()
        assert dict(counts) == {} and counts.launches == []
        scan.fused_scan(groups)
    assert dict(counts) == {"fused": 1}
    assert [k for k, _, _ in counts.launches] == [("fused_scan", 2, 8)]
    assert not scan.gates_open()


def _pipe(buckets=(256, 512), batch=16):
    return CompiledPipeline(parse_pipeline_config(pp._SENTINEL_YAML), buckets=buckets,
                            batch_size=batch, device="cpu")


def test_cost_pass_fingerprint_is_shape_determined(monkeypatch, one_torch_thread):
    monkeypatch.setenv("TEXTBLAST_WIRE", "u16")
    pipe = _pipe()
    fps = []
    for _ in range(2):
        pp.PROFILER.configure()
        launches = pipe.register_program_costs(include_split_rows=False)
        fps.append(pp.PROFILER.cost_fingerprint())
        assert set(launches) == set(pp.PROFILER.cost_table())
    assert fps[0] == fps[1] is not None
    with open(TORCH_BASELINE) as f:
        assert fps[0] == json.load(f)["cost_fingerprint"]  # recorded under u16
    table = pp.PROFILER.cost_table()
    for pk, c in table.items():
        assert c["launches"] == sum(launches[pk].values()) > 0
        assert c["bytes_accessed"] > c["argument_bytes"] + c["output_bytes"]
        assert c["argument_bytes"] == 16 * int(pk.split("/")[0][1:]) * 2 + 16 * 4
        assert pp.PROFILER.cost_entries()[pk]["source"] == "shape-model"
    pp.PROFILER.configure()
    _pipe(buckets=(256, 1024)).register_program_costs(include_split_rows=False)
    assert pp.PROFILER.cost_fingerprint() not in (None, fps[0])


def test_cost_pass_moves_none_of_the_runs_accounting(one_torch_thread):
    pipe = _pipe(batch=24)
    before = copy.deepcopy(pipe.counters)
    occupancy = pm.occupancy_snapshot()
    launches = {**scan.LAUNCHES}
    pp.PROFILER.configure()
    costed = pipe.register_program_costs()
    # Geometry rows and the split rung's (24 -> 16) for both buckets, both phases.
    assert sorted(costed) == sorted(f"b{b}/p{p}/r{r}" for b in (256, 512) for p in (0, 1)
                                    for r in (24, 16))
    assert pipe.counters == before
    assert pm.occupancy_snapshot() == occupancy
    assert scan.LAUNCHES == launches
    # A second pass skips what the PROFILER already holds.
    assert pipe.register_program_costs() == {}


def test_torch_baseline_passes_its_full_check(capsys, monkeypatch, one_torch_thread):
    monkeypatch.setenv("TEXTBLAST_WIRE", "u16")
    rc, out = _sentinel(capsys, ["--check", TORCH_BASELINE, "--device", "cpu"])
    assert rc == 0, out
    assert out.strip() == (f"PASS: 4 programs checked against {TORCH_BASELINE} "
                           "(warn tol 1.00%, fail tol 5.00%)")


def _fused_gopher_quality(shape):
    z = torch.zeros(shape, dtype=torch.int32)
    aff, add = scan.affine_group, scan.add_group
    return [aff(z, (z,)), aff(z, (z,)), aff(z, (z,)), add((z,) * 5, emit="last")]


def _chain_structure(shape):
    cps = torch.zeros(shape, dtype=torch.int32)
    mask, cls = stats._text_frame(cps, torch.zeros(shape[0], dtype=torch.int32))
    return stats._structure_passes(cps, mask, cls, True)


# PERF.md's kernel table: each row's bound at its shape.
BOUNDS = {
    "affine_scan": (lambda: cost.scan_cost("affine_scan", 64, 65536, 2), 0.0250),
    "dfa_scan": (lambda: cost.scan_cost("dfa_scan", 64, 65536, 5), 0.0100),
    "sort2": (lambda: cost.sort_cost(2, 256, 16384), 0.0200),
    "sort3": (lambda: cost.sort_cost(3, 64, 16384), 0.0075),
    "fused_scan": (lambda: cost.fused_cost(_fused_gopher_quality((64, 8192))), 0.0088),
    "chain_scan": (lambda: cost.chain_cost(_chain_structure((64, 8192))), 0.0106),
}


@pytest.mark.parametrize("kernel", list(BOUNDS))
def test_cost_model_gives_the_kernel_tables_bounds(kernel, one_torch_thread):
    model, want = BOUNDS[kernel]
    b = cost.bound(*model())
    assert round(b["bound_ms"], 4) == want
    assert b["bound_by"] == "bytes"


@contextlib.contextmanager
def _root_logger():
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        yield
    finally:
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        for h in handlers:
            if h not in root.handlers:
                root.addHandler(h)
        root.setLevel(level)


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with _root_logger(), contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_profile_on_the_cpu(tmp_path, one_torch_thread):
    inp = tmp_path / "in.parquet"
    _write_parquet(inp, make_corpus(40, seed=5))
    geo = ["--buckets", "512,2048", "--device-batch", "16"]
    runs = {}
    for name, extra in (("plain", []), ("profiled", ["--profile"])):
        files = [str(tmp_path / f"{name}_{x}.parquet") for x in ("kept", "excl")]
        report = str(tmp_path / f"{name}.json")
        rc, out, err = _cli(["run", "--device", "cpu", "-i", str(inp), "-c", CONFIG,
                             "-o", files[0], "-e", files[1], "--run-report", report,
                             *geo, *extra])
        assert rc == 0, err
        with open(report) as f:
            runs[name] = (files, json.load(f), err)
    for a, b in zip(runs["plain"][0], runs["profiled"][0]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    plain, profiled = runs["plain"][1], runs["profiled"][1]
    assert plain["device_profile"] == {"cost_fingerprint": None, "cost_model": {},
                                       "dispatch": {}, "top_dispatches": []}
    assert "Device profile:" not in runs["plain"][2]
    section = profiled["device_profile"]
    assert profiled["config"]["profile"] is True and plain["config"]["profile"] is False
    assert sum(e["count"] for e in section["dispatch"].values()) \
        == profiled["occupancy"]["device_batches"] > 0
    assert all("achieved_bytes_per_s" in e for e in section["dispatch"].values())
    assert section["top_dispatches"] and "lockstep" not in section
    fp = section["cost_fingerprint"]
    worst = section["top_dispatches"][0]
    assert (f"Device profile: cost fingerprint {fp[:12]}; slowest dispatch "
            f"{worst['seconds'] * 1e3:.1f} ms (bucket {worst['bucket']}, phase "
            f"{worst['phase']})") in runs["profiled"][2]
    # The standalone cost pass of the same config and geometry.
    pp.PROFILER.configure()
    CompiledPipeline(load_pipeline_config(CONFIG), buckets=(512, 2048), batch_size=16,
                     device="cpu").register_program_costs()
    assert pp.PROFILER.cost_fingerprint() == fp
