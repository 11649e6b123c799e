"""The port's event journal and flight recorder
(``textblaster_tpu_torch/utils/events.py``) against the JAX package's, on
the CPU, and the journal seams of the port's CLI and resilience layer.

* ``validate_record`` accepts and rejects the same records in both
  packages, with the same message; ``KINDS`` and ``SEVERITIES`` are equal.
* The same ``emit`` sequence gives equal journals (``ts_us`` masked), in
  the ring and spilled as JSONL, and the same ``events_total_<kind>`` and
  ``events_invalid_total`` deltas; ``JournalLogHandler`` mirrors warnings
  alike and skips the journal's own diagnostics.
* ``flight_record`` payloads are equal with ``ts_us`` masked (each package
  on a fresh registry), with and without the SLO engine armed.
* Every ``EVENTS.emit`` call site in the port names a kind of ``KINDS``
  with its required fields.
* The CLI: one 48-document file through ``textblast run --backend cpu``
  and the port's ``run --device cpu``, both with ``--trace``,
  ``--events-file`` and two ``--slo`` objectives, gives the same kept and
  excluded rows, the same journal (times and the backend's name masked),
  the same report ``events`` and ``slo`` sections and the same tail lines
  (numbers and paths masked).  The JAX run leaves out ``--trace-device``:
  its ``jax.profiler`` capture costs 6-40 s on the CPU and writes another
  format; the port's run with all four flags writes kept and excluded
  files byte-identical to an unarmed run's.  A failed run leaves equal
  flight records; ``TEXTBLAST_EVENTS``, ``TEXTBLAST_SLO`` and the config's
  ``slo:`` block arm the port as the flags do.
* Resilience: with the port's fault injector, the ``retry``,
  ``ladder_split``, ``retry_exhausted``, ``breaker_trip`` and
  ``watchdog_stall`` journal counts equal the port's ``METRICS`` counters.

The autouse :func:`hygiene` fixture (imported by ``test_torch_trace.py``
and ``test_torch_slo.py``) disarms both packages' ``TRACER``, ``EVENTS``
and ``SLO`` and the port's ``KERNEL_SPANS`` around every test, takes
either package's journal log handler off the root logger for the test and
gives back the root logger's handlers after, gives back the gauges the
engines set, and clears ``TEXTBLAST_EVENTS`` / ``TEXTBLAST_SLO``: all of it
outlives a test.
"""

import ast
import contextlib
import io
import json
import logging
import os
import re
from pathlib import Path

import pyarrow.parquet as pq
import pytest

import textblaster_tpu_torch.ops.pipeline as port_ops
from textblaster_tpu.cli import main as jax_main
from textblaster_tpu.utils import events as je
from textblaster_tpu.utils import metrics as jm
from textblaster_tpu.utils import slo as js
from textblaster_tpu.utils import telemetry as jtel
from textblaster_tpu.utils import trace as jt
from textblaster_tpu_torch.cli import main as port_main
from textblaster_tpu_torch.config.pipeline import parse_pipeline_config as port_parse
from textblaster_tpu_torch.data_model import TextDocument
from textblaster_tpu_torch.resilience import FAULTS, WATCHDOG
from textblaster_tpu_torch.utils import events as pe
from textblaster_tpu_torch.utils import metrics as pm
from textblaster_tpu_torch.utils import slo as ps
from textblaster_tpu_torch.utils import telemetry as ptel
from textblaster_tpu_torch.utils import trace as pt

from test_torch_pipeline import _write_parquet, make_corpus, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": (jt, je, js, jm), "port": (pt, pe, ps, pm)}
#: Gauges the engines and the pipeline set, given back after each test.
GAUGES = ("pipeline_warmup_done", "resilience_breaker_open")
GAUGE_PREFIXES = ("slo_target_", "slo_burn_rate_", "slo_budget_remaining_")


def _disarm():
    for trace, events, slo, _ in PACKAGES.values():
        trace.TRACER.close()
        trace.TRACER.drain()
        slo.SLO.reset()
        events.EVENTS.close()
        events.EVENTS.drain()
    pt.KERNEL_SPANS.enabled = False


def _gauges(reg):
    return {k: v for k, v in reg.all_values().items()
            if k in GAUGES or k.startswith(GAUGE_PREFIXES)}


@pytest.fixture(autouse=True)
def hygiene(monkeypatch):
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    # A CLI run elsewhere in the session may have left either package's
    # journal handler on the root logger; both packages start without one.
    for h in handlers:
        if isinstance(h, (je.JournalLogHandler, pe.JournalLogHandler)):
            root.removeHandler(h)
    saved = {tag: _gauges(mods[3].METRICS) for tag, mods in PACKAGES.items()}
    monkeypatch.delenv("TEXTBLAST_EVENTS", raising=False)
    monkeypatch.delenv("TEXTBLAST_SLO", raising=False)
    _disarm()
    yield
    _disarm()
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    for h in handlers:
        if h not in root.handlers:
            root.addHandler(h)
    root.setLevel(level)
    for tag, mods in PACKAGES.items():
        reg = mods[3].METRICS
        now = _gauges(reg)
        with reg._lock:
            for k in now:
                if k in saved[tag]:
                    reg._values[k] = saved[tag][k]
                else:
                    reg._values.pop(k, None)


def _fresh_registries(monkeypatch):
    """Give each package a fresh ``METRICS`` for the modules that read it
    lazily (the journal, the flight recorder and the SLO engine)."""
    for _, _, _, metrics in PACKAGES.values():
        monkeypatch.setattr(metrics, "METRICS", metrics.Metrics())


# --- the record schema -----------------------------------------------------------------------

ENVELOPE = {"seq": 1, "ts_us": 5, "rank": 0, "incarnation": 0, "epoch": 0}
RECORDS = {
    "retry": dict(ENVELOPE, kind="retry", severity="warning",
                  data={"seam": "device", "attempt": 1, "error": "OSError"}),
    "run_start": dict(ENVELOPE, kind="run_start", severity="info", data={}),
    "upgraded_severity": dict(ENVELOPE, kind="ladder_host", severity="critical",
                              data={"batch": 512, "phase": 1}),
    "extra_data": dict(ENVELOPE, kind="slo_alert", severity="error",
                       data={"key": "availability", "burn_rate": 3.0, "window_s": 60.0,
                             "budget_remaining": 0.1}),
    "missing_seq": {k: v for k, v in dict(ENVELOPE, kind="run_start", severity="info",
                                          data={}).items() if k != "seq"},
    "missing_data": {k: v for k, v in dict(ENVELOPE, kind="run_start",
                                           severity="info").items()},
    "unknown_kind": dict(ENVELOPE, kind="profile_done", severity="info", data={}),
    "bad_severity": dict(ENVELOPE, kind="run_start", severity="loud", data={}),
    "data_not_a_mapping": dict(ENVELOPE, kind="run_start", severity="info", data=[1]),
    "missing_field": dict(ENVELOPE, kind="watchdog_stall", severity="error",
                          data={"stage": "device_fetch", "elapsed_s": 1.0}),
}


def _verdict(validate, record):
    try:
        validate(dict(record))
    except ValueError as e:
        return str(e)
    return "ok"


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_validate_record_agrees(name):
    want = _verdict(je.validate_record, RECORDS[name])
    assert _verdict(pe.validate_record, RECORDS[name]) == want
    assert (want == "ok") == (name in ("retry", "run_start", "upgraded_severity", "extra_data"))


def test_vocabulary_is_the_jax_packages():
    assert pe.KINDS == je.KINDS
    assert pe.SEVERITIES == je.SEVERITIES
    assert pe.FLIGHTREC_SCHEMA == je.FLIGHTREC_SCHEMA


# --- the journal ------------------------------------------------------------------------------

EMITS = [
    ("run_start", None, dict(input="in.parquet", backend="device", num_processes=1)),
    ("retry", None, dict(seam="device", attempt=1, error="OSError")),
    ("retry", "error", dict(seam="device", attempt=2, error="OSError")),
    ("no_such_kind", None, dict(x=1)),
    ("retry", None, dict(seam="device")),
    ("run_end", "loud", dict(exit_code=0)),
    ("ladder_split", None, dict(batch=512, depth=16, phase=0)),
    ("breaker_trip", None, dict(seam="device", failures=2, cause="fell to host")),
    ("watchdog_stall", None, dict(stage="device_fetch", elapsed_s=0.25, deadline_s=0.2,
                                  detail="")),
    ("run_end", None, dict(exit_code=0)),
]


def _emit_all(events):
    for kind, severity, data in EMITS:
        events.EVENTS.emit(kind, severity, **data)


def _strip_ts(records):
    return [{k: v for k, v in r.items() if k != "ts_us"} for r in records]


def _deltas(reg, before):
    now = reg.all_values()
    return {k: now[k] - before.get(k, 0.0) for k in now
            if k.startswith("events_") and now[k] != before.get(k, 0.0)}


@pytest.mark.parametrize("spill", [False, True], ids=["ring", "spill"])
def test_same_emits_give_equal_journals(tmp_path, spill, caplog):
    got = {}
    for tag, (_, events, _, metrics) in PACKAGES.items():
        before = metrics.METRICS.all_values()
        path = str(tmp_path / f"{tag}.jsonl") if spill else None
        events.EVENTS.configure(path, ring=16)
        _emit_all(events)
        counts = events.EVENTS.counts()
        recent = events.EVENTS.recent()
        events.EVENTS.close()
        if spill:
            lines = Path(path).read_text().splitlines()
            records = [json.loads(ln) for ln in lines]
        else:
            records = events.EVENTS.drain()
        for r in records:
            events.validate_record(r)
        got[tag] = (_strip_ts(records), counts, _strip_ts(recent),
                    _deltas(metrics.METRICS, before))
    assert got["port"] == got["jax"]
    records, counts, recent, deltas = got["port"]
    assert [r["seq"] for r in recent] == list(range(1, 8))
    assert counts == {"run_start": 1, "retry": 2, "ladder_split": 1, "breaker_trip": 1,
                      "watchdog_stall": 1, "run_end": 1}
    assert deltas["events_invalid_total"] == 3 and deltas["events_emitted_total"] == 7
    assert len(records) == 7  # spilled: every line self-contained


def test_log_handler_mirrors_warnings_alike():
    got = {}
    for tag, (_, events, _, _) in PACKAGES.items():
        log = logging.getLogger(f"textblast.test.{tag}")
        handler = events.JournalLogHandler()
        log.addHandler(handler)
        try:
            log.warning("disarmed: not journaled")
            events.EVENTS.configure(None)
            log.info("below WARNING")
            log.warning("device %s slow", "batch")
            log.error("device lost")
            logging.getLogger(events.__name__).warning("own diagnostics")
            got[tag] = _strip_ts(events.EVENTS.drain())
        finally:
            log.removeHandler(handler)
    for r in got["jax"]:
        r["data"]["logger"] = r["data"]["logger"].replace(".jax", ".port")
    assert got["port"] == got["jax"]
    assert [(r["severity"], r["data"]["message"]) for r in got["port"]] == [
        ("warning", "device batch slow"), ("error", "device lost")]


@pytest.mark.parametrize("with_slo", [False, True], ids=["journal", "journal_slo"])
def test_flight_record_payloads_are_equal(tmp_path, monkeypatch, with_slo):
    _fresh_registries(monkeypatch)
    payloads = {}
    for tag, (_, events, slo, metrics) in PACKAGES.items():
        metrics.METRICS.inc("producer_results_received_total", 40)
        metrics.METRICS.inc("producer_results_error_total", 3)
        events.EVENTS.configure(None)
        if with_slo:
            slo.SLO.configure({"availability": 0.99}, start_ticker=False)
        _emit_all(events)
        path = events.flight_record(str(tmp_path / tag / "out.parquet"), rank=0,
                                    reason="pipeline_error", exc=OSError("disk gone"))
        assert path.endswith(os.path.join("out.parquet.flightrec", "rank0.json"))
        payload = json.loads(Path(path).read_text())
        payload["ts_us"] = None
        payload["events_recent"] = _strip_ts(payload["events_recent"])
        if with_slo:
            payload["slo"]["elapsed_s"] = None
        payloads[tag] = payload
        assert not os.path.exists(path + ".tmp")
    assert payloads["port"] == payloads["jax"]
    assert payloads["port"]["exception"] == {"type": "OSError", "message": "disk gone"}
    assert ("slo" in payloads["port"]) == with_slo
    assert "telemetry" not in payloads["port"]


def test_flight_record_carries_telemetry_when_on(tmp_path, monkeypatch):
    """Telemetry on: the dump holds the live rollup snapshot under
    ``telemetry``, key for key and value for value the JAX package's (one
    fake clock in both telemetry modules)."""
    _fresh_registries(monkeypatch)
    payloads = {}
    for tag, tele in (("jax", jtel), ("port", ptel)):
        _, events, _, metrics = PACKAGES[tag]
        clock = [500.0]
        monkeypatch.setattr(tele, "METRICS", metrics.METRICS)
        monkeypatch.setattr(tele, "time", type("Clock", (), {
            "perf_counter": staticmethod(lambda: clock[0])}))
        tele.TELEMETRY.configure(2, window_s=1.0, start_ticker=False)
        try:
            tele.TELEMETRY.set_geometry_baseline(0.25)
            tele.TELEMETRY.mark("read", [f"d{i}" for i in range(12)])
            clock[0] += 0.125
            tele.TELEMETRY.complete([type("Doc", (), {"id": f"d{i}"})() for i in range(6)])
            metrics.METRICS.inc("producer_results_received_total", 40)
            metrics.METRICS.inc("occupancy_padded_lanes_total", 1000)
            metrics.METRICS.inc("occupancy_real_codepoints_total", 400)
            tele.TELEMETRY.roll_window()
            events.EVENTS.configure(None)
            _emit_all(events)
            path = events.flight_record(str(tmp_path / tag / "out.parquet"), rank=0,
                                        reason="pipeline_error", exc=OSError("disk gone"))
        finally:
            tele.TELEMETRY.close()
        payload = json.loads(Path(path).read_text())
        payloads[tag] = payload["telemetry"]
    assert payloads["port"] == payloads["jax"]
    assert payloads["port"]["latency"]["stages"]["e2e"]["mean_s"] == 0.125
    assert payloads["port"]["enabled"] is True and len(payloads["port"]["windows"]) == 1
    assert payloads["port"]["sampled_docs"] == sum(ptel.doc_sampled(f"d{i}", 2)
                                                   for i in range(12))


def _emit_call_sites():
    for path in sorted((ROOT / "textblaster_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
        for node in ast.walk(tree):
            fn = getattr(node, "func", None)
            if not (isinstance(node, ast.Call) and isinstance(fn, ast.Attribute)
                    and fn.attr == "emit" and isinstance(fn.value, ast.Name)
                    and fn.value.id == "EVENTS"):
                continue
            if node.args and isinstance(node.args[0], ast.Constant):
                yield (f"{path.relative_to(ROOT)}:{node.lineno}", node.args[0].value,
                       [k.arg for k in node.keywords])


def test_every_port_emit_site_matches_the_schema():
    sites = list(_emit_call_sites())
    for where, kind, kw in sites:
        assert kind in pe.KINDS, f"{where} emits unknown kind {kind!r}"
        assert not [f for f in pe.KINDS[kind][1] if f not in kw], where
    assert {k for _, k, _ in sites} >= {
        "retry", "retry_exhausted", "breaker_trip", "breaker_probe", "breaker_recovery",
        "breaker_reopen", "ladder_split", "ladder_host", "watchdog_stall",
        "watchdog_escalation", "slo_alert", "slo_resolved", "log", "run_start", "run_end",
        "fatal"}


# --- the CLI pair -----------------------------------------------------------------------------

CLI_CONFIG = """
pipeline:
  - type: GopherQualityFilter
    min_doc_words: 60
"""
SLO_FLAGS = ["--slo", "availability=0.999", "--slo", "p99_latency_s=0.25"]
TAIL = ("Trace written -> ", "Event journal -> ", "SLO: ", "Run report -> ")


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_cli")
    inp, config = tmp / "in.parquet", tmp / "config.yaml"
    _write_parquet(inp, make_corpus(48, seed=21))
    config.write_text(CLI_CONFIG)
    common = ["--buckets", "512,2048", "--device-batch", "16"]
    plan = {
        "jax": (jax_main, ["--backend", "cpu"], True, False),
        "port": (port_main, ["--device", "cpu"], True, False),
        "port_all": (port_main, ["--device", "cpu"], True, True),
        "port_off": (port_main, ["--device", "cpu"], False, False),
    }
    runs = {}
    root = logging.getLogger()
    handlers = root.handlers[:]
    try:
        for tag, (main, backend, armed, device_trace) in plan.items():
            d = tmp / tag
            argv = ["run", "-i", str(inp), "-c", str(config), "-o", str(d / "kept.parquet"),
                    "-e", str(d / "excl.parquet"), *backend, *common]
            if armed:
                argv += ["--trace", str(d / "trace.json"), "--events-file",
                         str(d / "events.jsonl"), *SLO_FLAGS, "--run-report",
                         str(d / "report.json")]
            if device_trace:
                argv += ["--trace-device", str(d / "devtrace")]
            rc, out, err = _cli(main, argv)
            assert rc == 0, err
            assert not (jt.TRACER.enabled or je.EVENTS.enabled or js.SLO.enabled
                        or pt.TRACER.enabled or pe.EVENTS.enabled or ps.SLO.enabled)
            runs[tag] = {"dir": d, "out": out, "err": err}
        for tag, main, backend in (("jax_fail", jax_main, plan["jax"][1]),
                                   ("port_fail", port_main, plan["port"][1])):
            d = tmp / tag
            rc, out, err = _cli(main, ["run", "-i", str(tmp / "missing.parquet"), "-c",
                                       str(config), "-o", str(d / "kept.parquet"), "-e",
                                       str(d / "excl.parquet"), *backend, "--events-file",
                                       str(d / "events.jsonl")])
            assert rc == 1 and err.startswith("Pipeline run failed: ")
            runs[tag] = {"dir": d, "out": out, "err": err}
    finally:
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        for h in handlers:
            if h not in root.handlers:
                root.addHandler(h)
    return runs


def _journal(run, mask=("ts_us",)):
    recs = [json.loads(ln) for ln in (run["dir"] / "events.jsonl").read_text().splitlines()]
    for r in recs:
        pe.validate_record(r)
        for k in mask:
            r.pop(k, None)
        r["data"].pop("backend", None)  # "cpu" in the JAX package, "device" in the port
    return recs


def _rows(path):
    return sorted(map(tuple, (r.values() for r in pq.read_table(str(path)).to_pylist())))


def test_cli_rows_are_the_jax_packages_and_arming_changes_no_byte(cli_runs):
    for name in ("kept.parquet", "excl.parquet"):
        want = _rows(cli_runs["jax"]["dir"] / name)
        assert _rows(cli_runs["port"]["dir"] / name) == want
        off = (cli_runs["port_off"]["dir"] / name).read_bytes()
        for tag in ("port", "port_all"):
            assert (cli_runs[tag]["dir"] / name).read_bytes() == off, (tag, name)
    assert _rows(cli_runs["jax"]["dir"] / "kept.parquet")
    assert _rows(cli_runs["jax"]["dir"] / "excl.parquet")


def test_cli_journals_and_report_sections_are_the_jax_packages(cli_runs):
    want, got = _journal(cli_runs["jax"]), _journal(cli_runs["port"])
    assert got == want
    assert [r["kind"] for r in got] == ["run_start", "run_end"]
    reports = {t: json.loads((cli_runs[t]["dir"] / "report.json").read_text())
               for t in ("jax", "port")}
    for section in ("events", "slo"):
        assert reports["port"][section] == reports["jax"][section], section
    counts = {}
    for r in got:
        counts[r["kind"]] = counts.get(r["kind"], 0) + 1
    assert reports["port"]["events"]["by_kind"] == counts
    assert reports["port"]["slo"]["objectives"]["availability"]["events"] == 48
    for tag in ("jax", "port"):
        assert reports[tag]["config"]["events_file"] == str(cli_runs[tag]["dir"] / "events.jsonl")
    assert reports["port"]["config"]["slo"] == reports["jax"]["config"]["slo"] == {
        "availability": 0.999, "p99_latency_s": 0.25}


def _tail(run):
    lines = [ln for ln in run["err"].splitlines() if ln.startswith(TAIL)]
    lines = [ln.replace(str(run["dir"]), "<dir>") for ln in lines]
    return [re.sub(r"\d+(\.\d+)?", "<n>", ln) for ln in lines]


def test_cli_tail_lines_are_the_jax_packages(cli_runs):
    assert _tail(cli_runs["port"]) == _tail(cli_runs["jax"])
    assert [ln.split(" ")[0] for ln in _tail(cli_runs["port"])] == [
        "Trace", "Event", "SLO:", "Run"]
    summary = {t: re.sub(r"\d+\.\d+", "<t>", cli_runs[t]["out"].splitlines()[0])
               .replace(str(cli_runs[t]["dir"]), "<dir>") for t in ("jax", "port")}
    assert summary["port"] == summary["jax"]


def test_cli_trace_and_device_trace_files(cli_runs):
    spans = {}
    for tag in ("jax", "port", "port_all"):
        events = json.loads((cli_runs[tag]["dir"] / "trace.json").read_text())
        spans[tag] = {e["name"] for e in events if e["ph"] == "X"}
    assert spans["port"] == spans["jax"] == spans["port_all"]
    assert {"read", "pack", "dispatch", "device_dispatch", "device_wait", "post",
            "write"} <= spans["port"]
    dev = json.loads((cli_runs["port_all"]["dir"] / "devtrace" / pt.DEVICE_TRACE_FILE)
                     .read_text())
    assert {e["ph"] for e in dev} == {"M"}  # the CPU has no device spans
    warned = [r for r in _journal(cli_runs["port_all"]) if r["kind"] == "log"]
    assert len(warned) == 1 and "no device spans" in warned[0]["data"]["message"]


def test_failed_run_leaves_equal_flight_records(cli_runs):
    payloads = {}
    for tag in ("jax_fail", "port_fail"):
        d = cli_runs[tag]["dir"]
        payload = json.loads((d / "kept.parquet.flightrec" / "rank0.json").read_text())
        assert payload["schema"] == "textblaster-flightrec/v1"
        payload["events_recent"] = [
            {k: v for k, v in r.items() if k != "ts_us"} for r in payload["events_recent"]]
        for r in payload["events_recent"]:
            r["data"].pop("backend", None)
        payload["exception"]["message"] = payload["exception"]["message"].replace(
            str(d.parent), "<tmp>")
        payloads[tag] = {k: payload[k] for k in ("reason", "rank", "exception",
                                                  "events_recent", "events_counts")}
        assert [r["kind"] for r in _journal(cli_runs[tag])] == ["run_start", "fatal", "run_end"]
    assert payloads["port_fail"] == payloads["jax_fail"]
    assert payloads["port_fail"]["reason"] == "pipeline_error"


def test_environment_and_config_block_arm_the_port(tmp_path, monkeypatch):
    inp, config = tmp_path / "in.parquet", tmp_path / "config.yaml"
    _write_parquet(inp, make_corpus(16, seed=4))
    config.write_text(CLI_CONFIG + "slo:\n  availability: 0.99\n  p99_latency_s: 0.5\n")
    monkeypatch.setenv("TEXTBLAST_EVENTS", str(tmp_path / "env.jsonl"))
    monkeypatch.setenv("TEXTBLAST_SLO", "throughput_floor=1e-9")
    argv = ["run", "-i", str(inp), "-c", str(config), "-o", str(tmp_path / "k.parquet"),
            "-e", str(tmp_path / "e.parquet"), "--device", "cpu", "--buckets", "512,2048",
            "--run-report", str(tmp_path / "r.json"), "--quiet"]
    rc, _, err = _cli(port_main, argv)
    assert rc == 0, err
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["config"]["slo"] == {"availability": 0.99, "p99_latency_s": 0.5,
                                       "throughput_floor": 1e-9}
    assert report["config"]["events_file"] is None  # the flag's value, as in the JAX package
    kinds = [json.loads(ln)["kind"] for ln in (tmp_path / "env.jsonl").read_text().splitlines()]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    # --slo overrides the block per key and silences the environment's pairs.
    rc, _, err = _cli(port_main, argv + ["--slo", "availability=0.5"])
    assert rc == 0, err
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["config"]["slo"] == {"availability": 0.5, "p99_latency_s": 0.5}
    rc, _, err = _cli(port_main, argv + ["--slo", "latency=1"])
    assert rc == 1 and err.startswith("Invalid --slo value: unknown SLO key 'latency'")
    assert not (pe.EVENTS.enabled or ps.SLO.enabled or pt.TRACER.enabled)


# --- resilience seams -------------------------------------------------------------------------

CHAOS_CONFIG = """
pipeline:
  - type: GopherQualityFilter
    min_doc_words: 5
resilience:
  backoff_base_s: 0.0
  backoff_max_s: 0.0
  breaker_threshold: 2
overlap:
  pipeline_depth: 3
"""
GOOD = ("This is a sentence with a number of words that is long enough to pass "
        "the filter easily today.")
JOURNALED = {
    "retry": "resilience_retries_device_total",
    "retry_exhausted": "resilience_retry_exhausted_total",
    "ladder_split": "resilience_ladder_split_total",
    "breaker_trip": "resilience_breaker_trips_total",
    "watchdog_stall": "watchdog_stalls_total",
}
FAULT_CASES = {
    "retry": (10, 16, dict(exc=OSError("device blip"), times=2), 0.0, "retry"),
    "split": (10, 16, dict(exc=OSError("persistent-ish"), times=5), 0.0, "ladder_split"),
    "outage": (40, 8, dict(exc=OSError("device gone"), times=10**6), 0.0, "breaker_trip"),
    "hang": (60, 8, dict(kind="hang", times=2, after_calls=1), 0.2, "watchdog_stall"),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_resilience_journal_counts_equal_the_counters(case):
    n, batch, arm, deadline, kind = FAULT_CASES[case]
    pipe = port_ops.CompiledPipeline(port_parse(CHAOS_CONFIG), buckets=(512,),
                                     batch_size=batch, device="cpu")
    before = {k: pm.METRICS.get(k) for k in JOURNALED.values()}
    pe.EVENTS.configure(None)
    pt.TRACER.configure(None)
    FAULTS.inject("device.execute", **arm)
    WATCHDOG.configure(deadline)
    try:
        docs = [TextDocument(id=f"d{i}", content=GOOD if i % 3 else "too short", source="t")
                for i in range(n)]
        list(port_ops.process_documents_device(pipe.config, iter(docs), pipeline=pipe))
    finally:
        FAULTS.reset()
        WATCHDOG.reset()
    journal = pe.EVENTS.drain()
    instants = [e["name"] for e in pt.TRACER.drain() if e["ph"] == "i"]
    for r in journal:
        pe.validate_record(r)
    for k, counter in JOURNALED.items():
        n_journal = sum(r["kind"] == k for r in journal)
        assert n_journal == pm.METRICS.get(counter) - before[counter], (k, journal)
        if k != "retry_exhausted":  # a journal record with no trace instant, as in JAX
            assert instants.count(k) == n_journal
    assert sum(r["kind"] == kind for r in journal) >= 1
