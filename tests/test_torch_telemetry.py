"""The port's doc-latency telemetry against the JAX package's, on the CPU.

``textblaster_tpu_torch/utils/telemetry.py`` is the JAX module whole, on the
port's own registry, tracer and journal.  Each unit runs both modules on the
same inputs, made from a numpy seed, with fresh registries, tracers and
journals patched into each package and one fake clock per package (each
telemetry module's ``time.perf_counter``), and must agree exactly: the
sampled id sets, ``LogLinearHistogram``, ``expected_waste``, ``roll_window``
with the drift detector's edge trigger and its journal record,
``complete``'s per-stage deltas and ``doc_flow`` instants, the lineage cap's
eviction and ``format_latency_summary``'s text.

Then the seams: a small ``run_pipeline`` on the CPU at rate 1, windowed
(depth 2) and serial, must close one lineage a written document, with
stamps that never decrease in stage order, the ``dispatch`` stamp taken on
the caller's thread, and no dispatch stamp on documents the host oracle
decided.  The CLI's ``--doc-sample-rate`` parses, refuses a negative value
and prints its tail block as the JAX CLI does.
"""

import argparse
import contextlib
import io
import json
import threading
import types

import numpy as np
import pyarrow.parquet as pq
import pytest

from textblaster_tpu.cli import build_parser as jax_parser
from textblaster_tpu.cli import main as jax_main
from textblaster_tpu.ops import geometry as jax_geometry
from textblaster_tpu.utils import events as jax_events
from textblaster_tpu.utils import metrics as jax_metrics
from textblaster_tpu.utils import telemetry as jax_telemetry
from textblaster_tpu.utils import trace as jax_trace
from textblaster_tpu_torch import runner
from textblaster_tpu_torch.cli import build_parser
from textblaster_tpu_torch.cli import main as port_main
from textblaster_tpu_torch.config.pipeline import load_pipeline_config
from textblaster_tpu_torch.ops import geometry as port_geometry
from textblaster_tpu_torch.utils import events as port_events
from textblaster_tpu_torch.utils import metrics as port_metrics
from textblaster_tpu_torch.utils import telemetry as port_telemetry
from textblaster_tpu_torch.utils import trace as port_trace

from test_torch_cli import root_logger  # noqa: F401  (autouse fixture)
from test_torch_pipeline import _write_parquet, make_corpus, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

CONFIG = "configs/pipeline_config_offline.yaml"
PACKAGES = {
    "jax": (jax_metrics, jax_telemetry, jax_events, jax_trace),
    "port": (port_metrics, port_telemetry, port_events, port_trace),
}
QUANTILES = (0.0, 0.5, 0.9, 0.95, 0.99, 1.0)


class _Clock:
    """A perf-counter whose reading the test sets."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def hubs(monkeypatch):
    """Per package: a fresh registry, in-memory tracer and journal patched
    into its modules, a fake clock in its telemetry module, and a fresh
    (unconfigured) ``Telemetry`` hub."""
    out = {}
    for name, (metrics, telemetry, events, trace) in PACKAGES.items():
        reg, tracer, journal, clock = (
            metrics.Metrics(), trace.Tracer(), events.EventJournal(), _Clock())
        monkeypatch.setattr(metrics, "METRICS", reg)
        monkeypatch.setattr(telemetry, "METRICS", reg)
        monkeypatch.setattr(telemetry, "TRACER", tracer)
        monkeypatch.setattr(events, "EVENTS", journal)
        monkeypatch.setattr(telemetry, "time", types.SimpleNamespace(perf_counter=clock))
        tracer.configure(None)
        journal.configure(None)
        out[name] = types.SimpleNamespace(
            mod=telemetry, metrics=reg, tracer=tracer, journal=journal, clock=clock,
            hub=telemetry.Telemetry())
    yield out
    for h in out.values():
        h.hub.close()
        h.tracer.close()
        h.journal.close()


def _both(hubs, fn):
    """``fn(h)`` on each package's hub namespace: ``(jax result, port result)``."""
    return fn(hubs["jax"]), fn(hubs["port"])


def _instants(h, name):
    return [e["args"] for e in h.tracer.drain() if e.get("name") == name]


def _ids(seed: int, n: int = 3000):
    """Document ids: numbered, random ASCII and random non-ASCII."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789-_") + list("æøåÆØÅ数据🚀é")
    out = []
    for i in range(n):
        k = int(rng.integers(3))
        if k == 0:
            out.append(f"doc-{int(rng.integers(10**9)):09d}")
        else:
            size = int(rng.integers(1, 24))
            chars = alphabet[:38] if k == 1 else alphabet
            out.append("".join(chars[int(j)] for j in rng.integers(len(chars), size=size)) + str(i))
    return out


@pytest.mark.parametrize("rate", [1, 7, 64])
def test_sampled_id_set_equals_the_jax_modules(rate):
    ids = _ids(rate)
    want = {d for d in ids if jax_telemetry.doc_sampled(d, rate)}
    got = {d for d in ids if port_telemetry.doc_sampled(d, rate)}
    assert got == want
    assert 0 < len(got) <= len(ids)
    assert (len(got) == len(ids)) == (rate == 1)
    assert not any(port_telemetry.doc_sampled(d, 0) for d in ids[:50])


def _samples(dist: str, seed: int):
    rng = np.random.default_rng(seed)
    if dist == "bimodal":
        v = np.concatenate([rng.integers(10, 100, 3000), rng.integers(10**6, 5 * 10**6, 800)])
    elif dist == "heavy_tail":
        v = (rng.pareto(1.5, 4000) * 1000).astype(np.int64) + 1
    else:  # log-uniform over ~9 decades, with negatives (recorded as 0)
        v = np.exp(rng.uniform(0, 21, 4000)).astype(np.int64) - 5
    return [int(x) for x in v]


@pytest.mark.parametrize("dist", ["bimodal", "heavy_tail", "log_uniform"])
def test_log_linear_histogram_equals_the_jax_modules(dist):
    a_vals, b_vals = _samples(dist, 1), _samples(dist, 2)
    hists = {}
    for name, mod in (("jax", jax_telemetry), ("port", port_telemetry)):
        a, b = mod.LogLinearHistogram(), mod.LogLinearHistogram()
        for v in a_vals:
            a.record(v)
        for v in b_vals:
            b.record_seconds(v / 1e6)
        ab = a.merge(b)
        hists[name] = {
            "a": a.to_dict(), "b": b.to_dict(), "ab": ab.to_dict(),
            "q": [(ab.quantile_us(q), ab.quantile_s(q)) for q in QUANTILES],
            "round_trip": mod.LogLinearHistogram.from_dict(ab.to_dict()).to_dict(),
        }
    assert hists["port"] == hists["jax"]
    assert hists["port"]["ab"]["count"] == len(a_vals) + len(b_vals)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expected_waste_equals_the_jax_modules(seed):
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([
        rng.integers(0, 400, 600), rng.lognormal(7.0, 1.3, 600).astype(np.int64) % 90000,
    ]).tolist()
    buckets = sorted({int(b) for b in rng.integers(1, 1100, 5) * 64})
    geometries = [
        (types.SimpleNamespace(buckets=buckets),) * 2,
        (types.SimpleNamespace(buckets=(512, 2048, 8192, 32768, 65536)),) * 2,
        (jax_geometry.calibrate_geometry(lengths, backend="cpu"),
         port_geometry.calibrate_geometry(lengths, backend="cpu")),
    ]
    for jg, pg in geometries:
        want = jax_telemetry.expected_waste(lengths, jg)
        assert port_telemetry.expected_waste(lengths, pg) == want
        assert 0.0 < want < 1.0
    assert port_telemetry.expected_waste([], geometries[0][1]) == 0.0


#: Per window: the padding waste to produce (None: no device lanes).  With a
#: threshold of 0.1 the detector fires twice: against a pinned baseline of
#: 0.10 at windows 0 and 6 (high through 2, low at 3..5), against the first
#: window's adopted 0.5 at windows 1 and 8 (low again at 6).
WASTES = (0.5, 0.6, None, 0.15, 0.12, 0.19, 0.45, 0.5, 0.05)


@pytest.mark.parametrize("pinned", [True, False], ids=["baseline", "adopted"])
def test_roll_window_equals_the_jax_modules(hubs, pinned):
    rng = np.random.default_rng(5)
    for h in hubs.values():
        h.hub.configure(4, window_s=2.0, window_count=6, drift_threshold=0.1,
                        start_ticker=False)
        if pinned:
            h.hub.set_geometry_baseline(0.10)
    windows = {name: [] for name in hubs}
    for waste in WASTES:
        lanes = int(rng.integers(1000, 100000)) if waste is not None else 0
        deltas = {
            "producer_results_received_total": int(rng.integers(0, 5000)),
            "writer_chars_total": int(rng.integers(0, 10**7)),
            "occupancy_padded_lanes_total": lanes,
            "occupancy_real_codepoints_total": round(lanes * (1 - waste)) if lanes else 0,
            "multihost_exchange_posts_total": int(rng.integers(0, 3)),
            "multihost_exchange_post_seconds_total": float(rng.random()),
        }
        gauges = {g: int(rng.integers(0, 9)) for g in (
            "queue_depth_read", "queue_depth_pack", "queue_depth_write",
            "inflight_batches", "multihost_negotiated_depth")}
        for name, h in hubs.items():
            h.clock.t += 2.0
            for k, v in deltas.items():
                h.metrics.inc(k, v)
            for k, v in gauges.items():
                h.metrics.set(k, v)
            windows[name].append(h.hub.roll_window())
    assert windows["port"] == windows["jax"]
    want, got = _both(hubs, lambda h: _instants(h, "geometry_drift"))
    assert got == want
    assert len(got) == 2
    want, got = _both(hubs, lambda h: [
        (r["kind"], r["severity"], r["data"]) for r in h.journal.recent()])
    assert got == want and [r[0] for r in got] == ["geometry_drift"] * len(want)
    want, got = _both(hubs, lambda h: h.hub.snapshot())
    assert got == want
    assert len(got["windows"]) == 6 and got["sample_rate"] == 4
    assert hubs["port"].metrics.get("geometry_drift") == hubs["jax"].metrics.get("geometry_drift")


def _stamp_schedule(seed: int, n_docs: int = 40):
    """``(clock seconds, stage, ids)`` marks in time order: each document's
    stages in pipeline order with some skipped, a few re-marks (which must
    not move a stamp) and a few stages marked out of order (a negative
    delta, clamped to 0)."""
    rng = np.random.default_rng(seed)
    stages = port_telemetry.STAGES
    ids = [f"doc{i}" for i in range(n_docs)]
    marks = []
    t = 100.0
    for start in range(0, n_docs, 8):
        group = ids[start:start + 8]
        order = [s for s in stages if rng.random() > 0.2 or s in ("read", "write")]
        if start in (0, 16) or rng.random() < 0.3:
            i = int(rng.integers(1, len(order)))
            order[i - 1], order[i] = order[i], order[i - 1]
        for stage in order:
            t += float(rng.exponential(0.05))
            marks.append((t, stage, group))
            if rng.random() < 0.3:
                t += 0.01
                marks.append((t, stage, group[:3]))
    return marks, ids


@pytest.mark.parametrize("rate", [1, 3])
def test_complete_equals_the_jax_modules(hubs, rate):
    marks, ids = _stamp_schedule(9)
    for h in hubs.values():
        h.hub.configure(rate, start_ticker=False)
        for t, stage, group in marks:
            h.clock.t = t
            h.hub.mark(stage, iter(group))
        h.clock.t = marks[-1][0] + 0.25
        # Written documents in two batches, by id and through a wrapper
        # (``.document.id``), and ids never marked.
        h.hub.complete([types.SimpleNamespace(id=d) for d in ids[:25]] + [
            types.SimpleNamespace(id="never-marked")])
        h.clock.t += 0.5
        h.hub.complete([types.SimpleNamespace(document=types.SimpleNamespace(id=d))
                        for d in ids[25:]])
    want, flows = _both(hubs, lambda h: _instants(h, "doc_flow"))
    assert flows == want
    assert len(flows) == sum(port_telemetry.doc_sampled(d, rate) for d in ids)
    # Stage deltas telescope to e2e; a stamp out of stage order is clamped
    # at 0, so its lineage's deltas sum past e2e.
    excess = [sum(v for k, v in f["us"].items() if k != "e2e") - f["us"]["e2e"]
              for f in flows]
    assert min(excess) == 0 and max(excess) > 0
    families = [f"doc_latency_{s}_seconds" for s in jax_metrics.DOC_LATENCY_STAGES]
    want, got = _both(hubs, lambda h: [h.metrics.hdr_state(f) for f in families])
    assert got == want
    want, got = _both(hubs, lambda h: (h.metrics.all_values(), h.hub.snapshot()))
    assert got == want
    assert got[1]["open_lineages"] == 0


def test_lineage_cap_evicts_as_the_jax_module(hubs, monkeypatch):
    for h in hubs.values():
        monkeypatch.setattr(h.mod, "_LINEAGE_CAP", 4)
        h.hub.configure(1, start_ticker=False)
        h.hub.mark("read", [f"cap{i}" for i in range(10)])
        h.hub.mark("pack", ["cap9", "cap0"])
    want, got = _both(hubs, lambda h: (
        {k: dict(v) for k, v in h.hub._lineage.items()},
        h.metrics.get("doc_lineage_evicted_total"), h.metrics.get("doc_sampled_total")))
    assert got == want
    assert list(got[0]) == ["cap7", "cap8", "cap9", "cap0"] and got[1:] == (7, 11)


def test_format_latency_summary_equals_the_jax_modules(hubs):
    want, got = _both(hubs, lambda h: h.mod.format_latency_summary())
    assert got == want == "Per-document tail latency: no sampled documents completed."
    rng = np.random.default_rng(13)
    families = [f"doc_latency_{s}_seconds" for s in jax_metrics.DOC_LATENCY_STAGES]
    families.append("exchange_post_latency_seconds")
    for step in range(2):
        for fam in families[step:]:
            values = (rng.pareto(1.2, 200) * 3000).astype(np.int64)
            for h in hubs.values():
                for v in values:
                    h.metrics.observe_hdr(fam, int(v))
        if step == 0:
            base = {name: h.metrics.all_values() for name, h in hubs.items()}
    want, got = _both(hubs, lambda h: h.mod.format_latency_summary())
    assert got == want and "exchange_post" in got and len(got.splitlines()) == 9
    want, got = _both(hubs, lambda h: h.mod.format_latency_summary(
        base["jax" if h is hubs["jax"] else "port"]))
    assert got == want and "read " not in got


def test_disabled_hub_is_inert_as_the_jax_module(hubs):
    for h in hubs.values():
        h.hub.mark("read", ["ghost"])
        h.hub.complete([types.SimpleNamespace(id="ghost")])
    want, got = _both(hubs, lambda h: (h.hub.snapshot(), h.metrics.all_values()))
    assert got == want
    assert got[0]["enabled"] is False and got[0]["sampled_docs"] == 0


# --- the seams, in a run ----------------------------------------------------------


@pytest.fixture(scope="module")
def small_input(tmp_path_factory):
    path = tmp_path_factory.mktemp("telemetry") / "in.parquet"
    rows = make_corpus(40, seed=11)
    assert any("数" in t for _, t in rows)  # dictionary-script rows: host-routed
    _write_parquet(path, rows)
    return str(path), rows


@pytest.mark.parametrize("mode", ["windowed", "serial"])
def test_run_closes_one_ordered_lineage_a_written_document(small_input, tmp_path,
                                                           monkeypatch, mode):
    inp, rows = small_input
    config = load_pipeline_config(CONFIG)
    if mode == "serial":
        config.overlap.enabled = False
    else:
        config.overlap.pipeline_depth = 2
    tele = port_telemetry.TELEMETRY
    flows, marks = [], []
    tracer = port_telemetry.TRACER

    class FlowTap:
        def instant(self, name, args=None):
            if name == "doc_flow":
                flows.append(args)
            tracer.instant(name, args)

    real_mark = tele.mark

    def mark(stage, doc_ids):
        doc_ids = list(doc_ids)
        marks.append((stage, threading.current_thread(), doc_ids))
        real_mark(stage, doc_ids)

    monkeypatch.setattr(port_telemetry, "TRACER", FlowTap())
    monkeypatch.setattr(tele, "mark", mark)
    before = port_metrics.METRICS.hdr_state("doc_latency_e2e_seconds")[2]
    tele.configure(1, start_ticker=False)
    try:
        out, excl = tmp_path / "k.parquet", tmp_path / "e.parquet"
        result = runner.run_pipeline(config, inp, str(out), str(excl), device="cpu",
                                     buckets=(512, 2048), device_batch=8, quiet=True)
    finally:
        tele.close()
    written = [i for p in (out, excl) for i in pq.read_table(str(p)).column("id").to_pylist()]
    assert len(written) == result.received == len(rows)
    assert sorted(f["id"] for f in flows) == sorted(written)
    assert port_metrics.METRICS.hdr_state("doc_latency_e2e_seconds")[2] - before == len(written)
    stages = port_telemetry.STAGES
    for f in flows:
        # Consecutive stamps never decrease: the stage deltas (each clamped
        # at 0) then sum to the end-to-end latency exactly.
        assert sum(f["us"][s] for s in stages if s in f["us"]) == f["us"]["e2e"], f
    host = {i for i, t in rows if "数" in t}
    by_id = {f["id"]: f["us"] for f in flows}
    for i in written:
        if i in host:
            assert "dispatch" not in by_id[i] and "device_wait" not in by_id[i], i
        else:
            assert all(s in by_id[i] for s in stages), (i, by_id[i])
    caller = threading.current_thread()
    on = {stage: {t for s, t, _ in marks if s == stage} for stage in stages}
    assert on["dispatch"] == on["device_wait"] == on["assemble"] == {caller}
    if mode == "windowed":
        assert caller not in on["read"] | on["pack"] | on["write"]


# --- the CLI ----------------------------------------------------------------------


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _flag(parser):
    """The ``run`` command's ``--doc-sample-rate`` action."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return next(a for a in sub.choices["run"]._actions if a.dest == "doc_sample_rate")


def test_doc_sample_rate_flag_parses_as_the_jax_clis():
    argv = ["run", "-i", "in.parquet", "--doc-sample-rate", "16"]
    assert build_parser().parse_args(argv).doc_sample_rate == 16
    assert jax_parser().parse_args(argv).doc_sample_rate == 16
    got, want = _flag(build_parser()), _flag(jax_parser())
    assert (got.type, got.default, got.metavar) == (want.type, want.default, want.metavar)
    assert build_parser().parse_args(["run", "-i", "x"]).doc_sample_rate == 0


def test_negative_doc_sample_rate_is_refused_with_the_jax_message(small_input, tmp_path):
    inp, _ = small_input
    argv = ["run", "-i", inp, "-c", CONFIG, "-o", str(tmp_path / "k.parquet"),
            "-e", str(tmp_path / "e.parquet"), "--backend", "host", "--doc-sample-rate", "-3"]
    want = _run(jax_main, argv)
    got = _run(port_main, argv)
    assert got == want == (1, "", "Invalid --doc-sample-rate value: -3\n")
    assert not port_telemetry.TELEMETRY.enabled


def test_cli_prints_the_jax_latency_block_and_records_the_rate(small_input, tmp_path):
    inp, rows = small_input
    report = tmp_path / "report.json"
    base = port_metrics.METRICS.all_values()
    rc, out, err = _run(port_main, [
        "run", "-i", inp, "-c", CONFIG, "-o", str(tmp_path / "k.parquet"),
        "-e", str(tmp_path / "e.parquet"), "--device", "cpu", "--buckets", "512,2048",
        "--device-batch", "16", "--doc-sample-rate", "1", "--run-report", str(report)])
    assert rc == 0, err
    assert not port_telemetry.TELEMETRY.enabled  # closed with the run
    # The JAX module's text for the same numbers.
    block = jax_telemetry.format_latency_summary(base, port_metrics.METRICS.all_values())
    assert block.startswith("Per-document tail latency (sampled")
    assert block in err
    with open(report) as f:
        rep = json.load(f)
    assert rep["config"]["doc_sample_rate"] == 1
    assert rep["latency"]["stages"]["e2e"]["count"] == len(rows)
