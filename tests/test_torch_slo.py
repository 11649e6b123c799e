"""The port's SLO engine (``textblaster_tpu_torch/utils/slo.py``) against
the JAX package's, on the CPU.

* ``parse_slo_arg`` and the pipeline config's ``slo:`` block accept and
  reject the same inputs in both packages, with the same message; the
  port's config takes its vocabulary from ``utils/slo.py`` and keeps no
  ``SLO_KEYS`` of its own.
* Both engines, armed with ``start_ticker=False`` on fresh registries and
  one fake monotonic clock, driven through the same ``evaluate(now=...)``
  sequence over the same counters (HDR latency samples included), return
  equal states and snapshots, journal equal ``slo_alert`` /
  ``slo_resolved`` records (``ts_us`` masked), publish equal registries
  and give byte-equal ``slo_report`` sections.
* The ``p99_latency_s`` objective fed by lineages that both packages'
  telemetry hubs close, in lockstep.
* ``health_snapshot`` and the ``/healthz`` and ``/slo`` endpoints answer
  alike in both packages: starting, ready, degraded by the breaker, by a
  new watchdog escalation and by a firing alert.
"""

import json
import types
import urllib.error
import urllib.request

import pytest

import textblaster_tpu_torch.config.pipeline as port_config
from textblaster_tpu.config.pipeline import parse_pipeline_config as jax_parse
from textblaster_tpu.errors import PipelineError as JaxPipelineError
from textblaster_tpu_torch.config.pipeline import parse_pipeline_config as port_parse
from textblaster_tpu_torch.errors import PipelineError as PortPipelineError

from test_torch_events import PACKAGES, _fresh_registries, _strip_ts, hygiene  # noqa: F401

from test_torch_pipeline import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.torch_port

SLO = {tag: mods[2] for tag, mods in PACKAGES.items()}


@pytest.mark.parametrize("arg", [
    "availability=0.999", " p99_latency_s = 0.25 ", "throughput_floor=500",
    "availability", "error_rate=0.1", "availability=fast", "availability=1.5",
    "availability=0", "throughput_floor=-3", "p99_latency_s=0",
])
def test_parse_slo_arg_agrees(arg):
    def verdict(slo):
        try:
            return slo.parse_slo_arg(arg)
        except ValueError as e:
            return str(e)
    assert verdict(SLO["port"]) == verdict(SLO["jax"])
    assert list(SLO["port"].SLO_KEYS) == list(SLO["jax"].SLO_KEYS)


STEP = "pipeline:\n  - type: GopherQualityFilter\n    min_doc_words: 5\n"


@pytest.mark.parametrize("block", [
    None,
    "slo:\n  availability: 0.999\n  p99_latency_s: 0.25\n  fast_window_s: 30\n",
    "slo:\n  throughput_floor: 500\n  burn_threshold: 2\n  tick_s: 1\n",
    "slo:\n  latency: 0.5\n",
    "slo:\n  availability: 1.5\n",
    "slo:\n  availability: high\n",
    "slo:\n  throughput_floor: -1\n",
    "slo:\n  availability: 0.9\n  fast_window_s: 600\n",
    "slo:\n  tick_s: 0\n",
    "slo:\n  burn_threshold: 0\n",
    "slo: [1, 2]\n",
], ids=["none", "good", "knobs", "unknown_key", "availability_range", "not_a_number",
        "negative_floor", "windows_inverted", "zero_tick", "zero_threshold", "not_a_mapping"])
def test_slo_config_block_agrees(block):
    """The config repair: the same blocks pass and fail with the same
    message, and the port's vocabulary is ``utils/slo.py``'s."""
    text = STEP + (block or "")

    def verdict(parse, error):
        try:
            c = parse(text).slo
        except error as e:
            return type(e).__name__, str(e)
        return (c.objectives, c.fast_window_s, c.slow_window_s, c.burn_threshold, c.tick_s)

    assert verdict(port_parse, PortPipelineError) == verdict(jax_parse, JaxPipelineError)
    assert not hasattr(port_config, "SLO_KEYS")


# --- the engines side by side ---------------------------------------------------------------

SCENARIOS = {
    # name: (objectives, engine knobs, steps of (dt, received, errors, latency samples in us))
    "availability_alert_and_recovery": (
        {"availability": 0.99}, dict(fast_window_s=1.0, slow_window_s=2.0),
        [(0.5, 100, 50, ()), (1.0, 0, 0, ()), (4.0, 100_000, 0, ()), (7.0, 0, 0, ())]),
    "blip_under_the_slow_window": (
        {"availability": 0.9}, dict(fast_window_s=1.0, slow_window_s=6.0),
        [(1.0, 10_000, 0, ()), (2.0, 0, 0, ()), (3.0, 0, 0, ()), (6.0, 30, 30, ())]),
    "p99_latency_from_hdr_samples": (
        {"p99_latency_s": 0.5, "availability": 0.999}, dict(fast_window_s=2.0),
        [(1.0, 4, 0, (10_000, 200_000, 700_000, 2_000_000)), (2.0, 50, 0, (1_000,) * 50),
         (9.0, 10, 1, (900_000,) * 3)]),
    "throughput_floor_ticks": (
        {"throughput_floor": 50.0, "availability": 0.99}, dict(fast_window_s=3.0),
        [(1.0, 100, 0, ()), (2.0, 100, 0, ()), (3.0, 0, 0, ()), (4.0, 0, 0, ()),
         (5.0, 500, 2, ())]),
}


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engines_agree_step_by_step(name, monkeypatch):
    objectives, knobs, steps = SCENARIOS[name]
    _fresh_registries(monkeypatch)
    clock = _Clock()
    got = {}
    for tag, (_, events, slo, metrics) in PACKAGES.items():
        monkeypatch.setattr(slo, "time", types.SimpleNamespace(monotonic=clock))
        reg = metrics.METRICS
        events.EVENTS.configure(None)
        slo.SLO.configure(objectives, start_ticker=False, **knobs)
        t0 = slo.SLO._t0
        states, snapshots = [], []
        for dt, received, errors, samples in steps:
            reg.inc("producer_results_received_total", received)
            reg.inc("producer_results_error_total", errors)
            for us in samples:
                reg.observe_hdr("doc_latency_e2e_seconds", us)
            states.append(slo.SLO.evaluate(now=t0 + dt))
            snapshots.append(slo.SLO.snapshot())
        got[tag] = {
            "states": states, "snapshots": snapshots,
            "journal": _strip_ts(events.EVENTS.drain()),
            "registry": reg.all_values(), "render": reg.render(),
            "report": json.dumps(slo.slo_report(None, reg.all_values()), sort_keys=True),
            "alerts": slo.SLO.active_alerts(),
        }
        slo.SLO.reset()
        events.EVENTS.close()
    for key in got["jax"]:
        assert got["port"][key] == got["jax"][key], key
    assert json.loads(got["port"]["report"])["objectives"]
    kinds = [r["kind"] for r in got["port"]["journal"]]
    if name == "availability_alert_and_recovery":
        assert kinds.count("slo_alert") == 1 and kinds.count("slo_resolved") == 1
    if name == "blip_under_the_slow_window":
        assert "slo_alert" not in kinds


#: Lineage batches for the p99 objective: (clock step s, documents, seconds
#: from the read stamp to the write seam).
LINEAGES = ((1.0, 40, 0.05), (2.0, 10, 0.9), (3.0, 30, 0.2), (4.0, 5, 2.5))


def test_p99_latency_objective_reads_a_real_lineage(monkeypatch):
    """``p99_latency_s`` fed by lineages the telemetry hub closes (mark at
    every stage seam, then ``complete``), not by hand-made samples: equal
    states, journals and reports in both packages, one event a completed
    document, bad events the ones slower than the target."""
    from textblaster_tpu.utils import telemetry as jtel
    from textblaster_tpu_torch.utils import telemetry as ptel

    _fresh_registries(monkeypatch)
    clock, tele_clock = _Clock(), _Clock()
    got = {}
    for tag, tele in (("jax", jtel), ("port", ptel)):
        _, events, slo, metrics = PACKAGES[tag]
        monkeypatch.setattr(slo, "time", types.SimpleNamespace(monotonic=clock))
        monkeypatch.setattr(tele, "time", types.SimpleNamespace(perf_counter=tele_clock))
        monkeypatch.setattr(tele, "METRICS", metrics.METRICS)
        clock.t = tele_clock.t = 1000.0
        events.EVENTS.configure(None)
        tele.TELEMETRY.configure(1, start_ticker=False)
        slo.SLO.configure({"p99_latency_s": 0.5}, fast_window_s=2.0, slow_window_s=4.0,
                          start_ticker=False)
        t0 = slo.SLO._t0
        states, n = [], 0
        try:
            for step, docs, seconds in LINEAGES:
                ids = [f"d{n + i}" for i in range(docs)]
                n += docs
                for k, stage in enumerate(tele.STAGES):
                    tele_clock.t += seconds * (k > 0) / (len(tele.STAGES) - 1)
                    tele.TELEMETRY.mark(stage, ids)
                tele.TELEMETRY.complete([types.SimpleNamespace(id=i) for i in ids])
                states.append(slo.SLO.evaluate(now=t0 + step))
        finally:
            tele.TELEMETRY.close()
        got[tag] = {
            "states": states, "journal": _strip_ts(events.EVENTS.drain()),
            "report": slo.slo_report(None, metrics.METRICS.all_values()),
        }
        slo.SLO.reset()
        events.EVENTS.close()
    assert got["port"] == got["jax"]
    p99 = got["port"]["report"]["objectives"]["p99_latency_s"]
    assert p99["events"] == sum(d for _, d, _ in LINEAGES)
    assert p99["bad_events"] == sum(d for _, d, s in LINEAGES if s > 0.5)
    assert "slo_alert" in [r["kind"] for r in got["port"]["journal"]]


# --- health and the endpoints ---------------------------------------------------------------

def _scrape(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _health_steps(slo, metrics):
    """(step, /healthz answer) through starting, ready and three kinds of
    degraded."""
    reg = metrics.METRICS
    reg.set("pipeline_warmup_done", 0)
    yield "starting"
    reg.set("pipeline_warmup_done", 1)
    reg.set("resilience_breaker_open", 0)
    slo.health_snapshot()  # sync the escalation watermark
    yield "ready"
    reg.set("resilience_breaker_open", 1)
    yield "breaker_open"
    reg.set("resilience_breaker_open", 0)
    reg.inc("watchdog_escalations_total")
    yield "new_escalation"
    yield "escalation_seen"
    slo.SLO.configure({"availability": 0.99}, fast_window_s=1.0, slow_window_s=2.0,
                      start_ticker=False)
    reg.inc("producer_results_received_total", 100)
    reg.inc("producer_results_error_total", 50)
    slo.SLO.evaluate(now=slo.SLO._t0 + 0.5)
    yield "slo_alert"


def test_healthz_and_slo_endpoints_answer_alike(monkeypatch):
    _fresh_registries(monkeypatch)
    clock = _Clock()
    got = {}
    for tag, (_, _, slo, metrics) in PACKAGES.items():
        monkeypatch.setattr(slo, "time", types.SimpleNamespace(monotonic=clock))
        monkeypatch.setitem(slo._health_state, "escalations_seen", 0.0)
        server = metrics.setup_prometheus_metrics(0)
        assert server is not None
        port = server.server_address[1]
        answers = []
        try:
            for step in _health_steps(slo, metrics):
                answers.append((step, _scrape(port, "/healthz")))
            answers.append(("slo", _scrape(port, "/slo")))
        finally:
            server.shutdown()
            server.server_close()
            slo.SLO.reset()
        got[tag] = answers
    assert got["port"] == got["jax"]
    codes = {step: code for step, (code, _) in got["port"]}
    assert codes == {"starting": 503, "ready": 200, "breaker_open": 503,
                     "new_escalation": 503, "escalation_seen": 200, "slo_alert": 503,
                     "slo": 200}
    slo_body = got["port"][-1][1][1]
    assert slo_body["objectives"] == {"availability": 0.99}
    assert slo_body["alerting"] == ["availability"]
