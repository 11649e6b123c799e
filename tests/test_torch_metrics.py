"""The port's metrics layer against the JAX package's, on the CPU.

* ``Metrics.render()`` is byte-equal in both packages after the same
  seeded sequence of ``inc`` / ``dec`` / ``set`` / ``observe`` /
  ``observe_hdr`` calls over static, dynamic (occupancy, funnel, journal,
  SLO, roofline) and HDR families; ``all_values()`` and the catalogue
  agree too.
* The HDR helpers agree over seeded microsecond values in every index
  regime.
* ``record_occupancy`` gives equal counter deltas on the same documents
  packed by each package.
* The HTTP endpoint: GET, HEAD, a query string, 404, no port, a bind
  failure that is not fatal (as ``tests/test_metrics.py``); ``/healthz``,
  ``/slo`` and ``/telemetry`` answer JSON.
* The port's exposition lint (``utils/promlint.py``) passes both
  packages' exposition and catches each broken rule.
* The seams: TokenCounter's stand-in counter, the reader, writer, overlap
  and device-path stage counters.
"""

import importlib
import json
import sys
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import tokenizers

from textblaster_tpu.data_model import TextDocument as JaxDoc
from textblaster_tpu.ops.packing import pack_documents as jax_pack
from textblaster_tpu.ops.pipeline import record_occupancy as jax_record_occupancy
from textblaster_tpu.utils import metrics as jm
from textblaster_tpu.utils import telemetry as jax_telemetry
from textblaster_tpu_torch.data_model import TextDocument as TorchDoc
from textblaster_tpu_torch.ops.packing import pack_documents as port_pack
from textblaster_tpu_torch.ops.pipeline import record_occupancy as port_record_occupancy
from textblaster_tpu_torch.utils import metrics as pm
from textblaster_tpu_torch.utils.promlint import exposition_problems

from test_torch_pipeline import make_corpus, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

HISTOGRAMS = sorted(n for n, (t, _) in jm._SPECS.items() if t == "histogram")
SCALARS = sorted(n for n, (t, _) in jm._SPECS.items() if t != "histogram")
DYNAMIC = [
    jm.OCCUPANCY_BUCKET_PREFIX + "512",
    jm.OCCUPANCY_BUCKET_PREFIX + "2048",
    jm.OCCUPANCY_BUCKET_PREFIX + "65536",
    jm.FILTER_DROP_PREFIX + "GopherQualityFilter",
    jm.FILTER_DROP_PREFIX + "LanguageDetectionFilter",
    jm.DEVICE_BPS_PREFIX + "512_phase_1",
    jm.EVENT_KIND_PREFIX + "breaker_trip",
    jm.SLO_EVENTS_PREFIX + "availability",
    jm.SLO_BAD_EVENTS_PREFIX + "availability",
    "slo_target_availability",
    "slo_burn_rate_availability",
    "slo_budget_remaining_availability",
]
HDR = sorted(jm.HDR_SPECS) + [jm.DEVICE_TIME_PREFIX + "2048_phase_0_seconds"]


def _calls(seed: int, n: int = 300):
    """A seeded call sequence: (method, name, value) with plain Python
    numbers, the same objects handed to both registries."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        op = int(rng.integers(5))
        if op == 0:
            pool = SCALARS + DYNAMIC
            out.append(("inc", pool[int(rng.integers(len(pool)))],
                        float(rng.integers(1, 50)) * [1.0, 0.25, 1e-3][int(rng.integers(3))]))
        elif op == 1:
            out.append(("dec", SCALARS[int(rng.integers(len(SCALARS)))], 1.0))
        elif op == 2:
            pool = SCALARS + DYNAMIC
            out.append(("set", pool[int(rng.integers(len(pool)))],
                        float(np.round(rng.uniform(0, 1e4), 3))))
        elif op == 3:
            out.append(("observe", HISTOGRAMS[int(rng.integers(len(HISTOGRAMS)))],
                        float(10 ** rng.uniform(-4, 1.5))))
        else:
            out.append(("observe_hdr", HDR[int(rng.integers(len(HDR)))],
                        int(10 ** rng.uniform(0, 8))))
    return out


def _replay(cls, calls):
    m = cls()
    for method, name, value in calls:
        getattr(m, method)(name, value)
    return m


@pytest.mark.parametrize("seed", range(6))
def test_render_is_byte_equal_after_the_same_calls(seed):
    calls = _calls(seed)
    want = _replay(jm.Metrics, calls)
    got = _replay(pm.Metrics, calls)
    assert got.render() == want.render()
    assert got.all_values() == want.all_values()
    for name in HDR:
        assert got.hdr_state(name) == want.hdr_state(name)


def test_catalogue_and_specs_are_the_jax_packages():
    assert pm._SPECS == jm._SPECS
    assert pm.HDR_SPECS == jm.HDR_SPECS
    assert pm.STAGE_COUNTERS == jm.STAGE_COUNTERS
    assert pm.RUN_REPORT_SCHEMA == jm.RUN_REPORT_SCHEMA == "textblaster-run-report/v4"
    assert pm.metrics_catalog_markdown() == jm.metrics_catalog_markdown()
    for name in [*jm._SPECS, *DYNAMIC, "slo_target_x", "unknown_metric"]:
        assert pm.is_merge_gauge(name) == jm.is_merge_gauge(name), name


@pytest.mark.parametrize("lo,hi", [(0, 64), (64, 1 << 20), (1 << 20, 1 << 40)],
                         ids=["exact", "mid", "tail"])
def test_hdr_helpers_agree(lo, hi):
    rng = np.random.default_rng(lo + 3)
    values = [int(v) for v in rng.integers(lo, hi, size=2000)] + [lo, hi - 1, -5]
    for v in values:
        idx = jm.hdr_bucket_index(v)
        assert pm.hdr_bucket_index(v) == idx
        assert pm.hdr_bucket_high_us(idx) == jm.hdr_bucket_high_us(idx)
    buckets = {}
    for v in values:
        idx = jm.hdr_bucket_index(v)
        buckets[idx] = buckets.get(idx, 0) + 1
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert pm.hdr_quantile_us(buckets, len(values), q) == jm.hdr_quantile_us(
            buckets, len(values), q)


@pytest.mark.parametrize("bucket", [512, 2048])
def test_record_occupancy_deltas_match(bucket):
    rows = [r for r in make_corpus(40, seed=bucket) if len(r[1]) <= bucket - 8]
    deltas = []
    for pack, record, doc_cls, reg in (
        (jax_pack, jax_record_occupancy, JaxDoc, jm.METRICS),
        (port_pack, port_record_occupancy, TorchDoc, pm.METRICS),
    ):
        before = reg.all_values()
        for lo in range(0, len(rows), 16):
            docs = [doc_cls(id=i, source="t", content=t) for i, t in rows[lo:lo + 16]]
            record(pack(docs, batch_size=16, max_len=bucket))
        now = reg.all_values()
        deltas.append({k: now[k] - before.get(k, 0.0) for k in now
                       if k.startswith("occupancy_") and now[k] != before.get(k, 0.0)})
    assert deltas[0] == deltas[1]
    assert deltas[1]["occupancy_device_batches_total"] == -(-len(rows) // 16)
    assert deltas[1][f"occupancy_dispatches_bucket_{bucket}"] == -(-len(rows) // 16)


# --- the HTTP endpoint (as tests/test_metrics.py) ------------------------------------


@pytest.fixture
def server():
    s = pm.setup_prometheus_metrics(0)  # ephemeral port
    assert s is not None
    yield s
    s.shutdown()
    s.server_close()


def test_http_endpoint_serves_metrics(server):
    port = server.server_address[1]
    pm.METRICS.inc("producer_tasks_published_total")
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "text/plain; version=0.0.4"
        body = resp.read().decode()
    assert "producer_tasks_published_total" in body
    assert exposition_problems(body) == []
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/other")
    assert e.value.code == 404
    # /telemetry belongs to the telemetry hub (tests/test_torch_telemetry.py):
    # its snapshot as JSON, with the JAX package's keys.
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/telemetry?x=1") as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"] == "application/json"
        snapshot = json.loads(resp.read())
    assert sorted(snapshot) == sorted(jax_telemetry.TELEMETRY.snapshot())
    # /healthz and /slo belong to the SLO engine (tests/test_torch_slo.py):
    # served, as JSON, 200 or 503.
    for path in ("/healthz", "/slo"):
        try:
            resp = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}")
        except urllib.error.HTTPError as e:
            resp = e
        assert resp.code in (200, 503)
        assert resp.headers["Content-Type"] == "application/json"


def test_http_endpoint_ignores_query_string_and_serves_head(server):
    port = server.server_address[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics?timeout=5") as resp:
        assert resp.status == 200
        assert "producer_tasks_published_total" in resp.read().decode()
    head = urllib.request.Request(f"http://127.0.0.1:{port}/metrics", method="HEAD")
    with urllib.request.urlopen(head) as resp:
        assert resp.status == 200
        assert int(resp.headers["Content-Length"]) > 0
        assert resp.read() == b""
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(
            urllib.request.Request(f"http://127.0.0.1:{port}/other", method="HEAD"))
    assert e.value.code == 404


def test_no_port_means_no_server():
    assert pm.setup_prometheus_metrics(None) is None


def test_bind_failure_is_nonfatal(server):
    assert pm.setup_prometheus_metrics(server.server_address[1]) is None


# --- the exposition lint ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_lint_passes_both_packages_exposition(seed):
    calls = _calls(100 + seed)
    for cls in (jm.Metrics, pm.Metrics):
        assert exposition_problems(_replay(cls, calls).render()) == []
    assert exposition_problems(pm.Metrics().render()) == []


_CLEAN = (
    "# HELP a_total A counter\n# TYPE a_total counter\na_total 3\n"
    "# HELP h A histogram\n# TYPE h histogram\n"
    'h_bucket{le="0.1"} 1\nh_bucket{le="1"} 2\nh_bucket{le="+Inf"} 3\n'
    "h_sum 4.5\nh_count 3\n"
)


@pytest.mark.parametrize("broken,rule", [
    (_CLEAN[:-1], "newline"),
    (_CLEAN.replace("# HELP a_total A counter\n", ""), "TYPE before HELP"),
    (_CLEAN + "b_total 1\n", "has no TYPE"),
    (_CLEAN.replace("# TYPE a_total counter", "# TYPE a_total summary"), "unknown type"),
    (_CLEAN.replace('h_bucket{le="1"} 2', 'h_bucket{le="1"} 0'), "not cumulative"),
    (_CLEAN.replace('h_bucket{le="+Inf"} 3\n', ""), "+Inf"),
    (_CLEAN.replace("h_count 3", "h_count 4"), "_count differs"),
    (_CLEAN.replace("a_total 3", "a_total x"), "does not parse"),
    (_CLEAN.replace("a_total 3", "a-total 3"), "unparseable"),
])
def test_lint_catches_each_rule(broken, rule):
    assert exposition_problems(_CLEAN) == []
    problems = exposition_problems(broken)
    assert any(rule in p for p in problems), problems


# --- the seams ---------------------------------------------------------------------------


@pytest.fixture
def offline(monkeypatch):
    """A ``tokenizers`` module whose hub download fails at once, as on a
    machine with no network and no cache (tests/test_torch_vendored_data.py)."""

    class Tokenizer:
        from_file = staticmethod(tokenizers.Tokenizer.from_file)

        @staticmethod
        def from_pretrained(name, *args, **kwargs):
            raise OSError(f"hub unreachable: {name}")

    stub = types.ModuleType("tokenizers")
    stub.Tokenizer = Tokenizer
    monkeypatch.setitem(sys.modules, "tokenizers", stub)


def test_tokenizer_standin_counter_moves_alike(offline):
    deltas = []
    for root, reg in (("textblaster_tpu", jm.METRICS), ("textblaster_tpu_torch", pm.METRICS)):
        counter = importlib.import_module(f"{root}.filters.token_counter").TokenCounter
        before = reg.get("worker_tokenizer_standin_total")
        counter("gpt2")
        deltas.append(reg.get("worker_tokenizer_standin_total") - before)
    assert deltas == [1.0, 1.0]


def test_reader_writer_and_overlap_seams_count(tmp_path):
    from textblaster_tpu_torch.io import ParquetWriter
    from textblaster_tpu_torch.orchestration import read_documents
    from textblaster_tpu_torch.utils.overlap import ThreadedWriter, prefetch_iter

    from test_torch_pipeline import _write_parquet

    rows = make_corpus(30, seed=2)
    _write_parquet(tmp_path / "in.parquet", rows)
    before = pm.METRICS.all_values()
    docs = list(prefetch_iter(read_documents(str(tmp_path / "in.parquet"), batch_size=8),
                              depth=2, block=4))
    w = ThreadedWriter(ParquetWriter(str(tmp_path / "out.parquet")), max_queue=2)
    for lo in range(0, len(docs), 10):
        w.write_batch(docs[lo:lo + 10])
    w.close()
    assert [d.id for d in docs] == [r[0] for r in rows]
    assert pm.METRICS.get("stage_read_seconds") > before.get("stage_read_seconds", 0.0)
    assert pm.METRICS.get("stage_write_seconds") > before.get("stage_write_seconds", 0.0)
    assert w.seconds >= pm.METRICS.get("stage_write_seconds") - before.get(
        "stage_write_seconds", 0.0)
    # Both queues drained by the end.
    assert pm.METRICS.get("queue_depth_read") == 0
    assert pm.METRICS.get("queue_depth_write") == 0
