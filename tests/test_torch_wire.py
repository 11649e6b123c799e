"""The port's uint16 wire and host routing against the JAX package, on the CPU.

* On one small corpus holding dictionary-script, astral, over-length and
  tail-sized groups, the port's ``process_chunk`` outcome sequence (id,
  kind, reason, metadata, text) equals the JAX package's, both on the u16
  wire at depth 2 with host tails on and with ``TEXTBLAST_HOST_TAILS=off``
  (JAX on the CPU with ``TEXTBLAST_WIRE=u16``).
* The stats dict of every (bucket, phase) is the same on the u16 and the
  cp32 wire, and the u16 wire refuses a batch holding an astral code point
  (``tests/test_wire_u16.py``).
* The ``host_tail`` / ``host_routed_astral`` counters show what
  ``tests/test_tail_routing.py`` and ``tests/test_wire_u16.py`` check of
  the JAX package's metrics, and the outcomes equal the host oracle's.
"""

import numpy as np
import pytest

from textblaster_tpu.config.pipeline import load_pipeline_config as jax_load_config
from textblaster_tpu.data_model import TextDocument as JaxDoc
from textblaster_tpu.ops.pipeline import CompiledPipeline as JaxPipeline
from textblaster_tpu_torch.config.pipeline import load_pipeline_config, parse_pipeline_config
from textblaster_tpu_torch.data_model import TextDocument
from textblaster_tpu_torch.ops.packing import pack_documents
from textblaster_tpu_torch.ops.pipeline import CompiledPipeline
from textblaster_tpu_torch.orchestration import process_documents_host
from textblaster_tpu_torch.pipeline_builder import build_pipeline_from_config

import test_tail_routing
import test_wire_u16
from test_torch_pipeline import make_corpus, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

CONFIG = "configs/pipeline_config_offline.yaml"


def _sequence(outcomes):
    return [
        (o.document.id, o.kind, o.reason, tuple(sorted(o.document.metadata.items())),
         o.document.content)
        for o in outcomes
    ]


@pytest.fixture(scope="module")
def routing_corpus():
    """Prose under 508 chars (the 512 bucket) with CJK rows from
    ``make_corpus``, plus astral and over-length documents; 8 rows a batch
    leave leftover groups at or below both phases' tail cutoffs."""
    rows = make_corpus(56, seed=11, max_chars=540)
    rows += [
        ("astral-0", "Det er en god dag 😀 og vi skal ud at gå tur i skoven i dag."),
        ("astral-1", "𝒜 mathematical script letter starts this otherwise plain sentence."),
        ("cjk", "数据处理流水线的测试文本。Det er en god dag og vi skal ud."),
        ("long", "Det er en god dag og vi skal ud at gå tur. " * 14),
    ]
    assert any("数" in t for _, t in rows[:-4])
    assert sum(len(t) > 508 for _, t in rows) >= 2
    return rows


@pytest.fixture(scope="module")
def jax_pipeline():
    """The JAX package's pipeline on the u16 wire (chosen at construction),
    one for both settings so that its programs compile once."""
    cfg = jax_load_config(CONFIG)
    cfg.overlap.pipeline_depth = 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TEXTBLAST_WIRE", "u16")
        return JaxPipeline(cfg, buckets=(512,), batch_size=8)


@pytest.mark.parametrize("tails", ["on", "off"])
def test_sequence_equals_jax_process_chunk(routing_corpus, jax_pipeline, monkeypatch, tails):
    monkeypatch.setenv("TEXTBLAST_WIRE", "u16")
    monkeypatch.setenv("TEXTBLAST_HOST_TAILS", tails)
    monkeypatch.delenv("TEXTBLAST_NO_OVERLAP", raising=False)
    assert jax_pipeline.wire_u16
    want = _sequence(jax_pipeline.process_chunk(
        [JaxDoc(id=i, source="t", content=t) for i, t in routing_corpus]))
    cfg = load_pipeline_config(CONFIG)
    cfg.overlap.pipeline_depth = 2
    tp = CompiledPipeline(cfg, buckets=(512,), batch_size=8, device="cpu")
    assert tp.wire_u16
    got = _sequence(tp.process_chunk(
        [TextDocument(id=i, source="t", content=t) for i, t in routing_corpus]))
    assert got == want
    c = tp.counters
    assert c["host_routed_astral"] == 2
    assert c["host_routed_dict_script"] >= 2
    assert c["host_fallback"] == (
        c["host_routed_astral"] + c["host_routed_dict_script"]
        + sum(len(t) > 508 for _, t in routing_corpus)
    )
    assert (c["host_tail"] > 0) == (tails == "on")


def test_stats_equal_on_both_wires(routing_corpus, monkeypatch):
    monkeypatch.delenv("TEXTBLAST_WIRE", raising=False)
    tp = CompiledPipeline(load_pipeline_config(CONFIG), buckets=(512, 2048),
                          batch_size=8, device="cpu")
    assert not tp.wire_u16  # cp32 is the CPU's default
    texts = [t for _, t in routing_corpus if max(map(ord, t), default=0) < 0x10000]
    for bucket in (512, 2048):
        fits = [t for t in texts if len(t) <= bucket - 4][:8]
        batch = pack_documents(
            [TextDocument(id=str(i), source="t", content=t) for i, t in enumerate(fits)],
            batch_size=8, max_len=bucket,
        )
        for phase in range(len(tp.phases)):
            sizes = {}
            for wire in (False, True):
                tp.wire_u16 = wire
                before = tp.counters["upload_bytes"]
                stats, _, dev_s = tp.run_batch(batch, phase)
                sizes[wire] = tp.counters["upload_bytes"] - before
                if wire:
                    assert sorted(stats) == sorted(cp32), (bucket, phase)
                    for k in cp32:
                        np.testing.assert_array_equal(stats[k], cp32[k], err_msg=k)
                else:
                    cp32 = stats
                assert dev_s == 0.0  # no device clock on the CPU
            lanes = 8 * bucket
            assert sizes == {False: 4 * lanes + 32, True: 2 * lanes + 32}


def test_u16_wire_guard_refuses_astral_batch(monkeypatch):
    monkeypatch.setenv("TEXTBLAST_WIRE", "u16")
    cfg = parse_pipeline_config(test_wire_u16.YAML)
    tp = CompiledPipeline(cfg, batch_size=8, buckets=(512,), device="cpu")
    batch = pack_documents(
        [TextDocument(id="a", source="t", content="emoji \U0001F600 text")],
        batch_size=8, max_len=512,
    )
    with pytest.raises(RuntimeError, match="astral"):
        tp.dispatch_batch(batch)
    assert tp.counters["upload_bytes"] == 0


def _port_docs(jax_docs):
    return [TextDocument(id=d.id, source=d.source, content=d.content) for d in jax_docs]


def _host_outcomes(cfg, docs):
    return {o.document.id: (o.kind, o.reason, o.document.metadata)
            for o in process_documents_host(build_pipeline_from_config(cfg), iter(docs))}


def test_u16_wire_routes_astral_docs(monkeypatch):
    """tests/test_wire_u16.py: exactly the two astral docs reach the host
    oracle, and the decisions equal its own."""
    monkeypatch.setenv("TEXTBLAST_WIRE", "u16")
    cfg = parse_pipeline_config(test_wire_u16.YAML)
    tp = CompiledPipeline(cfg, batch_size=8, buckets=(512,), device="cpu")
    got = {o.document.id: (o.kind, o.reason, o.document.metadata)
           for o in tp.process_chunk(_port_docs(test_wire_u16._docs()))}
    assert got == _host_outcomes(cfg, _port_docs(test_wire_u16._docs()))
    assert tp.counters["host_fallback"] == tp.counters["host_routed_astral"] == 2
    monkeypatch.setenv("TEXTBLAST_WIRE", "cp32")
    tp = CompiledPipeline(cfg, batch_size=8, buckets=(512,), device="cpu")
    assert not tp.wire_u16
    list(tp.process_chunk(_port_docs(test_wire_u16._docs())))
    assert tp.counters["host_routed_astral"] == 0


@pytest.mark.parametrize("tails", ["on", "off"])
def test_tail_routing_counts_apart(monkeypatch, tails):
    """tests/test_tail_routing.py: leftover groups reach the host oracle as
    tails, counted apart from the fallback counter, only with tails on."""
    monkeypatch.setenv("TEXTBLAST_HOST_TAILS", tails)
    cfg = parse_pipeline_config(test_tail_routing._CONFIG)
    tp = CompiledPipeline(cfg, batch_size=8, device="cpu")
    docs = _port_docs(test_tail_routing._docs())
    got = {o.document.id: (o.kind, o.reason, o.document.metadata)
           for o in tp.process_chunk(docs)}
    assert got == _host_outcomes(cfg, _port_docs(test_tail_routing._docs()))
    assert tp.counters["host_fallback"] == 0
    assert (tp.counters["host_tail"] > 0) == (tails == "on")
