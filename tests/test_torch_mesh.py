"""The port's ``data`` mesh against the JAX package's, on the CPU.

A port mesh may repeat a device, so every two-shard mesh here is
``[cpu, cpu]``; the JAX side uses the suite's forced host devices.

* ``shard_rows`` gives the row ranges of ``NamedSharding(mesh, P("data"))``
  (read off ``addressable_shards``; nothing is compiled).
* ``CompiledPipeline(mesh=...)`` takes the JAX package's geometry, batch
  size and its wire, split, overlap and tail gates for 2, 3 and 8 entries.
* Stage level: every phase's two-shard stats dict equals the JAX
  ``_fn_for(512, phase)`` over a two-device JAX mesh, array for array.
* Run level: two- and three-shard runs write the single-device run's files
  and the host oracle's decisions; phase 1 sees survivors only.
* The ladder under a mesh retries, then goes to the host, with no split,
  as the JAX package's does; checkpoint/resume across a mesh and one
  device gives equal files.
* ``graft_entry``'s ``entry()`` and ``dryrun_multichip(2, device="cpu")``.
"""

import contextlib
import io
import os

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import textblaster_tpu.ops.pipeline as jax_ops
import textblaster_tpu_torch.ops.pipeline as port_ops
from textblaster_tpu.config.pipeline import parse_pipeline_config as jax_parse
from textblaster_tpu.data_model import TextDocument as JaxDoc
from textblaster_tpu.ops.geometry import calibrate_geometry as jax_calibrate
from textblaster_tpu.ops.packing import pack_documents as jax_pack
from textblaster_tpu.parallel import mesh as jax_mesh
from textblaster_tpu.resilience import FAULTS as JAX_FAULTS
from textblaster_tpu.utils.metrics import METRICS as JAX_METRICS
from textblaster_tpu_torch.checkpoint import run_checkpointed
from textblaster_tpu_torch.config.pipeline import parse_pipeline_config
from textblaster_tpu_torch.data_model import ProcessingOutcome, TextDocument
from textblaster_tpu_torch.errors import CheckpointError
from textblaster_tpu_torch.graft_entry import dryrun_multichip, entry
from textblaster_tpu_torch.ops.geometry import calibrate_geometry
from textblaster_tpu_torch.ops.packing import pack_documents
from textblaster_tpu_torch.orchestration import process_documents_host
from textblaster_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    data_mesh,
    gather_stats,
    shard_batch,
    shard_rows,
)
from textblaster_tpu_torch.pipeline_builder import build_pipeline_from_config
from textblaster_tpu_torch.resilience import FAULTS
from textblaster_tpu_torch.runner import run_mesh, run_pipeline
from textblaster_tpu_torch.utils.metrics import METRICS

from test_torch_pipeline import JAX_COMPILER_OPTIONS, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

# tests/test_sharding.py's config and texts.
YAML = """
pipeline:
  - type: LanguageDetectionFilter
    min_confidence: 0.5
    allowed_languages: [ "dan", "eng" ]
  - type: GopherQualityFilter
    min_doc_words: 5
    min_stop_words: 1
    stop_words: [ "og", "the", "er" ]
  - type: FineWebQualityFilter
    line_punct_thr: 0.12
    line_punct_exclude_zero: false
    short_line_thr: 0.9
    short_line_length: 10
    char_duplicates_ratio: 0.5
    new_line_ratio: 0.5
"""

TEXTS = [
    "Det er en god dag i dag, og vi skal ud at gå en lang tur i skoven nu.",
    "The quick brown fox jumps over the lazy dog near the old stone bridge.",
    "kort.",
    "Endnu en dansk tekst om vejret, og den er ganske lang og fin at læse.",
] * 4
#: 8 keepers and 24 documents the language phase kills.
PHASED_TEXTS = TEXTS[:2] * 4 + ["zzq qqz xjq wvx pqz kzx jqx vxq zzk qpx"] * 24

#: tests/test_torch_chaos.py's one-step config.
LADDER_YAML = """
pipeline:
  - type: GopherQualityFilter
    min_doc_words: 5
resilience:
  backoff_base_s: 0.0
  backoff_max_s: 0.0
  breaker_threshold: 2
"""
GOOD = ("This is a sentence with a number of words that is long enough to pass "
        "the filter easily today.")
LADDER = ("resilience_retries_device_total", "resilience_retry_exhausted_total",
          "resilience_ladder_split_total", "resilience_ladder_host_total",
          "resilience_breaker_trips_total")


def cpu_mesh(n):
    return data_mesh(["cpu"] * n)


def _docs(cls, texts, prefix="d"):
    return [cls(id=f"{prefix}{i}", source="s", content=t) for i, t in enumerate(texts)]


def _key(outcomes):
    return {o.document.id: (o.kind, o.reason, o.document.content, dict(o.document.metadata))
            for o in outcomes}


# --- the mesh ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 8])
def test_shard_rows_are_named_shardings(n):
    assert DATA_AXIS == jax_mesh.DATA_AXIS
    rows = 16
    jm = jax_mesh.data_mesh(jax.devices()[:n])
    x = jax.device_put(np.arange(rows * 3, dtype=np.int32).reshape(rows, 3),
                       jax_mesh.batch_sharding(jm, 2))
    by_device = {sh.device: sh.index[0] for sh in x.addressable_shards}
    want = [(by_device[d].start or 0, by_device[d].stop or rows) for d in jm.devices.flat]
    mesh = cpu_mesh(n)
    assert shard_rows(mesh, rows) == want
    # shard_batch puts those rows on each entry's device, and the gather
    # restores the batch.
    cps = np.arange(rows * 4, dtype=np.int32).reshape(rows, 4)
    lengths = np.arange(rows, dtype=np.int32)
    shards = shard_batch(mesh, cps, lengths)
    assert [(c.shape[0], ln.shape[0]) for c, ln in shards] == [(hi - lo, hi - lo) for lo, hi in want]
    back = gather_stats([{"c": c.numpy(), "l": ln.numpy()} for c, ln in shards])
    assert np.array_equal(back["c"], cps) and np.array_equal(back["l"], lengths)


def test_data_mesh_refuses_what_it_cannot_shard_on():
    m = data_mesh(["cpu", torch.device("cpu"), "cpu"])
    assert m.size == 3 and m.devices == (torch.device("cpu"),) * 3 and m == cpu_mesh(3)
    assert hash(m) == hash(cpu_mesh(3)) and m != cpu_mesh(2)
    with pytest.raises(AttributeError):
        m.devices = ()
    with pytest.raises(ValueError):
        data_mesh([])
    with pytest.raises(ValueError):
        data_mesh(["meta"])
    with pytest.raises(ValueError):
        shard_rows(m, 16)
    if not torch.cuda.is_available():
        for devices in (None, ["cuda"], ["cpu", "cuda:0"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                data_mesh(devices)
        # The runner's default: no CUDA, no mesh; a named device, no mesh.
        assert run_mesh(None, None) is None
    assert run_mesh("cpu", None) is None and run_mesh(None, m) is m


# --- geometry and gates ---------------------------------------------------------------


def _calibrated(jax_side: bool):
    rng = np.random.default_rng(5)
    lengths = [int(v) for v in rng.integers(20, 3000, size=300)]
    return (jax_calibrate(lengths, backend="cpu") if jax_side
            else calibrate_geometry(lengths, backend="cpu"))


GEOMETRY_CASES = {
    "ladder": dict(buckets=(512, 2048, 8192), batch_size=None),
    "explicit": dict(buckets=(512, 2048), batch_size=10),
    "smaller_than_mesh": dict(buckets=(512,), batch_size=1),
    "calibrated": dict(geometry=True),
}


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_geometry_rounding_matches_jax(n, case):
    kw = dict(GEOMETRY_CASES[case])
    jkw, pkw = dict(kw), dict(kw)
    if kw.pop("geometry", False):
        jkw, pkw = {"geometry": _calibrated(True)}, {"geometry": _calibrated(False)}
        assert jkw["geometry"].to_dict() == pkw["geometry"].to_dict()
    jp = jax_ops.CompiledPipeline(jax_parse(YAML), mesh=jax_mesh.data_mesh(jax.devices()[:n]),
                                  **jkw)
    tp = port_ops.CompiledPipeline(parse_pipeline_config(YAML), mesh=cpu_mesh(n), **pkw)
    assert tp.geometry.to_dict() == jp.geometry.to_dict()
    assert tp.batch_size == jp.batch_size
    assert all(b % n == 0 for b in tp.geometry.batch_sizes)
    assert tp.phases == jp.phases


def _gates(side, pipe, monkeypatch, capsys):
    """(wire_u16, warmup jobs, window depth, host-tail cutoffs) of one
    chunk: the packer is replaced by one that records its cutoffs and
    packs nothing, so nothing runs on a device."""
    mod = jax_ops if side == "jax" else port_ops
    seen = []

    def no_batches(docs_iter, **kwargs):
        seen.append(kwargs["host_tail_max"])
        return iter(())

    monkeypatch.setattr(mod, "iter_packed_batches", no_batches)
    doc = JaxDoc if side == "jax" else TextDocument
    list(pipe.process_chunk(_docs(doc, TEXTS[:4])))
    depth = [ln for ln in capsys.readouterr().out.split() if ln.startswith("depth=")]
    jobs = [j[1:] if side == "jax" else j for j in pipe._warmup_jobs()]
    return pipe.wire_u16, jobs, depth, seen


@pytest.mark.parametrize("n", [None, 2, 3, 8])
def test_gates_match_jax(n, monkeypatch, capsys):
    """Under a mesh: the int32 wire, no split rows, no window, no host
    tails — and with no mesh the window and the tails are on, on both."""
    monkeypatch.setenv("TEXTBLAST_HOST_TAILS", "on")
    monkeypatch.setenv("TEXTBLAST_PHASE_DEBUG", "1")
    monkeypatch.delenv("TEXTBLAST_NO_OVERLAP", raising=False)
    monkeypatch.delenv("TEXTBLAST_WIRE", raising=False)
    jkw = {} if n is None else {"mesh": jax_mesh.data_mesh(jax.devices()[:n])}
    pkw = {"device": "cpu"} if n is None else {"mesh": cpu_mesh(n)}
    jp = jax_ops.CompiledPipeline(jax_parse(YAML), buckets=(512, 2048), batch_size=16, **jkw)
    tp = port_ops.CompiledPipeline(parse_pipeline_config(YAML), buckets=(512, 2048),
                                   batch_size=16, **pkw)
    want = _gates("jax", jp, monkeypatch, capsys)
    got = _gates("port", tp, monkeypatch, capsys)
    assert got == want
    wire, jobs, depth, tails = got
    assert not wire
    if n is None:
        assert depth == ["depth=2"] and tails[0] != 0
        assert {r for _, _, r in jobs} == {16, 8}
    else:
        assert depth == ["depth=1"] and tails == [0]
        assert {r for _, _, r in jobs} == {16 // n * n}


# --- stage level ------------------------------------------------------------------


def test_stats_dicts_equal_the_jax_mesh_per_phase():
    jm = jax_mesh.data_mesh(jax.devices()[:2])
    jp = jax_ops.CompiledPipeline(jax_parse(YAML), buckets=(512,), batch_size=16, mesh=jm)
    tp = port_ops.CompiledPipeline(parse_pipeline_config(YAML), buckets=(512,), batch_size=16,
                                   mesh=cpu_mesh(2))
    single = port_ops.CompiledPipeline(parse_pipeline_config(YAML), buckets=(512,),
                                       batch_size=16, device="cpu")
    assert jp.phases == tp.phases and len(tp.phases) == 3
    batch = jax_pack(_docs(JaxDoc, TEXTS), 16, 512)
    port_batch = pack_documents(_docs(TextDocument, TEXTS), 16, 512)
    assert np.array_equal(batch.cps, port_batch.cps)
    cps_s, len_s = jax_mesh.shard_batch(jm, batch.cps, batch.lengths)
    for phase in range(len(jp.phases)):
        compiled = jp._fn_for(512, phase).lower(cps_s, len_s).compile(
            compiler_options=JAX_COMPILER_OPTIONS)
        want = {k: np.asarray(v) for k, v in compiled(cps_s, len_s).items()}
        got, _, dev_s = tp.run_batch(port_batch, phase)
        assert dev_s == 0.0
        assert set(got) == set(want), phase
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, (phase, k)
            assert np.array_equal(got[k], want[k]), (phase, k)
        one = single.run_batch(port_batch, phase)[0]
        assert all(np.array_equal(one[k], got[k]) for k in want)
    # Counted once a batch, whatever the shards.
    c = tp.counters
    assert c["batches_by_bucket"] == {512: 3} and c["device_rows"] == 3 * len(TEXTS)
    assert c["upload_bytes"] == 3 * (16 * 512 * 4 + 16 * 4)
    assert len(c["shard_launches"]) == 2


# --- run level --------------------------------------------------------------------


def _write(path, texts):
    pq.write_table(pa.table({"id": [f"r{i}" for i in range(len(texts))], "text": texts}), path)


def _rows(path):
    t = pq.read_table(path).to_pydict()
    return {(i, txt, md) for i, txt, md in zip(t["id"], t["text"], t["metadata"])}


def test_mesh_runs_write_the_single_device_files(tmp_path):
    config = parse_pipeline_config(YAML)
    inp = str(tmp_path / "in.parquet")
    texts = PHASED_TEXTS + TEXTS + ["Kort.", ""]
    _write(inp, texts)
    outs = {}
    for tag, kw in (("single", {"device": "cpu"}), ("mesh2", {"mesh": cpu_mesh(2)}),
                    ("mesh3", {"mesh": cpu_mesh(3)})):
        outs[tag] = (str(tmp_path / f"{tag}_k.parquet"), str(tmp_path / f"{tag}_e.parquet"))
        res = run_pipeline(config, inp, *outs[tag], device_batch=16, buckets=(512,),
                           quiet=True, **kw)
        assert res.received == len(texts)
    for tag in ("mesh2", "mesh3"):
        for a, b in zip(outs["single"], outs[tag]):
            assert _rows(a) == _rows(b), tag
    host = _key(process_documents_host(build_pipeline_from_config(config),
                                       iter(_docs(TextDocument, texts, "r"))))
    kept = {r[0] for r in _rows(outs["mesh3"][0])}
    assert kept == {i for i, (kind, *_) in host.items() if kind == ProcessingOutcome.SUCCESS}


@pytest.mark.parametrize("n", [2, 3])
def test_mesh_phases_short_circuit_and_match_the_host(n, monkeypatch):
    """test_sharding.py's test_mesh_phased_short_circuit on the port."""
    config = parse_pipeline_config(YAML)
    pipe = port_ops.CompiledPipeline(config, buckets=(512,), batch_size=16, mesh=cpu_mesh(n))
    assert len(pipe.phases) > 1 and pipe.batch_size == (16 // n) * n
    calls = []
    orig = pipe.dispatch_batch

    def spy(batch, phase=0, streams=None):
        calls.append((phase, len(batch.docs)))
        out = orig(batch, phase, streams)
        assert len(out) == n  # one stats dict a shard
        return out

    monkeypatch.setattr(pipe, "dispatch_batch", spy)
    dev = _key(port_ops.process_documents_device(
        config, iter(_docs(TextDocument, PHASED_TEXTS, "p")), pipeline=pipe))
    per_phase = {}
    for phase, k in calls:
        per_phase[phase] = per_phase.get(phase, 0) + k
    assert per_phase[0] == len(PHASED_TEXTS)
    assert 0 < per_phase.get(1, 0) < len(PHASED_TEXTS)  # survivors only
    host = _key(process_documents_host(build_pipeline_from_config(config),
                                       iter(_docs(TextDocument, PHASED_TEXTS, "p"))))
    assert dev == host


# --- the ladder and checkpoints ---------------------------------------------------------


@pytest.mark.parametrize("times,rung", [(2, "retry"), (5, "host")])
def test_mesh_ladder_retries_then_goes_to_the_host(times, rung):
    """The JAX mesh's ladder: retry, then the host rung, never a split."""
    n_docs = 10
    got = {}
    for side, faults, metrics in (("jax", JAX_FAULTS, JAX_METRICS), ("port", FAULTS, METRICS)):
        if side == "jax":
            pipe = jax_ops.CompiledPipeline(jax_parse(LADDER_YAML), buckets=(512,),
                                            batch_size=16,
                                            mesh=jax_mesh.data_mesh(jax.devices()[:2]))
            docs, mod = _docs(JaxDoc, [GOOD] * n_docs), jax_ops
        else:
            pipe = port_ops.CompiledPipeline(parse_pipeline_config(LADDER_YAML),
                                             buckets=(512,), batch_size=16, mesh=cpu_mesh(2))
            docs, mod = _docs(TextDocument, [GOOD] * n_docs), port_ops
        before = {k: metrics.get(k) for k in LADDER}
        faults.reset()
        faults.inject("device.execute", exc=OSError("device blip"), times=times)
        try:
            outs = list(mod.process_documents_device(pipe.config, iter(docs), pipeline=pipe))
        finally:
            faults.reset()
        got[side] = (_key(outs), {k: metrics.get(k) - before[k] for k in LADDER})
    assert got["port"] == got["jax"]
    deltas = got["port"][1]
    assert deltas["resilience_ladder_split_total"] == 0
    assert deltas["resilience_retries_device_total"] >= 1
    assert deltas["resilience_ladder_host_total"] == (n_docs if rung == "host" else 0)
    assert all(kind == ProcessingOutcome.SUCCESS for kind, *_ in got["port"][0].values())


def _same_files(a, b):
    for x, y in zip(a, b):
        assert pq.read_table(x).to_pydict() == pq.read_table(y).to_pydict(), y


@pytest.mark.parametrize("first,second", [("mesh", "single"), ("single", "mesh")])
def test_checkpoint_resumes_across_mesh_and_one_device(tmp_path, first, second):
    config = parse_pipeline_config(LADDER_YAML)
    inp = str(tmp_path / "in.parquet")
    _write(inp, [GOOD if i % 3 else "too short" for i in range(40)])
    kw = {"mesh": {"mesh": cpu_mesh(2)}, "single": {"device": "cpu"}}
    once = (str(tmp_path / "once_k.parquet"), str(tmp_path / "once_e.parquet"))
    run_checkpointed(config, inp, *once, ckpt_dir=str(tmp_path / "ck0"), chunk_size=12,
                     device_batch=8, **kw[second])
    out = (str(tmp_path / "k.parquet"), str(tmp_path / "e.parquet"))
    ckpt = str(tmp_path / "ck")
    with pytest.raises(CheckpointError, match="fault injection"):
        run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=12, device_batch=8,
                         stop_after_chunks=2, **kw[first])
    res = run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=12, device_batch=8,
                           **kw[second])
    assert res.received == 40 and not os.path.exists(ckpt)
    _same_files(once, out)


def test_checkpoint_records_and_rerounds_the_mesh_geometry(tmp_path):
    """The cursor holds the rounded geometry; a resume of a calibrated
    run under another mesh rounds the recorded geometry again."""
    import json

    config = parse_pipeline_config(LADDER_YAML)
    inp = str(tmp_path / "in.parquet")
    texts = [(GOOD + " ") * (1 + i % 7) if i % 3 else "too short" for i in range(40)]
    _write(inp, texts)
    plain = (str(tmp_path / "p_k.parquet"), str(tmp_path / "p_e.parquet"))
    run_pipeline(config, inp, *plain, backend="host", quiet=True)
    out = (str(tmp_path / "k.parquet"), str(tmp_path / "e.parquet"))
    ckpt = str(tmp_path / "ck")
    with pytest.raises(CheckpointError, match="fault injection"):
        run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=12, auto_geometry=True,
                         mesh=cpu_mesh(3), stop_after_chunks=1)
    with open(os.path.join(ckpt, "checkpoint.json")) as f:
        recorded = json.load(f)["geometry"]
    assert recorded["source"] == "auto" and all(b % 3 == 0 for b in recorded["batch_sizes"])
    res = run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=12, auto_geometry=True,
                           mesh=cpu_mesh(2))
    assert res.received == 40
    for a, b in zip(plain, out):
        assert _rows(a) == _rows(b)


# --- graft_entry ----------------------------------------------------------------------


def test_entry_and_dryrun_keep_the_contract():
    fn, args = entry(device="cpu")
    cps, lengths = args
    assert cps.shape == (8, 512) and cps.dtype == torch.int32 and lengths.shape == (8,)
    out = fn(*args)
    # The JAX entry's one program (phase_split off): its keys and shapes,
    # traced without a compile.
    from textblaster_tpu.config.pipeline import parse_pipeline_config as parse
    from textblaster_tpu_torch import graft_entry

    jp = jax_ops.CompiledPipeline(parse(graft_entry._PIPELINE_YAML), buckets=(512,),
                                  batch_size=8, phase_split=False)
    want = jax.eval_shape(jp._build_fn(512, 0, jit=False), cps.numpy(), lengths.numpy())
    assert {k: tuple(v.shape) for k, v in out.items()} == {k: v.shape for k, v in want.items()}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(2, device="cpu")
    line = buf.getvalue().strip()
    assert line.startswith("dryrun_multichip OK: 2-device mesh (cpu, cpu), batch 16, 3 phases")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun_multichip(2)
