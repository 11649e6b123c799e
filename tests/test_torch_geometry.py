"""Auto-geometry in the port (``textblaster_tpu_torch/ops/geometry.py``, the
calibration pass of ``runner.run_pipeline``) against the JAX package's, on
the CPU.

Every ported function equals its JAX twin on the same seeded samples
(``choose_buckets``, ``equalized_batch_sizes`` on the CPU and accelerator
budgets, ``calibrate_geometry``, ``LengthReservoir``, ``length_histogram``,
``geometry_from_histogram``).  At a calibrated width off the power-of-two
ladder (1,216 lanes) the stage dicts of one packed batch equal the JAX
package's, array for array, under the chain, fused and staged schedules.
And ``run_pipeline(auto_geometry=True, device="cpu")`` writes the JAX
package's ``run_pipeline(auto_geometry=True)`` files, row for row: both
calibrate on the CPU budget, so the geometry and the outcome order are the
same.
"""

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from textblaster_tpu.config.pipeline import load_pipeline_config as jax_load_config
from textblaster_tpu.data_model import TextDocument as JaxDoc
from textblaster_tpu.ops import geometry as jg
from textblaster_tpu.ops.packing import pack_documents as jax_pack
from textblaster_tpu.ops.pipeline import CompiledPipeline as JaxPipeline
from textblaster_tpu.parallel.runner import run_pipeline as jax_run
from textblaster_tpu_torch.config.pipeline import load_pipeline_config
from textblaster_tpu_torch.ops import geometry as pg
from textblaster_tpu_torch.ops.pipeline import CompiledPipeline
from textblaster_tpu_torch.runner import run_pipeline

from test_torch_pipeline import _write_parquet, make_corpus

pytestmark = pytest.mark.torch_port

CONFIG = "configs/pipeline_config_offline.yaml"
#: The calibrated ladder of :func:`mixed_corpus`: one bucket at 128 and
#: one at 1,216 lanes (a multiple of 64, not of 128).
MIXED_BUCKETS = (128, 1216)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU path on one thread: its batches are small, and under
    a parallel test run a thread a core in every worker spin-waits the
    cores away from each other (a stage-dict check took 70 s instead of
    half a second)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lengths(seed, n=3000):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, 400, size=n // 2),
        rng.lognormal(7.0, 1.2, size=n - n // 2).astype(np.int64) % 70000,
    ]).tolist()


@pytest.mark.parametrize("max_programs", [1, 3, 6])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_choose_buckets_equals_jax(seed, max_programs):
    lengths = _lengths(seed)
    assert pg.choose_buckets(lengths, max_programs=max_programs) == jg.choose_buckets(
        lengths, max_programs=max_programs)


def test_choose_buckets_with_weights_equals_jax():
    rng = np.random.default_rng(5)
    lengths = rng.integers(1, 20000, size=300).tolist()
    weights = rng.random(300).tolist()
    assert pg.choose_buckets(lengths, weights=weights) == jg.choose_buckets(
        lengths, weights=weights)


@pytest.mark.parametrize("port_dev,jax_backend", [("cpu", "cpu"), ("cuda", "tpu"),
                                                   (torch.device("cpu"), "cpu")])
@pytest.mark.parametrize("buckets", [(512, 2048, 8192, 32768, 65536), (128, 1216, 60032),
                                     (64, 100000)])
def test_equalized_batch_sizes_equal_jax(port_dev, jax_backend, buckets):
    assert pg.equalized_batch_sizes(buckets, backend=port_dev) == jg.equalized_batch_sizes(
        buckets, backend=jax_backend)
    assert pg.equalized_batch_sizes(buckets, backend=port_dev, lane_budget=9999) == \
        jg.equalized_batch_sizes(buckets, backend=jax_backend, lane_budget=9999)


def test_lane_budget_defaults_to_the_accelerator_branch():
    assert pg._lane_budget() == pg._lane_budget("cuda") == jg._lane_budget("tpu")
    assert pg._lane_budget("cpu") == jg._lane_budget("cpu") == (64 * 2048, 8, 256)


@pytest.mark.parametrize("port_dev,jax_backend", [("cpu", "cpu"), ("cuda", "tpu")])
@pytest.mark.parametrize("seed", [0, 3])
def test_calibrate_geometry_equals_jax(seed, port_dev, jax_backend):
    lengths = _lengths(seed)
    got = pg.calibrate_geometry(lengths, backend=port_dev)
    want = jg.calibrate_geometry(lengths, backend=jax_backend)
    assert got.to_dict() == want.to_dict()
    assert got.fingerprint() == want.fingerprint()
    assert got.describe() == want.describe()
    assert pg.DeviceGeometry.from_dict(want.to_dict()) == got


def test_reservoir_histogram_and_geometry_from_histogram_equal_jax():
    assert pg.CALIBRATION_SAMPLE == jg.CALIBRATION_SAMPLE
    assert pg.MAX_PROGRAMS == jg.MAX_PROGRAMS
    assert pg.HIST_BIN_EDGES == jg.HIST_BIN_EDGES
    lengths = _lengths(7, n=5000)
    rp, rj = pg.LengthReservoir(capacity=700, seed=9), jg.LengthReservoir(capacity=700, seed=9)
    for n in lengths:
        rp.add(n)
        rj.add(n)
    assert rp.lengths() == rj.lengths() and rp.n_seen == rj.n_seen == 5000
    hp, hj = pg.length_histogram(rp.lengths()), jg.length_histogram(rj.lengths())
    np.testing.assert_array_equal(hp, hj)
    for port_dev, jax_backend in (("cpu", "cpu"), ("cuda", "tpu")):
        assert (pg.geometry_from_histogram(hp, backend=port_dev).to_dict()
                == jg.geometry_from_histogram(hj, backend=jax_backend).to_dict())
    with pytest.raises(ValueError, match="empty histogram"):
        pg.geometry_from_histogram(np.zeros(len(pg.HIST_BIN_EDGES)))


def mixed_corpus(n=200, seed=11):
    """(id, text) pairs of two lengths: three quarters at most 124
    characters, a quarter of 1,160-1,200 characters (corpus prose joined
    and cut), which calibrate to :data:`MIXED_BUCKETS`."""
    rng = np.random.default_rng(seed)
    pool = [t for _, t in make_corpus(4 * n, seed=seed) if t]
    out = []
    for i in range(n):
        if i % 4 == 3:
            text = ""
            while len(text) < 1200:
                text += pool[int(rng.integers(len(pool)))] + "\n"
            text = text[: int(rng.integers(1160, 1201))]
        else:
            text = pool[i][: int(rng.integers(1, 125))]
        out.append((f"m{i}", text))
    return out


def test_mixed_corpus_calibrates_off_the_ladder():
    lengths = [len(t) for _, t in mixed_corpus()]
    for backend in ("cpu", "cuda"):
        geo = pg.calibrate_geometry(lengths, backend=backend)
        assert geo.buckets == MIXED_BUCKETS
    assert pg.calibrate_geometry(lengths, backend="cpu").batch_sizes == (256, 104)
    assert pg.calibrate_geometry(lengths, backend="cuda").batch_sizes == (1024, 1024)


@pytest.fixture(scope="module")
def calibrated_batch():
    """One [104, 1216] batch (the CPU geometry's rows at its off-ladder
    bucket) of the mixed corpus' long documents, the port's geometry, and
    the JAX package's stage dicts for it, phase by phase."""
    corpus = mixed_corpus()
    geo = pg.calibrate_geometry([len(t) for _, t in corpus], backend="cpu")
    bucket = geo.buckets[1]
    rows = geo.batch_for(bucket)
    jp = JaxPipeline(jax_load_config(CONFIG), geometry=jg.DeviceGeometry.from_dict(geo.to_dict()))
    docs = [JaxDoc(id=i, source="t", content=t) for i, t in corpus
            if 124 < len(t) and "数" not in t]
    batch = jax_pack(docs, rows, bucket)
    assert batch.cps.shape == (rows, bucket)
    want = [{k: np.asarray(v) for k, v in jp._build_fn(bucket, phase)(
        batch.cps, batch.lengths).items()} for phase in range(len(jp.phases))]
    return geo, batch, jp.phases, want


@pytest.mark.parametrize("schedule", ["chain", "fused", "staged"])
def test_stats_dict_at_a_calibrated_width_matches_jax(calibrated_batch, monkeypatch, schedule):
    """The JAX package takes its staged path at 1,216 lanes on the CPU (on
    a TPU too: its Pallas tiling wants multiples of 128 lanes); the port
    takes the chain schedule there (its kernels mask ragged rows), the
    fused one under ``TEXTBLAST_DEPFUSE=off`` and the staged one under
    ``TEXTBLAST_FUSED=off``: every statistic is equal."""
    for var in ("TEXTBLAST_FUSED", "TEXTBLAST_DEPFUSE"):
        monkeypatch.delenv(var, raising=False)
    if schedule == "fused":
        monkeypatch.setenv("TEXTBLAST_DEPFUSE", "off")
    elif schedule == "staged":
        monkeypatch.setenv("TEXTBLAST_FUSED", "off")
    geo, batch, phases, want = calibrated_batch
    tp = CompiledPipeline(load_pipeline_config(CONFIG), device="cpu", geometry=geo)
    assert tp.phases == phases
    bucket = batch.cps.shape[1]
    for phase, ref in enumerate(want):
        got = tp._build_fn(bucket, phase)(torch.from_numpy(batch.cps),
                                         torch.from_numpy(batch.lengths))
        assert sorted(ref) == sorted(got)
        for k in ref:
            g = got[k].numpy()
            assert g.shape == ref[k].shape, k
            np.testing.assert_array_equal(g.astype(ref[k].dtype), ref[k], err_msg=k)


def _two_phase(config):
    """The offline config's language and quality steps only (two device
    phases): the run-level check is of the calibration, the packer and the
    outcome order; the stage dicts above hold every step at 1,216 lanes."""
    config.pipeline = [s for s in config.pipeline
                       if s.type in ("LanguageDetectionFilter", "GopherQualityFilter")]
    return config


def test_auto_geometry_run_matches_jax_row_for_row(tmp_path, monkeypatch):
    for var in ("TEXTBLAST_FUSED", "TEXTBLAST_DEPFUSE"):
        monkeypatch.delenv(var, raising=False)
    inp = tmp_path / "in.parquet"
    _write_parquet(inp, mixed_corpus())
    tables = {}
    for tag in ("port", "jax"):
        out, excl = tmp_path / f"{tag}_out.parquet", tmp_path / f"{tag}_excl.parquet"
        if tag == "port":
            run_pipeline(_two_phase(load_pipeline_config(CONFIG)), str(inp), str(out),
                         str(excl), device="cpu", auto_geometry=True, quiet=True)
        else:
            jax_run(_two_phase(jax_load_config(CONFIG)), str(inp), str(out), str(excl),
                    backend="tpu", auto_geometry=True, quiet=True, warmup=False)
        tables[tag] = (pq.read_table(out).to_pylist(), pq.read_table(excl).to_pylist())
    assert tables["port"] == tables["jax"]
    kept, excluded = tables["port"]
    assert kept and excluded and len(kept) + len(excluded) == 200


def test_auto_geometry_takes_no_prebuilt_pipeline(tmp_path):
    pipe = CompiledPipeline(load_pipeline_config(CONFIG), device="cpu")
    with pytest.raises(ValueError, match="auto_geometry"):
        run_pipeline(load_pipeline_config(CONFIG), "in.parquet", "o", "e", pipeline=pipe,
                     auto_geometry=True)


def test_default_pipeline_geometry_source_matches_jax():
    """Default batch: ``source="default"``; another batch: ``"explicit"``;
    a geometry passed in wins over the knobs (the JAX rule)."""
    cfg = load_pipeline_config(CONFIG)
    jcfg = jax_load_config(CONFIG)
    for kw in ({}, {"batch_size": 16}, {"buckets": (512, 2048), "batch_size": 8}):
        got = CompiledPipeline(cfg, device="cpu", **kw).geometry
        assert got.to_dict() == JaxPipeline(jcfg, **kw).geometry.to_dict(), kw
    geo = pg.DeviceGeometry((128, 1216), (256, 104), source="auto")
    assert CompiledPipeline(cfg, device="cpu", buckets=(512,), batch_size=8,
                            geometry=geo).geometry is geo
