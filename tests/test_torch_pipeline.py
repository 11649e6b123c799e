"""The PyTorch port against the JAX package: per (bucket, phase) stats dicts
and the whole ``run``, on the CPU.

Both sides get the same packed batches; every statistic is int32 (or bool)
and must match exactly.  The per-(bucket, phase) check runs under the three
schedules (chain, fused and staged).  The whole-run check compares the kept
and excluded Parquet files as id-keyed sets (id, text, metadata, reason): the
port's ``run --device cpu`` under each schedule against the JAX package's
compiled pipeline pinned to the CPU, which in turn must equal the host
oracle.
"""

import jax
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from textblaster_tpu.config.pipeline import load_pipeline_config as jax_load_config
from textblaster_tpu.data_model import TextDocument as JaxDoc
from textblaster_tpu.ops.packing import pack_documents as jax_pack
from textblaster_tpu.ops.pipeline import CompiledPipeline as JaxPipeline
from textblaster_tpu.parallel.runner import run_pipeline as jax_run
from textblaster_tpu_torch.cli import main as port_main
from textblaster_tpu_torch.config.pipeline import load_pipeline_config
from textblaster_tpu_torch.ops.pipeline import CompiledPipeline

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU path on one torch thread: its batches are small, and
    under a parallel test run a thread a core in every worker spin-waits
    the cores away from each other.  The other port test files import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CONFIG = "configs/pipeline_config_offline.yaml"
BUCKETS = (512, 2048)
#: XLA's backend optimization off for the JAX side's phase programs: the
#: batches are 16 rows, and compiling the programs is most of the time.
JAX_COMPILER_OPTIONS = {"xla_backend_optimization_level": 0,
                        "xla_llvm_disable_expensive_passes": True}

DANISH = (
    "det er en god dag og vi skal ud at gå tur i skoven solen skinner over "
    "byen der mange mennesker på gaden som arbejde nu efter turen vil gerne "
    "drikke kop kaffe spise lidt brød hjemme haven igen bliver dejlig "
    "eftermiddag fordi vejret så godt børnene kommer fra skole aftenen lave "
    "mad sammen se film stuen før seng huset store vinduer mod syd lyset"
).split()
ENGLISH = (
    "the quick brown fox jumps over lazy dog and runs through green fields "
    "near river where people walk their dogs every morning before work they"
).split()


def make_corpus(n: int, seed: int, max_chars: int = 2000):
    """(id, text) pairs: Danish/English prose, repeated-line boilerplate,
    citations, CJK, empty and one-line rows, all shorter than ``max_chars``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = rng.random()
        words = DANISH if kind < 0.75 else ENGLISH
        lines = []
        for _ in range(int(rng.integers(2, 16))):
            sent = []
            for _ in range(int(rng.integers(1, 4))):
                ws = [words[int(rng.integers(len(words)))] for _ in range(int(rng.integers(4, 14)))]
                sent.append(" ".join(ws).capitalize() + ".")
            lines.append(" ".join(sent))
        text = "\n".join(lines)
        if kind > 0.93:
            text = "Samme linje her igen og igen.\n" * int(rng.integers(4, 30))
        elif kind > 0.88:
            text = text.replace(".", " [1].", 2).replace(".\n", " [2, 3].\n", 1)
        elif kind > 0.86:
            text = "数据处理流水线的测试文本。" + text
        elif kind > 0.85:
            text = ""
        elif kind > 0.83:
            text = text[: int(rng.integers(1, 40))]
        out.append((f"d{i}", text[: max_chars - 8]))
    return out


def _write_parquet(path, rows):
    pq.write_table(
        pa.table({"id": [r[0] for r in rows], "text": [r[1] for r in rows]}), str(path)
    )


def _read_set(path):
    t = pq.read_table(str(path)).to_pydict()
    return {
        (i, txt, md) for i, txt, md in zip(t["id"], t["text"], t["metadata"])
    }


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(100, seed=7)


@pytest.mark.parametrize(
    "bucket,schedule", [(512, "fused"), (512, "staged"), (2048, "staged"), (512, "chain")]
)
def test_stats_dict_matches_jax_per_bucket_phase(corpus, monkeypatch, bucket, schedule):
    """Chain: the port's default against the JAX package's chain branches,
    and fused (``TEXTBLAST_DEPFUSE=off``) against its fused ones, the JAX
    kernels in interpret mode (at 512 only, as interpret mode compiles
    slowly).  Staged: ``TEXTBLAST_FUSED=off`` on both sides."""
    for var in ("TEXTBLAST_PALLAS", "TEXTBLAST_NO_PALLAS", "TEXTBLAST_FUSED", "TEXTBLAST_DEPFUSE"):
        monkeypatch.delenv(var, raising=False)
    if schedule in ("chain", "fused"):
        monkeypatch.setenv("TEXTBLAST_PALLAS_INTERPRET", "1")
    if schedule == "fused":
        monkeypatch.setenv("TEXTBLAST_DEPFUSE", "off")
    elif schedule == "staged":
        monkeypatch.setenv("TEXTBLAST_FUSED", "off")
    jax_cfg = jax_load_config(CONFIG)
    port_cfg = load_pipeline_config(CONFIG)
    jp = JaxPipeline(jax_cfg, buckets=BUCKETS, batch_size=16)
    tp = CompiledPipeline(port_cfg, buckets=BUCKETS, batch_size=16, device="cpu")
    assert jp.phases == tp.phases
    fits = [(i, t) for i, t in corpus if len(t) <= bucket - 4 and "数" not in t]
    docs = [JaxDoc(id=i, source="t", content=t) for i, t in fits[:16]]
    batch = jax_pack(docs, 16, bucket)
    for phase in range(len(jp.phases)):
        # The program jp._build_fn(bucket, phase) jits on the CPU, compiled
        # with JAX_COMPILER_OPTIONS.
        fn = jax.jit(jp._build_fn(bucket, phase, jit=False))
        compiled = fn.lower(batch.cps, batch.lengths).compile(compiler_options=JAX_COMPILER_OPTIONS)
        want = {k: np.asarray(v) for k, v in compiled(batch.cps, batch.lengths).items()}
        got = tp._build_fn(bucket, phase)(
            torch.from_numpy(batch.cps), torch.from_numpy(batch.lengths)
        )
        assert sorted(want) == sorted(got)
        for k in want:
            g = got[k].numpy()
            assert g.shape == want[k].shape, k
            np.testing.assert_array_equal(g.astype(want[k].dtype), want[k], err_msg=k)


def test_small_leftover_groups_run_on_the_device(corpus, monkeypatch):
    """With ``TEXTBLAST_HOST_TAILS=off`` only dictionary-script documents
    reach the host oracle here: the partial end-of-chunk groups of every
    phase are packed for the device."""
    monkeypatch.setenv("TEXTBLAST_HOST_TAILS", "off")
    from textblaster_tpu_torch.data_model import TextDocument

    rows = corpus[:40]
    tp = CompiledPipeline(load_pipeline_config(CONFIG), buckets=BUCKETS,
                          batch_size=16, device="cpu")
    outs = list(tp.process_chunk([TextDocument(id=i, source="t", content=t) for i, t in rows]))
    n_cjk = sum("数" in t for _, t in rows)
    assert len(outs) == len(rows)
    assert tp.counters["host_fallback"] == tp.counters["host_routed_dict_script"] == n_cjk
    assert tp.counters["device_rows"] >= len(rows) - n_cjk
    assert tp.counters["host_tail"] == 0


def test_small_leftover_groups_go_to_the_host_with_tails_on(corpus, monkeypatch):
    """Host tails on (the default outside the test suite): leftover groups
    at or below a phase's cutoff (a sixteenth of a batch in phase 0, half
    after it) are decided by the host oracle and counted as tails, apart
    from the dictionary-script fallback."""
    monkeypatch.setenv("TEXTBLAST_HOST_TAILS", "on")
    from textblaster_tpu_torch.data_model import TextDocument

    rows = corpus[:40]
    docs = [TextDocument(id=i, source="t", content=t) for i, t in rows]
    tp = CompiledPipeline(load_pipeline_config(CONFIG), buckets=BUCKETS,
                          batch_size=16, device="cpu")
    outs = list(tp.process_chunk(docs))
    n_cjk = sum("数" in t for _, t in rows)
    assert len(outs) == len(rows)
    assert tp.counters["host_fallback"] == tp.counters["host_routed_dict_script"] == n_cjk
    assert tp.counters["host_tail"] > 0
    assert tp.counters["device_rows"] + n_cjk + tp.counters["host_tail"] >= len(rows)


@pytest.fixture(scope="module")
def reference_run(corpus, tmp_path_factory):
    """The corpus' Parquet file and the JAX package's kept/excluded sets,
    from its compiled pipeline on the CPU and from the host oracle."""
    tmp = tmp_path_factory.mktemp("reference_run")
    inp = tmp / "in.parquet"
    _write_parquet(inp, corpus)
    jax_cfg = jax_load_config(CONFIG)
    outs = {}
    for name in ("jax", "host"):
        o, e = tmp / f"{name}_out.parquet", tmp / f"{name}_excl.parquet"
        jax_run(
            jax_cfg, str(inp), str(o), str(e),
            backend="tpu" if name == "jax" else "host",
            buckets=BUCKETS, device_batch=16, quiet=True, warmup=False,
        )
        outs[name] = (_read_set(o), _read_set(e))
    return inp, outs


def _port_run(inp, tmp_path):
    o, e = tmp_path / "port_out.parquet", tmp_path / "port_excl.parquet"
    rc = port_main([
        "run", "-i", str(inp), "-c", CONFIG, "-o", str(o), "-e", str(e),
        "--device", "cpu", "--buckets", ",".join(map(str, BUCKETS)),
        "--device-batch", "16", "--quiet",
    ])
    assert rc == 0
    return _read_set(o), _read_set(e)


def test_run_matches_jax_and_host_oracle(corpus, reference_run, tmp_path, monkeypatch):
    """The port's default schedule, chain."""
    for var in ("TEXTBLAST_FUSED", "TEXTBLAST_DEPFUSE"):
        monkeypatch.delenv(var, raising=False)
    inp, outs = reference_run
    port = _port_run(inp, tmp_path)
    assert outs["jax"] == outs["host"]
    assert port == outs["jax"]
    kept, excluded = port
    assert kept and excluded and len(kept) + len(excluded) == len(corpus)


@pytest.mark.parametrize("switch", ["TEXTBLAST_DEPFUSE", "TEXTBLAST_FUSED"])
def test_run_other_schedules_match_jax(reference_run, tmp_path, monkeypatch, switch):
    """The fused schedule (``TEXTBLAST_DEPFUSE=off``) and the staged one
    (``TEXTBLAST_FUSED=off``) give the same run."""
    for var in ("TEXTBLAST_FUSED", "TEXTBLAST_DEPFUSE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(switch, "off")
    inp, outs = reference_run
    assert _port_run(inp, tmp_path) == outs["jax"]
