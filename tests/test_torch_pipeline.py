"""The PyTorch port against the JAX package: per (bucket, phase) stats dicts
and the whole ``run``, on the CPU.

Both sides get the same packed batches; every statistic is int32 (or bool)
and must match exactly.  The whole-run check compares the kept and excluded
Parquet files as id-keyed sets (id, text, metadata, reason): the port's
``run --device cpu`` against the JAX package's compiled pipeline pinned to
the CPU, which in turn must equal the host oracle.
"""

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

CONFIG = "configs/pipeline_config_offline.yaml"
BUCKETS = (512, 2048)

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


@pytest.mark.parametrize("bucket", BUCKETS)
def test_stats_dict_matches_jax_per_bucket_phase(corpus, bucket):
    jax_cfg = jax_load_config(CONFIG)
    port_cfg = load_pipeline_config(CONFIG)
    jp = JaxPipeline(jax_cfg, buckets=BUCKETS, batch_size=16)
    tp = CompiledPipeline(port_cfg, buckets=BUCKETS, batch_size=16, device="cpu")
    assert jp.phases == tp.phases
    fits = [(i, t) for i, t in corpus if len(t) <= bucket - 4 and "数" not in t]
    docs = [JaxDoc(id=i, source="t", content=t) for i, t in fits[:16]]
    batch = jax_pack(docs, 16, bucket)
    for phase in range(len(jp.phases)):
        want = {
            k: np.asarray(v)
            for k, v in jp._build_fn(bucket, phase)(batch.cps, batch.lengths).items()
        }
        got = tp._build_fn(bucket, phase)(
            torch.from_numpy(batch.cps), torch.from_numpy(batch.lengths)
        )
        assert sorted(want) == sorted(got)
        for k in want:
            g = got[k].numpy()
            assert g.shape == want[k].shape, k
            np.testing.assert_array_equal(g.astype(want[k].dtype), want[k], err_msg=k)


def test_small_leftover_groups_run_on_the_device(corpus, monkeypatch):
    """Only dictionary-script documents reach the host oracle here: the
    partial end-of-chunk groups of every phase are packed for the device."""
    monkeypatch.delenv("TEXTBLAST_HOST_TAILS", raising=False)
    from textblaster_tpu_torch.data_model import TextDocument

    rows = corpus[:40]
    tp = CompiledPipeline(load_pipeline_config(CONFIG), buckets=BUCKETS,
                          batch_size=16, device="cpu")
    outs = list(tp.process_chunk([TextDocument(id=i, source="t", content=t) for i, t in rows]))
    n_cjk = sum("数" in t for _, t in rows)
    assert len(outs) == len(rows)
    assert tp.counters["host_fallback"] == tp.counters["host_routed_dict_script"] == n_cjk
    assert tp.counters["device_rows"] >= len(rows) - n_cjk


def test_run_matches_jax_and_host_oracle(corpus, tmp_path):
    inp = tmp_path / "in.parquet"
    _write_parquet(inp, corpus)
    jax_cfg = jax_load_config(CONFIG)
    outs = {}
    for name in ("jax", "host"):
        o, e = tmp_path / f"{name}_out.parquet", tmp_path / f"{name}_excl.parquet"
        jax_run(
            jax_cfg, str(inp), str(o), str(e),
            backend="tpu" if name == "jax" else "host",
            buckets=BUCKETS, device_batch=16, quiet=True, warmup=False,
        )
        outs[name] = (_read_set(o), _read_set(e))
    o, e = tmp_path / "port_out.parquet", tmp_path / "port_excl.parquet"
    rc = port_main([
        "run", "-i", str(inp), "-c", CONFIG, "-o", str(o), "-e", str(e),
        "--device", "cpu", "--buckets", ",".join(map(str, BUCKETS)),
        "--device-batch", "16", "--quiet",
    ])
    assert rc == 0
    outs["port"] = (_read_set(o), _read_set(e))
    assert outs["jax"] == outs["host"]
    assert outs["port"] == outs["jax"]
    kept, excluded = outs["port"]
    assert kept and excluded and len(kept) + len(excluded) == len(corpus)
