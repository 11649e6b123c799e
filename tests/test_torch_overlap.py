"""The port's overlapped host pipeline, on the CPU.

* ``utils/overlap.py``'s primitives behave as the JAX package's
  (``tests/test_overlap.py``): strict FIFO, exceptions forwarded in order,
  ``close()`` unblocking the producer, ``ThreadedWriter`` copying on
  enqueue and surfacing write errors.
* ``CompiledPipeline.process_chunk`` emits the same outcome sequence (id,
  kind, reason, metadata, text) at depth 1, 2 and 4 and on the serial path
  (``TEXTBLAST_NO_OVERLAP=1``); ``run --no-overlap`` and ``run
  --pipeline-depth 3`` write the same Parquet bytes.
* An exception raised on the dispatch thread reaches the caller, and no
  dispatch or prefetch thread is alive after a chunk, a closed generator
  or an error (the shared pack pool's idle workers persist by design).
"""

import threading
import time

import pytest

from textblaster_tpu.utils.overlap import ThreadedWriter as JaxThreadedWriter
from textblaster_tpu.utils.overlap import prefetch_iter as jax_prefetch_iter
from textblaster_tpu_torch.cli import main as port_main
from textblaster_tpu_torch.config.pipeline import load_pipeline_config
from textblaster_tpu_torch.data_model import TextDocument
from textblaster_tpu_torch.ops.pipeline import CompiledPipeline
from textblaster_tpu_torch.utils.overlap import ThreadedWriter, prefetch_iter

from test_torch_pipeline import _write_parquet, make_corpus, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

CONFIG = "configs/pipeline_config_offline.yaml"
BUCKETS = (512, 2048)
WINDOW_THREADS = ("textblast-dispatch", "textblast-prefetch")


def _window_threads():
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(WINDOW_THREADS)]


# --- primitives ---------------------------------------------------------------


@pytest.mark.parametrize("impl", [prefetch_iter, jax_prefetch_iter], ids=["port", "jax"])
def test_prefetch_iter_preserves_order_and_exhausts(impl):
    items = list(range(1000))
    assert list(impl(iter(items), depth=3, block=17)) == items


def test_prefetch_iter_forwards_exception_in_order():
    def source():
        yield 1
        yield 2
        raise ValueError("reader died")

    it = prefetch_iter(source(), depth=2, block=1)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(ValueError, match="reader died"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_iter_close_unblocks_producer():
    produced = []

    def infinite():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = prefetch_iter(infinite(), depth=1, block=1)
    assert next(it) == 0
    it.close()  # must not hang on the blocked producer
    time.sleep(0.05)
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n, "producer thread kept running after close()"
    assert not it._thread.is_alive()


class _RecordingWriter:
    def __init__(self, fail_on=None):
        self.batches = []
        self.closed = 0
        self.fail_on = fail_on

    def write_batch(self, outcomes):
        if self.fail_on is not None and len(self.batches) == self.fail_on:
            raise OSError("disk full")
        self.batches.append(list(outcomes))

    def close(self):
        self.closed += 1


@pytest.mark.parametrize("impl", [ThreadedWriter, JaxThreadedWriter], ids=["port", "jax"])
def test_threaded_writer_fifo_and_copy_on_enqueue(impl):
    inner = _RecordingWriter()
    w = impl(inner, max_queue=4)
    buf = []
    for i in range(20):
        buf.append(i)
        w.write_batch(buf)
        buf.clear()  # callers reuse their buffer; the wrapper must copy
    w.close()
    assert inner.batches == [[i] for i in range(20)]
    assert inner.closed == 1


def test_threaded_writer_error_at_next_write_then_close_still_closes():
    inner = _RecordingWriter(fail_on=1)
    w = ThreadedWriter(inner, max_queue=2)
    with pytest.raises(OSError, match="disk full"):
        for i in range(50):
            w.write_batch([i])
            time.sleep(0.01)
    # A failed writer refuses further work...
    with pytest.raises(RuntimeError):
        w.write_batch([99])
    # ...drops what was queued after the failure, and close() still stops
    # its thread and closes the inner writer, once.
    thread = w._thread
    w.close()
    w.close()
    assert not thread.is_alive()
    assert inner.batches == [[0]]
    assert inner.closed == 1


def test_threaded_writer_error_at_close():
    inner = _RecordingWriter(fail_on=0)
    w = ThreadedWriter(inner, max_queue=8)
    w.write_batch([1])
    with pytest.raises(OSError, match="disk full"):
        w.close()
    assert inner.closed == 1  # close() still closes the inner writer


def test_threaded_writer_proxies_attributes():
    inner = _RecordingWriter()
    inner.rows_written = 7
    w = ThreadedWriter(inner)
    assert w.rows_written == 7
    w.close()


# --- the window -----------------------------------------------------------------


@pytest.fixture(scope="module")
def docs_rows():
    rows = make_corpus(70, seed=5)
    rows.append(("astral", "Det er en god dag 😀 og vi skal ud at gå tur i skoven i dag."))
    return rows


def _docs(rows):
    return [TextDocument(id=i, source="t", content=t) for i, t in rows]


def _sequence(outcomes):
    return [
        (o.document.id, o.kind, o.reason, tuple(sorted(o.document.metadata.items())),
         o.document.content)
        for o in outcomes
    ]


def _pipeline(depth=2, **kw):
    cfg = load_pipeline_config(CONFIG)
    cfg.overlap.pipeline_depth = depth
    return CompiledPipeline(cfg, buckets=BUCKETS, batch_size=16, device="cpu", **kw)


@pytest.mark.parametrize("tails", ["on", "off"])
def test_outcome_sequence_is_the_same_at_every_depth(docs_rows, monkeypatch, tails):
    monkeypatch.setenv("TEXTBLAST_HOST_TAILS", tails)
    monkeypatch.setenv("TEXTBLAST_WIRE", "u16")
    monkeypatch.delenv("TEXTBLAST_NO_OVERLAP", raising=False)
    seqs = {}
    for depth in (1, 2, 4):
        tp = _pipeline(depth)
        seqs[depth] = _sequence(tp.process_chunk(_docs(docs_rows)))
        assert tp.counters["seconds"]["wait"] > 0.0  # the window ran
        assert _window_threads() == []
    monkeypatch.setenv("TEXTBLAST_NO_OVERLAP", "1")
    serial = _pipeline(4)
    seqs["serial"] = _sequence(serial.process_chunk(_docs(docs_rows)))
    assert serial.counters["seconds"]["wait"] == 0.0
    assert len(seqs[1]) == len(docs_rows)
    assert seqs[1] == seqs[2] == seqs[4] == seqs["serial"]
    assert (serial.counters["host_tail"] > 0) == (tails == "on")
    assert serial.counters["host_routed_astral"] == 1


def test_overlap_disabled_by_config_runs_serially(docs_rows, monkeypatch):
    monkeypatch.delenv("TEXTBLAST_NO_OVERLAP", raising=False)
    tp = _pipeline(2)
    tp._overlap.enabled = False
    seq = _sequence(tp.process_chunk(_docs(docs_rows[:30])))
    assert len(seq) == 30
    assert tp.counters["seconds"]["wait"] == 0.0


def test_dispatch_thread_error_reaches_the_caller(docs_rows, monkeypatch):
    monkeypatch.delenv("TEXTBLAST_NO_OVERLAP", raising=False)
    tp = _pipeline(2)
    calls = []
    real = tp.dispatch_batch

    def failing(batch, phase=0):
        calls.append(threading.current_thread().name)
        if len(calls) == 3:
            raise RuntimeError("launch failed")
        return real(batch, phase)

    monkeypatch.setattr(tp, "dispatch_batch", failing)
    outs = []
    with pytest.raises(RuntimeError, match="launch failed"):
        for o in tp.process_chunk(_docs(docs_rows)):
            outs.append(o)
    assert all(name.startswith("textblast-dispatch") for name in calls)
    assert _window_threads() == []


def test_closed_generator_leaves_no_thread(docs_rows, monkeypatch):
    monkeypatch.delenv("TEXTBLAST_NO_OVERLAP", raising=False)
    tp = _pipeline(4)
    gen = tp.process_chunk(_docs(docs_rows))
    next(gen)
    assert any(name.startswith("textblast-dispatch") for name in _window_threads())
    gen.close()
    assert _window_threads() == []


def test_phase_debug_prints_each_phase(docs_rows, monkeypatch, capsys):
    monkeypatch.setenv("TEXTBLAST_PHASE_DEBUG", "1")
    tp = _pipeline(2)
    list(tp.process_chunk(_docs(docs_rows[:40])))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[phase")]
    assert len(lines) == len(tp.phases) and "depth=2" in lines[0]


# --- the CLI ----------------------------------------------------------------------


def _cli_run(inp, out_dir, tag, *flags):
    o, e = out_dir / f"{tag}_out.parquet", out_dir / f"{tag}_excl.parquet"
    rc = port_main([
        "run", "-i", str(inp), "-c", CONFIG, "-o", str(o), "-e", str(e),
        "--device", "cpu", "--buckets", ",".join(map(str, BUCKETS)),
        "--device-batch", "16", "--quiet", *flags,
    ])
    return rc, o, e


def test_run_no_overlap_and_depth_3_write_the_same_files(docs_rows, tmp_path, monkeypatch):
    monkeypatch.setenv("TEXTBLAST_HOST_TAILS", "on")
    monkeypatch.delenv("TEXTBLAST_NO_OVERLAP", raising=False)
    inp = tmp_path / "in.parquet"
    _write_parquet(inp, docs_rows)
    rc_s, *serial = _cli_run(inp, tmp_path, "serial", "--no-overlap")
    rc_w, *window = _cli_run(inp, tmp_path, "window", "--pipeline-depth", "3")
    assert rc_s == rc_w == 0
    for a, b in zip(serial, window):
        assert a.read_bytes() == b.read_bytes()
    assert _window_threads() == []
    assert [t for t in threading.enumerate() if t.name.startswith("textblast-writer")] == []


def test_run_refuses_pipeline_depth_below_one(tmp_path, capsys):
    rc, _, _ = _cli_run(tmp_path / "missing.parquet", tmp_path, "bad", "--pipeline-depth", "0")
    assert rc == 1
    assert "Invalid --pipeline-depth value: 0" in capsys.readouterr().err
