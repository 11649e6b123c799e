"""Chaos: the same faults armed in the JAX package and in the port, on the
CPU, give the same outcomes, ladder counters and fire counts.

Each device case arms ``device.execute`` in both packages (each has its
own ``FAULTS``, ``WATCHDOG`` and ``METRICS``) and runs the same documents
through ``process_documents_device`` with the one-step config of
``tests/test_fault_injection.py``, windowed (depth 3) and serial
(``TEXTBLAST_NO_OVERLAP=1``):

* retry (``times=2``), split (``times=5``), outage with the breaker
  (``times`` unbounded) and a fatal ``ValueError``;
* an injected hang at depth 3 with the watchdog at 0.2 s, held also
  against the fault-free run.

The ladder counters compared are the retries, the exhaustions, the split
and host rungs, the breaker trips and the watchdog's stalls and
escalations.  Also: a transient ``read.batch`` fault gives byte-identical
files; a quarantined row group gives the JAX package's dead-letter rows;
``run --errors-file --stage-deadline-s`` through the port's CLI; a
``torch.cuda.OutOfMemoryError`` from ``dispatch_batch`` reaches the split
rung with the failed attempt's tensors freed first; a sticky CUDA error,
the fatal one and a kernel library that fails to build or load propagate
with no dispatch thread left and the ladder untouched.

Each package keeps one pipeline per batch size for the module (bucket
512), its breaker renewed before each run.
"""

import gc
import threading
import weakref

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import textblaster_tpu.ops.pipeline as jax_ops
import textblaster_tpu_torch.ops.pipeline as port_ops
from textblaster_tpu.config.pipeline import parse_pipeline_config as jax_parse
from textblaster_tpu.data_model import TextDocument as JaxDoc
from textblaster_tpu.parallel.runner import run_pipeline as jax_run
from textblaster_tpu.resilience import FAULTS as JAX_FAULTS
from textblaster_tpu.resilience import WATCHDOG as JAX_WATCHDOG
from textblaster_tpu.resilience.breaker import CircuitBreaker as JaxBreaker
from textblaster_tpu.utils.metrics import METRICS as JAX_METRICS
from textblaster_tpu_torch.cli import main as port_main
from textblaster_tpu_torch.config.pipeline import parse_pipeline_config as port_parse
from textblaster_tpu_torch.data_model import TextDocument as PortDoc
from textblaster_tpu_torch.resilience import FAULTS, WATCHDOG
from textblaster_tpu_torch.resilience.breaker import CircuitBreaker
from textblaster_tpu_torch.runner import run_pipeline as port_run
from textblaster_tpu_torch.utils.metrics import METRICS

from test_torch_pipeline import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = [pytest.mark.torch_port, pytest.mark.chaos]

CONFIG_YAML = """
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

GOOD = (
    "This is a sentence with a number of words that is long enough to pass "
    "the filter easily today."
)
BAD = "too short"
BUCKETS = (512,)
LADDER = (
    "resilience_retries_device_total",
    "resilience_retry_exhausted_total",
    "resilience_ladder_split_total",
    "resilience_ladder_host_total",
    "resilience_breaker_trips_total",
    "watchdog_stalls_total",
    "watchdog_escalations_total",
)
SIDES = {
    "jax": (JAX_FAULTS, JAX_WATCHDOG, JAX_METRICS),
    "port": (FAULTS, WATCHDOG, METRICS),
}


@pytest.fixture(autouse=True)
def _hygiene():
    for faults, watchdog, _ in SIDES.values():
        faults.reset()
        watchdog.reset()
    yield
    for faults, watchdog, _ in SIDES.values():
        faults.reset()
        watchdog.reset()


@pytest.fixture(scope="module")
def pipes():
    """(side, batch size) -> that package's pipeline."""
    out = {}
    for batch in (8, 16):
        out[("jax", batch)] = jax_ops.CompiledPipeline(
            jax_parse(CONFIG_YAML), buckets=BUCKETS, batch_size=batch)
        out[("port", batch)] = port_ops.CompiledPipeline(
            port_parse(CONFIG_YAML), buckets=BUCKETS, batch_size=batch, device="cpu")
    return out


@pytest.fixture(params=["windowed", "serial"])
def mode(request, monkeypatch):
    if request.param == "serial":
        monkeypatch.setenv("TEXTBLAST_NO_OVERLAP", "1")
    else:
        monkeypatch.delenv("TEXTBLAST_NO_OVERLAP", raising=False)
    return request.param


def _docs(cls, n):
    return [cls(id=f"doc-{i}", content=GOOD if i % 3 else BAD, source="t") for i in range(n)]


def _outcome_key(outcomes):
    return {
        o.document.id: (o.kind, o.reason, o.document.content, dict(o.document.metadata))
        for o in outcomes
    }


def _window_threads():
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(("textblast-dispatch", "textblast-prefetch"))]


def _run(side, pipes, n, batch, arm=None, deadline=0.0):
    """One run of ``n`` documents on ``side``: (outcome key, ladder counter
    deltas, fires of device.execute)."""
    faults, watchdog, metrics = SIDES[side]
    pipe = pipes[(side, batch)]
    rc = pipe.config.resilience
    breaker = JaxBreaker if side == "jax" else CircuitBreaker
    pipe._breaker = breaker(rc.breaker_threshold, cooldown_s=rc.breaker_cooldown_s)
    mod, doc = (jax_ops, JaxDoc) if side == "jax" else (port_ops, PortDoc)
    before = {k: metrics.get(k) for k in LADDER}
    if arm is not None:
        faults.inject("device.execute", **arm)
    watchdog.configure(deadline)
    try:
        outs = list(mod.process_documents_device(pipe.config, iter(_docs(doc, n)),
                                                 pipeline=pipe))
        fired = faults.fired("device.execute")
    finally:
        faults.reset()
        watchdog.reset()
    return _outcome_key(outs), {k: metrics.get(k) - before[k] for k in LADDER}, fired


CASES = {
    # name: (documents, batch size, arming, the port's deltas that must be nonzero)
    "retry": (10, 16, dict(exc=OSError("device blip"), times=2),
              {"resilience_retries_device_total": 1}),
    "split": (10, 16, dict(exc=OSError("persistent-ish"), times=5),
              {"resilience_ladder_split_total": 1, "resilience_retry_exhausted_total": 1}),
    "outage": (40, 8, dict(exc=OSError("device gone"), times=10**6),
               {"resilience_ladder_host_total": 40, "resilience_breaker_trips_total": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ladder_matches_jax(pipes, mode, case):
    n, batch, arm, expect = CASES[case]
    clean = _run("port", pipes, n, batch)[0]
    got = {side: _run(side, pipes, n, batch, dict(arm)) for side in SIDES}
    assert got["port"] == got["jax"]
    key, deltas, fired = got["port"]
    assert key == clean
    for k, v in expect.items():
        assert deltas[k] == v, (k, deltas)
    if case == "outage":
        assert fired < 100  # the tripped breaker stopped the dispatches
        assert deltas["resilience_ladder_split_total"] == 2
    assert _window_threads() == []


def test_injected_hang_matches_jax(pipes, mode):
    n, batch = 60, 8
    arm = dict(kind="hang", times=2, after_calls=1)
    clean = _run("port", pipes, n, batch)[0]
    got = {side: _run(side, pipes, n, batch, arm, deadline=0.2) for side in SIDES}
    assert got["port"] == got["jax"]
    key, deltas, fired = got["port"]
    assert key == clean
    assert fired == 2
    assert deltas["watchdog_stalls_total"] == 2
    assert deltas["watchdog_escalations_total"] >= 1
    assert _window_threads() == []


@pytest.mark.parametrize("exc", [ValueError("shape bug"),
                                 RuntimeError("CUDA error: an illegal memory access was "
                                              "encountered")], ids=["fatal", "sticky"])
def test_fatal_errors_propagate(pipes, mode, exc):
    for side in SIDES:
        faults, _, metrics = SIDES[side]
        before = {k: metrics.get(k) for k in LADDER}
        with pytest.raises(type(exc), match=str(exc)[:12]):
            _run(side, pipes, 10, 16, dict(exc=exc, times=10))
        if side == "port":
            assert {k: metrics.get(k) - before[k] for k in LADDER} == dict.fromkeys(LADDER, 0)
    assert _window_threads() == []


def test_torch_oom_reaches_the_split_rung_with_the_failed_attempts_freed(pipes, mode,
                                                                         monkeypatch):
    """``dispatch_batch`` raises ``torch.cuda.OutOfMemoryError`` at the full
    batch's rows, after allocating a tensor in its frame: every full batch
    is retried, then split, and every attempt starts with the tensors of
    all failed attempts freed, also those of later batches whose failures
    wait in the window (depth 3) behind the one being retried."""
    pipe = pipes[("port", 16)]
    clean = _run("port", pipes, 40, 16)[0]
    real = pipe.dispatch_batch
    held = []

    def oom_at_full_rows(batch, phase=0):
        assert all(r() is None for r in held), "a failed attempt's tensor is still alive"
        if batch.batch_size == 16:
            scratch = torch.empty(1024)  # noqa: F841 — held by the frame
            held.append(weakref.ref(scratch))
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 4.00 GiB")
        return real(batch, phase)

    monkeypatch.setattr(pipe, "dispatch_batch", oom_at_full_rows)
    gc.disable()  # frames must be freed by the ladder, not by a collection
    try:
        key, deltas, _ = _run("port", pipes, 40, 16)
    finally:
        gc.enable()
    assert key == clean
    # Three full batches, each: the dispatch, the ladder's first attempt
    # and three retries.
    assert len(held) == 15
    assert deltas["resilience_ladder_split_total"] == 3
    assert deltas["resilience_retry_exhausted_total"] == 3
    assert deltas["resilience_ladder_host_total"] == 0


def _fail_build(kind, tmp_path, monkeypatch):
    """Make the next :func:`kernels.build.load` fail as ``kind`` does, with
    no library loaded yet."""
    from textblaster_tpu_torch.kernels import build as kb

    monkeypatch.setattr(kb, "_loaded", {})
    if kind == "dlopen":  # a library that cannot be opened
        monkeypatch.setattr(kb, "build", lambda: {n: str(tmp_path / f"libtb_{n}.so")
                                                  for n in kb.SOURCES})
    elif kind == "no-nvcc":  # a compiler that cannot be spawned
        monkeypatch.setattr(kb, "_BUILD_ROOT", str(tmp_path))
        monkeypatch.setattr(kb, "nvcc_path", lambda: str(tmp_path / "nvcc"))
    elif kind == "unwritable":
        def build():
            raise PermissionError(13, "Permission denied", "build/torch_kernels")
        monkeypatch.setattr(kb, "build", build)
    else:  # the compiler failed and printed "out of memory"
        def build():
            raise kb.BuildError("nvcc failed for scan.cu:\nout of memory")
        monkeypatch.setattr(kb, "build", build)
    return kb


BUILD_FAILURES = ["dlopen", "no-nvcc", "unwritable", "nvcc-oom"]


@pytest.mark.parametrize("kind", BUILD_FAILURES)
def test_kernel_build_failure_in_a_batch_propagates(pipes, mode, kind, tmp_path, monkeypatch):
    """A kernel library that fails to build or load on a batch's first
    launch (``dispatch_batch`` loads it first, as a wrapper does on a CUDA
    tensor) stops the run: no rung takes it, and nothing moves to the
    host."""
    kb = _fail_build(kind, tmp_path, monkeypatch)
    pipe = pipes[("port", 16)]
    real = pipe.dispatch_batch

    def launch_first(batch, phase=0):
        kb.load("scan")
        return real(batch, phase)

    monkeypatch.setattr(pipe, "dispatch_batch", launch_first)
    before = {k: METRICS.get(k) for k in LADDER}
    with pytest.raises(kb.BuildError):
        _run("port", pipes, 40, 16)
    assert {k: METRICS.get(k) - before[k] for k in LADDER} == dict.fromkeys(LADDER, 0)
    assert _window_threads() == []


@pytest.mark.parametrize("kind", BUILD_FAILURES)
def test_kernel_build_failure_raises_when_a_cuda_pipeline_is_set_up(kind, tmp_path,
                                                                     monkeypatch):
    kb = _fail_build(kind, tmp_path, monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(kb.BuildError):
        port_ops.CompiledPipeline(port_parse(CONFIG_YAML), buckets=BUCKETS, batch_size=8,
                                  device="cuda")


# --- the read seam, the dead-letter sink and the CLI ------------------------------


def _write_input(path, n=50, row_group_size=10):
    pq.write_table(pa.table({"id": [f"doc-{i}" for i in range(n)],
                             "text": [GOOD if i % 3 else BAD for i in range(n)]}),
                   path, row_group_size=row_group_size)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_transient_read_fault_gives_identical_files(tmp_path, pipes):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp)
    cfg = pipes[("port", 8)].config
    outs = {}
    for tag, arm in (("clean", None), ("faulted", 2)):
        if arm:
            FAULTS.inject("read.batch", OSError("transient read blip"), times=arm)
        before = METRICS.get("resilience_retries_read_total")
        paths = (str(tmp_path / f"{tag}_k.parquet"), str(tmp_path / f"{tag}_e.parquet"))
        res = port_run(cfg, inp, *paths, device="cpu", device_batch=8, buckets=BUCKETS)
        assert res.received == 50 and res.read_errors == 0
        assert METRICS.get("resilience_retries_read_total") - before == (arm or 0)
        outs[tag] = [_bytes(p) for p in paths]
    assert FAULTS.fired("read.batch") == 2
    assert outs["faulted"] == outs["clean"]


def test_quarantined_row_group_gives_jax_dead_letter_rows(tmp_path):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp)
    rows = {}
    for side, run, parse in (("jax", jax_run, jax_parse), ("port", port_run, port_parse)):
        faults, _, metrics = SIDES[side]
        faults.inject("read.batch", ValueError("corrupt page"), after_calls=2)
        before = metrics.get("resilience_quarantined_rows_total")
        errs = str(tmp_path / f"{side}_errs.parquet")
        kw = {"quiet": True} if side == "jax" else {}
        res = run(parse(CONFIG_YAML), inp, str(tmp_path / f"{side}_k.parquet"),
                  str(tmp_path / f"{side}_e.parquet"), backend="host", errors_file=errs, **kw)
        faults.reset()
        assert (res.read_errors, res.received) == (10, 40)
        assert metrics.get("resilience_quarantined_rows_total") - before == 10
        rows[side] = pq.read_table(errs).to_pylist()
        for kind in ("k", "e"):
            rows[f"{side}_{kind}"] = pq.read_table(str(tmp_path / f"{side}_{kind}.parquet")).to_pylist()
    assert len(rows["port"]) == 10
    assert all(r["step"] == "read" and "corrupt page" in r["reason"] for r in rows["port"])
    for key in ("", "_k", "_e"):
        assert rows["port" + key] == rows["jax" + key]


def test_cli_errors_file_and_stage_deadline(tmp_path, capsys):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp, n=30)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(CONFIG_YAML)
    base = ["run", "-i", inp, "-c", str(cfg), "--device", "cpu", "--buckets", "512",
            "--device-batch", "8"]
    outs = {}
    for tag, extra in (("plain", []),
                       ("armed", ["--errors-file", str(tmp_path / "errs.parquet"),
                                  "--stage-deadline-s", "5"])):
        paths = [str(tmp_path / f"{tag}_k.parquet"), str(tmp_path / f"{tag}_e.parquet")]
        assert port_main(base + ["-o", paths[0], "-e", paths[1]] + extra) == 0
        outs[tag] = [_bytes(p) for p in paths]
    assert outs["armed"] == outs["plain"]
    errs = pq.read_table(str(tmp_path / "errs.parquet"))
    assert errs.num_rows == 0 and "reason" in errs.schema.names
    assert WATCHDOG.enabled and WATCHDOG.deadline_for("device_fetch") == 5.0
    WATCHDOG.reset()
    assert port_main(base + ["--stage-deadline-s", "-1"]) == 1
    assert "Invalid --stage-deadline-s value: -1.0" in capsys.readouterr().err
