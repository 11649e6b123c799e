"""The port's resilience layer against the JAX package's, unit by unit, on
the CPU.

Where a behaviour is the same in both packages the test is parametrised
over them (``jax``, ``port``); where the port answers for CUDA (its error
classifier's CUDA branch, the CUDA-event readiness wait, the beat other
threads can see) the test is the port's alone.

* ``RetryPolicy``: the same seeded ``rng`` gives the same backoff delays;
  exhaustion, fatal errors and nested policies behave alike.
* ``classify_error`` / ``is_oom_error``: the same verdicts on a shared list
  of exceptions; ``torch.cuda.OutOfMemoryError`` and the kernels'
  ``cudaErrorMemoryAllocation`` are retryable out-of-memory errors, the
  sticky CUDA errors are fatal (the codes 2, 700, 702 and 719 through the
  kernel wrappers' ``check``).
* ``CircuitBreaker``: the half-open cycle on a fake clock.
* ``StageWatchdog``: bounded ``wait``, ``queue_get``/``queue_put`` and
  ``join_thread``; the hang and delay fault kinds; ``wait_device_ready``
  on objects with ``query()``.
* ``arm_from_env``, the dead-letter sink's rows and its empty file.
* Inertness: nothing armed and the watchdog disabled at every seam of a
  whole run; the planted seam names ``device.execute`` and ``read.batch``.
"""

import importlib
import inspect
import queue
import random
import threading
import time

import pyarrow.parquet as pq
import pytest
import torch

from test_torch_pipeline import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.torch_port

PACKAGES = ("textblaster_tpu", "textblaster_tpu_torch")
IDS = ("jax", "port")


class _Pkg:
    """One package's resilience layer and the classes its tests need."""

    def __init__(self, root: str) -> None:
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        res = mod("resilience")
        self.root = root
        self.errors = mod("errors")
        self.data_model = mod("data_model")
        self.metrics = mod("utils.metrics").METRICS
        self.faults_mod = mod("resilience.faults")
        self.watchdog_mod = mod("resilience.watchdog")
        for name in ("RetryPolicy", "CircuitBreaker", "DeadLetterSink", "DEADLETTER_SCHEMA",
                     "FaultInjector", "classify_error", "is_oom_error", "arm_from_env",
                     "outcome_row", "read_error_row", "FAULTS", "WATCHDOG", "StageWatchdog"):
            setattr(self, name, getattr(res, name))


@pytest.fixture(params=PACKAGES, ids=IDS)
def pkg(request):
    p = _Pkg(request.param)
    p.FAULTS.reset()
    p.WATCHDOG.reset()
    yield p
    p.FAULTS.reset()
    p.WATCHDOG.reset()


@pytest.fixture
def both():
    pair = tuple(_Pkg(root) for root in PACKAGES)
    for p in pair:
        p.FAULTS.reset()
        p.WATCHDOG.reset()
    yield pair
    for p in pair:
        p.FAULTS.reset()
        p.WATCHDOG.reset()


@pytest.fixture
def port():
    p = _Pkg("textblaster_tpu_torch")
    p.FAULTS.reset()
    p.WATCHDOG.reset()
    yield p
    p.FAULTS.reset()
    p.WATCHDOG.reset()


def _flaky(fail_times, exc_factory=lambda i: OSError(f"blip {i}")):
    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] <= fail_times:
            raise exc_factory(calls[0])
        return "ok"

    fn.calls = calls
    return fn


# --- RetryPolicy ----------------------------------------------------------------


def test_backoff_schedule_is_the_same_in_both_packages(both):
    delays = []
    for p in both:
        sleeps = []
        policy = p.RetryPolicy(max_retries=6, base_delay=0.01, max_delay=0.2,
                               multiplier=3.0, jitter=0.5, sleep=sleeps.append,
                               rng=random.Random(1234))
        assert policy.run(_flaky(6), seam="unit") == "ok"
        delays.append(sleeps)
    assert len(delays[0]) == 6
    assert delays[0] == delays[1]
    for k, d in enumerate(delays[0]):
        base = min(0.01 * 3.0 ** k, 0.2)
        assert base <= d <= 1.5 * base


def test_retry_exhaustion_and_metrics(pkg):
    sleeps = []
    policy = pkg.RetryPolicy(max_retries=2, base_delay=0.0, sleep=sleeps.append, jitter=0.0)
    before = {n: pkg.metrics.get(n) for n in ("resilience_retries_unit_total",
                                              "resilience_retry_exhausted_total")}
    with pytest.raises(pkg.errors.RetryExhaustedError) as ei:
        policy.run(_flaky(5), seam="unit")
    assert ei.value.attempts == 3 and isinstance(ei.value.last, OSError)
    assert pkg.metrics.get("resilience_retries_unit_total") - before[
        "resilience_retries_unit_total"] == 2
    assert pkg.metrics.get("resilience_retry_exhausted_total") - before[
        "resilience_retry_exhausted_total"] == 1
    assert sleeps == []  # zero backoff never sleeps


def test_fatal_error_is_not_retried_and_nested_policies_do_not_multiply(pkg):
    fn = _flaky(3, lambda i: ValueError("shape bug"))
    with pytest.raises(ValueError, match="shape bug"):
        pkg.RetryPolicy(max_retries=5, sleep=lambda s: None).run(fn)
    assert fn.calls[0] == 1
    inner = pkg.RetryPolicy(max_retries=1, sleep=lambda s: None)
    outer = pkg.RetryPolicy(max_retries=3, sleep=lambda s: None)
    fn = _flaky(100)
    with pytest.raises(pkg.errors.RetryExhaustedError):
        outer.run(lambda: inner.run(fn, seam="inner"), seam="outer")
    assert fn.calls[0] == 2


# --- the classifier ---------------------------------------------------------------


def _shared_cases(p):
    e, doc = p.errors, p.data_model.TextDocument()
    return [
        OSError("disk hiccup"), TimeoutError(), ConnectionResetError(), MemoryError(),
        RuntimeError("RESOURCE_EXHAUSTED: out of memory"), RuntimeError("connection reset"),
        RuntimeError("response body closed before all bytes were read"),
        RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        RuntimeError("an illegal memory access was encountered"),
        RuntimeError("unspecified launch failure"), RuntimeError("launch failed"),
        ValueError("nope"), KeyError("k"), KeyboardInterrupt(),
        e.ParquetError("connection reset while reading footer"),
        e.ParquetError("Invalid magic bytes"), e.CheckpointError("different input"),
        e.DocumentFiltered(doc, "r"), e.StepError("X", e.DocumentFiltered(doc, "r")),
        e.RetryExhaustedError("device", 4, OSError("x")),
        e.RetryExhaustedError("device", 4, RuntimeError("ran out of memory")),
        e.StallError("device_fetch", elapsed_s=1.0, deadline_s=0.5),
    ]


def test_classifier_verdicts_are_the_same_in_both_packages(both):
    jax_pkg, port_pkg = both
    jax_cases, port_cases = _shared_cases(jax_pkg), _shared_cases(port_pkg)
    got = [(port_pkg.classify_error(b), port_pkg.is_oom_error(b)) for b in port_cases]
    want = [(jax_pkg.classify_error(a), jax_pkg.is_oom_error(a)) for a in jax_cases]
    assert got == want
    assert got[0] == ("retryable", False)
    assert got[7] == ("retryable", True)
    assert got[8] == ("fatal", False)


STICKY = [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: the launch timed out and was terminated",
    "CUDA error: device-side assert triggered",
    "CUDA error: unspecified launch failure",
    "CUDA error: misaligned address",
    "sort2: CUDA error 700 (cudaErrorIllegalAddress: an illegal memory access was encountered)",
]


@pytest.mark.parametrize("msg", STICKY)
def test_sticky_cuda_errors_are_fatal(port, msg):
    assert port.classify_error(RuntimeError(msg)) == "fatal"
    assert not port.is_oom_error(RuntimeError(msg))


def test_torch_out_of_memory_is_retryable_and_reaches_the_split_rung(port):
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 8.00 GiB")
    assert port.classify_error(oom) == "retryable"
    assert port.is_oom_error(oom)
    assert port.is_oom_error(port.errors.RetryExhaustedError("device", 4, oom))
    # An OOM's message never carries a sticky marker.
    assert port.classify_error(torch.cuda.OutOfMemoryError("")) == "retryable"


@pytest.mark.parametrize("code,name,verdict,oom", [
    (2, "cudaErrorMemoryAllocation", "retryable", True),
    (700, "cudaErrorIllegalAddress", "fatal", False),
    (702, "cudaErrorLaunchTimeout", "fatal", False),
    (719, "cudaErrorLaunchFailure", "fatal", False),
])
def test_kernel_wrapper_errors_name_the_cuda_error(port, code, name, verdict, oom):
    from textblaster_tpu_torch.kernels.build import check

    check(0, "sort2")
    with pytest.raises(RuntimeError) as ei:
        check(code, "chain_scan")
    msg = str(ei.value)
    assert msg.startswith(f"chain_scan: CUDA error {code} ({name}: ")
    assert port.classify_error(ei.value) == verdict
    assert port.is_oom_error(ei.value) is oom


@pytest.mark.parametrize("msg", ["nvcc failed for scan.cu:\nout of memory",
                                 "could not build or load the kernels: OSError('libtb_scan.so')"])
def test_kernel_build_failures_are_fatal(port, msg):
    from textblaster_tpu_torch.kernels.build import BuildError

    assert port.classify_error(BuildError(msg)) == "fatal"


def test_every_wrapper_checks_through_check():
    from textblaster_tpu_torch.ops import scan, sort

    for mod in (scan, sort):
        src = inspect.getsource(mod)
        assert "CUDA error {err}" not in src
    assert inspect.getsource(scan).count("check(err, ") == 4


# --- circuit breaker --------------------------------------------------------------


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def test_breaker_half_open_cycle(pkg):
    m = pkg.metrics
    clock = FakeClock()
    b = pkg.CircuitBreaker(threshold=2, cooldown_s=10.0, clock=clock)
    trips, probes, recov = (m.get(n) for n in ("resilience_breaker_trips_total",
                                               "resilience_breaker_probe_total",
                                               "resilience_breaker_recoveries_total"))
    b.record_failure("x")
    b.record_success()  # a success resets the streak
    b.record_failure("x")
    assert b.state == "closed" and b.allow_request()
    b.record_failure("x")
    assert b.state == "open" and not b.allow_request()
    assert m.get("resilience_breaker_trips_total") == trips + 1
    assert m.get("resilience_breaker_open") == 1
    clock.t = 9.9
    assert not b.allow_request()
    b.record_success()  # a dispatch from before the trip does not untrip it
    assert b.state == "open"
    clock.t = 10.1
    assert b.allow_request() and b.state == "half_open"
    assert not b.allow_request()  # one probe at a time
    b.record_failure("probe failed")  # reopens with a fresh cooldown
    assert b.state == "open"
    clock.t = 20.0
    assert not b.allow_request()
    clock.t = 20.2
    assert b.allow_request()
    b.record_success()
    assert b.state == "closed" and b.allow_request()
    assert m.get("resilience_breaker_probe_total") == probes + 2
    assert m.get("resilience_breaker_recoveries_total") == recov + 1
    assert m.get("resilience_breaker_open") == 0
    assert m.get("resilience_breaker_trips_total") == trips + 1


def test_breaker_without_cooldown_latches(pkg):
    b = pkg.CircuitBreaker(threshold=1, cooldown_s=0.0, clock=FakeClock())
    b.record_failure()
    assert not b.allow_request()
    b.record_success()
    assert b.tripped
    with pytest.raises(ValueError):
        pkg.CircuitBreaker(threshold=0)


# --- watchdog ---------------------------------------------------------------------


def test_watchdog_wait_and_queue_bounds(pkg):
    w = pkg.StageWatchdog()
    stall = pkg.errors.StallError
    w.wait("device_fetch", lambda: False)  # disarmed: returns at once
    w.configure(0.1)
    assert w.enabled and pkg.metrics.get("watchdog_deadline_seconds_pack_wait") == 0.1
    flag = threading.Event()
    threading.Timer(0.03, flag.set).start()
    w.wait("pack_wait", flag.is_set)
    before = pkg.metrics.get("watchdog_stalls_total")
    with pytest.raises(stall) as ei:
        w.wait("device_fetch", lambda: False, lambda: "wedged")
    assert ei.value.stage == "device_fetch" and "wedged" in str(ei.value)
    q = queue.Queue(maxsize=1)
    w.queue_put("write_queue", q, 1)
    with pytest.raises(stall):
        w.queue_put("write_queue", q, 2)
    assert w.queue_get("read_prefetch", q) == 1
    with pytest.raises(stall):
        w.queue_get("read_prefetch", q)
    assert pkg.metrics.get("watchdog_stalls_total") - before == 3
    w.configure(0.0)
    assert not w.enabled


def test_watchdog_join_thread_restarts_on_progress(pkg):
    w = pkg.StageWatchdog()
    w.configure(0.15)
    done = [0]

    def slow():
        for _ in range(4):
            time.sleep(0.08)
            done[0] += 1

    t = threading.Thread(target=slow)
    t.start()
    w.join_thread("write_queue", t, lambda: done[0])  # 0.32 s, progress every 0.08 s
    assert not t.is_alive()
    stop = threading.Event()
    t = threading.Thread(target=stop.wait)
    t.start()
    with pytest.raises(pkg.errors.StallError):
        w.join_thread("write_queue", t, lambda: 0)
    stop.set()
    t.join(5)
    assert not t.is_alive()


def test_injected_hang_and_delay_kinds(pkg):
    f, w = pkg.FAULTS, pkg.WATCHDOG
    w.configure(0.1)
    f.inject("device.execute", kind="hang", times=1)
    t0 = time.monotonic()
    with pytest.raises(pkg.errors.StallError):
        with w.stage_beat("device_fetch"):
            f.fire("device.execute")
    assert 0.1 <= time.monotonic() - t0 < 2.0
    f.reset()
    f.inject("device.execute", kind="delay", delay_ms=20)
    with w.stage_beat("device_fetch"):
        f.fire("device.execute")  # shorter than the deadline: proceeds
    f.inject("read.batch", kind="delay", delay_ms=500)
    with pytest.raises(pkg.errors.StallError):
        with w.stage_beat("read_prefetch"):
            f.fire("read.batch")
    assert f.fired("device.execute") == 1 and f.fired("read.batch") == 1
    # A hang outside any beat ends when another thread disarms.
    f.reset()
    f.inject("device.execute", kind="hang")
    threading.Timer(0.05, f.reset).start()
    f.fire("device.execute")
    with pytest.raises(ValueError):
        f.inject("x", kind="delay")


def test_wait_device_ready_polls_query(port):
    w = port.StageWatchdog()

    class Event:
        def __init__(self, ready_after):
            self.calls, self.ready_after = 0, ready_after

        def query(self):
            self.calls += 1
            return self.calls > self.ready_after

    w.wait_device_ready("device_fetch", [Event(10**9)])  # disarmed: no poll
    w.configure(0.1)
    ev = Event(2)
    w.wait_device_ready("device_fetch", [ev, object(), 3])  # host objects are ready
    assert ev.calls == 3
    with pytest.raises(port.errors.StallError) as ei:
        w.wait_device_ready("device_fetch", [Event(10**9)])
    assert "CUDA event" in str(ei.value)


def test_beat_is_visible_from_other_threads(port):
    w = port.StageWatchdog()
    w.configure(0.5)
    inside, leave = threading.Event(), threading.Event()

    def body():
        with w.stage_beat("device_fetch"):
            inside.set()
            leave.wait(5)

    t = threading.Thread(target=body)
    t.start()
    assert inside.wait(5)
    assert w.in_beat(t)
    leave.set()
    t.join(5)
    assert not t.is_alive() and not w.in_beat(t)


# --- fault injector ---------------------------------------------------------------


def test_arm_from_env(pkg):
    inj = pkg.FaultInjector()
    n = pkg.arm_from_env({"TEXTBLAST_FAULTS": "read.batch:after=1:times=2;"
                                              "device.execute:exc=RuntimeError;"
                                              "device.execute:delay=5"}, injector=inj)
    assert n == 3 and inj.active()
    inj.fire("read.batch")
    for _ in range(2):
        with pytest.raises(OSError, match="injected fault at read.batch"):
            inj.fire("read.batch")
    inj.fire("read.batch")
    with pytest.raises(RuntimeError):
        inj.fire("device.execute")
    assert pkg.arm_from_env({"TEXTBLAST_FAULTS": "x", "TEXTBLAST_FAULTS_PROCESS": "1"},
                            process_id=0, injector=pkg.FaultInjector()) == 0
    for bad in ("x:exc=SystemExit", "x:hang:delay=3", "x:bogus=1", "x:delay=0"):
        with pytest.raises(ValueError):
            pkg.arm_from_env({"TEXTBLAST_FAULTS": bad}, injector=pkg.FaultInjector())


# --- dead-letter sink -------------------------------------------------------------


def _error_outcome(p, i=0):
    doc = p.data_model.TextDocument(id=f"doc-{i}", content="bad text", source="s.parquet",
                                    metadata={"language": "xx"})
    msg = "Error in processing step 'C4BadWordsFilter': no list for 'xx'"
    return p.data_model.ProcessingOutcome.error(doc, msg, f"worker-{i}")


def test_deadletter_rows_are_the_same_in_both_packages(both, tmp_path):
    tables = []
    for p in both:
        path = str(tmp_path / f"{p.root}.parquet")
        before = p.metrics.get("deadletter_rows_total")
        with p.DeadLetterSink(path, batch_size=2) as sink:
            for i in range(3):
                sink.record_outcome(_error_outcome(p, i))
            sink.record_read_error(p.errors.ParquetError("row quarantined: row group 2"))
        assert p.metrics.get("deadletter_rows_total") - before == 4
        tables.append(pq.read_table(path))
        assert p.outcome_row(_error_outcome(p))["step"] == "C4BadWordsFilter"
        assert p.read_error_row(p.errors.ParquetError("x"))["step"] == "read"
    assert tables[0].schema == tables[1].schema
    assert tables[0].to_pylist() == tables[1].to_pylist()
    rows = tables[1].to_pylist()
    assert rows[0]["metadata"] == '{"language":"xx"}' and rows[3]["id"] is None


def test_deadletter_empty_file_is_well_formed(pkg, tmp_path):
    path = str(tmp_path / "errors.parquet")
    sink = pkg.DeadLetterSink(path)
    sink.close()
    t = pq.read_table(path)
    assert t.num_rows == 0 and t.schema.names == list(pkg.DEADLETTER_SCHEMA.names)
    with pytest.raises(pkg.errors.ParquetError, match="closed"):
        sink.record_read_error(pkg.errors.ParquetError("late"))


# --- inertness and the planted seams ---------------------------------------------


def test_fault_seams_are_planted(pkg):
    reader = importlib.import_module(f"{pkg.root}.io.parquet_reader")
    pipeline = importlib.import_module(f"{pkg.root}.ops.pipeline")
    assert 'FAULTS.fire("read.batch")' in inspect.getsource(reader)
    assert 'FAULTS.fire("device.execute")' in inspect.getsource(pipeline)
    assert not pkg.FAULTS.active()
    assert pkg.FAULTS.fire("device.execute") is None
    assert pkg.FAULTS.fired("device.execute") == 0
    assert not pkg.WATCHDOG.enabled


def test_disabled_watchdog_is_inert_at_every_seam(port, tmp_path, monkeypatch):
    """A whole windowed run (reader thread, pack pool, dispatch thread,
    writer threads) with every watchdog entry point replaced by a
    tripwire: a disabled watchdog is never consulted."""
    import pyarrow as pa

    from textblaster_tpu_torch.config.pipeline import parse_pipeline_config
    from textblaster_tpu_torch.runner import run_pipeline

    def boom(*a, **k):
        raise AssertionError("disabled watchdog was consulted")

    for name in ("stage_beat", "wait", "wait_device_ready", "queue_get", "queue_put",
                 "check_beat", "stall", "join_thread", "in_beat"):
        monkeypatch.setattr(port.WATCHDOG, name, boom)
    monkeypatch.delenv("TEXTBLAST_NO_OVERLAP", raising=False)
    inp = str(tmp_path / "in.parquet")
    good = "This is a sentence with a number of words that is long enough to pass."
    pq.write_table(pa.table({"id": [f"d{i}" for i in range(40)],
                             "text": [good if i % 3 else "too short" for i in range(40)]}),
                   inp, row_group_size=16)
    cfg = parse_pipeline_config(
        "pipeline:\n  - type: GopherQualityFilter\n    min_doc_words: 5\n"
        "overlap:\n  pipeline_depth: 3\n")
    errs = str(tmp_path / "errs.parquet")
    res = run_pipeline(cfg, inp, str(tmp_path / "k.parquet"), str(tmp_path / "e.parquet"),
                       device="cpu", device_batch=8, buckets=(512,), errors_file=errs)
    assert (res.received, res.success, res.filtered) == (40, 26, 14)
    assert pq.read_table(errs).num_rows == 0
    assert not port.FAULTS.active()
