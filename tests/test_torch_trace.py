"""The port's tracer (``textblaster_tpu_torch/utils/trace.py``) against the
JAX package's, on the CPU, and its device timeline on fake CUDA events.

* The same seeded sequence of spans (with ``add_args``), instants,
  counters and ``align`` calls on both ``TRACER``s gives equal event
  lists once ``ts``, ``dur``, ``pid`` and ``tid`` are masked, in memory and
  spilled to a file that loads as JSON.
* Ring overflow drops the same number of events in both packages and
  counts them in each one's ``trace_events_dropped_total``.
* :class:`DeviceClock` maps device times onto the trace clock, re-anchors
  after each batch's synchronize and reports the drift each re-anchor
  corrects; a batch's spans, mapped between the anchors before and after
  it, stay inside the host's reads around the batch under a timer that
  drifts 500 ppm; a slow clock read makes the anchor record again; :class:`KernelSpans` turns pooled event pairs into
  a Chrome trace of kernel and batch spans.  Both run here on a fake
  ``torch.cuda.Event`` with a device timer that runs fast against the
  host's clock; ``tests/test_torch_card.py`` runs them on the card.
* ``--trace-device`` on the CPU writes a trace with no device spans and
  warns once.
"""

import json
import logging

import numpy as np
import pytest
import torch

from textblaster_tpu.utils import metrics as jm
from textblaster_tpu.utils import trace as jt
from textblaster_tpu_torch.utils import metrics as pm
from textblaster_tpu_torch.utils import trace as pt

from test_torch_events import hygiene  # noqa: F401  (autouse fixture)

from test_torch_pipeline import one_torch_thread  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.torch_port

MASK = ("ts", "dur", "pid", "tid")


def _masked(events):
    return [{k: v for k, v in ev.items() if k not in MASK} for ev in events]


def _calls(seed, n=120):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        op = int(rng.integers(4))
        if op == 0:
            args = {"bucket": int(rng.choice([512, 2048])), "phase": int(rng.integers(3))}
            extra = {"bytes_per_s": float(rng.integers(1, 1000))} if rng.random() < 0.3 else None
            out.append(("span", ["read", "pack", "dispatch", "post"][int(rng.integers(4))],
                        args if rng.random() < 0.8 else None, extra))
        elif op == 1:
            out.append(("instant", ["retry", "breaker_trip", "ladder_split"][int(rng.integers(3))],
                        {"seam": "device", "attempt": i} if rng.random() < 0.7 else None, None))
        elif op == 2:
            out.append(("counter", ["inflight_batches", "queue_depth_pack"][int(rng.integers(2))],
                        int(rng.integers(0, 5)), None))
        else:
            out.append(("align", None, int(rng.integers(0, 10**6)), {"host": i}))
    return out


def _replay(tracer, calls):
    for op, name, a, b in calls:
        if op == "span":
            with tracer.span(name, a) as sp:
                if b is not None:
                    sp.add_args(b)
        elif op == "instant":
            tracer.instant(name, a)
        elif op == "counter":
            tracer.counter(name, a)
        else:
            tracer.align(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_same_calls_give_equal_events(seed):
    calls = _calls(seed)
    got = {}
    for tag, mod in (("jax", jt), ("port", pt)):
        mod.TRACER.configure(None, ring=4096)
        _replay(mod.TRACER, calls)
        got[tag] = mod.TRACER.drain()
        mod.TRACER.close()
    assert _masked(got["port"]) == _masked(got["jax"])
    assert len(got["port"]) > len(calls) // 2
    # Disarmed, a call records nothing.
    _replay(pt.TRACER, calls)
    assert pt.TRACER.drain() == []


def test_ring_overflow_drops_and_counts_alike(capsys):
    dropped = {}
    for tag, mod, reg in (("jax", jt, jm.METRICS), ("port", pt, pm.METRICS)):
        before = reg.get("trace_events_dropped_total")
        mod.TRACER.configure(None, ring=16)
        for i in range(100):
            mod.TRACER.instant("retry", {"attempt": i})
        kept = mod.TRACER.drain()
        mod.TRACER.close()
        dropped[tag] = (reg.get("trace_events_dropped_total") - before, _masked(kept))
    assert dropped["port"] == dropped["jax"]
    assert dropped["port"][0] > 0
    assert capsys.readouterr().err.count("trace events dropped") == 2


def test_spill_files_load_as_json_and_agree(tmp_path):
    calls = _calls(7, n=200)
    loaded = {}
    for tag, mod in (("jax", jt), ("port", pt)):
        path = tmp_path / f"{tag}.json"
        mod.TRACER.configure(str(path), ring=16)
        _replay(mod.TRACER, calls)
        mod.TRACER.close()
        loaded[tag] = json.loads(path.read_text())
    assert _masked(loaded["port"]) == _masked(loaded["jax"])
    assert loaded["port"][0]["name"] == "process_name"


def test_clock_helpers_behave_alike():
    for mod in (jt, pt):
        mod.TRACER.configure(None)
        a = mod.TRACER.now_us()
        wall = mod.TRACER.wall_at_origin_us()
        mod.TRACER.align(500_000)
        assert mod.TRACER.now_us() >= a + 500_000
        assert abs(wall - mod.TRACER.wall_at_origin_us()) < 50_000
        mod.TRACER.close()


# --- the device timeline on fake CUDA events ----------------------------------------------

class _FakeDevice:
    """A device timer that runs ``rate`` times as fast as the host's trace
    clock, ``offset_us`` ahead of it; events take the device time at
    ``record`` (or at the next ``release``, when the stream is busy), and
    ``elapsed_time`` reads the device timer."""

    def __init__(self, monkeypatch, rate=1.0 + 2e-5, offset_us=1234.5):
        self.rate, self.offset_us = rate, offset_us
        self.host_us = 0.0
        self.busy = False
        self.held = []
        dev = self

        class Event:
            def __init__(self, enable_timing=False):
                self.t = None

            def record(self, stream=None):
                self.t = None
                if dev.busy:
                    if self not in dev.held:
                        dev.held.append(self)
                else:
                    self.t = dev.device_us()

            def query(self):
                return self.t is not None

            def elapsed_time(self, other):
                if self.t is None or other.t is None:
                    raise RuntimeError("event not complete")
                return (other.t - self.t) / 1000.0

            def synchronize(self):
                if self.t is None:
                    dev.release()

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
        monkeypatch.setattr(pt.TRACER, "now_us", lambda: dev.host_us)

    def device_us(self):
        return self.offset_us + self.host_us * self.rate

    def release(self):
        self.busy = False
        for ev in self.held:
            ev.t = self.device_us()
        self.held = []


@pytest.mark.parametrize("rate", [1.0 + 2e-5, 1.0 - 5e-5, 1.0])
def test_device_clock_maps_and_reanchors(monkeypatch, rate):
    dev = _FakeDevice(monkeypatch, rate=rate)
    clock = pt.DeviceClock()
    clock.anchor(None)
    worst = 0.0
    for b in range(40):
        dev.host_us += 10_000.0
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        dev.host_us += 3_000.0
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        dev.host_us += 50.0  # the synchronize returns
        clock.settle(None)
        # Device times read on the host clock: the error is what the timer
        # drifted since the anchor in use, recorded after the last batch.
        worst = max(worst, abs(clock.to_us(start) - (dev.host_us - 3_050.0)))
        assert start.elapsed_time(end) == pytest.approx(3.0 * rate)
    stats = clock.stats()
    drift = abs(rate - 1.0)
    assert stats["reanchors"] == 39  # the last batch's anchor is still pending
    assert worst <= 10_000.0 * drift + 1e-6
    # Drifts are rounded to 1 ns, the span to 1 ms.
    assert stats["max_drift_us"] == pytest.approx(13_050.0 * drift, abs=1e-3)
    # The latest anchor taken over was recorded after batch 39.
    assert stats["total_drift_span_s"] == pytest.approx(39 * 0.01305, abs=1e-3)
    assert stats["total_drift_us"] == pytest.approx(39 * 13_050.0 * (rate - 1.0), abs=1e-3)


def test_reanchor_waits_until_the_device_passes_it(monkeypatch):
    dev = _FakeDevice(monkeypatch)
    clock = pt.DeviceClock()
    clock.anchor(None)
    dev.host_us += 100.0
    clock.settle(None)  # records a re-anchor
    dev.busy = True  # the next one waits behind queued work
    dev.host_us += 100.0
    clock.settle(None)
    assert clock.reanchors == 1
    dev.host_us += 100.0
    clock.settle(None)  # still queued: not taken, no new one recorded
    assert clock.reanchors == 1 and len(dev.held) == 1
    dev.release()
    clock.settle(None)
    assert clock.reanchors == 2
    # An anchor the device reached 100 us late shows as 100 us of drift:
    # why an anchor goes on an idle stream.
    assert clock.stats()["max_drift_us"] == pytest.approx(100.0, abs=0.01)


@pytest.mark.parametrize("rate", [1.0 + 5e-4, 1.0 - 5e-4, 1.0])
def test_bracketed_batch_spans_stay_inside_their_host_span(monkeypatch, rate):
    """A batch of one second after a wait of two, on a device timer that
    drifts 500 ppm against the host clock: mapped from the anchor before
    the batch alone, a fast timer puts the batch's end past the host's
    read after its synchronize; mapped between the anchors before and
    after it (``bracketed``), start and end land inside the host span,
    each early by less than the record latency."""
    dev = _FakeDevice(monkeypatch, rate=rate)
    clock = pt.DeviceClock()
    clock.anchor(None)
    latency = 3.0  # host read to device stamp of every record, in us
    for b in range(5):
        dev.host_us += 2_000_000.0
        host_start = dev.host_us
        dev.host_us += latency
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        dev.host_us += 1_000_000.0
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        dev.host_us += latency  # the synchronize returns
        host_end = dev.host_us
        clock.settle(None)
        span = clock.bracketed()
        t0, t1 = span.to_us(start), span.to_us(end)
        assert host_start <= t0 <= host_start + latency + 1e-6
        assert host_end - latency - 1e-6 <= t1 <= host_end
        if rate > 1.0:
            assert clock.to_us(end) > host_end  # the fault bracketed() repairs
    assert clock.bracketed() is not clock  # a pending anchor: interpolate


def test_anchor_is_recorded_again_after_a_slow_clock_read(monkeypatch):
    """A read of the trace clock that ends more than 20 us after it began
    (the thread was descheduled between the read and the record) makes
    the anchor record again, at most three times."""
    dev = _FakeDevice(monkeypatch)
    reads = iter([0.0, 50.0, 60.0, 61.0] + [61.0] * 10)
    monkeypatch.setattr(pt.TRACER, "now_us", lambda: next(reads))
    records = []
    real = torch.cuda.Event

    class Counted(real):
        def record(self, stream=None):
            records.append(dev.host_us)
            super().record(stream)

    monkeypatch.setattr(torch.cuda, "Event", Counted)
    clock = pt.DeviceClock()
    clock.anchor(None)
    assert len(records) == 3  # the creating record, a slow one, a tight one
    assert clock._anchor_us == 60.0


def test_kernel_spans_resolve_into_a_chrome_trace(monkeypatch, tmp_path):
    dev = _FakeDevice(monkeypatch, rate=1.0, offset_us=0.0)
    clock = pt.DeviceClock()
    clock.anchor(None)
    spans = pt.KernelSpans()
    assert not spans.enabled
    spans.configure(str(tmp_path))
    launched = []
    for b in range(3):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        for kernel, key in (("chain_scan", ("chain_scan", 64, 2048)),
                            ("sort2", ("sort2", 64, 2048))):
            ev = spans.begin(None)
            dev.host_us += 7.0
            spans.end(ev, None, kernel, key)
            dev.host_us += 1.0
            launched.append(kernel)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        spans.resolve(clock, start, end, {"bucket": 2048, "phase": 0, "batch": b + 1})
    assert len(spans._pool) == 4  # handed back after each batch, and reused
    path = spans.close()
    assert not spans.enabled and spans.close() is None
    events = json.load(open(path))
    kernels = [e for e in events if e.get("tid") == 2 and e["ph"] == "X"]
    batches = [e for e in events if e.get("tid") == 1 and e["ph"] == "X"]
    assert [e["args"]["kernel"] for e in kernels] == launched
    assert kernels[0]["name"] == "chain_scan[64,2048]" and kernels[0]["dur"] == 7.0
    assert sum(e["dur"] for e in kernels) == pytest.approx(42.0)
    assert sum(e["dur"] for e in batches) == pytest.approx(48.0)
    assert [e["args"]["batch"] for e in batches] == [1, 2, 3]
    for k in kernels:
        b = batches[k["args"]["batch"] - 1]
        assert b["ts"] <= k["ts"] and k["ts"] + k["dur"] <= b["ts"] + b["dur"]


def test_trace_device_on_the_cpu_writes_no_spans_and_warns_once(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="textblaster_tpu_torch.utils.trace"):
        with pt.device_profile(str(tmp_path / "dev"), "cpu"):
            assert pt.KERNEL_SPANS.enabled
        with pt.device_profile(None, "cpu"):
            assert not pt.KERNEL_SPANS.enabled
    events = json.load(open(tmp_path / "dev" / pt.DEVICE_TRACE_FILE))
    assert {e["ph"] for e in events} == {"M"}
    assert len([r for r in caplog.records if "no device spans" in r.getMessage()]) == 1
