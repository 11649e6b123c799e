"""The port's CLI (``python -m textblaster_tpu_torch``) against the JAX
package's, on the CPU: the three faults of the port's CLI that the JAX
package does not have, repaired, and the new flags.

* A failed run (the smallest input: ``run -i`` a file that does not exist)
  prints ``Pipeline run failed: <e>`` on stderr and exits 1, with no
  traceback.
* The summary line is the JAX package's
  (``Processed N documents in T.TTs (R.R docs/sec): ...``), printed under
  ``--quiet`` too; ``--quiet`` silences only the progress line and the
  stderr breakdowns.
* ``--batch-size N`` (default 1024) reaches the Parquet reader; the
  progress line shows on a terminal only, throttled, and not under
  ``--quiet``.
* ``--metrics-port`` serves ``/metrics`` during and after the run, and the
  scrape passes the exposition lint.
"""

import contextlib
import io
import logging
import os
import re
import socket
import subprocess
import sys
import types
import urllib.request

import pytest

from textblaster_tpu.cli import build_parser as jax_parser
from textblaster_tpu_torch import cli, orchestration, runner
from textblaster_tpu_torch.cli import build_parser, main
from textblaster_tpu_torch.utils.promlint import exposition_problems

from test_torch_pipeline import _write_parquet, make_corpus

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/pipeline_config_offline.yaml"
SUMMARY = re.compile(
    r"^Processed (\d+) documents in \d+\.\d\ds \(\d+\.\d docs/sec\): "
    r"(\d+) kept -> (\S+), (\d+) excluded -> (\S+), (\d+) errored "
    r"(\(in neither file\)|-> \S+)\.$"
)


@pytest.fixture(autouse=True)
def root_logger():
    """The CLI sets up logging; give each test the root logger back."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    for h in handlers:
        if h not in root.handlers:
            root.addHandler(h)
    root.setLevel(level)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "in.parquet"
    _write_parquet(path, make_corpus(12, seed=3))
    return str(path)


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _outs(tmp_path):
    return ["-o", str(tmp_path / "kept.parquet"), "-e", str(tmp_path / "excl.parquet")]


def test_run_flags_parse_as_the_jax_packages():
    argv = ["run", "-i", "in.parquet", "--batch-size", "512", "--metrics-port", "9091",
            "--run-report", "r.json", "--quiet"]
    got, want = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    for name in ("batch_size", "metrics_port", "run_report", "quiet"):
        assert getattr(got, name) == getattr(want, name), name
    defaults = build_parser().parse_args(["run", "-i", "x.parquet"])
    assert defaults.batch_size == 1024
    assert defaults.metrics_port is None and defaults.run_report is None
    assert defaults.quiet is False


@pytest.mark.parametrize("extra", [["--backend", "host"], ["--device", "cpu"]],
                         ids=["host", "device"])
def test_missing_input_fails_without_a_traceback(tmp_path, extra):
    rc, out, err = _run(["run", "-i", str(tmp_path / "missing.parquet"), "-c", CONFIG,
                         *_outs(tmp_path), *extra])
    assert rc == 1
    assert err.startswith("Pipeline run failed: ")
    assert "missing.parquet" in err
    assert "Traceback" not in err
    assert out == ""


def test_missing_input_exit_code_from_the_shell(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "textblaster_tpu_torch", "run", "-i",
         str(tmp_path / "missing.parquet"), "-c", CONFIG, "--backend", "host",
         *_outs(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
    assert "Pipeline run failed: " in proc.stderr
    assert "Traceback" not in proc.stderr


@pytest.mark.parametrize("quiet", [False, True], ids=["loud", "quiet"])
def test_summary_line_is_printed_in_the_jax_format(small, tmp_path, quiet):
    rc, out, err = _run(["run", "-i", small, "-c", CONFIG, *_outs(tmp_path),
                         "--backend", "host", *(["--quiet"] if quiet else [])])
    assert rc == 0
    lines = out.splitlines()
    m = SUMMARY.match(lines[0])
    assert m, lines[0]
    received, kept, excluded, errors = (int(m.group(i)) for i in (1, 2, 4, 6))
    assert received == 12 and kept + excluded + errors == 12
    assert m.group(3) == str(tmp_path / "kept.parquet")
    assert m.group(7) == "(in neither file)"
    assert ("Stage breakdown" in err) == (not quiet)
    assert "processed=" not in out + err  # the old line is gone


def test_summary_line_names_the_errors_file(small, tmp_path):
    errors = str(tmp_path / "errors.parquet")
    rc, out, _ = _run(["run", "-i", small, "-c", CONFIG, *_outs(tmp_path),
                       "--backend", "host", "--errors-file", errors, "--quiet"])
    assert rc == 0
    m = SUMMARY.match(out.splitlines()[0])
    assert m and m.group(7) == f"-> {errors}"


@pytest.mark.parametrize("batch_size", [1, 5, 256])
def test_batch_size_reaches_the_reader(small, tmp_path, monkeypatch, batch_size):
    seen = []
    real = orchestration.ParquetReader

    def spy(config, **kw):
        seen.append(config.batch_size)
        return real(config, **kw)

    monkeypatch.setattr(orchestration, "ParquetReader", spy)
    rc, out, _ = _run(["run", "-i", small, "-c", CONFIG, *_outs(tmp_path), "--backend",
                       "host", "--batch-size", str(batch_size), "--quiet"])
    assert rc == 0 and SUMMARY.match(out.splitlines()[0])
    assert seen == [batch_size]


def test_summaries_cover_this_run_only(small, tmp_path):
    """Two runs in one process: the second's occupancy and stage summaries
    count its own dispatches, not the process's."""
    dispatches = []
    for k in range(2):
        rc, _, err = _run(["run", "-i", small, "-c", CONFIG, "-o", str(tmp_path / f"k{k}.parquet"),
                           "-e", str(tmp_path / f"e{k}.parquet"), "--device", "cpu",
                           "--buckets", "512,2048", "--device-batch", "16"])
        assert rc == 0
        m = re.search(r"across (\d+) dispatches", err)
        assert m and "Stage breakdown" in err, err
        dispatches.append(int(m.group(1)))
    assert dispatches[0] == dispatches[1] > 0


class _Tty(io.StringIO):
    def isatty(self):
        return True


@pytest.mark.parametrize("tty,quiet,shown", [(True, False, True), (True, True, False),
                                             (False, False, False)])
def test_progress_line_on_a_terminal_only(monkeypatch, tty, quiet, shown):
    err = _Tty() if tty else io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    clock = iter([50.0, 50.05, 50.2])
    monkeypatch.setattr(runner, "time", types.SimpleNamespace(monotonic=lambda: next(clock)))
    p = runner._Progress(enabled=not quiet)
    p.update(orchestration.AggregationResult(received=3, success=2, filtered=1))
    p.update(orchestration.AggregationResult(received=4))  # throttled: within 0.1 s
    p.update(orchestration.AggregationResult(received=5, success=3, filtered=1, errors=1))
    p.finish()
    want = ("\rprocessed=3 kept=2 excluded=1 errors=0"
            "\rprocessed=5 kept=3 excluded=1 errors=1\n") if shown else ""
    assert err.getvalue() == want


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_port_serves_the_runs_counters(small, tmp_path, monkeypatch):
    servers = []
    real = cli.setup_prometheus_metrics

    def capture(port):
        servers.append(real(port))
        return servers[-1]

    monkeypatch.setattr(cli, "setup_prometheus_metrics", capture)
    port = _free_port()
    rc, out, _ = _run(["run", "-i", small, "-c", CONFIG, *_outs(tmp_path), "--device", "cpu",
                       "--buckets", "512,2048", "--device-batch", "16",
                       "--metrics-port", str(port), "--quiet"])
    assert rc == 0 and SUMMARY.match(out.splitlines()[0])
    assert len(servers) == 1 and servers[0] is not None
    try:
        # The endpoint stays up after the run, as the JAX package's does.
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            body = resp.read().decode()
    finally:
        servers[0].shutdown()
        servers[0].server_close()
    assert exposition_problems(body) == []
    for family in ("producer_results_received_total", "occupancy_device_batches_total",
                   "stage_post_seconds"):
        assert f"# TYPE {family} " in body, family
    assert "# TYPE occupancy_dispatches_bucket_" in body
