"""Checkpoint/resume in the port (``textblaster_tpu_torch/checkpoint.py``)
against the JAX package's, on the CPU.

Each case of ``tests/test_checkpoint.py`` runs here on the port, on the
host branch and on the device branch (``device="cpu"``): a single-shot
checkpointed run equals a plain run; a crash and its resume give the same
files; a resume with another input, config or geometry is refused; an
auto-geometry resume needs the flag; a foreign non-empty directory is
refused; the finalize keeps unrelated files.  Beside them: the port's
cursor has the JAX cursor's keys and fingerprints, the ``checkpoint.commit``
seam is retried, one ``checkpoint_commit`` journal record a chunk, the
dead-letter rows survive a crash and resume once each, and the CLI's
``--checkpoint-dir`` / ``--checkpoint-every`` / ``--auto-geometry`` and its
two refusals behave as the JAX CLI's.
"""

import contextlib
import io
import json
import os

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from textblaster_tpu.checkpoint import run_checkpointed as jax_run_checkpointed
from textblaster_tpu.cli import main as jax_main
from textblaster_tpu.config.pipeline import parse_pipeline_config as jax_parse
from textblaster_tpu_torch import cli
from textblaster_tpu_torch.checkpoint import (
    CHECKPOINT_FILE,
    CheckpointState,
    _config_fingerprint,
    _input_fingerprint,
    run_checkpointed,
)
from textblaster_tpu_torch.config.pipeline import parse_pipeline_config
from textblaster_tpu_torch.errors import CheckpointError
from textblaster_tpu_torch.resilience import FAULTS
from textblaster_tpu_torch.runner import run_pipeline
from textblaster_tpu_torch.utils.events import EVENTS
from textblaster_tpu_torch.utils.metrics import METRICS

from test_torch_events import hygiene  # noqa: F401  (autouse fixture)

pytestmark = pytest.mark.torch_port

CONFIG_YAML = """
pipeline:
  - type: GopherQualityFilter
    min_doc_words: 5
resilience:
  backoff_base_s: 0.0
  backoff_max_s: 0.0
"""

GOOD = (
    "This is a sentence with a number of words that is long enough to pass "
    "the filter easily today."
)
BAD = "too short"

#: (backend, device) of the port's two branches.
BRANCHES = [("host", None), ("device", "cpu")]
BRANCH_IDS = ["host", "device"]


def _write_input(path, n=50, languages=None):
    rows = {
        "id": [f"doc-{i}" for i in range(n)],
        "text": [GOOD if i % 3 else BAD for i in range(n)],
    }
    if languages is not None:
        rows["metadata"] = ['{"language": "%s"}' % languages[i % len(languages)]
                            for i in range(n)]
    pq.write_table(pa.table(rows), path)


@pytest.fixture
def config():
    return parse_pipeline_config(CONFIG_YAML)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU path on one thread: its batches are small, and under
    a parallel test run a thread a core in every worker spin-waits the
    cores away from each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def _paths(tmp_path, tag):
    return str(tmp_path / f"{tag}_out.parquet"), str(tmp_path / f"{tag}_excl.parquet")


def _same_tables(pairs):
    for a, b in pairs:
        assert pq.read_table(a).to_pydict() == pq.read_table(b).to_pydict(), b


def _plain(config, inp, tmp_path):
    out = _paths(tmp_path, "plain")
    run_pipeline(config, inp, *out, backend="host", quiet=True)
    return out


@pytest.mark.parametrize("backend,device", BRANCHES, ids=BRANCH_IDS)
def test_single_shot_checkpointed_matches_plain(tmp_path, config, backend, device):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp)
    plain = _plain(config, inp, tmp_path)
    ck = _paths(tmp_path, "ck")
    result = run_checkpointed(config, inp, *ck, ckpt_dir=str(tmp_path / "ckpt"),
                              chunk_size=16, backend=backend, device=device)
    assert result.received == 50
    if backend == "host":
        _same_tables(zip(plain, ck))
    else:  # the device branch orders by bucket: the same rows by id
        for a, b in zip(plain, ck):
            assert pq.read_table(a).to_pydict()["id"] == pq.read_table(b).to_pydict()["id"]
    assert not os.path.exists(tmp_path / "ckpt")


@pytest.mark.parametrize("backend,device", BRANCHES, ids=BRANCH_IDS)
def test_crash_and_resume_produces_identical_outputs(tmp_path, config, backend, device):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp)
    once = _paths(tmp_path, "once")
    run_checkpointed(config, inp, *once, ckpt_dir=str(tmp_path / "ck0"), chunk_size=12,
                     backend=backend, device=device)
    out = _paths(tmp_path, "resumed")
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(CheckpointError, match="fault injection"):
        run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=12,
                         backend=backend, device=device, stop_after_chunks=2)
    state = CheckpointState.load(ckpt)
    assert state is not None and state.rows_consumed == 24
    assert not os.path.exists(out[0])
    result = run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=12,
                              backend=backend, device=device)
    assert result.received == 50
    for a, b in zip(once, out):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), b
    assert not os.path.exists(ckpt)


@pytest.mark.parametrize("backend,device", BRANCHES, ids=BRANCH_IDS)
@pytest.mark.parametrize("change", ["input", "config"])
def test_resume_rejects_different_input_or_config(tmp_path, config, backend, device, change):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp)
    ckpt = str(tmp_path / "ckpt")
    out = _paths(tmp_path, "o")
    with pytest.raises(CheckpointError, match="fault injection"):
        run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=10,
                         backend=backend, device=device, stop_after_chunks=1)
    if change == "input":
        _write_input(inp, n=60)
        match = "different input"
    else:
        config = parse_pipeline_config(
            "pipeline:\n  - type: GopherQualityFilter\n    min_doc_words: 6\n")
        match = "different .*config"
    with pytest.raises(CheckpointError, match=match):
        run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=10,
                         backend=backend, device=device)


def test_checkpoint_file_is_valid_json_cursor(tmp_path, config):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(CheckpointError):
        run_checkpointed(config, inp, *_paths(tmp_path, "o"), ckpt_dir=ckpt,
                         chunk_size=20, backend="host", stop_after_chunks=1)
    with open(os.path.join(ckpt, CHECKPOINT_FILE)) as f:
        d = json.load(f)
    assert d["rows_consumed"] == 20 and d["received"] == 20
    assert d["input"]["num_rows"] == 50
    assert all(os.path.exists(os.path.join(ckpt, p)) for p in d["out_parts"])


@pytest.mark.parametrize("backend,device", BRANCHES, ids=BRANCH_IDS)
def test_cursor_matches_the_jax_packages(tmp_path, backend, device):
    """Same input and config: the two cursors after one chunk are equal key
    for key (fingerprints, counts, part names and, on the device, the
    geometry)."""
    inp = str(tmp_path / "in.parquet")
    _write_input(inp, n=30)
    cursors = {}
    for tag, run, cfg, kw in (
        ("port", run_checkpointed, parse_pipeline_config(CONFIG_YAML),
         {"backend": backend, "device": device}),
        ("jax", jax_run_checkpointed, jax_parse(CONFIG_YAML),
         {"backend": "tpu" if backend == "device" else "host"}),
    ):
        ckpt = str(tmp_path / f"ck_{tag}")
        with pytest.raises(Exception, match="fault injection"):
            run(cfg, inp, *_paths(tmp_path, tag), ckpt_dir=ckpt, chunk_size=10,
                device_batch=8 if backend == "device" else None,
                stop_after_chunks=1, **kw)
        with open(os.path.join(ckpt, CHECKPOINT_FILE)) as f:
            cursors[tag] = json.load(f)
    assert cursors["port"] == cursors["jax"]
    assert _input_fingerprint(inp) == cursors["jax"]["input"]
    assert _config_fingerprint(parse_pipeline_config(CONFIG_YAML)) == cursors["jax"]["config_hash"]
    assert (cursors["port"]["geometry"] is not None) == (backend == "device")


def test_device_backend_checkpointed(tmp_path, config):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp, n=30)
    out = _paths(tmp_path, "ck")
    result = run_checkpointed(config, inp, *out, ckpt_dir=str(tmp_path / "ckpt"),
                              chunk_size=8, device="cpu", device_batch=8)
    assert result.received == 30
    plain = _plain(config, inp, tmp_path)
    assert pq.read_table(out[0]).to_pydict()["id"] == pq.read_table(plain[0]).to_pydict()["id"]


def test_resume_rejects_different_geometry(tmp_path, config):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp, n=40)
    ckpt = str(tmp_path / "ckpt")
    out = _paths(tmp_path, "o")
    with pytest.raises(CheckpointError, match="fault injection"):
        run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=10,
                         device="cpu", device_batch=8, stop_after_chunks=1)
    state = CheckpointState.load(ckpt)
    assert state is not None and state.geometry is not None
    assert state.geometry["source"] != "auto"
    assert all(n == 8 for n in state.geometry["batch_sizes"])
    with pytest.raises(CheckpointError, match="geometry.*x16.*original"):
        run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=10,
                         device="cpu", device_batch=16)
    with pytest.raises(CheckpointError, match="WITHOUT --auto-geometry"):
        run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=10,
                         device="cpu", auto_geometry=True)
    result = run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=10,
                              device="cpu", device_batch=8)
    assert result.received == 40
    assert not os.path.exists(ckpt)


def test_auto_geometry_resume_requires_flag(tmp_path, config, monkeypatch):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp, n=40)
    ckpt = str(tmp_path / "ckpt")
    out = _paths(tmp_path, "o")
    with pytest.raises(CheckpointError, match="fault injection"):
        run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=10,
                         device="cpu", auto_geometry=True, stop_after_chunks=1)
    state = CheckpointState.load(ckpt)
    assert state is not None and state.geometry["source"] == "auto"
    with pytest.raises(CheckpointError, match="pass --auto-geometry again"):
        run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=10, device="cpu")

    # The resume reuses the recorded geometry: no second calibration.
    import textblaster_tpu_torch.checkpoint as ck

    def no_calibration(*a, **k):
        raise AssertionError("the resume calibrated again")

    monkeypatch.setattr(ck, "_calibrate", no_calibration)
    result = run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=10,
                              device="cpu", auto_geometry=True)
    assert result.received == 40
    plain = _plain(config, inp, tmp_path)
    assert pq.read_table(out[0]).to_pydict()["id"] == pq.read_table(plain[0]).to_pydict()["id"]


@pytest.mark.parametrize("backend,device", BRANCHES, ids=BRANCH_IDS)
def test_refuses_foreign_non_empty_directory(tmp_path, config, backend, device):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp, n=10)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "precious.txt").write_text("do not delete")
    with pytest.raises(CheckpointError, match="not empty"):
        run_checkpointed(config, inp, *_paths(tmp_path, "o"), ckpt_dir=str(ckpt),
                         chunk_size=5, backend=backend, device=device)
    assert (ckpt / "precious.txt").read_text() == "do not delete"


@pytest.mark.parametrize("backend,device", BRANCHES, ids=BRANCH_IDS)
def test_finalize_preserves_unrelated_files(tmp_path, config, backend, device):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp, n=30)
    ckpt = tmp_path / "ckpt"
    out = _paths(tmp_path, "o")
    with pytest.raises(CheckpointError, match="fault injection"):
        run_checkpointed(config, inp, *out, ckpt_dir=str(ckpt), chunk_size=10,
                         backend=backend, device=device, stop_after_chunks=1)
    (ckpt / "stray.log").write_text("user data")
    result = run_checkpointed(config, inp, *out, ckpt_dir=str(ckpt), chunk_size=10,
                              backend=backend, device=device)
    assert result.received == 30 and os.path.exists(out[0])
    assert (ckpt / "stray.log").read_text() == "user data"
    assert not os.path.exists(ckpt / CHECKPOINT_FILE)
    assert not any(p.suffix == ".parquet" for p in ckpt.iterdir())


def test_commit_fault_is_retried_and_journaled(tmp_path, config):
    """``checkpoint.commit`` armed to raise once: one retry on the
    ``checkpoint`` seam, the same files, and one ``checkpoint_commit``
    journal record a chunk."""
    inp = str(tmp_path / "in.parquet")
    _write_input(inp)
    ref = _paths(tmp_path, "ref")
    run_checkpointed(config, inp, *ref, ckpt_dir=str(tmp_path / "ck0"), chunk_size=16,
                     backend="host")
    journal = str(tmp_path / "events.jsonl")
    EVENTS.configure(journal, rank=0)
    FAULTS.inject("checkpoint.commit", OSError("fsync blip"), times=1)
    before = METRICS.get("resilience_retries_checkpoint_total")
    out = _paths(tmp_path, "out")
    try:
        result = run_checkpointed(config, inp, *out, ckpt_dir=str(tmp_path / "ck1"),
                                  chunk_size=16, backend="host")
    finally:
        EVENTS.close()
    assert result.received == 50
    assert METRICS.get("resilience_retries_checkpoint_total") - before == 1
    assert FAULTS.fired("checkpoint.commit") == 1
    for a, b in zip(ref, out):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), b
    with open(journal) as f:
        records = [json.loads(line) for line in f]
    commits = [r for r in records if r["kind"] == "checkpoint_commit"]
    assert [r["data"]["chunk"] for r in commits] == [1, 2, 3, 4]  # 50 rows, 16 a chunk
    assert commits[-1]["data"]["rows_consumed"] == 50


def test_adopt_claims_the_cursor_and_journals_it(tmp_path, config):
    inp = str(tmp_path / "in.parquet")
    _write_input(inp, n=10)
    ckpt = str(tmp_path / "stripe")
    os.makedirs(ckpt)
    journal = str(tmp_path / "events.jsonl")
    EVENTS.configure(journal, rank=0)
    try:
        state = CheckpointState.adopt(
            ckpt, {"rank": 1, "incarnation": 2},
            input_fingerprint=_input_fingerprint(inp),
            config_hash=_config_fingerprint(config))
    finally:
        EVENTS.close()
    assert state.owner == {"rank": 1, "incarnation": 2}
    assert CheckpointState.load(ckpt).owner == state.owner
    with open(journal) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds.count("checkpoint_adopted") == 1 and kinds.count("checkpoint_commit") == 1
    with pytest.raises(CheckpointError, match="different pipeline config"):
        CheckpointState.adopt(ckpt, {"rank": 0, "incarnation": 0},
                              input_fingerprint=_input_fingerprint(inp), config_hash="x")


BADWORDS_YAML = """
pipeline:
  - type: C4BadWordsFilter
    default_language: en
    keep_fraction: 0.0
    fail_on_missing_language: false
    seed: 1
resilience:
  backoff_base_s: 0.0
"""


@pytest.mark.parametrize("backend,device", BRANCHES, ids=BRANCH_IDS)
def test_deadletter_checkpointed_crash_resume_no_dupes(tmp_path, monkeypatch, backend, device):
    """Every fourth row fails its step (an Error outcome): across a crash
    and its resume the dead-letter file holds each of them once."""
    from textblaster_tpu_torch.filters.c4_badwords import C4BadWordsFilter

    real = C4BadWordsFilter.process

    def process(self, document):
        if document.metadata.get("language") == "xx":
            raise RuntimeError("synthetic step crash for 'xx'")
        return real(self, document)

    monkeypatch.setattr(C4BadWordsFilter, "process", process)
    config = parse_pipeline_config(BADWORDS_YAML)
    if backend == "device":
        # A default language with a local list puts the step on the device,
        # where a crash of its host filter propagates (the JAX package's
        # device path).  One without a list keeps the step on the host, as
        # the JAX package places it; there a step's crash is an Error
        # outcome, the path this branch holds to the dead-letter file.
        # Every row names its language, so the default is never read.
        config.pipeline[0].params.default_language = "sv"
        from textblaster_tpu_torch.ops.pipeline import CompiledPipeline

        placed = CompiledPipeline(config, device=device)
        assert not placed.device_steps and len(placed.host_steps) == 1
    inp = str(tmp_path / "in.parquet")
    _write_input(inp, n=40, languages=("en", "en", "en", "xx"))
    out = _paths(tmp_path, "o")
    errs = str(tmp_path / "errors.parquet")
    ckpt = str(tmp_path / "ck")
    with pytest.raises(CheckpointError, match="fault injection"):
        run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=12, backend=backend,
                         device=device, errors_file=errs, stop_after_chunks=2)
    assert not os.path.exists(errs)
    result = run_checkpointed(config, inp, *out, ckpt_dir=ckpt, chunk_size=12,
                              backend=backend, device=device, errors_file=errs)
    assert result.errors == 10
    dead = pq.read_table(errs).to_pylist()
    assert sorted(r["id"] for r in dead) == sorted(f"doc-{i}" for i in range(3, 40, 4))
    assert all(r["step"] == "C4BadWordsFilter" for r in dead)


# --- the CLI ------------------------------------------------------------------------


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _summary(stdout, tag):
    line = [ln for ln in stdout.splitlines() if ln.startswith("Processed ")][0]
    head, _, tail = line.partition(" in ")
    return head, tail.split(": ", 1)[1].replace(tag, "X")


@pytest.mark.parametrize("auto", [False, True], ids=["checkpoint", "checkpoint_auto"])
def test_cli_checkpoint_flags_match_the_jax_cli(tmp_path, monkeypatch, auto):
    """``--checkpoint-dir`` / ``--checkpoint-every`` (with ``--auto-geometry``
    too): the port's CLI on the CPU and the JAX CLI on the CPU write the
    same kept and excluded rows, print the same summary, and leave no
    checkpoint directory; the port's run report counts the run and its
    journal holds one ``checkpoint_commit`` a chunk between ``run_start``
    and ``run_end``."""
    monkeypatch.chdir(tmp_path)  # the CLI's log directory
    inp = str(tmp_path / "in.parquet")
    _write_input(inp, n=30)
    yaml = tmp_path / "cfg.yaml"
    yaml.write_text(CONFIG_YAML)
    rows = {}
    for tag, main, backend in (("port", cli.main, ["--device", "cpu"]),
                               ("jax", jax_main, ["--backend", "cpu"])):
        out, excl = _paths(tmp_path, tag)
        report, journal = tmp_path / f"{tag}_report.json", tmp_path / f"{tag}_events.jsonl"
        argv = ["run", "-i", inp, "-c", str(yaml), "-o", out, "-e", excl, "--quiet",
                "--checkpoint-dir", str(tmp_path / f"ck_{tag}"), "--checkpoint-every", "7",
                "--run-report", str(report), "--events-file", str(journal),
                *backend] + (["--auto-geometry"] if auto else [])
        rc, stdout, _ = _cli(main, argv)
        assert rc == 0, stdout
        assert not os.path.exists(tmp_path / f"ck_{tag}")
        rows[tag] = ({r["id"]: r for r in pq.read_table(out).to_pylist()},
                     {r["id"]: r for r in pq.read_table(excl).to_pylist()},
                     _summary(stdout, tag))
    assert rows["port"] == rows["jax"]
    with open(tmp_path / "port_report.json") as f:
        report = json.load(f)
    assert report["counts"]["received"] == 30
    assert report["counts"]["success"] == len(rows["port"][0])
    assert report["config"]["auto_geometry"] is auto
    with open(tmp_path / "port_events.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("checkpoint_commit") == 5  # 30 rows, 7 a chunk


@pytest.mark.parametrize("extra", [["--buckets", "512,2048"], ["--device-batch", "8"],
                                   ["--backend", "host"]],
                         ids=["buckets", "device_batch", "host"])
def test_cli_auto_geometry_refusals_match_the_jax_cli(tmp_path, monkeypatch, extra):
    monkeypatch.chdir(tmp_path)
    inp = str(tmp_path / "in.parquet")
    _write_input(inp, n=5)
    got = {}
    for tag, main in (("port", cli.main), ("jax", jax_main)):
        argv = ["run", "-i", inp, "-c", "x.yaml", *_outs(tmp_path, tag), "--auto-geometry",
                *extra]
        (tmp_path / "x.yaml").write_text(CONFIG_YAML)
        got[tag] = _cli(main, argv)
    assert got["port"][0] == got["jax"][0] == 1
    assert got["port"][2] == got["jax"][2]
    assert "--auto-geometry" in got["port"][2]
    assert not os.path.exists(tmp_path / "port_out.parquet")


def _outs(tmp_path, tag):
    out, excl = _paths(tmp_path, tag)
    return ["-o", out, "-e", excl]


def test_cli_flags_parse_as_the_jax_packages():
    from textblaster_tpu.cli import build_parser as jax_parser

    argv = ["run", "-i", "in.parquet", "--checkpoint-dir", "ck", "--checkpoint-every", "100",
            "--auto-geometry"]
    got, want = cli.build_parser().parse_args(argv), jax_parser().parse_args(argv)
    for name in ("checkpoint_dir", "checkpoint_every", "auto_geometry"):
        assert getattr(got, name) == getattr(want, name), name
    got = cli.build_parser().parse_args(["run", "-i", "x"])
    want = jax_parser().parse_args(["run", "-i", "x"])
    for name in ("checkpoint_dir", "checkpoint_every", "auto_geometry"):
        assert getattr(got, name) == getattr(want, name), name
