"""The port's multi-host gang against the JAX package's, on the CPU.

Every gang here is two processes of the port's CLI with ``--device cpu``
on one free loopback port (``OMP_NUM_THREADS=1``), joined through
``textblaster_tpu_torch.parallel.multihost``.

* Unit cases: ``detect_stale_shards`` against the JAX function;
  ``merge_shard_files``' rank order and its atomic failure; the exchanges
  at world size 1; the ragged-row guard.
* Two-rank CLI runs over ``tests/test_multihost.py``'s three document sets:
  the merged kept and excluded files equal, row for row, the JAX
  ``run_local_shard`` outputs over each stripe in rank order, and the JAX
  host oracle by id; the merged errors file, the merged run report and
  both ranks' traces.
* Edges and failures: an empty stripe, stale shards with and without
  ``--force``, a peer that never posts (the exchange deadline) and one that
  posts a ragged row (the CLI's peer-failure exit), ``--auto-geometry``
  over the summed histogram, the refusals, the four flags against the JAX
  parser, and the provenance's ``device`` and ``num_processes``.
"""

import contextlib
import io
import json
import logging
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import textblaster_tpu_torch.parallel.multihost as mh
from textblaster_tpu import cli as jax_cli
from textblaster_tpu.config.pipeline import parse_pipeline_config as jax_parse
from textblaster_tpu.data_model import ProcessingOutcome as JaxOutcome
from textblaster_tpu.data_model import TextDocument as JaxDoc
from textblaster_tpu.orchestration import aggregate_results_from_stream as jax_aggregate
from textblaster_tpu.orchestration import process_documents_host as jax_host
from textblaster_tpu.parallel import multihost as jax_mh
from textblaster_tpu.parallel.runner import run_pipeline as jax_run
from textblaster_tpu.pipeline_builder import build_pipeline_from_config as jax_build
from textblaster_tpu_torch import cli
from textblaster_tpu_torch.errors import PeerFailure
from textblaster_tpu_torch.ops.geometry import geometry_from_histogram, length_histogram
from textblaster_tpu_torch.parallel.mesh import data_mesh

from test_multihost import YAML, _docs
from test_torch_pipeline import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = "512,2048"
SPAWN_TIMEOUT_S = 60


def _all_filtered_phase0():
    """``test_one_host_all_filtered_phase0``'s documents: rank 1's stripe is
    all langid-killed."""
    good = [JaxDoc(id=f"g-{i}", source="s", content=(
        "Det er en god dag i dag, og vi skal ud at gå en lang tur "
        "i skoven, og den er ganske fin at læse om vejret nu.")) for i in range(12)]
    bad = [JaxDoc(id=f"b-{i}", source="s", content="zzqx vvkj qqzz xkcv bbnm " * 4)
           for i in range(12)]
    return good + bad


def _uneven_buckets():
    """``test_uneven_bucket_distribution``'s documents: rank 0's stripe all
    short, rank 1's all long."""
    short = [JaxDoc(id=f"s-{i}", source="s",
                    content="Det er en god dag, og vi er ude at gå en tur i skoven nu.")
             for i in range(10)]
    long_ = [JaxDoc(id=f"l-{i}", source="s", content=(
        "En meget lang dansk tekst om byen og havnen og vejret, og "
        "den bliver ved i rigtig mange ord her. ") * 12) for i in range(10)]
    return short + long_


DOC_SETS = {"base": _docs, "all_filtered_phase0": _all_filtered_phase0,
            "uneven_buckets": _uneven_buckets}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_input(tmp_path, docs):
    inp = tmp_path / "input.parquet"
    pq.write_table(pa.table({"id": [d.id for d in docs], "text": [d.content for d in docs],
                             "source": [d.source for d in docs]}), inp)
    (tmp_path / "cfg.yaml").write_text(YAML, encoding="utf-8")
    return inp


def _env():
    env = dict(os.environ)
    env.update({"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    return env


def _spawn(tmp_path, argv, cwd=None):
    return subprocess.Popen(
        [sys.executable, *argv], cwd=str(cwd or tmp_path), env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _gang(tmp_path, extra=(), ranks=(0, 1), port=None):
    """Run the two-rank CLI gang over ``tmp_path/input.parquet``; returns
    ``[(returncode, output), ...]`` in rank order."""
    port = port or _free_port()
    procs = []
    try:
        for pid in ranks:
            argv = ["-m", "textblaster_tpu_torch", "run", "--device", "cpu",
                    "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                    "--process-id", str(pid), "-i", "input.parquet", "-o", "kept.parquet",
                    "-e", "excluded.parquet", "-c", "cfg.yaml", "--quiet", *extra]
            procs.append(_spawn(tmp_path, argv))
        outs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
        return [(p.returncode, out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _rows(path):
    t = pq.read_table(path).to_pydict()
    return list(zip(t["id"], t["text"], t["metadata"]))


def _jax_stripes(docs, tmp_path, n=2):
    """Each rank's stripe through the JAX package in this process, in rank
    order: ``(lockstep, single)``, each a list of ``(kept rows, excluded
    rows)`` a stripe.  ``lockstep`` is the JAX gang's ``run_local_shard``
    (written by the JAX aggregator); ``single`` is the JAX single-process
    ``run_pipeline`` over the stripe's rows (the JAX device path on the
    CPU)."""
    config = jax_parse(YAML)
    stride = -(-len(docs) // n)
    lockstep, single = [], []
    for r in range(n):
        stripe = [d.copy() for d in docs[r * stride:(r + 1) * stride]]
        outcomes = jax_mh.run_local_shard(config, stripe, buckets=(512, 2048)) if stripe else []
        k, e = tmp_path / f"jax_kept{r}.parquet", tmp_path / f"jax_excl{r}.parquet"
        jax_aggregate(iter(outcomes), str(k), str(e))
        lockstep.append((_rows(k), _rows(e)))
        inp = tmp_path / f"stripe{r}.parquet"
        pq.write_table(pa.table({"id": [d.id for d in stripe],
                                 "text": [d.content for d in stripe]}), inp)
        k, e = tmp_path / f"jax_single_kept{r}.parquet", tmp_path / f"jax_single_excl{r}.parquet"
        jax_run(config, str(inp), str(k), str(e), backend="tpu", buckets=(512, 2048), quiet=True)
        single.append((_rows(k), _rows(e)))
    return lockstep, single


def _jax_oracle(docs):
    """The JAX host oracle's decisions: {id: (text, metadata)} kept, excluded."""
    kept, excl = {}, {}
    for o in jax_host(jax_build(jax_parse(YAML)), iter([d.copy() for d in docs])):
        d = o.document
        if o.kind == JaxOutcome.SUCCESS:
            kept[d.id] = (d.content, d.metadata)
        elif o.kind == JaxOutcome.FILTERED:
            excl[d.id] = (d.content, d.metadata)
    return kept, excl


def _by_id(rows):
    return {i: (t, json.loads(m) if m else {}) for i, t, m in rows}


@contextlib.contextmanager
def _cli_in_process():
    """``cli.main`` in this process: the root logger's handlers given back
    after (``init_logging`` replaces them), stderr captured."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            yield err
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in handlers:
            root.addHandler(h)
        root.setLevel(level)


# --- (a) unit cases -----------------------------------------------------------


def test_detect_stale_shards_matches_jax(tmp_path):
    finals = [str(tmp_path / "kept.parquet"), str(tmp_path / "ex[1].parquet")]
    for name in ("kept.parquet.shard0", "kept.parquet.shard1", "kept.parquet.shard2",
                 "kept.parquet.shard10", "ex[1].parquet.shard1", "ex[1].parquet.shard3",
                 "ex1.parquet.shard5", "other.parquet.shard0"):
        (tmp_path / name).write_bytes(b"")
    for n in (1, 2, 3, 11):
        got = mh.detect_stale_shards(finals, n)
        assert got == jax_mh.detect_stale_shards(finals, n)
    assert mh.detect_stale_shards(finals, 2) == sorted(
        str(tmp_path / f) for f in ("kept.parquet.shard2", "kept.parquet.shard10",
                                    "ex[1].parquet.shard3"))


def _shard(path, ids):
    pq.write_table(pa.table({"id": ids, "v": list(range(len(ids)))}), path)


def test_merge_shard_files_rank_order_and_atomic_failure(tmp_path, monkeypatch):
    a, b = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    pairs = []
    for final, n in ((a, 3), (b, 2)):
        shards = [f"{final}.shard{i}" for i in range(n)]
        for i, s in enumerate(shards):
            _shard(s, [f"{i}-{j}" for j in range(i + 1)])
        pairs.append((final, shards))
    real = mh._commit_merged

    def failing(final, shards):
        if final == b:
            raise OSError("disk gone")
        real(final, shards)

    monkeypatch.setattr(mh, "_commit_merged", failing)
    with pytest.raises(OSError):
        mh.merge_shard_files(pairs)
    assert all(os.path.exists(s) for _, shards in pairs for s in shards)
    assert not os.path.exists(b)
    monkeypatch.setattr(mh, "_commit_merged", real)
    mh.merge_shard_files(pairs)
    assert pq.read_table(a).column("id").to_pylist() == ["0-0", "1-0", "1-1", "2-0", "2-1", "2-2"]
    assert pq.read_table(b).column("id").to_pylist() == ["0-0", "1-0", "1-1"]
    assert not list(tmp_path.glob("*.shard*")) and not list(tmp_path.glob("*.tmp"))


def test_exchanges_at_world_size_one():
    assert not mh._distributed_initialized()
    mh.configure_exchange(deadline_s=5)
    posts = mh.METRICS.get("multihost_exchange_posts_total")
    got = mh.host_allgather(np.array([3, -4, 2**40]))
    assert got.dtype == np.int64 and got.tolist() == [[3, -4, 2**40]]
    obj = {"process": 0, "metrics": {"x": 1.5}, "name": "vejr æøå"}
    assert mh.host_allgather_obj(obj) == [obj]
    assert mh.METRICS.get("multihost_exchange_posts_total") == posts + 3
    assert mh.KVExchangeTransport().members() == (0,)
    assert mh.current_exchange_epoch() == 0 and mh.bump_exchange_epoch() == 1
    mh.configure_exchange(deadline_s=mh.DEFAULT_EXCHANGE_DEADLINE_S)
    assert mh.current_exchange_epoch() == 0


@pytest.mark.parametrize("rows,width,bad", [
    ([[1], [1, 2]], 1, 1), ([[], [7]], 1, 0), ([[1, 2], [3, 4], [5]], 2, 2)])
def test_ragged_row_names_the_rank(rows, width, bad):
    with pytest.raises(PeerFailure) as got:
        mh._validate_rows(rows, width, seq=4, epoch=1)
    with pytest.raises(jax_mh.PeerFailure) as want:
        jax_mh._validate_rows(rows, width, seq=4, epoch=1)
    assert got.value.missing_ranks == want.value.missing_ranks == (bad,)
    assert str(got.value) == str(want.value)


# --- (b) two-rank CLI runs ----------------------------------------------------


@pytest.mark.parametrize("doc_set", sorted(DOC_SETS))
def test_two_rank_gang_matches_jax_stripes(tmp_path, doc_set, one_torch_thread):  # noqa: F811
    docs = DOC_SETS[doc_set]()
    _write_input(tmp_path, docs)
    ran = _gang(tmp_path, ("--buckets", BUCKETS, "--errors-file", "errors.parquet",
                           "--run-report", "report.json", "--trace", "t.json"))
    for rc, out in ran:
        assert rc == 0, out[-3000:]
    assert not list(tmp_path.glob("*.shard*"))
    kept, excl = _rows(tmp_path / "kept.parquet"), _rows(tmp_path / "excluded.parquet")
    lockstep, single = _jax_stripes(docs, tmp_path)
    # Row for row: each rank's shard is what a single-process run over its
    # stripe writes, the JAX package's included, and the shards in rank order.
    assert kept == [row for k, _ in single for row in k]
    assert excl == [row for _, e in single for row in e]
    # The JAX gang's stripes hold the same rows, stripe by stripe in rank
    # order; within a stripe its lockstep rounds order the kept rows their
    # own way (the negotiated rounds are not ported yet).
    at = [0, 0]
    for stripe in lockstep:
        for i, (got, want) in enumerate(zip((kept, excl), stripe)):
            assert sorted(got[at[i]:at[i] + len(want)]) == sorted(want)
            at[i] += len(want)
    assert at == [len(kept), len(excl)]
    host_kept, host_excl = _jax_oracle(docs)
    assert _by_id(kept) == host_kept and _by_id(excl) == host_excl
    errors = pq.read_table(tmp_path / "errors.parquet")
    assert errors.num_rows == 0 and {"id", "step", "reason", "worker"} <= set(errors.column_names)
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["num_hosts"] == 2 and [h["process"] for h in report["hosts"]] == [0, 1]
    assert report["counts"] == {"received": len(docs), "success": len(kept),
                                "filtered": len(excl), "errors": 0, "read_errors": 0}
    assert sum(h["counts"]["received"] for h in report["hosts"]) == len(docs)
    assert report["config"]["num_processes"] == 2 and report["config"]["device"] == "cpu"
    for trace in ("t.json", "t.json.host1"):
        text = (tmp_path / trace).read_text()
        assert "trace_clock_offset" in text, trace


# --- (c) edges and failures ---------------------------------------------------


def test_empty_stripe_equals_single_process(tmp_path, one_torch_thread):  # noqa: F811
    from textblaster_tpu_torch.config.pipeline import parse_pipeline_config
    from textblaster_tpu_torch.runner import run_pipeline

    docs = _docs()[:1]
    _write_input(tmp_path, docs)
    for rc, out in _gang(tmp_path, ("--buckets", BUCKETS)):
        assert rc == 0, out[-3000:]
    k, e = str(tmp_path / "one_kept.parquet"), str(tmp_path / "one_excl.parquet")
    run_pipeline(parse_pipeline_config(YAML), str(tmp_path / "input.parquet"), k, e,
                 device="cpu", buckets=(512, 2048), quiet=True)
    assert _rows(tmp_path / "kept.parquet") == _rows(k)
    assert _rows(tmp_path / "excluded.parquet") == _rows(e)
    assert not list(tmp_path.glob("*.shard*"))


def test_stale_shard_fails_before_joining_unless_forced(tmp_path):
    _write_input(tmp_path, _docs()[:8])
    stale = tmp_path / "kept.parquet.shard2"
    stale.write_bytes(b"left over")
    t0 = time.monotonic()
    ran = _gang(tmp_path, ("--buckets", BUCKETS))
    for rc, out in ran:
        assert rc == 1
        assert "stale shard files from a previous run would be ignored by the merge" in out
        assert "kept.parquet.shard2" in out and "--force" in out
    # Neither rank waited for its peer at the join.
    assert time.monotonic() - t0 < 30 and stale.exists()
    for rc, out in _gang(tmp_path, ("--buckets", BUCKETS, "--force")):
        assert rc == 0, out[-3000:]
    assert not stale.exists() and not list(tmp_path.glob("*.shard*"))
    assert pq.read_table(tmp_path / "kept.parquet").num_rows > 0


PEER = textwrap.dedent("""
    import json, sys, time
    from textblaster_tpu_torch.parallel import multihost as mh
    role, port = sys.argv[1], int(sys.argv[2])
    if role == "quit":  # joins, then leaves without posting
        mh.initialize(f"127.0.0.1:{port}", 2, 1)
    elif role == "ragged":  # joins, posts two lanes where one is expected
        mh.initialize(f"127.0.0.1:{port}", 2, 1)
        mh._store().set(mh._ag_key(0, 0, 1), "1,2")
        time.sleep(2)
    else:
        from textblaster_tpu_torch.config.pipeline import load_pipeline_config
        t0 = time.monotonic()
        try:
            mh.run_multihost(load_pipeline_config("cfg.yaml"), "input.parquet", "kept.parquet",
                             "excluded.parquet", coordinator=f"127.0.0.1:{port}",
                             num_processes=2, process_id=0, device="cpu",
                             exchange_deadline_s=3)
            print(json.dumps({"raised": None}))
        except mh.PeerFailure as e:
            print(json.dumps({"raised": "PeerFailure", "missing": list(e.missing_ranks),
                              "seconds": time.monotonic() - t0,
                              "initialized": mh._distributed_initialized()}))
""")


def test_peer_that_never_posts_raises_peer_failure(tmp_path):
    _write_input(tmp_path, _docs()[:8])
    (tmp_path / "peer.py").write_text(PEER)
    port = str(_free_port())
    t0 = time.monotonic()
    procs = [_spawn(tmp_path, ["peer.py", role, port]) for role in ("rank0", "quit")]
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert time.monotonic() - t0 < 20, outs
    assert procs[1].returncode == 0, outs[1]
    got = json.loads(outs[0].strip().splitlines()[-1])
    assert got["raised"] == "PeerFailure" and got["missing"] == [1], outs[0]
    assert 3 <= got["seconds"] < 20 and not got["initialized"]


def test_cli_exits_one_on_peer_failure(tmp_path):
    _write_input(tmp_path, _docs()[:8])
    (tmp_path / "peer.py").write_text(PEER)
    port = _free_port()
    t0 = time.monotonic()
    peer = _spawn(tmp_path, ["peer.py", "ragged", str(port)])
    try:
        (rc, out), = _gang(tmp_path, ("--events-file", "ev.jsonl", "--run-report", "r.json"),
                           ranks=(0,), port=port)
        peer.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if peer.poll() is None:
            peer.kill()
    assert time.monotonic() - t0 < 30
    assert rc == 1 and "Pipeline run failed:" in out and "rank 1 posted 2 lane(s)" in out
    records = [json.loads(x) for x in (tmp_path / "ev.jsonl").read_text().splitlines()]
    fatal = [r for r in records if r["kind"] == "fatal"]
    assert len(fatal) == 1 and fatal[0]["data"]["reason"] == "peer_failure"
    assert fatal[0]["data"]["missing_ranks"] == [1]
    assert records[-1]["kind"] == "run_end" and records[-1]["data"]["exit_code"] == 1
    assert (tmp_path / "kept.parquet.flightrec" / "rank0.json").exists()
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["aborted"] and report["peer_failure"]["missing_ranks"] == [1]


def _geometry_lines(tmp_path):
    lines = (tmp_path / "log" / "textblast.log").read_text().splitlines()
    return [json.loads(x)["message"] for x in lines
            if "Negotiated device geometry" in x]


def test_auto_geometry_gang_builds_on_the_summed_histogram(tmp_path, one_torch_thread):  # noqa: F811
    docs = _uneven_buckets()
    _write_input(tmp_path, docs)
    for rc, out in _gang(tmp_path, ("--auto-geometry",)):
        assert rc == 0, out[-3000:]
    hist = length_histogram([len(d.content) for d in docs])
    want = geometry_from_histogram(hist, backend="cpu")
    lines = _geometry_lines(tmp_path)
    assert len(lines) == 2 and all(line.endswith(want.describe()) for line in lines), lines
    assert all(f"from {len(docs)} documents over 2 processes" in line for line in lines)
    auto = [pq.read_table(tmp_path / f).to_pylist() for f in ("kept.parquet", "excluded.parquet")]
    for rc, out in _gang(tmp_path):
        assert rc == 0, out[-3000:]
    default = [pq.read_table(tmp_path / f).to_pylist() for f in ("kept.parquet", "excluded.parquet")]
    for a, d in zip(auto, default):
        assert {r["id"]: r for r in a} == {r["id"]: r for r in d}


@pytest.mark.parametrize("extra,message", [
    (("--checkpoint-dir", "ck"), "--coordinator and --checkpoint-dir are mutually exclusive"),
    (("--backend", "host"), "--coordinator requires the device pipeline"),
])
def test_coordinator_refusals(tmp_path, extra, message):
    with _cli_in_process() as err:
        rc = cli.main(["run", "-i", str(tmp_path / "in.parquet"), "--device", "cpu",
                       "--coordinator", "127.0.0.1:1", "--num-processes", "2", *extra])
    assert rc == 1 and message in err.getvalue()


@pytest.mark.parametrize("argv", [
    [],
    ["--coordinator", "10.0.0.1:1234", "--num-processes", "4", "--process-id", "3", "--force"],
    ["--coordinator=h:1", "--num-processes=2", "--process-id=1"],
])
def test_four_flags_parse_as_jax(argv):
    base = ["run", "-i", "in.parquet"]
    got = cli.build_parser().parse_args(base + argv)
    want = jax_cli.build_parser().parse_args(base + argv)
    for flag in ("coordinator", "num_processes", "process_id", "force"):
        assert getattr(got, flag) == getattr(want, flag), flag


def test_provenance_records_the_mesh_and_processes(tmp_path, monkeypatch, one_torch_thread):  # noqa: F811
    import textblaster_tpu_torch.runner as runner

    inp = _write_input(tmp_path, _docs()[:10])
    two = data_mesh(["cpu", "cpu"])
    monkeypatch.setattr(runner, "run_mesh", lambda device, mesh: mesh or (two if device is None else None))
    reports = {}
    for tag, device in (("mesh", []), ("cpu", ["--device", "cpu"])):
        rep = tmp_path / f"{tag}.json"
        with _cli_in_process():
            rc = cli.main(["run", "-i", str(inp), "-c", str(tmp_path / "cfg.yaml"), "--quiet",
                           "-o", str(tmp_path / f"{tag}_k.parquet"), "--buckets", BUCKETS,
                           "-e", str(tmp_path / f"{tag}_e.parquet"), "--run-report", str(rep),
                           *device])
        assert rc == 0
        reports[tag] = json.loads(rep.read_text())["config"]
    assert reports["mesh"]["device"] == ["cpu", "cpu"]
    assert reports["cpu"]["device"] == "cpu"
    assert reports["mesh"]["num_processes"] == reports["cpu"]["num_processes"] == 1
    for kind in ("k", "e"):
        assert (set(_rows(tmp_path / f"mesh_{kind}.parquet"))
                == set(_rows(tmp_path / f"cpu_{kind}.parquet")))
