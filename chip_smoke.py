#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final result line):

1. Environment: the card's name and power limit (``nvidia-smi``); exits
   with code 2 when CUDA is not available or the port is not beside this
   script.
2. Build: compiles ``textblaster_tpu_torch/csrc/*.cu`` with ``nvcc``
   (``sm_90a``), one compiler per source, all at once; the runtime's names
   of the CUDA errors the classifier tells apart must be the kernel
   wrappers' (``kernels/build.py`` ``CUDA_ERRORS``).
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, with ``torch.equal`` (exact: every value is int32), at the
   shapes the main path gives it: ``affine_scan`` (k = 1, 2) and
   ``dfa_scan`` (1..8 states, maps with stray nibbles above them) at every
   edge of ``scan_geometry`` (1 .. 70000 lanes on 1, 7, 64 and 65 rows),
   on aligned tensors and offset views; ``fused_scan`` with each of its four call
   sites' group lists and two generic lists, also beyond its 16384-lane
   gate, and at its edges (one and zero lanes in both emit modes, 1, 7
   and 65 rows, DFA maps with stray nibbles at 1..8 states, offset views
   at ragged widths); ``chain_scan`` with every call site's program, built by the sites'
   own builders on batches of corpus documents of each bucket (both C4
   split modes; above 16384 lanes the sorted-table programs, 8192 and
   16384 wide), with the JAX package's probe program and with a generic
   full-range program (every group kind, forward and reverse passes, shift
   taps with nonzero fills, every emit mode) at every width the chain takes;
   ``sort3`` with ties and the int32 extremes at every edge of its
   layouts (1 .. 40000 keys, the last on the shared-memory network, on 1,
   7, 64 and 65 rows, aligned and on offset views), printing the layout
   each width takes.  Then CUDA-event timings
   beside the bound (the larger of the bytes at 3.35 TB/s and the integer
   operations at 67 T/s): the kernel and, where one exists, the single
   PyTorch call computing the same function, each replayed from a CUDA
   graph of 10 calls (device time); the wrapper's eager call (host cost
   included); and the plain version.  The per-scan kernels are timed in
   every variant the main path launches (k = 1, 2; 4 and 5 states).  ``sort2`` also at edge widths (1 .. 16384 keys,
   ragged) on 1, 7 and 320 rows; ``chain_scan`` also on 600 short rows
   ([600, 256]) and with a ragged cluster ([64, 5000]).  The split rung's
   half batches (32 rows a job) are checked too: the per-scan kernels at
   32768/65536, ``sort2`` at 32/64/128/160 rows, ``fused_scan`` and every
   chain site's program on 32-row batches.
4. Main path: a seeded synthetic Danish/English corpus of >= 20,000
   documents whose lengths fill all five default buckets is written to
   Parquet and run through the port's ``run`` entry point on ``cuda`` with
   ``configs/pipeline_config_offline.yaml``: under the chain schedule (the
   default) over the whole corpus, windowed (the default: reader thread,
   pack pool, a dispatch thread on its own CUDA stream with two batches in
   flight, writer threads); over its first 2,000 documents, windowed,
   under the fused schedule (``TEXTBLAST_DEPFUSE=off``), the staged one
   (``TEXTBLAST_FUSED=off``) and the chain schedule with
   ``TEXTBLAST_HOST_TAILS=off``, then the last serially
   (``TEXTBLAST_NO_OVERLAP=1``);
   then once through the port's host oracle (sharded over the CPU cores,
   one process per shard).  Each run's kept and excluded sets must equal
   the oracle's id for id (text and metadata), parity exactly 1.0; the
   windowed chain run with tails off must write the same kept and
   excluded ids, and the same bytes, as the serial one; the chain run
   must dispatch every
   default bucket and route astral documents to the host (the u16 wire);
   each chain run must launch ``chain_scan``, ``fused_scan``,
   ``affine_scan``, ``dfa_scan`` and ``sort2``; each fused run
   ``fused_scan`` and never ``chain_scan``; the staged run ``affine_scan``,
   ``dfa_scan`` and ``sort2`` and neither ``fused_scan`` nor
   ``chain_scan``.  Launch counters (per kernel, per shape, and per chain
   site and width) are set to 0 just before each run and read just after.
   Each run prints docs/s, parity, the stage seconds (pack, device per
   phase, wait, drain, assembly, host routes and their tail share, read,
   write), the host
   routes by cause, the bytes uploaded and the device-busy share: CUDA
   events around each batch on the stream that ran it, summed, over the
   run's wall time.  Each run's report (the port's ``build_run_report``
   relative to a ``metrics_snapshot`` taken just before the run) must
   hold its outcome counts, a funnel whose per-step drops sum to the rows
   of the excluded file, and device batches equal to the pipeline's
   batches over all phases and to the per-bucket dispatch counters,
   bucket by bucket; each run prints the report's stage breakdown (the
   JAX package's stage names, with the host/device verdict), the padding
   waste and the funnel.
   The first windowed chain run over the whole corpus runs with the
   profiler armed (``utils/profiler.py``): configure, the cost pass
   (before the launch counters are set to 0), the run, close.
5. Launches per shape: the first chain run's launches of every kernel by
   shape and variant, each beside the kernel's time at that shape
   (``sort2`` and the per-scan kernels are timed at every shape and
   variant the run launched them at), and per kernel the sum of
   launches x (kernel ms - bound ms), the device time the kernel loses on
   the main path against its bound.
6. The profiler: per (bucket, phase) of the profiled chain run, the
   dispatch count, mean / p50 / p99 device seconds (the batch's CUDA
   events), the modeled bytes, the achieved bytes/s and its share of
   3.35 TB/s; the top-8 slowest dispatches and the recommended
   ``--stage-deadline-s`` (twice the slowest); the HDR counts must equal
   the batches dispatched, bucket by bucket, and the cost model's launches
   times each program's dispatches must be at least the run's launches
   (printed with the gap per kernel); its docs/s beside the next
   windowed run's (the CLI's profiled run is the same-documents pair).
   Then one batch of
   corpus documents per (bucket, phase) of the default ladder, plainly
   and under ``torch.profiler`` (CPU and CUDA activity): the batch's
   CUDA-event span split into hand-kernel time, eager PyTorch kernel time
   and launches, copies, device idle gaps and host time blocked in
   synchronizing calls (fails when the profiler records no CUDA
   activity).  Then the sentinel workload on ``cuda`` and on ``cpu``:
   equal dispatch counts (the JAX package's baseline's) and an equal cost
   fingerprint, passing ``profiles/sentinel_baseline_torch.json``.
7. The CLI: ``textblaster_tpu_torch.cli.main`` on ``cuda`` over the first
   2,000 documents with ``--run-report`` and ``--metrics-port`` on a free
   loopback port; one ``GET /metrics`` while the endpoint is up must pass
   the exposition rules (``utils/promlint.py``), the summary line must be
   the JAX package's, with the report's counts and the files' rows; a run
   over a missing input must exit 1 with ``Pipeline run failed:``.  The
   same documents again with the trace, device trace, journal and two
   SLOs armed (the ``cli armed`` line), then with ``--doc-sample-rate 1``
   (every document: the worst case), a ``p99_latency_s`` SLO,
   ``--run-report`` and ``--metrics-port`` (the ``cli telemetry`` line):
   files byte-identical to the plain run's; ``doc_sampled_total`` equal to
   the ids read; the ``e2e`` latency count, and the ``doc_flow`` lineages
   (one a document, by id), equal to the documents written; every
   lineage's stamps non-decreasing in stage order (its stage deltas sum to
   its end-to-end latency); ``GET /telemetry`` during the run answers
   JSON with at least one rollup window; the SLO saw events.  Then with
   ``--profile`` and ``--run-report`` (the ``cli profiled`` line): files
   byte-identical to the plain run's, the report's ``device_profile``
   dispatch counts summing to its device batches, a cost fingerprint,
   the ``Device profile:`` line, docs/s against the plain run's.  Then
   the host seconds of one registry increment (the unit cost of a metric
   hook), over 200,000 of them.
8. Auto-geometry: ``run_pipeline(auto_geometry=True)`` over the first
   5,000 documents (the whole calibration sample), windowed, chain
   schedule, host tails on, beside the default geometry's run of the same
   documents; both held to the host oracle (parity 1.0) and to each other
   (every column, by id).  Prints the calibrated buckets and batch sizes,
   and for both runs docs/s, padding waste, batches per bucket, host
   tails and peak device memory.  Every (kernel, rows, width, variant)
   the calibrated run launched and no default-geometry run did is held to
   its plain version (``torch.equal``): the per-scan kernels in that
   variant, ``sort2``, ``fused_scan`` with every call site's list, and
   ``chain_scan`` with every call site's program on a corpus batch of each
   calibrated bucket at its rows (probe and generic programs at any shape
   left over).
9. C4BadWords on the device: ``affine_scan`` with k = 1 on the operands
   ``ops/badwords.py`` gives it (``m`` 0 at column 0, 31 or 1,000,003 inside
   the row, 1 past its end; lowered code points) at every default bucket
   and calibrated width, on 1, 7, 64 and 65 rows and the calibrated batch
   rows, aligned and on offset views, ``torch.equal`` to its plain version,
   then timed at 1,000,003 on each bucket's geometry rows beside its bound.
   Path (a): the JAX package's badwords benchmark config (``bench.py``'s
   text, ``synth_badwords(515, n=400)`` as the ``en`` list in a cache dir)
   over the first 10,000 documents with ``bench.py``'s injection (about 5% of the
   documents given a list entry, 0.5% ``" ſ"``), windowed, host tails off:
   parity 1.0 against the host oracle, every default bucket dispatched,
   exactly two ``affine_scan`` launches (k = 1) a batch and no other
   launch, ``worker_fold_hazard_rows_total`` equal to the device rows
   holding an ``en`` hazard code point, the funnel's drops all the
   filter's and equal to the excluded rows; docs/s, the tables' distinct
   lengths and ``max_dup``, the host routes, the device-busy share and the
   peak device memory of one 64 x 65536 batch.  Path (b): the offline
   pipeline with ``C4BadWordsFilter`` (``da``, keep 0.1, seeded) appended,
   over the first 3,000 documents with about 5% given a ``da`` entry,
   beside the offline pipeline alone over the same file: both at parity
   1.0, the step on the device in phase 2, kept-by-fraction rows present,
   every chain-run kernel launched and ``affine_scan`` with k = 1 at 512,
   2048 and 8192.
10. The native host core (``textblaster_tpu_torch/native``, built with
   ``g++`` before the main path, which already runs its host routes on
   it): the build seconds, ``available()`` (must be True) and the host
   CPU (``lscpu``); on one pool of worker processes, before any run, the
   core against the numpy paths on this host over the first 2,000
   documents and every CJK and astral one (word spans, the offline
   config's top 2-4 and dup 5-10 n-gram scans, duplicate lines and
   paragraphs) and ``utf8_lengths`` / ``pack_utf8`` at every default
   bucket over the corpus Parquet's Arrow buffers, every result equal,
   beside the token-counting run's host oracle;
   the chain schedule, windowed, over the first 2,000 documents with the
   core on and then off (``native.disabled()``): parity 1.0 both, kept
   and excluded files byte-identical, the core's calls above 0 and 0,
   docs/s, host-route and tail seconds each; then
   ``configs/pipeline_config.yaml`` with TokenCounter on a ``merges.txt``
   written from the vendored stand-in's merges, on the card over the
   first 2,000 documents: equal to the host oracle under the same spec
   row for row, ``token_count`` on every kept row, one BPE call a kept
   row.
11. Checkpoint/resume over the CLI run's 2,000 documents, 500 a chunk: an
   uninterrupted ``cli.main`` run with ``--checkpoint-dir`` and
   ``--events-file``; ``run_checkpointed`` stopped after 2 chunks and
   resumed; the same under ``auto_geometry=True`` (a resume without the
   flag must raise ``CheckpointError``; the resume must not calibrate
   again; its new kernel shapes are held to the plain versions); one run
   with ``checkpoint.commit`` armed to raise ``OSError`` once (exactly one
   checkpoint retry).  Every run's files equal the uninterrupted run's row
   for row (the calibrated run's by id) and the non-checkpointed CLI
   run's by id, every column; one ``checkpoint_commit`` journal record a
   chunk; no checkpoint directory left.
12. The data mesh over the first 1,000 documents (2,000 until the gang
   phase came, to make room for it): the chain schedule, serially, on
   ``[cuda:0]``, ``[cuda:0, cuda:0]`` and the default mesh, each at parity
   1.0 and equal to the single-device windowed run with tails off over
   the subset (restricted to its documents), every main-path kernel
   launched on every shard; every (bucket, phase) stage dict of the
   two-shard mesh ``torch.equal`` to one device's; ``dryrun_multichip``;
   docs/s beside the single-device runs.
13. The multi-host gang: two ranks as processes of the port's CLI
   (``--coordinator 127.0.0.1:<free port> --num-processes 2``, each run by
   ``GANG_RANK``, a small program that calls ``cli.main`` and writes the rank's
   kernel launches beside its shard) on this one card over the CLI phase's
   2,000 documents, chain schedule, windowed, with ``--run-report``,
   ``--trace``, ``--events-file`` and ``--errors-file``: both exit 0 and
   leave no shard; the merged files equal, row for row, the port's
   in-process windowed runs over rows 0-999 and 1000-1999 concatenated;
   parity 1.0 against the host oracle; the merged report's counts the
   files' rows, with two hosts; both traces hold the clock handshake;
   every rank launched every main-path kernel on the card.  Prints each
   rank's wall seconds and docs/s, the gang's wall beside the CLI phase's
   single-process run and the exchanges posted.
14. Fault phase: the degradation ladder, the breaker and the watchdog,
   each run with zero backoff and a breaker threshold of 2 and held to a
   fault-free run of the same documents (kept and excluded rows equal by
   id, every column): over the first 1,000 documents a fault-free run
   writing ``--errors-file`` (a well-formed empty file), a retry run
   (``device.execute`` raises ``OSError`` twice at the run's last dispatch:
   one retry) and a split run (five times: the batch exhausts its retries
   and splits; every shape the halves launched that the fault-free run did
   not must have been held to its plain version); over the first 500 an
   outage (every dispatch fails: every document on the host rung, the
   breaker trips once); over the first 1,000 at depth 3 an injected hang
   twice under a 0.5 s stage deadline; over the first 192 documents longer
   than 32,768 characters (only the 65536 bucket) a real out-of-memory run, the
   allocator capped before each batch between the half batch's and the
   full batch's peak of its phase (measured in two pilot runs), where
   every full batch must split and no document reach the host rung; and
   a fatal ``ValueError`` that must propagate with no dispatch thread
   left.  Each run prints docs/s beside its fault-free run's, the ladder
   and watchdog counters and the launches at the split rows.
15. Output: a ``{"kernels": [...]}`` line (each kernel's launches on
   the chain main path, and by path: chain, badwords (a), Danish badwords
   (b); by shard of the two-shard mesh; by rank of the gang), the
   ``nvidia-smi`` line, and as
   the last line ``{"ok": true, "device": {...}}``.

Long output (per-shape kernel timings, the main path's counters) is also
written to ``chip_smoke.json`` in ``$CHIP_SMOKE_OUT``
(default ``build/chip_smoke/``, where the scratch files go too).  The
script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "pipeline_config_offline.yaml")
N_DOCS = int(os.environ.get("CHIP_SMOKE_DOCS", "20000"))
#: The documents of the runs over a subset: 2,000 (3,000 until the native
#: phase came), so that the later phases fit the script's time.
STAGED_SUBSET = 2000
#: The auto-geometry phase's documents: the first GEOMETRY_DOCS.
GEOMETRY_DOCS = 5000
#: Windowed runs over the first STAGED_SUBSET documents: the fused and the
#: staged schedules, and the chain schedule with the host tails off.
SUBSET_RUNS = (("fused", {"TEXTBLAST_DEPFUSE": "off"}), ("staged", {"TEXTBLAST_FUSED": "off"}),
               ("chain_tails_off", {"TEXTBLAST_HOST_TAILS": "off"}),
               ("chain_serial", {"TEXTBLAST_HOST_TAILS": "off", "TEXTBLAST_NO_OVERLAP": "1"}))
SEED = 20251016
# The offline config's GopherRepetition n-gram sizes.
TOP_NS, DUP_NS = (2, 3, 4), (5, 6, 7, 8, 9, 10)

# Word lists copied from the repo's bench.py (Danish / English prose).
DANISH_WORDS = (
    "det er en god dag og vi skal ud at gå tur i skoven solen skinner over "
    "byen der mange mennesker på gaden som arbejde nu efter turen vil gerne "
    "drikke kop kaffe spise lidt brød hjemme haven igen bliver dejlig "
    "eftermiddag fordi vejret så godt børnene kommer fra skole aftenen lave "
    "mad sammen se film stuen før seng huset store vinduer mod syd lyset "
    "falder ind om morgenen når står op tidligt cyklen til byen langs vandet "
    "møder venner torvet taler længe gamle dage planlægger næste rejse sydpå"
).split()
ENGLISH_WORDS = (
    "the quick brown fox jumps over lazy dog and runs through green fields "
    "near river where people walk their dogs every morning before work they "
    "stop for coffee at small cafe on corner watching boats pass slowly under "
    "old stone bridge while children play in park across street from market"
).split()

#: (share, min chars, max chars) of the corpus' length classes; each class
#: lands in one of the default buckets 512/2048/8192/32768/65536.
LENGTH_MIX = (
    (0.55, 40, 500),
    (0.25, 500, 2000),
    (0.12, 2000, 8000),
    (0.06, 8000, 32000),
    (0.02, 32000, 60000),
)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# --- corpus -------------------------------------------------------------------


def make_corpus(n_docs: int, seed: int):
    """Seeded (id, text) rows: prose from the two word lists with about 5%
    repeated-line boilerplate, 3% citations, 1% CJK, 1% ending in an emoji
    (a supplementary-plane code point) and a few empty rows, lengths drawn
    from ``LENGTH_MIX``."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def sentence_pool(words, n):
        arr = np.array(words, dtype=object)
        out = []
        lens = rng.integers(4, 18, size=n)
        idx = rng.integers(0, len(words), size=int(lens.sum()))
        pos = 0
        for k in lens:
            ws = arr[idx[pos : pos + k]]
            pos += k
            out.append(" ".join(ws).capitalize() + ".")
        return out

    pools = (sentence_pool(DANISH_WORDS, 60000), sentence_pool(ENGLISH_WORDS, 20000))
    shares = np.array([c[0] for c in LENGTH_MIX])
    classes = rng.choice(len(LENGTH_MIX), size=n_docs, p=shares / shares.sum())
    rows = []
    for i in range(n_docs):
        _, lo, hi = LENGTH_MIX[classes[i]]
        target = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        kind = rng.random()
        pool = pools[0] if rng.random() < 0.8 else pools[1]
        if kind < 0.05:
            line = pool[int(rng.integers(len(pool)))]
            text = ((line + "\n") * (target // (len(line) + 1) + 1))[:target]
        else:
            parts, size = [], 0
            while size < target:
                k = int(rng.integers(1, 5))
                sents = [pool[j] for j in rng.integers(0, len(pool), size=k)]
                if 0.05 <= kind < 0.08:
                    sents = [s[:-1] + (" [1]." if j % 2 else " [2, 3].") for j, s in enumerate(sents)]
                line = " ".join(sents)
                parts.append(line)
                size += len(line) + 1
            text = "\n".join(parts)[:target]
            if 0.08 <= kind < 0.09:
                text = ("数据处理流水线的测试文本，包含中文。" + text)[:target]
            elif 0.09 <= kind < 0.10:
                text = (text[: max(0, target - 3)] + " \U0001F600")[:target]
        if i % 2000 == 17:
            text = ""
        rows.append((f"doc-{i}", text))
    return rows


def write_parquet(path: str, rows) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(
        pa.table({"id": [r[0] for r in rows], "text": [r[1] for r in rows]}),
        path, row_group_size=4096,
    )


def read_set(path: str):
    import pyarrow.parquet as pq

    t = pq.read_table(path).to_pydict()
    return {(i, x, m) for i, x, m in zip(t["id"], t["text"], t["metadata"])}


def load_config(spec=None):
    """The pipeline config of ``spec``: the offline config's file when None,
    else ``(yaml_text, badwords_cache_dir or None)``, the cache dir set as
    every C4BadWordsFilter's ``cache_base_path`` (which YAML cannot set)."""
    from pathlib import Path

    from textblaster_tpu_torch.config.pipeline import load_pipeline_config, parse_pipeline_config

    if spec is None:
        return load_pipeline_config(CONFIG)
    text, cache = spec
    config = parse_pipeline_config(text)
    for step in config.pipeline:
        if step.type == "C4BadWordsFilter" and cache is not None:
            step.params.cache_base_path = Path(cache)
    return config


def _host_shard(args):
    """One worker task of the host oracle: every ``n``-th row of ``inp``
    from ``k``, through the port's host executor under the config of
    ``spec``, into its own kept/excluded Parquet pair."""
    tag, inp, k, n, work, spec = args
    from textblaster_tpu_torch.orchestration import (
        aggregate_results_from_stream,
        process_documents_host,
    )
    from textblaster_tpu_torch.pipeline_builder import build_pipeline_from_config
    from textblaster_tpu_torch.io.parquet_reader import ParquetInputConfig, ParquetReader

    docs = ParquetReader(ParquetInputConfig(inp, "text", "id")).read_documents()
    mine = (d for j, d in enumerate(docs) if j % n == k)
    executor = build_pipeline_from_config(load_config(spec))
    out = (os.path.join(work, f"host_kept.{tag}.{k}.parquet"),
           os.path.join(work, f"host_excl.{tag}.{k}.parquet"))
    res = aggregate_results_from_stream(process_documents_host(executor, mine), *out)
    return tag, out, res.received


def host_pool():
    """A pool of spawned worker processes, one a CPU core up to 8."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max(1, min(8, os.cpu_count() or 1)),
                               mp_context=mp.get_context("spawn"))


def host_oracles(jobs, work: str, pool=None):
    """The port's host oracle over each ``(tag, inp, spec)`` of ``jobs``:
    the whole file under the config of ``spec`` (:func:`load_config`),
    sharded over the CPU cores (documents are independent; the outputs are
    compared as sets), every job on one pool of worker processes (``pool``,
    else a :func:`host_pool` of its own, joined before this returns).
    Returns ``{tag: (kept, excluded, received)}``."""
    if pool is None:
        with host_pool() as own:
            return host_oracles(jobs, work, own)
    n = pool._max_workers
    out = {tag: (set(), set(), 0) for tag, _, _ in jobs}
    tasks = [(tag, inp, k, n, work, spec) for tag, inp, spec in jobs for k in range(n)]
    for tag, (k_path, e_path), got in pool.map(_host_shard, tasks):
        kept, excl, received = out[tag]
        out[tag] = (kept | read_set(k_path), excl | read_set(e_path), received + got)
    return out


def host_oracle(inp: str, work: str, spec=None):
    """:func:`host_oracles` of one file: ``(kept, excluded, received)``."""
    return host_oracles([("main", inp, spec)], work)["main"]


# --- kernels ------------------------------------------------------------------


def cuda_ms(fn, iters: int = 10) -> float:
    """CUDA-event time of one eager call of ``fn``, after warm-up: where the
    host's per-call cost exceeds the device work, this is the host's."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, per_graph: int = 10) -> float:
    """Device time of one call of ``fn``: ``per_graph`` calls are captured
    in one CUDA graph, replayed ``iters`` times between CUDA events, and the
    time is divided by the calls.  Neither the wrapper's host cost (checks,
    ctypes, allocation) nor the graph launch's own floor, which one call a
    graph leaves in the figure for a short kernel, is counted.  Replays
    reuse the same inputs, which may stay in the 50 MB L2."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per_graph):
            fn()
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * per_graph)


def packed_maps(rng, shape, n_states, dev, stray=False):
    """Seeded nibble-packed DFA maps on ``dev``: every nibble below
    ``n_states`` a state; with ``stray`` the nibbles at or above it hold
    anything (the op clears them, except in a one-lane row)."""
    import numpy as np
    import torch

    out = rng.integers(0, 2**32, size=shape, dtype=np.int64) if stray else np.zeros(shape, np.int64)
    for s in range(n_states):
        out &= ~(15 << (4 * s))
        out |= rng.integers(0, n_states, size=shape, dtype=np.int64) << (4 * s)
    return torch.from_numpy(out.astype(np.uint32).view(np.int32)).to(dev)


def fused_site_lists(full_range, packed_maps, shape):
    """name -> the group list of ``fused_scan`` at each of its four call
    sites (``ops/stats.py``), on fresh full-range inputs of ``shape``, plus
    two generic lists: dfa groups at 4, 5 and 8 states, affine k = 1..4,
    add scans, and ``emit="last"`` on every kind."""
    from textblaster_tpu_torch.ops import scan

    def r(n):
        return tuple(full_range(shape) for _ in range(n))

    aff, add, dfa = scan.affine_group, scan.add_group, scan.dfa_group
    return {
        # structure: the packed aggregates (length <= 8192) and the hashes.
        "structure": lambda: [aff(*r(1), r(2)), aff(*r(1), r(2))],
        "structure_nohash": lambda: [aff(*r(1), r(2))],
        # structure above 8192 lanes: the unpacked four-accumulator group.
        "structure_wide": lambda: [aff(*r(1), r(4)), aff(*r(1), r(2))],
        # gopher_quality: three segmented adds and five row totals.
        "gopher_quality": lambda: [aff(*r(1), r(1)), aff(*r(1), r(1)), aff(*r(1), r(1)),
                                   add(r(5), emit="last")],
        # fineweb: the line group, the line hash, the reversed counter, totals.
        "fineweb": lambda: [aff(*r(1), r(3)), aff(*r(1), r(1)), aff(*r(1), r(1)),
                            add(r(2), emit="last")],
        "c4_trim": lambda: [aff(*r(1), r(1)), aff(*r(1), r(1))],
        "generic_a": lambda: [dfa(packed_maps(shape, 4), 4), dfa(packed_maps(shape, 5), 5),
                              dfa(packed_maps(shape, 8), 8), aff(*r(1), r(1)),
                              aff(*r(1), r(2)), aff(*r(1), r(3))],
        "generic_b": lambda: [aff(*r(1), r(4)), aff(*r(1), r(2), emit="last"), add(r(2)),
                              add(r(2), emit="last"), dfa(packed_maps(shape, 4), 4, emit="last"),
                              dfa(packed_maps(shape, 8), 8, emit="last")],
    }


def text_batch(rows, shape, dev):
    """A [b, len] batch of corpus documents that fill between a quarter of
    the row and the row less the packing margin, as a bucket holds them."""
    import numpy as np
    import torch

    b, length = shape
    texts = [t for _, t in rows if length // 4 < len(t) <= length - 4][:b]
    cps = np.zeros(shape, np.int32)
    lens = np.zeros(b, np.int32)
    for i, t in enumerate(texts):
        cps[i, : len(t)] = [ord(c) for c in t]
        lens[i] = len(t)
    return torch.from_numpy(cps).to(dev), torch.from_numpy(lens).to(dev)


def site_programs(rows, shape, dev):
    """name -> the ``chain_scan`` program of every call site, built by the
    sites' own builders (``ops/stats.py``) on a batch of corpus documents
    with the offline config's parameters.  Above the chain gate (the 32768
    and 65536 buckets) only the sorted-table programs, the one chain site
    those buckets run (its tables are ``max_words`` wide)."""
    from textblaster_tpu_torch.ops import scan, stats
    from textblaster_tpu_torch.ops.pipeline import _table_sizes

    cps, lens = text_batch(rows, shape, dev)
    _, max_words = _table_sizes(shape[1])
    if shape[1] > scan.FUSED_MAX_LANES:
        return stats.sorted_table_programs(stats.structure(cps, lens), TOP_NS, DUP_NS, max_words)
    stop = tuple(sorted({stats.hash_string(w) for w in ("og", "i", "jeg", "det", "at", "en")}))
    c4 = stats.C4Params(True, True, True, 5, 3, 1000, True, True, True, True)
    return stats.chain_site_programs(cps, lens, stop, TOP_NS, DUP_NS, max_words, c4)


def generic_chain(full_range, packed_maps, shape, dev):
    """A chain program over full-range int32 operands with every group kind,
    forward and reverse passes, shift taps with nonzero fills and every
    emit mode."""
    import numpy as np
    import torch

    from textblaster_tpu_torch.ops import scan

    x = full_range(shape)
    r = torch.from_numpy((np.random.default_rng(shape[1]).random(shape) < 0.05)
                         .astype(np.int32)).to(dev)
    m = torch.where(r != 0, 0, 1).to(torch.int32).contiguous()
    T, cg = scan.Tap, scan.chain_group
    return [
        scan.chain_pass([
            scan.affine_group(m, (x,), emit="none"),
            scan.affine_group(x, (m, x)),
            scan.add_group((x, m), emit="last"),
            scan.dfa_group(packed_maps(shape, 4), 4),
            scan.dfa_group(packed_maps(shape, 8), 8, emit="none"),
        ]),
        scan.chain_pass([
            scan.segmax_group(x, r),
            cg("segmax", (T(0, 0), r), prep=scan.reset_value, n_ops=2, emit="none"),
            cg("copy", (T(0, 6, shift=1, fill=-7), T(0, 1))),
            cg("add", (T(0, 5, shift=1, fill=123456789),), prep=scan.state_is_one, n_ops=1,
               emit="last"),
        ], reverse=True),
        scan.chain_pass([
            cg("affine", (T(1, 1, shift=1, fill=5), T(0, 2), T(1, 0))),
            cg("add", (T(1, 2),), prep=scan.low_bit, n_ops=1),
            cg("copy", (T(1, 1), T(0, 0, shift=1, fill=-1)), prep=scan.sum2, n_ops=1),
            cg("dfa", (T(0, 6),), emit="last", n_states=8),
        ]),
        scan.chain_pass([
            cg("add", (T(2, 0, shift=1, fill=2**31 - 1),), prep=scan.twice, n_ops=1, emit="last"),
            scan.segmax_group(T(2, 1), T(2, 2, shift=1, fill=-5)),
        ], reverse=True),
    ]


def offset_view(t):
    """The same values in a contiguous view 4 bytes past an aligned base:
    the kernel takes its scalar loads and stores."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def check_sort2(rng, rows, width, dev) -> int:
    """``sort2`` against its plain version on seeded keys of ``[rows,
    width]`` (ties in the first key); fails on any difference, else returns
    the largest absolute difference (0)."""
    import numpy as np
    import torch

    from textblaster_tpu_torch.ops import sort

    k1 = torch.from_numpy(rng.integers(-1000, 1000, size=(rows, width)).astype(np.int32)).to(dev)
    k2 = torch.from_numpy(rng.integers(0, 2**31 - 1, size=(rows, width)).astype(np.int32)).to(dev)
    got = sort.sort2(k1, k2)
    torch.cuda.synchronize()
    want = sort.sort2_plain(k1, k2)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"sort2 differs from its plain version at {[rows, width]}")
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def kernel_phase(corpus):
    """Exactness at every main-path shape, then timings per shape; the chain
    sites' programs are built from ``corpus`` documents."""
    import numpy as np
    import torch

    from textblaster_tpu_torch.ops import scan, sort
    from textblaster_tpu_torch.ops.cost import bound, chain_cost, fused_cost, scan_cost, sort_cost

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")

    def full_range(shape):
        return torch.from_numpy(
            rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)
        ).to(dev)

    def packed_maps_(shape, n_states):
        return packed_maps(rng, shape, n_states, dev)

    def max_err(got, want):
        return max((int((g.long() - w.long()).abs().max()) if g.numel() else 0
                    for g, w in zip(got, want)), default=0)

    errs = {"affine_scan": 0, "dfa_scan": 0, "sort2": 0}
    per_shape = []
    # affine_scan and dfa_scan at every edge of scan_geometry (one warp per
    # row to 512 lanes, one CTA to 8192, clusters beyond, segments beyond
    # 65536) on 1, 7, 64 and 65 rows, which take in every main-path shape;
    # k = 1 and 2 and every n_states, on maps with stray nibbles above
    # n_states; on aligned tensors and on offset views (scalar accesses).
    # Their own generator, so that the other kernels' inputs stay as they were.
    srng = np.random.default_rng(SEED + 2)
    scan_widths = [1, 31, 32, 511, 512, 513, 2047, 2048, 8192, 8193, 16384, 32768, 65536, 70000]
    scan_shapes = [(r, n) for n in scan_widths for r in (1, 7, 64, 65)] + [(37, 1000)]
    # The fault phase's split rung: half batches (32 rows) at the buckets
    # the per-scan kernels serve.
    scan_shapes += [(32, n) for n in (32768, 65536)]
    for shape in scan_shapes:
        m, a1, a2 = (torch.from_numpy(srng.integers(-(2**31), 2**31, size=shape, dtype=np.int64)
                                      .astype(np.int32)).to(dev) for _ in range(3))
        for view_name, view in (("aligned", lambda t: t), ("offset", offset_view)):
            for accs in ((a1,), (a1, a2)):
                mv, av = view(m), tuple(view(a) for a in accs)
                got = scan.affine_hash_scan(mv, av)
                torch.cuda.synchronize()
                want = scan.affine_hash_scan_plain(mv, av)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"affine_scan differs from its plain version at {shape} k={len(accs)} "
                         f"({view_name})")
                errs["affine_scan"] = max(errs["affine_scan"], max_err(got, want))
            for ns in range(1, 9):
                f = view(packed_maps(srng, shape, ns, dev, stray=True))
                got = scan.dfa_compose_scan(f, ns)
                torch.cuda.synchronize()
                want = scan.dfa_compose_scan_plain(f, ns)
                if not torch.equal(got, want):
                    fail(f"dfa_scan differs from its plain version at {shape} n_states={ns} "
                         f"({view_name})")
                errs["dfa_scan"] = max(errs["dfa_scan"], max_err((got,), (want,)))
        del m, a1, a2
    # sort2 rows as the main path stacks its 64-row batches: 2 jobs (line and
    # paragraph tables, widths max_lines), 4 and 5 jobs (n-gram tables,
    # widths max_words); 64 and 128 rows for the sort-table form's bucket
    # widths and a padded width.
    sort_shapes = [(128, w) for w in (128, 256, 1024, 4096, 8192)]
    sort_shapes += [(r, w) for r in (256, 320) for w in (256, 512, 2048, 8192, 16384)]
    sort_shapes += [(r, w) for r in (64, 128) for w in (32768, 65536, 1536)]
    sort_shapes += [(r, w) for r in (1, 7, 320) for w in (1, 3, 255, 257, 1025, 2049, 16383)]
    # The split rung's half batches: 32 rows a job (1, 2, 4 and 5 jobs).
    sort_shapes += [(r, w) for r in (32, 64, 128, 160) for w in (128, 256, 512, 1024, 2048,
                                                                 4096, 8192, 16384)]
    sort_shapes += [(32, w) for w in (1536, 32768, 65536)]
    for rows, width in sort_shapes:
        errs["sort2"] = max(errs["sort2"], check_sort2(rng, rows, width, dev))
    # fused_scan: every call site's group list and the generic lists, at the
    # fused buckets, beyond the gate (any width works) and a ragged shape;
    # then its edges: one and zero lanes in both emit modes, 1, 7 and 65
    # rows, DFA maps with stray nibbles at 1..8 states, and offset views
    # (scalar accesses) at ragged widths.
    errs["fused_scan"] = 0

    fused_checked = set()

    def check_fused(label, groups):
        fused_checked.add(tuple(groups[0]["xs"][0].shape))
        got = scan.fused_scan(groups)
        torch.cuda.synchronize()
        want = scan.fused_scan_plain(groups)
        for g, w in zip(got, want):
            if len(g) != len(w) or not all(
                x.shape == y.shape and torch.equal(x, y) for x, y in zip(g, w)
            ):
                fail(f"fused_scan differs from its plain version: {label}")
            errs["fused_scan"] = max(errs["fused_scan"], max_err(g, w))

    fused_shapes = [(64, n) for n in (512, 2048, 8192, 16384, 32768, 65536)] + [(37, 1000)]
    fused_shapes += [(32, n) for n in (512, 2048, 8192)]  # the split rung's halves
    for shape in fused_shapes:
        for name, make in fused_site_lists(full_range, packed_maps_, shape).items():
            check_fused(f"list {name} at {list(shape)}", make())
    aff, add, dfa = scan.affine_group, scan.add_group, scan.dfa_group

    def fused_edge_lists(shape, view):
        r = [view(full_range(shape)) for _ in range(7)]
        head = [aff(r[0], (r[1],)), aff(r[1], r[2:7], emit="last"), add((r[2], r[3])),
                add((r[4],), emit="last")]
        for states in ((1, 2, 3, 4), (5, 6, 7, 8)):
            yield head + [dfa(view(packed_maps(rng, shape, ns, dev, stray=True)), ns,
                              emit="last" if i % 2 else "scan")
                          for i, ns in enumerate(states)]

    fused_edges = [(r, n, "aligned") for r in (1, 7, 65) for n in (0, 1, 2, 129, 1000, 2049, 8193,
                                                                    16385)]
    fused_edges += [(r, n, "offset") for r in (7, 65) for n in (1, 513, 1000, 4097)]
    for rows, width, view_name in fused_edges:
        view = offset_view if view_name == "offset" else (lambda t: t)
        for groups in fused_edge_lists((rows, width), view):
            check_fused(f"edge list at {[rows, width]} ({view_name})", groups)
    # chain_scan: every call site's program, built by the sites' own builders
    # on corpus batches of the chain buckets and a ragged shape, and the
    # sorted-table programs on batches of the two wider buckets (tables 8192
    # and 16384 wide); the JAX probe program and the generic one at every
    # width the chain takes.
    errs["chain_scan"] = 0
    text_shapes = [(64, 512), (64, 2048), (64, 8192), (37, 1000), (64, 32768), (64, 65536)]
    text_shapes += [(32, n) for n in (512, 2048, 8192, 32768, 65536)]  # the split rung's halves
    generic_shapes = [(64, 512), (64, 2048), (64, 8192), (64, 16384), (37, 1000), (600, 256),
                      (64, 5000)]
    sites, chain_widths, site_progs = set(), set(), {}

    def check_chain(label, passes):
        got = scan.chain_scan(passes)
        torch.cuda.synchronize()
        want = scan.chain_scan_plain(passes)
        for gp, wp in zip(got, want):
            for g, w in zip(gp, wp):
                if len(g) != len(w) or not all(
                    x.shape == y.shape and torch.equal(x, y) for x, y in zip(g, w)
                ):
                    fail(f"chain_scan differs from its plain version: {label}")
                errs["chain_scan"] = max(errs["chain_scan"], max_err(g, w))
        chain_widths.add(tuple(scan._chain_plan(passes)[1][0].shape))

    for shape in text_shapes:
        programs = site_programs(corpus, shape, dev)
        site_progs[shape] = programs
        sites |= set(programs)
        for name, passes in programs.items():
            check_chain(f"program {name} on a {list(shape)} batch", passes)
    for shape in generic_shapes:
        vals = torch.from_numpy(rng.integers(0, 97, size=shape).astype(np.int32)).to(dev)
        reset = torch.from_numpy((rng.random(shape) < 0.05).astype(np.int32)).to(dev)
        check_chain(f"probe program at {list(shape)}", scan.chain_probe_program(vals, reset))
        check_chain(f"generic program at {list(shape)}",
                    generic_chain(full_range, packed_maps_, shape, dev))
    want_sites = {"structure", "structure_nohash", "gopher_quality", "gopher_rep",
                  "sorted_tables", "sorted_tables_rest", "c4_trim", "c4_sentences", "c4_post",
                  "sentence_counts"}
    if sites != want_sites:
        fail(f"chain programs built for {sorted(sites)}, expected {sorted(want_sites)}")
    # sort3: ties and both int32 extremes, at its timed widths (64 rows) and
    # at every edge of its layouts on 1, 7, 64 and 65 rows, aligned and on
    # offset views; 40000 keys take the shared-memory network.
    errs["sort3"] = 0
    sort3_widths = (256, 512, 2048, 8192, 16384, 32768)
    sort3_edges = (1, 3, 100, 1000, 4097, 8192, 16384, 16385, 32767, 32768, 40000)

    def keys3(width, rows=64, gen=rng):
        ks = []
        for _ in range(3):
            k = gen.integers(-3, 3, size=(rows, width)).astype(np.int32)
            k[gen.random(k.shape) < 0.05] = 2**31 - 1
            k[gen.random(k.shape) < 0.05] = -(2**31)
            ks.append(torch.from_numpy(k).to(dev))
        return ks

    sort3_shapes = [(64, w, "aligned") for w in sort3_widths]
    sort3_shapes += [(r, w, v) for w in sort3_edges for r in (1, 7, 64, 65)
                     for v in ("aligned", "offset")]
    s3rng = np.random.default_rng(SEED + 3)
    for rows, width, view_name in sort3_shapes:
        ks = keys3(width, rows, s3rng)
        if view_name == "offset":
            ks = [offset_view(k) for k in ks]
        got = sort.sort3(*ks)
        torch.cuda.synchronize()
        want = sort.sort3_plain(*ks)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"sort3 differs from its plain version at {[rows, width]} ({view_name})")
        errs["sort3"] = max(errs["sort3"], max_err(got, want))
    for width in sorted(set(sort3_widths + sort3_edges)):
        g = sort.sort_geometry(width, 3)
        print(f"  sort3 layout at {width} keys: " + (
            "shared-memory network (scratch)" if g is None else
            f"{'one warp a row' if g.rows_per_cta > 1 else 'CTA' if g.ctas == 1 else 'cluster'}"
            f" (mp {g.mp}, E {g.keys}, {g.threads} threads x {g.ctas} CTAs, "
            f"{g.rows_per_cta} rows a CTA)"), flush=True)
    print(f"kernels exact: affine_scan (k = 1, 2) and dfa_scan (n_states 1..8) at "
          f"{scan_shapes}, aligned and offset, "
          f"sort2 at {sort_shapes}, fused_scan at {fused_shapes} and its edges {fused_edges}, "
          f"chain_scan at "
          f"{sorted(chain_widths)} (sites {sorted(sites)} on batches {text_shapes}; probe and "
          f"generic at {generic_shapes}), sort3 at {sort3_shapes}", flush=True)

    # Timings: per shape (written to the JSON file), and the representative
    # main-path call per kernel (the kernels line).
    def time_scan(kind, rows, width, variant):
        shape = (rows, width)
        if kind == "affine_scan":
            m, *accs = (full_range(shape) for _ in range(1 + variant))
            accs = tuple(accs)

            def call():
                return scan.affine_hash_scan(m, accs)

            def plain():
                return scan.affine_hash_scan_plain(m, accs)
        else:
            f = packed_maps_(shape, variant)

            def call():
                return scan.dfa_compose_scan(f, variant)

            def plain():
                return scan.dfa_compose_scan_plain(f, variant)
        return dict(
            shape=list(shape), variant=variant, ms=graph_ms(call), call_ms=cuda_ms(call),
            plain_ms=cuda_ms(plain, 3), library_ms=None,
            **bound(*scan_cost(kind, rows, width, variant)),
        )

    def time_sort(rows, width):
        k1 = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(rows, width), dtype=np.int64).astype(np.int32)).to(dev)
        k2 = torch.from_numpy(rng.integers(0, 2**31 - 1, size=(rows, width)).astype(np.int32)).to(dev)
        z = (k1.long() << 32) | k2.long()
        return dict(
            shape=[rows, width],
            ms=graph_ms(lambda: sort.sort2(k1, k2)),
            call_ms=cuda_ms(lambda: sort.sort2(k1, k2)),
            plain_ms=cuda_ms(lambda: sort.sort2_plain(k1, k2), 3),
            library_ms=graph_ms(lambda: torch.sort(z, dim=1)),
            **bound(*sort_cost(2, rows, width)),
        )

    # Every variant the main path launches (affine k = 1, 2; DFA 4 and 5
    # states) at its five buckets; no single PyTorch call computes either.
    for n in (512, 2048, 8192, 32768, 65536):
        for kind, variant in (("affine_scan", 1), ("affine_scan", 2), ("dfa_scan", 4),
                              ("dfa_scan", 5)):
            per_shape.append({"kernel": kind, **time_scan(kind, 64, n, variant)})
    # Sort rows as the main path stacks them: 4 jobs x 64 rows for the
    # n-gram tables (widths = max_words of each bucket), 5 x 64 when the
    # dup gate fires at the widest bucket.
    for rows, width in ((256, 256), (256, 512), (256, 2048), (256, 8192),
                        (256, 16384), (320, 16384), (64, 32768), (64, 65536)):
        per_shape.append({"kernel": "sort2", **time_sort(rows, width)})
    # Each fused call site's list at the three fused default buckets.  No
    # single PyTorch call computes a multi-group scan: library_ms is null.
    for n in (512, 2048, 8192):
        shape = (64, n)
        for name, make in fused_site_lists(full_range, packed_maps_, shape).items():
            if name.startswith("generic") or (name == "structure_wide") != (n > 8192):
                continue
            groups = make()
            per_shape.append(dict(
                kernel="fused_scan", site=name, shape=list(shape),
                ms=graph_ms(lambda: scan.fused_scan(groups)),
                call_ms=cuda_ms(lambda: scan.fused_scan(groups)),
                plain_ms=cuda_ms(lambda: scan.fused_scan_plain(groups), 3),
                library_ms=None, **bound(*fused_cost(groups)),
            ))
            del groups
    # Each chain site's program on the 64-row batches of every bucket (at
    # the program's own shape: a sorted-table program is max_words wide),
    # and sort3.  No single PyTorch call computes either: library_ms is null.
    for shape in text_shapes:
        if shape[0] != 64:
            continue
        for site, passes in site_progs[shape].items():
            per_shape.append(dict(
                kernel="chain_scan", site=site, bucket=shape[1],
                shape=list(scan._chain_plan(passes)[1][0].shape),
                ms=graph_ms(lambda: scan.chain_scan(passes)),
                call_ms=cuda_ms(lambda: scan.chain_scan(passes)),
                plain_ms=cuda_ms(lambda: scan.chain_scan_plain(passes), 3),
                library_ms=None, **bound(*chain_cost(passes)),
            ))
    for width in sort3_widths:
        ks = keys3(width)
        per_shape.append(dict(
            kernel="sort3", shape=[64, width],
            ms=graph_ms(lambda: sort.sort3(*ks)),
            call_ms=cuda_ms(lambda: sort.sort3(*ks)),
            plain_ms=cuda_ms(lambda: sort.sort3_plain(*ks), 3),
            library_ms=None, **bound(*sort_cost(3, 64, width)),
        ))
    for row in per_shape:
        label = row["kernel"] + (f":{row['site']}" if "site" in row else "")
        label += f"@{row['bucket']}" if "bucket" in row else ""
        label += f"/{row['variant']}" if "variant" in row else ""
        print(f"  {label:32s} {str(row['shape']):16s} kernel {row['ms']:.4f} ms"
              f"  call {row['call_ms']:.4f} ms"
              f"  plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms"
              + (f"  library {row['library_ms']:.4f} ms" if row["library_ms"] else ""),
              flush=True)
    rep = {
        "affine_scan": next(r for r in per_shape if r["kernel"] == "affine_scan"
                            and r["shape"] == [64, 65536] and r["variant"] == 2),
        "dfa_scan": next(r for r in per_shape if r["kernel"] == "dfa_scan"
                         and r["shape"] == [64, 65536] and r["variant"] == 5),
        "sort2": next(r for r in per_shape if r["kernel"] == "sort2" and r["shape"] == [256, 16384]),
        # The main path's largest fused call: gopher_quality's 4 groups.
        "fused_scan": next(r for r in per_shape if r["kernel"] == "fused_scan"
                           and r["site"] == "gopher_quality" and r["shape"] == [64, 8192]),
        # The main path's largest chain program: structure with hashes.
        "chain_scan": next(r for r in per_shape if r["kernel"] == "chain_scan"
                           and r["site"] == "structure" and r["bucket"] == 8192),
        "sort3": next(r for r in per_shape if r["kernel"] == "sort3" and r["shape"] == [64, 16384]),
    }
    timers = {"sort2": lambda b, n, _: time_sort(b, n),
              "affine_scan": lambda b, n, v: time_scan("affine_scan", b, n, v),
              "dfa_scan": lambda b, n, v: time_scan("dfa_scan", b, n, v)}
    # (rows, width) each kernel was held to its plain version at (every
    # variant at each per-scan shape).
    checked = {"affine_scan": set(scan_shapes), "dfa_scan": set(scan_shapes),
               "sort2": {tuple(s) for s in sort_shapes}, "fused_scan": fused_checked,
               "chain_scan": set(chain_widths)}
    return errs, rep, per_shape, timers, checked


def launch_losses(run, per_shape, timers):
    """The run's launches of every kernel by shape and variant (k for
    ``affine_scan``, n_states for ``dfa_scan``), each beside the kernel's
    time at that shape and variant from ``per_shape`` (``sort2`` and the
    per-scan kernels timed now at any shape or variant not timed yet;
    ``fused_scan`` with ``fineweb``'s list, the chain schedule's one fused
    site), and per kernel the sum of launches x (kernel ms - bound ms)."""
    timed = {}
    for r in per_shape:
        timed.setdefault((r["kernel"], r.get("site"), r["shape"][0], r["shape"][1],
                          r.get("variant")), r)
    site_of = {"fused_scan": "fineweb"}
    rows, totals = [], {}
    launched = [(key[0], site_of.get(key[0]), key[1], key[2], key[3] if len(key) > 3 else None, c)
                for key, c in run["shape_launches"] if key[0] != "chain_scan"]
    launched += [("chain_scan", s, 64, n, None, c) for (s, n), c in run["chain_shape_launches"]]
    for kernel, site, b, n, variant, count in sorted(
            launched, key=lambda x: (x[0], str(x[1]), x[2], x[3], x[4] or 0)):
        t = timed.get((kernel, site, b, n, variant))
        if t is None and kernel in timers:
            t = {"kernel": kernel, **timers[kernel](b, n, variant)}
            per_shape.append(t)
            timed[(kernel, site, b, n, variant)] = t
        row = {"kernel": kernel, "site": site, "shape": [b, n], "variant": variant,
               "launches": count,
               "ms": t["ms"] if t else None, "bound_ms": t["bound_ms"] if t else None}
        row["loss_ms"] = count * (t["ms"] - t["bound_ms"]) if t else None
        rows.append(row)
        tot = totals.setdefault(kernel, {"launches": 0, "timed_launches": 0, "loss_ms": 0.0})
        tot["launches"] += count
        if t:
            tot["timed_launches"] += count
            tot["loss_ms"] += row["loss_ms"]
    for r in rows:
        label = r["kernel"] + (f":{r['site']}" if r["site"] else "")
        label += f"/{r['variant']}" if r["variant"] is not None else ""
        ms = f"{r['ms']:.4f}" if r["ms"] is not None else "not timed"
        loss = f"{r['loss_ms']:.3f}" if r["loss_ms"] is not None else "-"
        print(f"  launches {label:32s} {str(r['shape']):14s} {r['launches']:5d} x kernel {ms} ms"
              f" -> loss {loss} ms", flush=True)
    print("launches x (kernel ms - bound ms), first chain run: " + json.dumps(totals), flush=True)
    return {"per_shape": rows, "per_kernel": totals}


def time_dup_walk():
    """The exact n-gram walk (a torch loop, not a kernel) at its widest:
    6 dup-n jobs x 64 rows over 16384 window positions (65536 bucket)."""
    import numpy as np
    import torch

    from textblaster_tpu_torch.ops.stats import _find_all_dup_bytes_batched

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    b, m = 64, 16384
    jobs = []
    for n in (5, 6, 7, 8, 9, 10):
        rid = torch.from_numpy(rng.integers(0, m // 4, size=(b, m)).astype(np.int32)).to(dev)
        val = torch.ones((b, m), dtype=torch.bool, device=dev)
        gb = torch.from_numpy(rng.integers(10, 60, size=(b, m)).astype(np.int32)).to(dev)
        jobs.append((n, rid, val, gb))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _find_all_dup_bytes_batched(jobs)
    torch.cuda.synchronize()
    return {"rows": 6 * b, "steps": m, "ms": (time.perf_counter() - t0) * 1e3}


# --- main path ----------------------------------------------------------------


def device_run(config, inp: str, work: str, tag: str, device: str, errors_file=None,
               batch_size=None, prepare=None, mesh=None):
    """One run of the port's ``run`` entry point over ``inp``; every kernel
    launch counter and the dup-walk counters are set to 0 just before and
    read just after.  ``prepare(pipeline)`` runs before the run.  The
    run's report (``build_run_report``, relative to a ``metrics_snapshot``
    taken just before) rides along as ``report``.  With a ``mesh`` the
    pipeline shards its batches over it (``device`` names its type)."""
    from textblaster_tpu_torch.ops import scan, sort, stats
    from textblaster_tpu_torch.ops.pipeline import CompiledPipeline
    from textblaster_tpu_torch.runner import run_pipeline
    from textblaster_tpu_torch.utils.metrics import build_run_report, metrics_snapshot

    pipe = CompiledPipeline(config, device=device if mesh is None else None,
                            batch_size=batch_size, mesh=mesh)
    if prepare is not None:
        prepare(pipe)
    if device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()
    out = (os.path.join(work, f"{tag}_kept.parquet"), os.path.join(work, f"{tag}_excl.parquet"))
    for d in (scan.LAUNCHES, sort.LAUNCHES, stats.DUP_WALK):
        for k in d:
            d[k] = 0
    for d in (scan.SHAPE_LAUNCHES, sort.SHAPE_LAUNCHES, scan.CHAIN_SITE_LAUNCHES,
              scan.CHAIN_SHAPE_LAUNCHES):
        d.clear()
    baseline = metrics_snapshot()
    t0 = time.perf_counter()
    res = run_pipeline(config, inp, *out, backend="device", pipeline=pipe,
                       errors_file=errors_file)
    if device == "cuda":
        torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    c = pipe.counters
    report = build_run_report(
        baseline=baseline, wall_time_s=dev_s,
        counts={"received": res.received, "success": res.success, "filtered": res.filtered,
                "errors": res.errors, "read_errors": res.read_errors},
        provenance={"entry": "chip_smoke.py device_run", "schedule": tag, "device": device},
    )
    return {
        "schedule": tag,
        "overlapped": (config.overlap.enabled and os.environ.get("TEXTBLAST_NO_OVERLAP") != "1"
                       and mesh is None),
        "host_tails": os.environ.get("TEXTBLAST_HOST_TAILS") != "off" and mesh is None,
        "received": res.received,
        "kept": res.success,
        "excluded": res.filtered,
        "errors": res.errors,
        "read_errors": res.read_errors,
        "device_seconds": dev_s,
        "device_docs_per_s": res.received / dev_s,
        # Summed CUDA-event spans, each batch's upload to its download on
        # the stream that ran it, over the run's wall time.
        "device_busy_share": c["seconds"]["device_busy"] / dev_s,
        "launches": {**scan.LAUNCHES, **sort.LAUNCHES},
        "chain_site_launches": dict(scan.CHAIN_SITE_LAUNCHES),
        # [[kernel, rows, width], n] and [[site, width], n] (JSON keys are strings).
        "shape_launches": sorted([list(k), v] for k, v in
                                 {**scan.SHAPE_LAUNCHES, **sort.SHAPE_LAUNCHES}.items()),
        "chain_shape_launches": sorted(([list(k), v] for k, v in
                                        scan.CHAIN_SHAPE_LAUNCHES.items()), key=str),
        "pipeline_launches": dict(c["launches"]),
        "shard_launches": c.get("shard_launches"),
        "geometry": pipe.geometry.to_dict(),
        "batches_by_bucket": {str(k): v for k, v in sorted(c["batches_by_bucket"].items())},
        "device_rows": c["device_rows"],
        "upload_bytes": c["upload_bytes"],
        "wire": "u16" if pipe.wire_u16 else "cp32",
        "host_routes": {k: c[k] for k in ("host_fallback", "host_routed_dict_script",
                                          "host_routed_astral", "host_overflow",
                                          "host_tail")},
        "seconds": {**c["seconds"], "read": res.seconds["read"], "write": res.seconds["write"]},
        "dup_walk": dict(stats.DUP_WALK),
        "peak_device_mib": (torch.cuda.max_memory_allocated() / 2**20) if device == "cuda" else None,
        "outputs": out,
        "report": report,
    }


def check_report(run) -> None:
    """Hold a run's report to the run: its counts are the run's outcome
    counts; its funnel's drops sum to the rows of the excluded file; its
    occupancy counts the batches the pipeline dispatched over all phases
    (``counters["batches_by_bucket"]``), bucket by bucket.  Prints the
    stage breakdown under the JAX package's names, with its verdict, and
    the padding waste."""
    import pyarrow.parquet as pq

    tag, rep = run["schedule"], run["report"]
    counts = {"received": run["received"], "success": run["kept"], "filtered": run["excluded"],
              "errors": run["errors"], "read_errors": run["read_errors"]}
    if rep["counts"] != counts:
        fail(f"{tag}: run report counts {rep['counts']}, the run {counts}")
    excluded_rows = pq.ParquetFile(run["outputs"][1]).metadata.num_rows
    funnel = rep["funnel"]
    if not (funnel["dropped_total"] == excluded_rows == run["excluded"]
            == sum(funnel["per_filter_dropped"].values())):
        fail(f"{tag}: funnel {funnel} against {excluded_rows} excluded rows")
    occ = rep["occupancy"]
    by_bucket = {int(k): v for k, v in run["batches_by_bucket"].items()}
    if not (occ["device_batches"] == sum(by_bucket.values())
            == sum(occ["per_bucket_dispatches"].values())
            and occ["per_bucket_dispatches"] == by_bucket):
        fail(f"{tag}: occupancy {occ} against the pipeline's batches {by_bucket}")
    st = rep["stages"]
    print(f"run report, {tag}: stages {json.dumps(st['stages_s'])}, host {st['host_s']} s "
          f"vs device-wait {st['device_s']} s -> {st['verdict']}; occupancy "
          f"{occ['real_codepoints']} real of {occ['padded_lanes']} lanes, waste "
          f"{occ['waste_ratio']}, dispatches {json.dumps(occ['per_bucket_dispatches'])}; "
          f"funnel {json.dumps(funnel)}", flush=True)


def _parity(run, host_kept, host_excl, ids=None):
    """Share of the host oracle's decisions the run reproduced (restricted
    to ``ids`` when the run saw only part of the corpus), and whether the
    kept and excluded sets are equal."""
    if ids is not None:
        host_kept = {r for r in host_kept if r[0] in ids}
        host_excl = {r for r in host_excl if r[0] in ids}
    kept, excl = read_set(run["outputs"][0]), read_set(run["outputs"][1])
    agree = len(kept & host_kept) + len(excl & host_excl)
    equal = kept == host_kept and excl == host_excl
    return agree / max(len(host_kept) + len(host_excl), 1), equal


def env_run(config, inp, work, tag, device, env=None):
    """:func:`device_run` with the variables of ``env`` set for the run
    only."""
    env = env or {}
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return device_run(config, inp, work, tag, device)
    finally:
        for k, v in prev.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def profiled_chain_run(config, inp: str, work: str, device: str):
    """:func:`device_run` of the chain schedule, windowed, with the profiler
    armed: configure, the cost pass (before the launch counters are set to
    0), the run, close.  The run carries each program's launches by kernel
    (``program_launches``), the cost pass's seconds and the top-K table."""
    from textblaster_tpu_torch.utils.profiler import PROFILER

    costed = {}

    def prepare(pipe):
        PROFILER.configure()
        t0 = time.perf_counter()
        costed["launches"] = pipe.register_program_costs()
        costed["seconds"] = time.perf_counter() - t0
        costed["rows"] = {b: pipe.geometry.batch_for(b) for b in pipe.buckets}

    try:
        run = device_run(config, inp, work, "chain", device, prepare=prepare)
    finally:
        PROFILER.close()
    run["program_launches"] = costed["launches"]
    run["cost_pass_seconds"] = costed["seconds"]
    run["geometry_rows"] = costed["rows"]
    run["top_dispatches"] = PROFILER.top_dispatches()
    return run


def _ids(path: str):
    import pyarrow.parquet as pq

    return set(pq.read_table(path, columns=["id"]).column("id").to_pylist())


def main_path(device: str, rows, work: str):
    """The chain schedule (this port's default) windowed (the default, with
    the profiler armed) over the whole corpus; then over the first
    ``STAGED_SUBSET`` documents, windowed, the fused schedule
    (``TEXTBLAST_DEPFUSE=off``), the staged one (``TEXTBLAST_FUSED=off``)
    and the chain schedule with ``TEXTBLAST_HOST_TAILS=off``, the last
    also serially (``TEXTBLAST_NO_OVERLAP=1``, as ``run --no-overlap``).
    Every run is held against one host-oracle run, and the windowed chain
    run with tails off against the serial one: the same kept and excluded
    ids, and the same bytes."""
    from textblaster_tpu_torch.config.pipeline import load_pipeline_config
    from textblaster_tpu_torch.ops.packing import DEFAULT_BUCKETS

    os.makedirs(work, exist_ok=True)
    inp = os.path.join(work, "corpus.parquet")
    write_parquet(inp, rows)
    n_chars = sum(len(r[1]) for r in rows)
    config = load_pipeline_config(CONFIG)

    # Warm-up, not measured: tables, the language model and the host
    # executor load on first use, which would otherwise fall on the first
    # run of the A/B.
    warm = os.path.join(work, "corpus_warmup.parquet")
    write_parquet(warm, rows[:200])
    device_run(config, warm, work, "warmup", device)

    runs = [profiled_chain_run(config, inp, work, device)]
    sub = rows[:STAGED_SUBSET]
    sub_inp = os.path.join(work, "corpus_staged.parquet")
    write_parquet(sub_inp, sub)
    runs += [env_run(config, sub_inp, work, tag, device, env)
             for tag, env in SUBSET_RUNS]

    t0 = time.perf_counter()
    host_kept, host_excl, host_received = host_oracle(inp, work)
    host_s = time.perf_counter() - t0

    summary = {
        "documents": len(rows),
        "chars": n_chars,
        "staged_documents": len(sub),
        "host_oracle_seconds": host_s,
    }
    must = {"chain": ("chain_scan", "fused_scan", "affine_scan", "dfa_scan", "sort2"),
            "fused": ("fused_scan", "affine_scan", "dfa_scan", "sort2"),
            "staged": ("affine_scan", "dfa_scan", "sort2")}
    never = {"chain": (), "fused": ("chain_scan",), "staged": ("fused_scan", "chain_scan")}
    sub_ids = {r[0] for r in sub}
    for run in runs:
        tag = run["schedule"]
        whole = tag not in dict(SUBSET_RUNS)
        run["decision_parity"], equal = _parity(
            run, host_kept, host_excl, None if whole else sub_ids
        )
        summary[tag] = run
        sec = run["seconds"]
        stages = {k: round(sec[k], 3) for k in ("pack", "wait", "drain", "assemble",
                                                 "host_routes", "host_tails", "read",
                                                 "write")}
        stages["device"] = {str(p): round(v, 3) for p, v in sec["device"].items()}
        print(f"main path, {tag} ({'windowed' if run['overlapped'] else 'serial'}, host tails "
              f"{'on' if run['host_tails'] else 'off'}): {run['received']} documents, "
              f"{run['device_docs_per_s']:.2f} docs/s ({run['device_seconds']:.2f} s), "
              f"parity {run['decision_parity']}, device-busy share "
              f"{run['device_busy_share']:.4f}, stage seconds {json.dumps(stages)}, "
              f"host routes {json.dumps(run['host_routes'])}, uploaded "
              f"{run['upload_bytes']} bytes ({run['wire']}), dup walk "
              f"{run['dup_walk']['seconds']:.2f} s, launches {run['launches']}", flush=True)
        if (run["decision_parity"] != 1.0 or not equal
                or (whole and run["received"] != host_received)):
            fail(f"{tag} run and host oracle differ (parity {run['decision_parity']})")
        check_report(run)
        schedule = tag.split("_")[0]
        for k in must[schedule]:
            if run["launches"][k] <= 0:
                fail(f"kernel {k} was never launched on the {tag} main path")
        for k in never[schedule]:
            if run["launches"][k] != 0:
                fail(f"the {tag} schedule launched {k}")
    for i in (0, 1):
        a, b = summary["chain_tails_off"]["outputs"][i], summary["chain_serial"]["outputs"][i]
        if _ids(a) != _ids(b):
            fail("chain_tails_off and chain_serial keep or exclude different ids")
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                fail(f"chain_tails_off and chain_serial wrote different bytes to "
                     f"{os.path.basename(a)}")
    if not all(summary[t]["overlapped"] for t in ("chain", *dict(SUBSET_RUNS))
               if t != "chain_serial"):
        fail("a windowed run ran serially")
    if summary["chain_serial"]["overlapped"]:
        fail("a serial run was windowed")
    if summary["chain"]["host_routes"]["host_routed_astral"] <= 0:
        fail("the u16 wire routed no astral document to the host")
    if summary["chain_tails_off"]["host_routes"]["host_tail"] \
            or summary["chain_serial"]["host_routes"]["host_tail"]:
        fail("TEXTBLAST_HOST_TAILS=off still routed tails to the host")
    print("main path: " + json.dumps(summary), flush=True)
    missing = [b for b in DEFAULT_BUCKETS if summary["chain"]["batches_by_bucket"].get(str(b), 0) == 0]
    if missing:
        fail(f"buckets never dispatched: {missing}")
    return summary, (host_kept, host_excl)


# --- the profiler ---------------------------------------------------------------

#: Hand-written kernels by the names of their ``__global__`` functions in
#: ``textblaster_tpu_torch/csrc/`` (as torch.profiler's CUDA events name them).
HAND_KERNEL_RE = (r"chain_scan_kernel|fused_scan_kernel|scan_rows|sort_warp_kernel|"
                  r"sort_cta_kernel|bitonic_tile_kernel|bitonic_global_step")
#: Host calls that block on the device (torch.profiler's CUDA runtime events).
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy")


def profile_report(summary) -> dict:
    """The profiled chain run (:func:`profiled_chain_run`): per (bucket,
    phase) count, mean / p50 / p99 device seconds, modeled bytes, achieved
    bytes/s and its share of the memory rate; the top-8 slowest dispatches;
    the recommended ``--stage-deadline-s`` (twice the slowest healthy
    dispatch).  Checks: the HDR counts sum to the batches dispatched, bucket
    by bucket (a fault-free run: every dispatch returned); the cost model's
    launches times each program's dispatches are at least the run's
    launches (its gates are open); parity as the main path checked it."""
    from textblaster_tpu_torch.ops.cost import HBM_BYTES_PER_S
    from textblaster_tpu_torch.utils.profiler import program_key

    run = summary["chain"]
    dp = run["report"]["device_profile"]
    dispatch = dp["dispatch"]
    by_bucket = {int(k): v for k, v in run["batches_by_bucket"].items()}
    counted = {}
    for key, e in dispatch.items():
        b = int(key.split("/")[0][1:])
        counted[b] = counted.get(b, 0) + e["count"]
    total = sum(e["count"] for e in dispatch.values())
    if total != sum(by_bucket.values()) or counted != by_bucket:
        fail(f"profiled run: {total} dispatches recorded {counted} against the batches "
             f"{by_bucket}")
    if not dp["cost_fingerprint"]:
        fail("profiled run: no cost fingerprint")
    modeled = {}
    for key, e in dispatch.items():
        b, p = (int(x[1:]) for x in key.split("/"))
        prog = run["program_launches"][program_key(b, p, run["geometry_rows"][b])]
        for k, n in prog.items():
            modeled[k] = modeled.get(k, 0) + n * e["count"]
    actual = {k: v for k, v in run["pipeline_launches"].items() if v}
    gap = {k: modeled.get(k, 0) - actual.get(k, 0) for k in sorted(set(modeled) | set(actual))}
    if sum(modeled.values()) < sum(actual.values()):
        fail(f"the cost model's launches {modeled} fall below the run's {actual}")
    rows = []
    for key, e in dispatch.items():
        bps = e.get("achieved_bytes_per_s", 0)
        rows.append({"program": key, "count": e["count"], "mean_s": e["mean_s"],
                     "p50_s": e["p50_s"], "p99_s": e["p99_s"],
                     "modeled_bytes": e.get("modeled_bytes"), "achieved_bytes_per_s": bps,
                     "share_of_hbm": bps / HBM_BYTES_PER_S})
        print(f"  profile {key:10s} {e['count']:4d} dispatches, mean {e['mean_s']:.6f} s, "
              f"p50 {e['p50_s']:.6f} s, p99 {e['p99_s']:.6f} s, modeled "
              f"{e.get('modeled_bytes')} bytes, achieved {bps / 1e9:.3f} GB/s "
              f"({bps / HBM_BYTES_PER_S:.6f} of 3.35 TB/s)", flush=True)
    top = run["top_dispatches"]
    for i, t in enumerate(top):
        print(f"  slowest #{i + 1}: {t['seconds']:.6f} s, bucket {t['bucket']}, phase "
              f"{t['phase']}, rows {t['rows']}", flush=True)
    deadline = 2 * top[0]["seconds"]
    fused = summary["fused"]
    print(f"profile: cost fingerprint {dp['cost_fingerprint'][:12]} ({len(dp['cost_model'])} "
          f"programs, cost pass {run['cost_pass_seconds']:.3f} s); {total} dispatches = "
          f"device batches {by_bucket}; launches modeled {modeled} >= run {actual} (gap "
          f"{gap}); recommended --stage-deadline-s {deadline:.3f} (twice the slowest "
          f"dispatch); {run['device_docs_per_s']:.2f} docs/s profiled, against "
          f"{fused['device_docs_per_s']:.2f} for the next windowed run (fused, unarmed, "
          f"{fused['received']} documents); parity {run['decision_parity']}", flush=True)
    return {"per_program": rows, "top_dispatches": top, "stage_deadline_s": deadline,
            "launches_modeled": modeled, "launches_run": actual, "launch_gap": gap,
            "cost_fingerprint": dp["cost_fingerprint"],
            "cost_pass_seconds": run["cost_pass_seconds"]}


def _trace_events(prof):
    """``(name, device_type, start_ns, end_ns)`` of every event a
    ``torch.profiler`` session recorded, read from its kineto results
    (building the profiler's function events costs far more)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
        else:
            t0 = e.start_us() * 1e3
            t1 = t0 + e.duration_us() * 1e3
        out.append((e.name(), e.device_type(), t0, t1))
    return out


def batch_anatomy(corpus) -> list:
    """One batch of corpus documents per (bucket, phase) of the default
    ladder, run once plainly (its CUDA-event span, the reference) and once
    under ``torch.profiler`` (CPU and CUDA activity; a session a batch):
    the profiled span
    split into hand-kernel time, eager PyTorch kernel time (and launches),
    copies, device idle gaps (the span less the union of the device's
    intervals) and the host's time blocked in synchronizing calls.  The
    profiler slows the host, not the device: the plain span less the
    device's busy time estimates the gaps without it.  Fails when the
    profiler records no CUDA activity."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from textblaster_tpu_torch.config.pipeline import load_pipeline_config
    from textblaster_tpu_torch.data_model import TextDocument
    from textblaster_tpu_torch.ops.packing import PACK_MARGIN, pack_documents
    from textblaster_tpu_torch.ops.pipeline import CompiledPipeline

    pipe = CompiledPipeline(load_pipeline_config(CONFIG), device="cuda")
    hand = re.compile(HAND_KERNEL_RE)
    cuda = torch.autograd.DeviceType.CUDA
    out, lo = [], 0
    for length in pipe.buckets:
        rows = pipe.geometry.batch_for(length)
        docs = [TextDocument(id=i, source="s", content=t) for i, t in corpus
                if max(lo, length // 4) < len(t) <= length - PACK_MARGIN
                and max(map(ord, t)) < 0x2E80][:rows]
        lo = length
        batch = pack_documents(docs, rows, length)
        for phase in range(len(pipe.phases)):
            plain_s = pipe.run_batch(batch, phase)[2]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, host_s, dev_s = pipe.run_batch(batch, phase)
            torch.cuda.synchronize()
            events = _trace_events(prof)
            dev = [e for e in events if e[1] == cuda]
            if not dev:
                fail(f"torch.profiler recorded no CUDA activity at bucket {length}, phase {phase}")
            cls = {"hand": 0.0, "eager": 0.0, "copies": 0.0}
            n_eager = n_hand = 0
            for name, _, t0, t1 in dev:
                if name.startswith(("Memcpy", "Memset")):
                    cls["copies"] += t1 - t0
                elif hand.search(name):
                    cls["hand"] += t1 - t0
                    n_hand += 1
                else:
                    cls["eager"] += t1 - t0
                    n_eager += 1
            union, end = 0.0, None
            for _, _, t0, t1 in sorted(dev, key=lambda e: e[2]):
                if end is None or t0 > end:
                    union += t1 - t0
                    end = t1
                elif t1 > end:
                    union += t1 - end
                    end = t1
            syncs = [t1 - t0 for name, _, t0, t1 in events if name in SYNC_CALLS]
            span_ns = dev_s * 1e9
            row = {"bucket": length, "phase": phase, "rows": rows, "docs": len(docs),
                   "plain_span_ms": plain_s * 1e3, "span_ms": span_ns / 1e6,
                   "host_ms": host_s * 1e3,
                   "hand_ms": cls["hand"] / 1e6, "hand_launches": n_hand,
                   "eager_ms": cls["eager"] / 1e6, "eager_launches": n_eager,
                   "copies_ms": cls["copies"] / 1e6, "busy_ms": union / 1e6,
                   "gaps_ms": max(0.0, span_ns - union) / 1e6,
                   "plain_gaps_ms": max(0.0, plain_s * 1e9 - union) / 1e6,
                   "sync_ms": sum(syncs) / 1e6, "sync_calls": len(syncs)}
            out.append(row)
            print(f"  anatomy b{length}/p{phase} ({len(docs)} docs): profiled span "
                  f"{row['span_ms']:.3f} ms = hand {row['hand_ms']:.3f} ({n_hand} launches) + "
                  f"eager {row['eager_ms']:.3f} ({n_eager} launches) + copies "
                  f"{row['copies_ms']:.3f} + gaps {row['gaps_ms']:.3f} ms; host blocked in "
                  f"{len(syncs)} syncs {row['sync_ms']:.3f} ms; plain span "
                  f"{row['plain_span_ms']:.3f} ms, of it gaps {row['plain_gaps_ms']:.3f} ms",
                  flush=True)
    return out


def sentinel_phase() -> dict:
    """The sentinel workload's profile on ``cuda`` and on ``cpu`` in one
    process, under the u16 wire the sentinel pins: equal dispatch counts and
    an equal cost fingerprint (the shape model does not depend on the
    device), both passing the committed baseline
    (``profiles/sentinel_baseline_torch.json``, full check) and the JAX
    package's baseline's dispatch counts."""
    from textblaster_tpu_torch.utils.profiler import collect_sentinel_profile, compare_profiles

    prev = os.environ.get("TEXTBLAST_WIRE")
    os.environ["TEXTBLAST_WIRE"] = "u16"
    t0 = time.perf_counter()
    try:
        got = {dev: collect_sentinel_profile(device=dev) for dev in ("cuda", "cpu")}
    finally:
        if prev is None:
            del os.environ["TEXTBLAST_WIRE"]
        else:
            os.environ["TEXTBLAST_WIRE"] = prev
    seconds = time.perf_counter() - t0
    counts = {dev: {pk: p["dispatch_counts"] for pk, p in g["programs"].items()}
              for dev, g in got.items()}
    fps = {dev: g["cost_fingerprint"] for dev, g in got.items()}
    if counts["cuda"] != counts["cpu"] or fps["cuda"] != fps["cpu"] or not fps["cuda"]:
        fail(f"sentinel: cuda and cpu differ: counts {counts}, fingerprints {fps}")
    with open(os.path.join(ROOT, "profiles", "sentinel_baseline_torch.json")) as f:
        status, findings = compare_profiles(json.load(f), got["cuda"])
    with open(os.path.join(ROOT, "profiles", "sentinel_baseline.json")) as f:
        jax_counts = {pk: p["dispatch_counts"] for pk, p in json.load(f)["programs"].items()}
    if status != "pass" or findings or counts["cuda"] != jax_counts:
        fail(f"sentinel against the baselines: {status} {findings}; counts {counts['cuda']}, "
             f"the JAX package's {jax_counts}")
    print(f"sentinel: cuda and cpu give the same dispatch counts {counts['cuda']} (the JAX "
          f"package's baseline's) and cost fingerprint {fps['cuda'][:12]}, which passes "
          f"profiles/sentinel_baseline_torch.json; {seconds:.1f} s", flush=True)
    return {"dispatch_counts": counts["cuda"], "cost_fingerprint": fps["cuda"],
            "seconds": seconds}


def profile_phase(summary, corpus) -> dict:
    t0 = time.perf_counter()
    res = {"main_path": profile_report(summary), "anatomy": batch_anatomy(corpus),
           "sentinel": sentinel_phase()}
    res["seconds"] = time.perf_counter() - t0
    print(f"profile phase: {res['seconds']:.1f} s", flush=True)
    return res


# --- the CLI --------------------------------------------------------------------

CLI_DOCS = 2000  # the CLI run's documents
#: The JAX package's summary line (textblaster_tpu/cli.py:743-757).
SUMMARY_RE = (r"^Processed (\d+) documents in \d+\.\d\ds \((\d+\.\d) docs/sec\): "
              r"(\d+) kept -> (\S+), (\d+) excluded -> (\S+), (\d+) errored "
              r"\(in neither file\)\.$")


def registry_op_seconds(n: int = 200_000) -> float:
    """Host seconds of one locked ``Metrics.inc`` on this machine (``n`` of
    them on a scratch registry): the unit cost of a metric hook."""
    from textblaster_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    t0 = time.perf_counter()
    for _ in range(n):
        m.inc("producer_results_received_total")
    return (time.perf_counter() - t0) / n


def _free_loopback_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_main(argv):
    """``textblaster_tpu_torch.cli.main(argv)`` with its stdout and stderr
    captured and the root logger given back after (the CLI sets up
    logging): ``(exit code, stdout, stderr)``."""
    import contextlib
    import io
    import logging

    from textblaster_tpu_torch import cli

    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        for h in handlers:
            if h not in root.handlers:
                root.addHandler(h)
        root.setLevel(level)
    return rc, out.getvalue(), err.getvalue()


def cli_phase(rows, work: str, device: str = "cuda"):
    """The port's CLI on ``device`` over the first ``CLI_DOCS`` documents,
    with ``--run-report`` and ``--metrics-port`` on a free loopback port:
    one ``GET /metrics`` while the endpoint is up, held to the exposition
    rules (``utils/promlint.py``); the summary line in the JAX package's
    format, its numbers equal to the report's counts and the output files'
    rows; then a run over a missing input, which must exit 1 with
    ``Pipeline run failed:``."""
    import re
    import urllib.request

    import pyarrow.parquet as pq

    from textblaster_tpu_torch import cli
    from textblaster_tpu_torch.utils.promlint import exposition_problems

    inp = os.path.join(work, "corpus_cli.parquet")
    write_parquet(inp, rows[:CLI_DOCS])
    kept, excl = os.path.join(work, "cli_kept.parquet"), os.path.join(work, "cli_excl.parquet")
    report_path = os.path.join(work, "cli_report.json")
    port = _free_loopback_port()
    servers = []
    real = cli.setup_prometheus_metrics

    def capture(p):
        servers.append(real(p))
        return servers[-1]

    cli.setup_prometheus_metrics = capture
    try:
        t0 = time.perf_counter()
        rc, out, err = _cli_main(["run", "-i", inp, "-c", CONFIG, "-o", kept, "-e", excl,
                                  "--device", device, "--run-report", report_path,
                                  "--metrics-port", str(port)])
        wall = time.perf_counter() - t0
        for line in (out + err).splitlines():
            print(f"  cli | {line}", flush=True)
        if rc != 0:
            fail(f"the CLI run exited {rc}")
        if len(servers) != 1 or servers[0] is None:
            fail(f"the CLI did not serve /metrics on port {port}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
            status, body = resp.status, resp.read().decode("utf-8")
        m_off = re.match(SUMMARY_RE, out.splitlines()[0] if out else "")
        if not m_off:
            fail(f"the CLI's summary line is not the JAX package's: {out[:300]!r}")
        armed = armed_cli_run(inp, work, device, kept, excl, float(m_off.group(2)))
        telemetry = telemetry_cli_run(inp, work, device, kept, excl, float(m_off.group(2)))
        profiled = profiled_cli_run(inp, work, device, kept, excl, float(m_off.group(2)))
    finally:
        cli.setup_prometheus_metrics = real
        for server in servers:
            if server is not None:
                server.shutdown()
                server.server_close()
    problems = exposition_problems(body)
    if status != 200 or problems:
        fail(f"GET /metrics: status {status}, exposition problems {problems[:5]}")
    m = m_off
    received, rate, n_kept, n_excl, errors = (m.group(1), m.group(2), m.group(3),
                                              m.group(5), m.group(7))
    with open(report_path) as f:
        report = json.load(f)
    counts = report["counts"]
    rows_kept, rows_excl = (pq.ParquetFile(p).metadata.num_rows for p in (kept, excl))
    if not (int(received) == counts["received"] == CLI_DOCS
            and int(n_kept) == counts["success"] == rows_kept
            and int(n_excl) == counts["filtered"] == rows_excl
            == report["funnel"]["dropped_total"]
            and int(errors) == counts["errors"]):
        fail(f"the CLI's summary {m.group(0)!r} and report counts {counts} disagree "
             f"with the files ({rows_kept} kept, {rows_excl} excluded rows)")
    if report["schema"] != "textblaster-run-report/v4" or report["config"]["device"] != device:
        fail(f"the CLI's run report: schema {report['schema']}, config {report['config']}")
    scraped = {ln.split(" ")[0]: float(ln.split(" ")[1]) for ln in body.splitlines()
               if ln and not ln.startswith("#") and "{" not in ln}
    if scraped.get("occupancy_device_batches_total", 0.0) < report["occupancy"]["device_batches"]:
        fail("the scrape shows fewer device batches than the CLI run dispatched")
    missing = os.path.join(work, "no_such_input.parquet")
    # Its own output paths: a failed run may leave its outputs behind, and
    # the checkpoint phase reads this run's files.
    rc_missing, out_missing, err_missing = _cli_main(
        ["run", "-i", missing, "-c", CONFIG, "-o", os.path.join(work, "cli_missing_kept.parquet"),
         "-e", os.path.join(work, "cli_missing_excl.parquet"), "--device", device])
    if rc_missing != 1 or not err_missing.startswith("Pipeline run failed:") \
            or "Traceback" in err_missing:
        fail(f"a missing input gave exit code {rc_missing}: {err_missing[:300]!r}")
    print(f"cli: {CLI_DOCS} documents on {device}, {rate} docs/s by the summary line "
          f"({wall:.2f} s with set-up); GET /metrics {status}, {len(body)} bytes, "
          f"{len(scraped)} samples, exposition clean; missing input -> exit 1, "
          f"{err_missing.strip()[:80]!r}", flush=True)
    return {"documents": CLI_DOCS, "wall_seconds": wall, "summary_line": m.group(0),
            "report": report, "scrape_bytes": len(body), "scrape_samples": len(scraped),
            "missing_input": err_missing.strip(), "armed": armed, "telemetry": telemetry,
            "profiled": profiled,
            "input": inp,
            "outputs": (kept, excl)}


def armed_cli_run(inp, work, device, kept_off, excl_off, rate_off):
    """The CLI run again over the same documents with the trace, the device
    trace, the event journal and two SLOs armed (``availability=0.999`` and
    a throughput floor of a quarter of the unarmed run's docs/s), and
    ``--run-report`` and ``--metrics-port``.  Checks: kept and excluded files byte-identical to the
    unarmed run's; the trace loads; one ``device_batch`` span a device
    batch of the report, each inside its ``device_dispatch`` host span
    (the host's spans are floored to whole microseconds: 2 us of slack);
    one kernel span a launch, kernel by kernel; every journal line valid
    and its per-kind counts the report's; the report's ``slo`` section;
    ``GET /healthz`` and ``GET /slo`` while the endpoint is up.  Prints
    the kernel-busy share (kernel span time over batch span time and over
    the run's wall), the device clock's drift and the docs/s armed
    against unarmed."""
    import re
    import urllib.error
    import urllib.request

    from textblaster_tpu_torch.ops import scan, sort
    from textblaster_tpu_torch.utils.events import validate_record
    from textblaster_tpu_torch.utils.trace import DEVICE_TRACE_FILE

    d = os.path.join(work, "cli_armed")
    os.makedirs(d, exist_ok=True)
    kept, excl = os.path.join(d, "kept.parquet"), os.path.join(d, "excl.parquet")
    trace, journal = os.path.join(d, "trace.json"), os.path.join(d, "events.jsonl")
    devdir, report_path = os.path.join(d, "devtrace"), os.path.join(d, "report.json")
    floor = rate_off / 4
    port = _free_loopback_port()
    for counts in (scan.LAUNCHES, sort.LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    rc, out, err = _cli_main(["run", "-i", inp, "-c", CONFIG, "-o", kept, "-e", excl,
                              "--device", device, "--trace", trace, "--trace-device", devdir,
                              "--events-file", journal, "--slo", "availability=0.999",
                              "--slo", f"throughput_floor={floor:.3f}", "--run-report",
                              report_path, "--metrics-port", str(port)])
    wall = time.perf_counter() - t0
    launches = {**scan.LAUNCHES, **sort.LAUNCHES}
    for line in err.splitlines()[-4:]:
        print(f"  cli armed | {line}", flush=True)
    if rc != 0:
        fail(f"the armed CLI run exited {rc}: {err[-500:]!r}")
    answers = {}
    for path in ("/healthz", "/slo"):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
                answers[path] = (resp.status, json.loads(resp.read()))
        except urllib.error.HTTPError as e:
            answers[path] = (e.code, json.loads(e.read()))
    if answers["/healthz"][0] not in (200, 503) or "status" not in answers["/healthz"][1] \
            or answers["/slo"][0] != 200 or "objectives" not in answers["/slo"][1]:
        fail(f"GET /healthz and /slo: {answers}")
    for a, b in ((kept, kept_off), (excl, excl_off)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                fail(f"the armed run's {os.path.basename(a)} differs from the unarmed run's")
    with open(report_path) as f:
        report = json.load(f)
    with open(trace) as f:
        events = json.load(f)
    host = {e["args"]["batch"]: e for e in events
            if e["name"] == "device_dispatch" and "batch" in e.get("args", {})}
    dev = [e for e in events if e["name"] == "device_batch"]
    if len(dev) != report["occupancy"]["device_batches"] or len(host) != len(dev):
        fail(f"{len(dev)} device spans and {len(host)} host spans for "
             f"{report['occupancy']['device_batches']} device batches")
    lead = min(e["ts"] - host[e["args"]["batch"]]["ts"] for e in dev)
    tail = min(host[e["args"]["batch"]]["ts"] + host[e["args"]["batch"]]["dur"]
               - e["ts"] - e["dur"] for e in dev)
    clocks = [e["args"] for e in events if e["name"] == "device_clock"]
    clock = clocks[-1] if clocks else {}
    with open(os.path.join(devdir, DEVICE_TRACE_FILE)) as f:
        devtrace = json.load(f)
    spans = [e for e in devtrace if e["ph"] == "X"]
    per_kernel = {}
    for e in spans:
        if e["tid"] == 2:
            per_kernel[e["args"]["kernel"]] = per_kernel.get(e["args"]["kernel"], 0) + 1
    if per_kernel != {k: v for k, v in launches.items() if v}:
        fail(f"kernel spans {per_kernel} against launches {launches}")
    kernel_us = sum(e["dur"] for e in spans if e["tid"] == 2)
    batch_us = sum(e["dur"] for e in spans if e["tid"] == 1)
    m = re.match(SUMMARY_RE, out.splitlines()[0] if out else "")
    if not m:
        fail(f"the armed run's summary line: {out[:300]!r}")
    run_s = float(re.search(r" in (\d+\.\d\d)s ", m.group(0)).group(1))
    with open(journal) as f:
        records = [json.loads(line) for line in f]
    counts = {}
    for r in records:
        validate_record(r)
        counts[r["kind"]] = counts.get(r["kind"], 0) + 1
    if counts != report["events"]["by_kind"] or records[0]["kind"] != "run_start" \
            or records[-1]["kind"] != "run_end":
        fail(f"journal kinds {counts} against the report's {report['events']}")
    if set(report["slo"].get("objectives", {})) != {"availability", "throughput_floor"}:
        fail(f"the report's slo section: {report['slo']}")
    rate = float(m.group(2))
    busy = {"kernel_over_batch": kernel_us / batch_us, "kernel_over_wall": kernel_us / 1e6 / run_s,
            "batch_over_wall": batch_us / 1e6 / run_s}
    print(f"cli armed: {rate} docs/s armed against {rate_off} unarmed ({rate / rate_off:.4f}x), "
          f"files byte-identical; {len(dev)} device spans = device batches, each inside its "
          f"host span (least lead {lead} us, least tail {tail} us); device clock {clock}; "
          f"kernel spans = launches {per_kernel}; kernel-busy share {busy['kernel_over_batch']:.4f} "
          f"of batch span time, {busy['kernel_over_wall']:.4f} of the run's {run_s:.2f} s wall "
          f"(batches {busy['batch_over_wall']:.4f}); journal {len(records)} lines valid, "
          f"kinds {counts}; slo {report['slo']}; GET /healthz {answers['/healthz'][0]} "
          f"{answers['/healthz'][1]['status']}, GET /slo {answers['/slo'][0]}", flush=True)
    if lead < -2 or tail < -2:
        fail(f"a device span leaves its host span: least lead {lead} us, least tail {tail} us")
    return {"docs_per_s": rate, "docs_per_s_unarmed": rate_off, "wall_seconds": wall,
            "run_seconds": run_s, "device_spans": len(dev), "least_lead_us": lead,
            "least_tail_us": tail, "device_clock": clock, "kernel_spans": per_kernel,
            "kernel_us": kernel_us, "batch_us": batch_us, "busy": busy,
            "journal_kinds": counts, "slo": report["slo"],
            "healthz": answers["/healthz"], "slo_endpoint": answers["/slo"][1]}


def profiled_cli_run(inp, work, device, kept_off, excl_off, rate_off):
    """The CLI run again over the same documents with ``--profile`` and
    ``--run-report``.  Checks: kept and excluded files byte-identical to
    the plain run's; the report's ``device_profile`` dispatch counts summing
    to its device batches; a cost fingerprint; the ``Device profile:``
    line.  Prints docs/s profiled against plain."""
    import re

    d = os.path.join(work, "cli_profiled")
    os.makedirs(d, exist_ok=True)
    kept, excl = os.path.join(d, "kept.parquet"), os.path.join(d, "excl.parquet")
    report_path = os.path.join(d, "report.json")
    rc, out, err = _cli_main(["run", "-i", inp, "-c", CONFIG, "-o", kept, "-e", excl,
                              "--device", device, "--profile", "--run-report", report_path])
    if rc != 0:
        fail(f"the profiled CLI run exited {rc}: {err[-500:]!r}")
    for a, b in ((kept, kept_off), (excl, excl_off)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                fail(f"the profiled run's {os.path.basename(a)} differs from the plain run's")
    with open(report_path) as f:
        report = json.load(f)
    dp = report["device_profile"]
    n = sum(e["count"] for e in dp["dispatch"].values())
    if n != report["occupancy"]["device_batches"] or not dp["cost_fingerprint"]:
        fail(f"the profiled run's report: {n} dispatches for "
             f"{report['occupancy']['device_batches']} device batches, fingerprint "
             f"{dp['cost_fingerprint']}")
    line = [ln for ln in err.splitlines()
            if ln.startswith(f"Device profile: cost fingerprint {dp['cost_fingerprint'][:12]}")]
    m = re.match(SUMMARY_RE, out.splitlines()[0] if out else "")
    if not line or not m:
        fail(f"the profiled run's summary: {out[:300]!r}, {err[-300:]!r}")
    rate = float(m.group(2))
    print(f"cli profiled: {rate} docs/s profiled against {rate_off} plain "
          f"({rate / rate_off:.4f}x), files byte-identical; {n} dispatches = device batches; "
          f"{line[0]}", flush=True)
    return {"docs_per_s": rate, "docs_per_s_plain": rate_off, "dispatches": n,
            "cost_fingerprint": dp["cost_fingerprint"], "line": line[0],
            "top_dispatches": dp["top_dispatches"]}


TELEMETRY_POLL_S = 1.0  # how often the telemetry run's poller asks GET /telemetry


def telemetry_cli_run(inp, work, device, kept_off, excl_off, rate_off):
    """The CLI run again over the same documents with ``--doc-sample-rate 1``
    (every document sampled), a ``p99_latency_s`` SLO, ``--run-report`` and
    ``--metrics-port``, while a thread asks ``GET /telemetry`` every
    ``TELEMETRY_POLL_S``.  The ``doc_flow`` lineages are read at the
    telemetry module's trace seam (a tap that keeps each instant's
    arguments and passes it on to the tracer, which is off here).  Checks:
    kept and excluded files byte-identical to the plain run's;
    ``doc_sampled_total`` (this run's delta) equal to the ids read; the
    report's ``e2e`` latency count, and the lineages by id, equal to the
    documents written; every lineage's stage deltas summing to its
    end-to-end latency (consecutive stamps never decrease: a negative
    delta is clamped to 0 and would make the sum exceed it), and every
    device lineage carrying dispatch, device_wait and assemble; a
    ``/telemetry`` answer during the run with at least one window; the
    SLO's events equal to the lineages.  Prints docs/s sampled against
    plain, each stage's p50/p95/p99, the counts and the windows."""
    import re
    import threading
    import urllib.request

    import pyarrow.parquet as pq

    from textblaster_tpu_torch.utils import telemetry as telemetry_mod
    from textblaster_tpu_torch.utils.metrics import METRICS

    d = os.path.join(work, "cli_telemetry")
    os.makedirs(d, exist_ok=True)
    kept, excl = os.path.join(d, "kept.parquet"), os.path.join(d, "excl.parquet")
    report_path = os.path.join(d, "report.json")
    port = _free_loopback_port()
    flows = []
    tracer = telemetry_mod.TRACER

    class FlowTap:
        def instant(self, name, args=None):
            if name == "doc_flow":
                flows.append(args)
            tracer.instant(name, args)

    polls = []
    done = threading.Event()

    def poll():
        while not done.wait(TELEMETRY_POLL_S):
            try:
                url = f"http://127.0.0.1:{port}/telemetry"
                with urllib.request.urlopen(url, timeout=10) as resp:
                    polls.append((resp.status, json.loads(resp.read())))
            except OSError:  # the endpoint is not up yet
                pass

    sampled_before = METRICS.get("doc_sampled_total")
    poller = threading.Thread(target=poll, name="telemetry-poll", daemon=True)
    telemetry_mod.TRACER = FlowTap()
    poller.start()
    try:
        rc, out, err = _cli_main(["run", "-i", inp, "-c", CONFIG, "-o", kept, "-e", excl,
                                  "--device", device, "--doc-sample-rate", "1",
                                  "--slo", "p99_latency_s=30", "--run-report", report_path,
                                  "--metrics-port", str(port)])
    finally:
        done.set()
        poller.join()
        telemetry_mod.TRACER = tracer
    sampled = int(METRICS.get("doc_sampled_total") - sampled_before)
    block = err[err.find("Per-document tail latency"):].splitlines()[:9]
    for line in block:
        print(f"  cli telemetry | {line}", flush=True)
    if rc != 0:
        fail(f"the telemetry CLI run exited {rc}: {err[-500:]!r}")
    for a, b in ((kept, kept_off), (excl, excl_off)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                fail(f"the telemetry run's {os.path.basename(a)} differs from the plain run's")
    with open(report_path) as f:
        report = json.load(f)
    n_read = pq.ParquetFile(inp).metadata.num_rows
    written = [pq.read_table(p, columns=["id"]).column("id").to_pylist() for p in (kept, excl)]
    written = written[0] + written[1]
    stages = report["latency"]["stages"]
    e2e = stages.get("e2e", {}).get("count", 0)
    slo = report["slo"].get("objectives", {}).get("p99_latency_s", {})
    if sampled != n_read or e2e != len(written) or slo.get("events") != e2e:
        fail(f"telemetry counts: {sampled} sampled of {n_read} read, e2e count {e2e} of "
             f"{len(written)} written, SLO {slo}")
    if sorted(f["id"] for f in flows) != sorted(written):
        fail(f"{len(flows)} doc_flow lineages for {len(written)} written documents")
    order = telemetry_mod.STAGES
    broken = [f for f in flows if sum(f["us"][s] for s in order if s in f["us"]) != f["us"]["e2e"]]
    device_flows = [f for f in flows if "dispatch" in f["us"]]
    partial = [f for f in device_flows
               if not all(s in f["us"] for s in ("read", "pack", "device_wait", "assemble", "write"))]
    if broken or partial or not device_flows:
        fail(f"lineages: {len(broken)} with decreasing stamps ({broken[:2]}), "
             f"{len(partial)} device lineages missing a stage ({partial[:2]}), "
             f"{len(device_flows)} reached the device")
    live = [body for status, body in polls if status == 200 and body.get("windows")]
    if not live or not all(k in live[-1] for k in ("latency", "sample_rate", "open_lineages")):
        fail(f"GET /telemetry during the run: {len(polls)} answers, none with a window")
    m = re.match(SUMMARY_RE, out.splitlines()[0] if out else "")
    if not m:
        fail(f"the telemetry run's summary line: {out[:300]!r}")
    rate = float(m.group(2))
    quantiles = {s: (v["p50_s"], v["p95_s"], v["p99_s"]) for s, v in stages.items()}
    p99_stage = max((s for s in order if s in stages), key=lambda s: stages[s]["p99_s"])
    print(f"cli telemetry: {rate} docs/s sampled at 1 against {rate_off} plain "
          f"({rate / rate_off:.4f}x), files byte-identical; {sampled} sampled = {n_read} read; "
          f"e2e count {e2e} = {len(written)} written = doc_flow lineages; "
          f"{len(device_flows)} reached the device, stamps non-decreasing in every lineage; "
          f"p50/p95/p99 s by stage {quantiles}; largest p99 in {p99_stage}; "
          f"GET /telemetry {len(live)} of {len(polls)} answers with windows, "
          f"{len(live[-1]['windows'])} windows in the last; SLO p99_latency_s {slo}", flush=True)
    return {"docs_per_s": rate, "docs_per_s_plain": rate_off, "sampled": sampled,
            "read": n_read, "written": len(written), "e2e_count": e2e,
            "device_lineages": len(device_flows), "stages": stages, "p99_stage": p99_stage,
            "telemetry_polls": len(polls), "windows": len(live[-1]["windows"]),
            "last_snapshot": live[-1], "slo": slo}


# --- auto-geometry and checkpoint/resume -----------------------------------------

CKPT_EVERY = 500  # documents a checkpointed chunk (of the CLI run's CLI_DOCS)


def _zero_launches():
    from textblaster_tpu_torch.ops import scan, sort, stats

    for d in (scan.LAUNCHES, sort.LAUNCHES, stats.DUP_WALK):
        for k in d:
            d[k] = 0
    for d in (scan.SHAPE_LAUNCHES, sort.SHAPE_LAUNCHES, scan.CHAIN_SITE_LAUNCHES,
              scan.CHAIN_SHAPE_LAUNCHES):
        d.clear()


def auto_run(config, inp: str, work: str, tag: str, device: str):
    """One ``run_pipeline(..., auto_geometry=True)`` over ``inp``: the
    calibration pass and its pipeline are the runner's own, so the run's
    occupancy and host routes come from its report and the ``METRICS``
    counters (taken relative to a snapshot just before), its launches from
    the kernel counters (set to 0 just before, read just after)."""
    import torch

    from textblaster_tpu_torch.ops import scan, sort, stats
    from textblaster_tpu_torch.runner import run_pipeline
    from textblaster_tpu_torch.utils.metrics import METRICS, build_run_report, metrics_snapshot

    out = (os.path.join(work, f"{tag}_kept.parquet"), os.path.join(work, f"{tag}_excl.parquet"))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    baseline = metrics_snapshot()
    routes0 = {k: METRICS.get(k) for k in ("worker_host_tail_total", "worker_host_fallback_total")}
    t0 = time.perf_counter()
    res = run_pipeline(config, inp, *out, backend="device", device=device, auto_geometry=True)
    if device == "cuda":
        torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    report = build_run_report(
        baseline=baseline, wall_time_s=dev_s,
        counts={"received": res.received, "success": res.success, "filtered": res.filtered,
                "errors": res.errors, "read_errors": res.read_errors},
        provenance={"entry": "chip_smoke.py auto_run", "schedule": tag, "device": device},
    )
    return {
        "schedule": tag, "received": res.received, "kept": res.success,
        "excluded": res.filtered, "errors": res.errors, "read_errors": res.read_errors,
        "device_seconds": dev_s, "device_docs_per_s": res.received / dev_s,
        "launches": {**scan.LAUNCHES, **sort.LAUNCHES},
        "shape_launches": sorted([list(k), v] for k, v in
                                 {**scan.SHAPE_LAUNCHES, **sort.SHAPE_LAUNCHES}.items()),
        "chain_shape_launches": sorted(([list(k), v] for k, v in
                                        scan.CHAIN_SHAPE_LAUNCHES.items()), key=str),
        "host_tail": int(METRICS.get("worker_host_tail_total") - routes0["worker_host_tail_total"]),
        "host_fallback": int(METRICS.get("worker_host_fallback_total")
                             - routes0["worker_host_fallback_total"]),
        "dup_walk": dict(stats.DUP_WALK),
        "peak_device_mib": (torch.cuda.max_memory_allocated() / 2**20) if device == "cuda" else None,
        "outputs": out, "report": report,
    }


def _variant_keys(run):
    return {tuple(k) for k, _ in run["shape_launches"]}


def check_new_shapes(corpus, geometry, new, device: str = "cuda"):
    """Hold every kernel to its plain version (``torch.equal``) at the
    (kernel, rows, width, variant) keys of ``new``, launched by a
    calibrated run and by no default run: the per-scan kernels in their
    variant (k accumulators, DFA states) on full-range operands and maps
    with stray nibbles, ``sort2`` on keys with ties, ``fused_scan`` with
    every call site's group list; ``chain_scan`` with every call site's
    program built by the sites' own builders on a corpus batch of each
    calibrated bucket at its batch rows, then the probe and generic
    programs at any new chain shape those did not cover.  Returns the
    keys checked, by kernel."""
    import numpy as np
    import torch

    from textblaster_tpu_torch.ops import scan

    rng = np.random.default_rng(SEED + 7)
    dev = torch.device(device)

    def full_range(shape):
        return torch.from_numpy(
            rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)).to(dev)

    def maps(shape, n_states):
        return packed_maps(rng, shape, n_states, dev, stray=True)

    def same(label, got, want):
        if device == "cuda":
            torch.cuda.synchronize()
        for g, w in zip(got, want):
            if isinstance(g, torch.Tensor):
                g, w = (g,), (w,)
            if len(g) != len(w) or not all(x.shape == y.shape and torch.equal(x, y)
                                           for x, y in zip(g, w)):
                fail(f"{label} differs from its plain version at a calibrated shape")

    done = {}
    for key in sorted(new):
        kernel, rows, width, *variant = key
        shape = (rows, width)
        if kernel == "affine_scan":
            m, accs = full_range(shape), tuple(full_range(shape) for _ in range(variant[0]))
            same(f"affine_scan {key}", scan.affine_hash_scan(m, accs),
                 scan.affine_hash_scan_plain(m, accs))
        elif kernel == "dfa_scan":
            f = maps(shape, variant[0])
            same(f"dfa_scan {key}", (scan.dfa_compose_scan(f, variant[0]),),
                 (scan.dfa_compose_scan_plain(f, variant[0]),))
        elif kernel == "sort2":
            check_sort2(rng, rows, width, dev)
        elif kernel == "fused_scan":
            for name, make in fused_site_lists(full_range, lambda s, n: maps(s, n),
                                               shape).items():
                groups = make()
                same(f"fused_scan list {name} {key}", scan.fused_scan(groups),
                     scan.fused_scan_plain(groups))
        elif kernel != "chain_scan":
            fail(f"{kernel} launched at a calibrated shape {key} that no check covers")
        done.setdefault(kernel, []).append(list(key))
    chain_new = {(r, w) for k, r, w, *_ in new if k == "chain_scan"}
    covered = set()
    if chain_new:
        for bucket, rows in zip(geometry.buckets, geometry.batch_sizes):
            for name, passes in site_programs(corpus, (rows, bucket), dev).items():
                got, want = scan.chain_scan(passes), scan.chain_scan_plain(passes)
                for gp, wp in zip(got, want):
                    same(f"chain_scan program {name} on a [{rows}, {bucket}] batch", gp, wp)
                covered.add(tuple(scan._chain_plan(passes)[1][0].shape))
        for rows, width in sorted(chain_new - covered):
            vals = torch.from_numpy(rng.integers(0, 97, size=(rows, width)).astype(np.int32)).to(dev)
            reset = torch.from_numpy((rng.random((rows, width)) < 0.05).astype(np.int32)).to(dev)
            for label, passes in (("probe", scan.chain_probe_program(vals, reset)),
                                  ("generic", generic_chain(full_range, maps, (rows, width), dev))):
                for gp, wp in zip(scan.chain_scan(passes), scan.chain_scan_plain(passes)):
                    same(f"chain_scan {label} program at [{rows}, {width}]", gp, wp)
        done["chain_scan"] = sorted([list(s) for s in chain_new])
        done["chain_scan_site_batches"] = sorted([list(s) for s in covered])
    return done


def auto_geometry_phase(rows, work: str, oracle, default_keys, device: str = "cuda"):
    """``run_pipeline(auto_geometry=True)`` over the first
    ``GEOMETRY_DOCS`` documents (the whole calibration sample), windowed,
    chain schedule, host tails on, beside the default geometry's run of
    the same documents: the calibrated buckets and batch sizes, padding
    waste, batches per bucket, host tails, docs/s and peak device memory of
    both.  Both runs' kept and excluded rows equal the host oracle's by id
    (text and metadata) and each other's, every column.  Every (kernel,
    shape, variant) the calibrated run launched that no default run did is
    held to its plain version (:func:`check_new_shapes`).  Returns the
    phase's summary and the keys launched so far (``default_keys`` and
    this phase's)."""
    from textblaster_tpu_torch.config.pipeline import load_pipeline_config
    from textblaster_tpu_torch.ops.geometry import CALIBRATION_SAMPLE, calibrate_geometry
    from textblaster_tpu_torch.ops.packing import DEFAULT_BUCKETS

    sub = rows[:GEOMETRY_DOCS]
    inp = os.path.join(work, "corpus_geometry.parquet")
    write_parquet(inp, sub)
    config = load_pipeline_config(CONFIG)
    geo = calibrate_geometry([len(t) for _, t in sub[:CALIBRATION_SAMPLE]], backend=device)
    runs = {"default": device_run(config, inp, work, "geometry_default", device),
            "auto": auto_run(config, inp, work, "geometry_auto", device)}
    host_kept, host_excl = oracle
    ids = {r[0] for r in sub}
    for tag, run in runs.items():
        run["decision_parity"], equal = _parity(run, host_kept, host_excl, ids)
        if run["decision_parity"] != 1.0 or not equal or run["received"] != len(sub):
            fail(f"the {tag} geometry run and the host oracle differ "
                 f"(parity {run['decision_parity']})")
        for k in ("chain_scan", "fused_scan", "sort2") if device == "cuda" else ():
            if run["launches"][k] <= 0:
                fail(f"the {tag} geometry run never launched {k}")
    for i in (0, 1):
        if read_rows(runs["auto"]["outputs"][i]) != read_rows(runs["default"]["outputs"][i]):
            fail(f"the calibrated run's {os.path.basename(runs['auto']['outputs'][i])} rows "
                 "differ from the default geometry's")
    occ = runs["auto"]["report"]["occupancy"]
    dispatched = {int(b) for b, n in occ["per_bucket_dispatches"].items() if n}
    if not dispatched <= set(geo.buckets) or geo.source != "auto":
        fail(f"the calibrated run dispatched buckets {sorted(dispatched)}, "
             f"its geometry {geo.describe()}")
    off_ladder = sorted(dispatched - set(DEFAULT_BUCKETS))
    if not off_ladder:
        fail(f"the calibrated geometry {geo.describe()} dispatched no bucket off the ladder")
    new = _variant_keys(runs["auto"]) - default_keys - _variant_keys(runs["default"])
    checked = check_new_shapes(rows, geo, new, device)
    widest = widest_bucket_peaks(config, geo, sub, device)
    lines = {}
    for tag, run in runs.items():
        o = run["report"]["occupancy"]
        tails = run["host_routes"]["host_tail"] if "host_routes" in run else run["host_tail"]
        lines[tag] = {
            "docs_per_s": run["device_docs_per_s"], "seconds": run["device_seconds"],
            "waste_ratio": o["waste_ratio"], "padded_lanes": o["padded_lanes"],
            "real_codepoints": o["real_codepoints"], "device_batches": o["device_batches"],
            "batches_per_bucket": o["per_bucket_dispatches"], "host_tails": tails,
            "peak_device_mib": run["peak_device_mib"], "launches": run["launches"],
            "dup_walk_seconds": run["dup_walk"]["seconds"],
        }
        print(f"auto-geometry, {tag}: {run['received']} documents, "
              f"{run['device_docs_per_s']:.2f} docs/s ({run['device_seconds']:.2f} s), parity "
              f"{run['decision_parity']}, waste {o['waste_ratio']} ({o['real_codepoints']} real "
              f"of {o['padded_lanes']} lanes), batches per bucket "
              f"{json.dumps(o['per_bucket_dispatches'])}, host tails {tails}, peak device "
              f"memory {run['peak_device_mib']} MiB, launches {run['launches']}", flush=True)
    print(f"auto-geometry: calibrated {geo.describe()} from {min(len(sub), CALIBRATION_SAMPLE)} "
          f"documents; off the ladder {off_ladder}; peak device memory of one batch of the "
          f"widest bucket by phase {json.dumps(widest)}; {len(new)} new (kernel, rows, width, "
          f"variant) keys held to their plain versions: {json.dumps(checked)}", flush=True)
    known = default_keys | _variant_keys(runs["default"]) | _variant_keys(runs["auto"])
    return {"geometry": geo.to_dict(), "off_ladder": off_ladder, "runs": lines,
            "widest_bucket_peak_mib": widest, "new_shapes_checked": checked}, known


def widest_bucket_peaks(config, geo, rows, device: str = "cuda"):
    """Peak device memory (MiB allocated) of one full batch of the widest
    calibrated bucket through each phase function, on a pipeline with the
    calibrated geometry: the corpus documents that land in that bucket,
    packed to its batch rows."""
    from textblaster_tpu_torch.data_model import TextDocument
    from textblaster_tpu_torch.ops.packing import pack_documents
    from textblaster_tpu_torch.ops.pipeline import CompiledPipeline

    pipe = CompiledPipeline(config, device=device, geometry=geo)
    width, n = geo.largest, geo.batch_for(geo.largest)
    docs = [TextDocument(id=i, source="chip_smoke", content=t) for i, t in rows
            if geo.bucket_for(len(t)) == width][:n]
    batch = pack_documents(docs, batch_size=n, max_len=width)
    peaks = {"bucket": width, "rows": n, "documents": len(docs)}
    for phase in range(len(pipe.phases)):
        if device == "cuda":
            import torch

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        pipe.run_batch(batch, phase)
        peaks[f"phase_{phase}"] = (torch.cuda.max_memory_allocated() / 2**20
                                   if device == "cuda" else None)
    return peaks


# --- C4BadWords on the device --------------------------------------------------

#: The JAX package's badwords benchmark config (bench.py:359-370), its list
#: seed (bench.py:372) and its injection shares (bench.py:554-562).
BADWORDS_CONFIG = """
pipeline:
  - type: C4BadWordsFilter
    default_language: en
    keep_fraction: 0.0
    fail_on_missing_language: true
"""
BADWORDS_SEED = 515
BADWORDS_HIT_SHARE, BADWORDS_HAZARD_SHARE = 0.05, 0.005
#: Path (b): the step appended to the offline Danish pipeline, keeping a
#: tenth of the matching documents (the draw is seeded per document, so the
#: host oracle draws the same), over the first BADWORDS_SUBSET documents.
DANISH_BADWORDS_STEP = """- type: C4BadWordsFilter
  default_language: da
  keep_fraction: 0.1
  fail_on_missing_language: true
  seed: 18
"""
BADWORDS_SUBSET = 3000
#: Path (a)'s documents: the first BADWORDS_DOCS of the corpus (every
#: default bucket still fills), so that the native phase fits the
#: script's time.
BADWORDS_DOCS = 10000
#: The window-hash multipliers (ops/badwords.py: 31 and MUL2).
BADWORDS_MULS = (31, 1000003)


def inject_badwords(rows, words, seed, hazard_share, prefix=False):
    """``rows`` with about 5% of the documents given one list entry after a
    space (before the text and a space with ``prefix``) and about
    ``hazard_share`` given ``" ſ"`` (a fold-hazard code point for every
    Latin list), from a seeded generator, as bench.py does."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for doc_id, text in rows:
        r = rng.random()
        if r < BADWORDS_HIT_SHARE:
            word = words[int(rng.integers(0, len(words)))]
            text = f"{word} {text}" if prefix else f"{text} {word}"
        elif r < BADWORDS_HIT_SHARE + hazard_share:
            text += " ſ"
        out.append((doc_id, text))
    return out


def badwords_operands(rng, corpus, rows, width, mul, dev):
    """The operands ``_window_context`` gives the k = 1 ``affine_scan`` on a
    ``[rows, width]`` batch of corpus documents: ``m`` is 0 at column 0,
    ``mul`` inside the row, 1 past its end; the accumulator is the lowered
    code points inside the row, 0 past it."""
    import numpy as np
    import torch

    from textblaster_tpu_torch.ops.device import lowered

    cps = np.zeros((rows, width), np.int32)
    lengths = np.zeros(rows, np.int32)
    for r in range(rows):
        text = corpus[int(rng.integers(len(corpus)))][1]
        arr = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)[:width]
        n = int(rng.integers(0, len(arr) + 1)) if r % 3 == 2 else len(arr)
        cps[r, :n] = arr[:n]
        lengths[r] = n
    cps_t = torch.from_numpy(cps).to(dev)
    pos = torch.arange(width, device=dev, dtype=torch.int32)[None, :]
    mask = pos < torch.from_numpy(lengths).to(dev)[:, None]
    m = torch.where(pos == 0, 0, torch.where(mask, mul, 1)).to(torch.int32).contiguous()
    acc = torch.where(mask, lowered(cps_t), 0).to(torch.int32).contiguous()
    return m, acc


def badwords_kernels(corpus, geometry):
    """The k = 1 ``affine_scan`` with the badwords operands at both
    multipliers, at every default bucket and every calibrated width, on 1,
    7, 64 and 65 rows and the calibrated batch rows, aligned and on offset
    views, each ``torch.equal`` to its plain version; then its time at
    ``MUL2`` at each default bucket's geometry rows beside its bound."""
    import numpy as np
    import torch

    from textblaster_tpu_torch.ops import scan
    from textblaster_tpu_torch.ops.cost import bound, scan_cost
    from textblaster_tpu_torch.ops.packing import DEFAULT_BUCKETS
    from textblaster_tpu_torch.ops.pipeline import default_batch_size

    rng = np.random.default_rng(SEED + 11)
    dev = torch.device("cuda")
    calibrated = dict(zip(geometry["geometry"]["buckets"], geometry["geometry"]["batch_sizes"]))
    shapes = sorted({(r, w) for w in set(DEFAULT_BUCKETS) | set(calibrated)
                     for r in (1, 7, 64, 65)} | {(r, w) for w, r in calibrated.items()})

    checked = 0
    for rows, width in shapes:
        for mul in BADWORDS_MULS:
            m, acc = badwords_operands(rng, corpus, rows, width, mul, dev)
            for view_name, view in (("aligned", lambda t: t), ("offset", offset_view)):
                mv, av = view(m), (view(acc),)
                got = scan.affine_hash_scan(mv, av)
                torch.cuda.synchronize()
                want = scan.affine_hash_scan_plain(mv, av)
                if not torch.equal(got[0], want[0]):
                    fail(f"affine_scan (k = 1, badwords operands, m = {mul}) differs from its "
                         f"plain version at {[rows, width]} ({view_name})")
                checked += 1
    timed = []
    rows = default_batch_size(DEFAULT_BUCKETS, "cuda")
    for width in DEFAULT_BUCKETS:
        m, acc = badwords_operands(rng, corpus, rows, width, BADWORDS_MULS[1], dev)
        accs = (acc,)
        row = dict(kernel="affine_scan", variant=1, mul=BADWORDS_MULS[1], shape=[rows, width],
                   ms=graph_ms(lambda: scan.affine_hash_scan(m, accs)),
                   call_ms=cuda_ms(lambda: scan.affine_hash_scan(m, accs)),
                   plain_ms=cuda_ms(lambda: scan.affine_hash_scan_plain(m, accs), 3),
                   library_ms=None, **bound(*scan_cost("affine_scan", rows, width, 1)))
        timed.append(row)
        print(f"  badwords affine_scan/1 m={BADWORDS_MULS[1]} {str(row['shape']):14s} kernel "
              f"{row['ms']:.4f} ms  call {row['call_ms']:.4f} ms  plain {row['plain_ms']:.4f} ms"
              f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    print(f"badwords kernels exact: affine_scan k = 1 with the badwords operands "
          f"(m = {list(BADWORDS_MULS)}) at {shapes}, aligned and offset: {checked} checks",
          flush=True)
    return {"checked_shapes": [list(s) for s in shapes], "checks": checked, "timed": timed}


def _bmp(text: str) -> bool:
    """No supplementary-plane code point: the u16 wire's device rows."""
    return not text or max(text) <= "\uffff"


def _kept_statuses(path):
    import pyarrow.parquet as pq

    out = {}
    for md in pq.read_table(path, columns=["metadata"]).column("metadata").to_pylist():
        status = json.loads(md or "{}").get("c4_badwords_filter_status")
        out[status] = out.get(status, 0) + 1
    return out


def badwords_batch_peak(pipe, rows):
    """Peak device memory (MiB allocated) of one full batch of the 65536
    bucket through the badwords program: the corpus documents longer than
    32768 characters, packed to the bucket's geometry rows."""
    import torch

    from textblaster_tpu_torch.data_model import TextDocument
    from textblaster_tpu_torch.ops.packing import pack_documents

    width = max(pipe.buckets)
    n = pipe.geometry.batch_for(width)
    docs = [TextDocument(id=i, source="chip_smoke", content=t) for i, t in rows
            if 32768 < len(t) <= width and _bmp(t)][:n]
    batch = pack_documents(docs, batch_size=n, max_len=width)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pipe.run_batch(batch, 0)
    return {"bucket": width, "rows": n, "documents": len(docs),
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def badwords_whole_corpus(rows, work, device: str = "cuda"):
    """Path (a), its run: the JAX package's badwords benchmark config at
    list scale (``synth_badwords(515, n=400)`` as the ``en`` list in a
    cache dir) over the first ``BADWORDS_DOCS`` documents of the corpus
    with the benchmark's injection,
    windowed, chain schedule, host tails off (so that the device decides
    every document but the astral ones, and the fold-hazard count is
    exact).  Returns the run, with its pipeline, input, config spec and
    documents (checked by :func:`check_badwords_whole_corpus`)."""
    from textblaster_tpu_torch.utils.metrics import METRICS
    from textblaster_tpu_torch.utils.synthwords import synth_badwords

    cache = os.path.join(work, "badwords_cache")
    os.makedirs(cache, exist_ok=True)
    words = synth_badwords(BADWORDS_SEED, n=400)
    with open(os.path.join(cache, "en"), "w", encoding="utf-8") as f:
        f.write("\n".join(words) + "\n")
    spec = (BADWORDS_CONFIG, cache)
    inj = inject_badwords(rows[:BADWORDS_DOCS], words, SEED + 5, BADWORDS_HAZARD_SHARE)
    inp = os.path.join(work, "corpus_badwords.parquet")
    write_parquet(inp, inj)
    held = {}

    def prepare(pipe):
        held["pipe"] = pipe

    os.environ["TEXTBLAST_HOST_TAILS"] = "off"
    try:
        hz0 = METRICS.get("worker_fold_hazard_rows_total")
        run = device_run(load_config(spec), inp, work, "badwords", device, prepare=prepare)
        run["fold_hazard_rows"] = int(METRICS.get("worker_fold_hazard_rows_total") - hz0)
    finally:
        del os.environ["TEXTBLAST_HOST_TAILS"]
    run.update(pipe=held["pipe"], input=inp, spec=spec, documents=inj)
    return run


def check_badwords_whole_corpus(run, oracle, device: str = "cuda"):
    """Path (a) held to the host oracle (parity 1.0); every default bucket
    dispatched; ``affine_scan`` (k = 1) launched exactly twice a batch and
    nothing else; ``worker_fold_hazard_rows_total`` equal to the device
    rows holding an ``en`` hazard code point; the funnel's drops equal to
    the excluded rows, all the filter's.  Returns the path's summary."""
    from textblaster_tpu_torch.ops.packing import DEFAULT_BUCKETS

    pipe = run["pipe"]
    host_kept, host_excl, host_received = oracle
    run["decision_parity"], equal = _parity(run, host_kept, host_excl)
    if run["decision_parity"] != 1.0 or not equal or run["received"] != host_received:
        fail(f"the badwords run and the host oracle differ (parity {run['decision_parity']})")
    check_report(run)
    missing = [b for b in DEFAULT_BUCKETS if run["batches_by_bucket"].get(str(b), 0) == 0]
    if missing:
        fail(f"the badwords run never dispatched buckets {missing}")
    n_batches = sum(run["batches_by_bucket"].values())
    others = {k: v for k, v in run["launches"].items() if k != "affine_scan" and v}
    if device == "cuda" and (run["launches"]["affine_scan"] != 2 * n_batches or others):
        fail(f"the badwords run launched {run['launches']} over {n_batches} batches "
             "(two affine_scan launches a batch, nothing else)")
    if any(k[0] != "affine_scan" or k[3] != 1 for k, _ in run["shape_launches"]):
        fail(f"the badwords run launched {run['shape_launches']} (k = 1 only)")
    tables = pipe._badwords_device_tables[0]
    hazard_chars = {chr(c) for c in tables["en"].hazard_cps}
    want_hazard = sum(1 for _, t in run["documents"] if _bmp(t) and hazard_chars & set(t))
    fold_rows = run["fold_hazard_rows"]
    if fold_rows != want_hazard or fold_rows == 0:
        fail(f"worker_fold_hazard_rows_total {fold_rows}, rows with an en hazard code point "
             f"{want_hazard}")
    funnel = run["report"]["funnel"]["per_filter_dropped"]
    if funnel != ({"C4BadWordsFilter": run["excluded"]} if run["excluded"] else {}):
        fail(f"the badwords run's funnel {funnel}, {run['excluded']} excluded rows")
    peak = badwords_batch_peak(pipe, run["documents"]) if device == "cuda" else None
    summary = {
        "documents": run["received"], "docs_per_s": run["device_docs_per_s"],
        "seconds": run["device_seconds"], "parity": run["decision_parity"],
        "kept": run["kept"], "excluded": run["excluded"],
        "tables": {lang: {"entries": int(sum(len(t) for t in tb.tables1)),
                          "distinct_lengths": len(tb.lengths), "max_dup": tb.max_dup,
                          "hazard_cps": [hex(c) for c in tb.hazard_cps]}
                   for lang, tb in sorted(tables.items())},
        "fold_hazard_rows": fold_rows, "host_routes": run["host_routes"],
        "device_busy_share": run["device_busy_share"], "batches": n_batches,
        "batches_by_bucket": run["batches_by_bucket"], "launches": run["launches"],
        "shape_launches": run["shape_launches"], "peak_batch": peak,
        "peak_device_mib": run["peak_device_mib"],
        "stage_seconds": {k: v for k, v in run["seconds"].items() if k != "device"},
        "device_seconds_by_phase": run["seconds"]["device"],
    }
    print(f"badwords (a): {run['received']} documents, {run['device_docs_per_s']:.2f} docs/s "
          f"({run['device_seconds']:.2f} s), parity {run['decision_parity']}, kept "
          f"{run['kept']} / excluded {run['excluded']}, tables "
          f"{json.dumps(summary['tables'])}, fold-hazard rows {fold_rows}, host routes "
          f"{json.dumps(run['host_routes'])}, device-busy share "
          f"{run['device_busy_share']:.4f}, {n_batches} batches "
          f"{json.dumps(run['batches_by_bucket'])}, launches {run['launches']}, peak device "
          f"memory of one batch {json.dumps(peak)}", flush=True)
    return summary


def badwords_in_main_pipeline(rows, work, device: str = "cuda"):
    """Path (b), its runs: the offline Danish pipeline with
    ``DANISH_BADWORDS_STEP`` appended (built in memory), over the first
    ``BADWORDS_SUBSET`` documents with about 5% given an entry of the
    vendored ``da`` list, windowed, chain schedule; then the offline
    pipeline alone over the same file.  Returns both runs, the first with
    its pipeline, input and config spec."""
    from textblaster_tpu_torch.filters.c4_badwords import load_local_badwords

    with open(CONFIG, encoding="utf-8") as f:
        spec = (f.read() + DANISH_BADWORDS_STEP, None)
    # Entries go before the text: C4's rewrite drops a last line without
    # terminal punctuation, so an entry appended after it never reaches
    # the step.
    inj = inject_badwords(rows[:BADWORDS_SUBSET], load_local_badwords("da"), SEED + 6, 0.0,
                          prefix=True)
    inp = os.path.join(work, "corpus_badwords_da.parquet")
    write_parquet(inp, inj)
    held = {}

    def prepare(pipe):
        held["pipe"] = pipe

    runs = {"badwords": device_run(load_config(spec), inp, work, "badwords_da", device,
                                   prepare=prepare),
            "plain": device_run(load_config(), inp, work, "badwords_da_plain", device)}
    runs["badwords"].update(pipe=held["pipe"], input=inp, spec=spec)
    return runs


def check_badwords_in_main_pipeline(runs, oracles, device: str = "cuda"):
    """Path (b) held to the host oracle under both configs (parity 1.0);
    the step on the device in phase 2; kept-by-fraction rows present;
    every kernel of the chain run launched, and ``affine_scan`` with
    k = 1 at 512, 2048 and 8192.  Returns the path's summary."""
    pipe = runs["badwords"]["pipe"]
    where = [i for i, ph in enumerate(pipe.phases) for j in ph
             if pipe.device_steps[j].type == "C4BadWordsFilter"]
    if where != [2] or pipe.host_steps or pipe.fully_host:
        fail(f"the Danish badwords step was placed in phases {where}, host steps "
             f"{[s.type for s in pipe.host_steps]}")
    for tag, run in runs.items():
        kept, excl, received = oracles[tag]
        run["decision_parity"], equal = _parity(run, kept, excl)
        if run["decision_parity"] != 1.0 or not equal or run["received"] != received:
            fail(f"the Danish {tag} run and the host oracle differ "
                 f"(parity {run['decision_parity']})")
        check_report(run)
        for k in ("chain_scan", "fused_scan", "affine_scan", "dfa_scan", "sort2"):
            if device == "cuda" and run["launches"][k] <= 0:
                fail(f"kernel {k} was never launched on the Danish {tag} run")
    statuses = _kept_statuses(runs["badwords"]["outputs"][0])
    if not statuses.get("passed_kept_by_fraction"):
        fail(f"the Danish badwords run kept no document by fraction: {statuses}")
    k1 = {(k[2]) for k, _ in runs["badwords"]["shape_launches"]
          if k[0] == "affine_scan" and k[3] == 1}
    if device == "cuda" and not {512, 2048, 8192} <= k1:
        fail(f"the Danish badwords run launched affine_scan with k = 1 at {sorted(k1)}")
    dropped = runs["badwords"]["report"]["funnel"]["per_filter_dropped"]
    summary = {
        "documents": runs["badwords"]["received"],
        "docs_per_s": runs["badwords"]["device_docs_per_s"],
        "plain_docs_per_s": runs["plain"]["device_docs_per_s"],
        "seconds": runs["badwords"]["device_seconds"],
        "plain_seconds": runs["plain"]["device_seconds"],
        "parity": runs["badwords"]["decision_parity"],
        "plain_parity": runs["plain"]["decision_parity"],
        "kept_statuses": statuses, "funnel": dropped,
        "phases": pipe.phases, "affine_k1_widths": sorted(k1),
        "launches": runs["badwords"]["launches"], "plain_launches": runs["plain"]["launches"],
        "host_routes": runs["badwords"]["host_routes"],
        "device_busy_share": runs["badwords"]["device_busy_share"],
        "device_seconds_by_phase": runs["badwords"]["seconds"]["device"],
        "plain_device_seconds_by_phase": runs["plain"]["seconds"]["device"],
    }
    print(f"badwords (b): {summary['documents']} documents of the offline Danish pipeline + "
          f"C4BadWordsFilter(da, keep 0.1): {summary['docs_per_s']:.2f} docs/s "
          f"({summary['seconds']:.2f} s) against {summary['plain_docs_per_s']:.2f} docs/s "
          f"({summary['plain_seconds']:.2f} s) without the step, parity {summary['parity']} / "
          f"{summary['plain_parity']}, phases {pipe.phases}, kept statuses "
          f"{json.dumps(statuses)}, funnel {json.dumps(dropped)}, affine_scan k = 1 at "
          f"{sorted(k1)}, device seconds by phase "
          f"{json.dumps(summary['device_seconds_by_phase'])} (without: "
          f"{json.dumps(summary['plain_device_seconds_by_phase'])}), launches "
          f"{summary['launches']} (without: {summary['plain_launches']})", flush=True)
    return summary


def badwords_phase(rows, work, geometry, device: str = "cuda"):
    """The C4BadWords slice: its kernel checks and timings (on ``cuda``),
    the runs of paths (a) and (b), one host-oracle pool for the three
    files' configs, then each path's checks.  Returns the phase's
    summary."""
    t0 = time.perf_counter()
    kernels = badwords_kernels(rows, geometry) if device == "cuda" else None
    whole = badwords_whole_corpus(rows, work, device)
    danish = badwords_in_main_pipeline(rows, work, device)
    t1 = time.perf_counter()
    oracles = host_oracles([("whole", whole["input"], whole["spec"]),
                            ("badwords", danish["badwords"]["input"], danish["badwords"]["spec"]),
                            ("plain", danish["badwords"]["input"], None)], work)
    host_s = time.perf_counter() - t1
    whole_summary = check_badwords_whole_corpus(whole, oracles.pop("whole"), device)
    danish_summary = check_badwords_in_main_pipeline(danish, oracles, device)
    seconds = time.perf_counter() - t0
    print(f"badwords phase: {seconds:.1f} s (host oracles {host_s:.1f} s)", flush=True)
    return {"kernels": kernels, "whole_corpus": whole_summary, "danish": danish_summary,
            "host_oracle_seconds": host_s, "seconds": seconds}


# --- the native host core ----------------------------------------------------

#: The exactness checks' documents: the first NATIVE_DOCS of the corpus and
#: every CJK and astral one.
NATIVE_DOCS = 2000
#: The token-counting run's documents: the first TOKEN_DOCS.
TOKEN_DOCS = 2000
SHIPPED_CONFIG = os.path.join(ROOT, "configs", "pipeline_config.yaml")
STANDIN_TOKENIZER = os.path.join(ROOT, "textblaster_tpu_torch", "data", "tokenizers", "gpt2",
                                 "tokenizer.json")


def native_build() -> dict:
    """Build (or load) the port's native host core before any host route
    needs it: the build seconds, the compiler's share and ``available()``;
    fails when the core is not available on this host."""
    from textblaster_tpu_torch import native

    t0 = time.perf_counter()
    path = native.build()
    seconds = time.perf_counter() - t0
    ok = native.available()
    print(f"native build: {seconds:.2f} s (g++ {native.last_build_seconds:.2f} s), "
          f"{os.path.relpath(path, ROOT)}, available {ok}", flush=True)
    if not ok:
        fail("the native host core is not available on this host")
    return {"seconds": seconds, "compile_seconds": native.last_build_seconds,
            "library": os.path.relpath(path, ROOT), "available": ok}


def _item_spans(text: str, sep):
    """Code point spans of ``sep.split(text)``'s pieces."""
    import numpy as np

    out, start = [], 0
    for m in sep.finditer(text):
        out.append((start, m.start()))
        start = m.end()
    out.append((start, len(text)))
    return np.array(out, dtype=np.int32).reshape(-1, 2)


def _native_text_checks(texts):
    """One worker task of the exactness checks: the core against the numpy
    paths on ``texts``.  Returns ``(checks, [(text head, what), ...])`` of
    the unequal ones."""
    import numpy as np

    from textblaster_tpu_torch import native
    from textblaster_tpu_torch.filters.gopher_repetition import _LINE_RE, _PARAGRAPH_RE
    from textblaster_tpu_torch.utils import text as T
    from textblaster_tpu_torch.utils.chartables import classify, codepoints

    checks, bad = 0, []
    for t in texts:
        cps = codepoints(t).astype(np.int32)
        spans = native.word_spans_native(cps, classify(cps.astype(np.uint32)))
        with native.disabled():
            want = T._word_spans_raw(t)
        words = [t[a:b] for a, b in want]
        pairs = [("spans", [tuple(x) for x in spans.tolist()], want)]
        pairs += [(f"top{n}", native.top_ngram_bytes(cps, spans, n),
                   T.find_top_duplicate(T.get_n_grams(words, n))) for n in TOP_NS]
        pairs += [(f"dup{n}", native.dup_ngram_bytes(cps, spans, n),
                   T.find_all_duplicate(words, n)) for n in DUP_NS]
        trimmed = t.strip()
        tcps = codepoints(trimmed).astype(np.int32)
        pairs += [(f"items {sep.pattern!r}", native.dup_items(tcps, _item_spans(trimmed, sep)),
                   T.find_duplicates(sep.split(trimmed))) for sep in (_LINE_RE, _PARAGRAPH_RE)]
        checks += len(pairs)
        bad += [(t[:40], what) for what, got, ref in pairs if got != ref]
    return checks, bad


def _native_pack_checks(corpus_path: str, width: int):
    """One worker task of the exactness checks: ``pack_utf8`` at ``width``,
    64 rows a call, over the Arrow buffers of the corpus Parquet (and, at
    the first default bucket, ``utf8_lengths``), against the numpy code
    points.  Returns ``(checks, documents, [(what, row), ...])``."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from textblaster_tpu_torch import native
    from textblaster_tpu_torch.ops.packing import DEFAULT_BUCKETS
    from textblaster_tpu_torch.utils.chartables import codepoints

    checks, docs, bad = 0, 0, []
    for chunk in pq.read_table(corpus_path, columns=["text"]).column("text").chunks:
        wide = pa.types.is_large_string(chunk.type)
        _, offs_buf, data_buf = chunk.buffers()
        offs = np.frombuffer(offs_buf, dtype=np.int64 if wide else np.int32)
        offs = offs[chunk.offset: chunk.offset + len(chunk) + 1].astype(np.int64)
        data = np.frombuffer(data_buf, dtype=np.uint8) if data_buf is not None \
            else np.zeros(1, dtype=np.uint8)
        refs = [codepoints(t).astype(np.int32) for t in chunk.to_pylist()]
        if width == DEFAULT_BUCKETS[0]:
            checks += 1
            if native.utf8_lengths(data, offs).tolist() != [len(r) for r in refs]:
                bad.append(("utf8_lengths", docs))
        for b0 in range(0, len(refs), 64):
            cps, lens = native.pack_utf8(data, offs[b0: b0 + 65], width, 64)
            part = refs[b0: b0 + 64]
            for i, ref in enumerate(part):
                n = len(ref)
                ok = (lens[i] == -n and not cps[i].any()) if n > width else (
                    lens[i] == n and np.array_equal(cps[i, :n], ref) and not cps[i, n:].any())
                checks += 1
                if not ok:
                    bad.append((f"pack_utf8 at {width}", docs + b0 + i))
            checks += 1
            if lens[len(part):].any() or cps[len(part):].any():
                bad.append((f"pack_utf8 padding at {width}", docs + b0))
        docs += len(refs)
    return checks, docs, bad


def native_exactness_tasks(rows, corpus_path: str, pool):
    """Submit the exactness checks to ``pool``: the core against the numpy
    paths over the first ``NATIVE_DOCS`` documents and every CJK and astral
    one (word spans, the n-gram scans at the offline config's ``TOP_NS`` /
    ``DUP_NS``, ``dup_items`` over GopherRepetition's lines and
    paragraphs), and ``utf8_lengths`` / ``pack_utf8`` at every default
    bucket over the corpus Parquet.  Returns what
    :func:`native_exactness_result` reads."""
    import re

    from textblaster_tpu_torch.ops.packing import DEFAULT_BUCKETS
    from textblaster_tpu_torch.utils.cjk import DICT_SCRIPT_RE

    astral = re.compile("[\U00010000-\U0010FFFF]")
    chosen = [t for i, (_, t) in enumerate(rows)
              if i < NATIVE_DOCS or DICT_SCRIPT_RE.search(t) or astral.search(t)]
    by_len = sorted(chosen, key=len, reverse=True)
    parts = [by_len[k::32] for k in range(32)]  # longest first, dealt round
    text_futs = [pool.submit(_native_text_checks, part) for part in parts if part]
    pack_futs = [pool.submit(_native_pack_checks, corpus_path, w) for w in DEFAULT_BUCKETS]
    return {"documents": len(chosen), "text": text_futs, "pack": pack_futs,
            "t0": time.perf_counter()}


def native_exactness_result(tasks) -> dict:
    """Collect :func:`native_exactness_tasks`; every result must be
    equal."""
    from textblaster_tpu_torch.ops.packing import DEFAULT_BUCKETS

    checks, bad, docs = 0, [], 0
    for fut in tasks["text"]:
        c, b = fut.result()
        checks, bad = checks + c, bad + b
    for fut in tasks["pack"]:
        c, docs, b = fut.result()
        checks, bad = checks + c, bad + b
    wall = time.perf_counter() - tasks["t0"]
    out = {"documents": tasks["documents"], "corpus_documents": docs, "checks": checks,
           "mismatches": len(bad), "pool_seconds": wall}
    print(f"native exactness: {checks} checks on this host's CPU ({tasks['documents']} "
          f"documents: word spans, top {list(TOP_NS)}, dup {list(DUP_NS)}, duplicate lines "
          f"and paragraphs; {docs} corpus documents: utf8_lengths, pack_utf8 at "
          f"{list(DEFAULT_BUCKETS)}), {len(bad)} unequal, {wall:.1f} s on the worker pool "
          "(with the token counter's host oracle)", flush=True)
    if bad:
        fail(f"the native core differs from the numpy paths: {bad[:5]}")
    return out


def native_main_path(config, sub_inp: str, work: str, oracle, sub_ids,
                     device: str = "cuda") -> dict:
    """The chain schedule, windowed, host tails on, over the first
    ``STAGED_SUBSET`` documents with the core on and with it off
    (``native.disabled()``), in that order: both at parity 1.0 against the
    host oracle, the kept and excluded files byte-identical, the core's
    calls above 0 with it on and 0 with it off."""
    import contextlib

    from textblaster_tpu_torch import native

    runs = {}
    for tag in ("native_on", "native_off"):
        native.reset_calls()
        with native.disabled() if tag == "native_off" else contextlib.nullcontext():
            run = device_run(config, sub_inp, work, tag, device)
        run["native_calls"] = dict(native.CALLS)
        run["decision_parity"], equal = _parity(run, *oracle, ids=sub_ids)
        if run["decision_parity"] != 1.0 or not equal:
            fail(f"{tag}: the run and the host oracle differ (parity {run['decision_parity']})")
        runs[tag] = run
    on, off = runs["native_on"], runs["native_off"]
    for a, b in zip(on["outputs"], off["outputs"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                fail(f"the core on and off wrote different bytes to {os.path.basename(a)}")
    if not on["native_calls"]["word_spans"] or any(off["native_calls"].values()):
        fail(f"native calls: on {on['native_calls']}, off {off['native_calls']}")
    out = {}
    for tag, run in runs.items():
        sec = run["seconds"]
        out[tag] = {"documents": run["received"], "docs_per_s": run["device_docs_per_s"],
                    "seconds": run["device_seconds"], "host_routes_s": sec["host_routes"],
                    "host_tails_s": sec["host_tails"], "host_routes": run["host_routes"],
                    "dup_walk_s": run["dup_walk"]["seconds"],
                    "device_busy_share": run["device_busy_share"],
                    "native_calls": run["native_calls"], "parity": run["decision_parity"]}
    out["docs_per_s_on_over_off"] = on["device_docs_per_s"] / off["device_docs_per_s"]
    out["host_routes_on_over_off"] = on["seconds"]["host_routes"] / max(off["seconds"]["host_routes"], 1e-9)
    print("native main path: " + "; ".join(
        f"{tag} {r['docs_per_s']:.2f} docs/s ({r['seconds']:.2f} s), host routes "
        f"{r['host_routes_s']:.3f} s (tails {r['host_tails_s']:.3f} s) "
        f"{json.dumps(r['host_routes'])}, dup walk {r['dup_walk_s']:.2f} s, native calls "
        f"{json.dumps(r['native_calls'])}" for tag, r in out.items() if tag in runs)
        + f"; on/off docs/s {out['docs_per_s_on_over_off']:.4f}, host routes "
        f"{out['host_routes_on_over_off']:.4f}; files byte-identical, parity 1.0", flush=True)
    return out


def write_standin_merges(path: str) -> int:
    """The vendored stand-in tokenizer's ``model.merges`` as a GPT-2
    ``merges.txt`` (``#version: 0.2``, one ``a b`` a line); returns the
    merges written."""
    with open(STANDIN_TOKENIZER, encoding="utf-8") as f:
        merges = json.load(f)["model"]["merges"]
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.writelines((m if isinstance(m, str) else " ".join(m)) + "\n" for m in merges)
    return len(merges)


def token_counter_input(rows, work: str):
    """The token-counting run's input (the first ``TOKEN_DOCS`` documents)
    and spec: ``configs/pipeline_config.yaml`` with TokenCounter on a
    ``merges.txt`` written from the stand-in's merges.  Returns ``(input,
    spec, merges)``."""
    merges_path = os.path.join(work, "merges.txt")
    n_merges = write_standin_merges(merges_path)
    with open(SHIPPED_CONFIG, encoding="utf-8") as f:
        text = f.read()
    if text.count("tokenizer_name: gpt2") != 1:
        fail("configs/pipeline_config.yaml no longer ends in TokenCounter(gpt2)")
    spec = (text.replace("tokenizer_name: gpt2", f"tokenizer_name: '{merges_path}'"), None)
    inp = os.path.join(work, "corpus_tokens.parquet")
    write_parquet(inp, rows[:TOKEN_DOCS])
    return inp, spec, n_merges


def token_counter_run(inp: str, spec, n_merges: int, oracle, work: str,
                      device: str = "cuda") -> dict:
    """The shipped config with TokenCounter on the native BPE core
    (:func:`token_counter_input`) on ``device``, held to the host oracle
    under the same spec row for row; every kept row carries
    ``token_count``, and the core counted once a kept row."""
    from textblaster_tpu_torch import native

    native.reset_calls()
    run = device_run(load_config(spec), inp, work, "tokens", device)
    bpe = native.CALLS["bpe_count"]
    host_kept, host_excl, host_received = oracle
    run["decision_parity"], equal = _parity(run, host_kept, host_excl)
    if run["decision_parity"] != 1.0 or not equal or run["received"] != host_received:
        fail(f"the token-counting run and the host oracle differ (parity {run['decision_parity']})")
    kept = read_set(run["outputs"][0])
    counts = [json.loads(m).get("token_count") for _, _, m in kept]
    if not kept or not all(c is not None and c.isdigit() for c in counts):
        fail("a kept row of the token-counting run has no token_count")
    if bpe != sum(1 for _, t, _ in kept if t):
        fail(f"the BPE core counted {bpe} texts for {len(kept)} kept rows")
    check_report(run)
    sec = run["seconds"]
    out = {"documents": run["received"], "docs_per_s": run["device_docs_per_s"],
           "seconds": run["device_seconds"], "kept": run["kept"], "excluded": run["excluded"],
           "merges": n_merges, "bpe_calls": bpe, "tokens": sum(int(c) for c in counts),
           "host_routes_s": sec["host_routes"], "host_routes": run["host_routes"],
           "parity": run["decision_parity"]}
    print(f"token counter: {run['received']} documents of configs/pipeline_config.yaml with "
          f"TokenCounter on a {n_merges}-merge merges.txt on {device}, "
          f"{out['docs_per_s']:.2f} docs/s ({out['seconds']:.2f} s), parity 1.0, kept "
          f"{run['kept']} (every one with token_count, {out['tokens']} tokens) / excluded "
          f"{run['excluded']}, BPE calls {bpe}, host routes {sec['host_routes']:.3f} s "
          f"{json.dumps(run['host_routes'])}", flush=True)
    return out


def native_phase(rows, work: str, oracle, build: dict, device: str = "cuda") -> dict:
    """The native host core: its build (:func:`native_build`, at the
    start of the script), the exactness checks and the token-counting
    run's host oracle on one worker pool (before any run, so that no run
    shares the CPU with them), the main path with the core on and off,
    and the shipped config's TokenCounter on a ``merges.txt``."""
    from textblaster_tpu_torch.config.pipeline import load_pipeline_config

    t0 = time.perf_counter()
    cpu = host_cpu()
    print(f"native: library {build['library']}, build {build['seconds']:.2f} s, available "
          f"{build['available']}, host CPU {cpu}", flush=True)
    tok_inp, tok_spec, n_merges = token_counter_input(rows, work)
    with host_pool() as pool:
        tasks = native_exactness_tasks(rows, os.path.join(work, "corpus.parquet"), pool)
        t1 = time.perf_counter()
        tok_oracle = host_oracles([("tokens", tok_inp, tok_spec)], work, pool)["tokens"]
        exact = native_exactness_result(tasks)
        pool_s = time.perf_counter() - t1
    sub_ids = {r[0] for r in rows[:STAGED_SUBSET]}
    main = native_main_path(load_pipeline_config(CONFIG),
                            os.path.join(work, "corpus_staged.parquet"), work, oracle, sub_ids,
                            device)
    tokens = token_counter_run(tok_inp, tok_spec, n_merges, tok_oracle, work, device)
    seconds = time.perf_counter() - t0
    print(f"native phase: {seconds:.1f} s (worker pool: exactness and the token counter's "
          f"host oracle {pool_s:.1f} s)", flush=True)
    return {"build": build, "host_cpu": cpu, "exactness": exact, "main_path": main,
            "token_counter": tokens, "pool_seconds": pool_s, "seconds": seconds}


def host_cpu() -> str:
    """This host's CPU, beside every host number: ``lscpu``'s model name,
    else ``/proc/cpuinfo``'s, with the vendor, family and model and the
    CPUs this process may use."""
    fields = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    for line in out.splitlines():
        key, _, val = line.partition(":")
        fields.setdefault("lscpu " + key.strip(), val.strip())
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            for line in f:
                key, _, val = line.partition(":")
                fields.setdefault("cpuinfo " + key.strip(), val.strip())
    except OSError:
        pass
    name = next((v for v in (fields.get("lscpu Model name"), fields.get("cpuinfo model name"))
                 if v and v.lower() not in ("unknown", "-")), "unknown")
    ident = "/".join(fields.get(k, "?") for k in ("cpuinfo vendor_id", "cpuinfo cpu family",
                                                    "cpuinfo model"))
    return f"{name} ({ident}, {len(os.sched_getaffinity(0))} CPUs)"


def _journal_commits(path):
    with open(path) as f:
        return [json.loads(line) for line in f if '"checkpoint_commit"' in line]


def checkpoint_phase(rows, work: str, cli_run, known_keys, device: str = "cuda"):
    """Checkpoint/resume over the CLI run's ``CLI_DOCS`` documents, chunks
    of ``CKPT_EVERY``: an uninterrupted ``cli.main`` run with
    ``--checkpoint-dir`` (and its journal); ``run_checkpointed`` stopped
    after 2 chunks and resumed; the same under ``auto_geometry=True``,
    whose resume without the flag must raise ``CheckpointError`` and whose
    resume with it must reuse the recorded geometry (no second
    calibration); a run with ``checkpoint.commit`` armed to raise
    ``OSError`` once, which must show exactly one checkpoint retry.  Every
    run's files equal the uninterrupted run's row for row (the calibrated
    ones by id, every column: another geometry orders the rows
    otherwise) and the non-checkpointed CLI run's by id, every column;
    each run's journal holds one ``checkpoint_commit`` a chunk it
    committed; no checkpoint directory is left.  The calibrated runs'
    (kernel, shape, variant) keys that no earlier run launched
    (``known_keys``) are held to the plain versions too."""
    import re

    import pyarrow.parquet as pq

    import textblaster_tpu_torch.checkpoint as ck
    from textblaster_tpu_torch.config.pipeline import load_pipeline_config
    from textblaster_tpu_torch.errors import CheckpointError
    from textblaster_tpu_torch.ops import scan, sort
    from textblaster_tpu_torch.ops.geometry import DeviceGeometry
    from textblaster_tpu_torch.resilience import FAULTS
    from textblaster_tpu_torch.utils.events import EVENTS
    from textblaster_tpu_torch.utils.metrics import METRICS

    d = os.path.join(work, "checkpoint")
    os.makedirs(d, exist_ok=True)
    inp = cli_run["input"]
    n_chunks = -(-CLI_DOCS // CKPT_EVERY)
    config = load_pipeline_config(CONFIG)
    calibrations = []
    real_calibrate = ck._calibrate

    def counted(*a, **k):
        calibrations.append(1)
        return real_calibrate(*a, **k)

    def paths(tag):
        return (os.path.join(d, f"{tag}_kept.parquet"), os.path.join(d, f"{tag}_excl.parquet"),
                os.path.join(d, f"{tag}_ckpt"), os.path.join(d, f"{tag}_events.jsonl"))

    def journaled(journal, fn):
        EVENTS.configure(journal, rank=0)
        try:
            return fn()
        finally:
            EVENTS.close()

    summary, t_phase = {}, time.perf_counter()
    # The uninterrupted run, through the CLI.
    kept, excl, ckpt, journal = paths("cli")
    t0 = time.perf_counter()
    rc, out, err = _cli_main(["run", "-i", inp, "-c", CONFIG, "-o", kept, "-e", excl,
                              "--device", device, "--checkpoint-dir", ckpt,
                              "--checkpoint-every", str(CKPT_EVERY), "--events-file", journal])
    if rc != 0:
        fail(f"the checkpointed CLI run exited {rc}: {err[-500:]!r}")
    m = re.match(SUMMARY_RE, out.splitlines()[0] if out else "")
    if not m or int(m.group(1)) != CLI_DOCS:
        fail(f"the checkpointed CLI run's summary line: {out[:300]!r}")
    summary["cli"] = {"seconds": time.perf_counter() - t0, "docs_per_s": float(m.group(2)),
                      "commits": len(_journal_commits(journal))}
    ref = {"rows": [pq.read_table(p).to_pylist() for p in (kept, excl)]}
    plain = [read_rows(p) for p in cli_run["outputs"]]
    runs = {"cli": (kept, excl, ckpt, [journal], n_chunks, True)}

    ck._calibrate = counted
    try:
        for tag, auto in (("resumed", False), ("resumed_auto", True)):
            kept, excl, ckpt, journal = paths(tag)
            kw = dict(ckpt_dir=ckpt, chunk_size=CKPT_EVERY, device=device, auto_geometry=auto)
            t0 = time.perf_counter()
            _zero_launches()
            try:
                journaled(journal + ".1", lambda: ck.run_checkpointed(
                    config, inp, kept, excl, stop_after_chunks=2, **kw))
                fail(f"the {tag} run did not stop after 2 chunks")
            except CheckpointError as e:
                if "fault injection" not in str(e):
                    raise
            state = ck.CheckpointState.load(ckpt)
            if state is None or state.rows_consumed != 2 * CKPT_EVERY \
                    or (state.geometry["source"] == "auto") != auto:
                fail(f"the {tag} cursor after 2 chunks: {state}")
            if auto:
                try:
                    ck.run_checkpointed(config, inp, kept, excl, ckpt_dir=ckpt,
                                        chunk_size=CKPT_EVERY, device=device)
                    fail("an auto-geometry checkpoint resumed without --auto-geometry")
                except CheckpointError as e:
                    if "pass --auto-geometry again" not in str(e):
                        raise
                before = len(calibrations)
            res = journaled(journal + ".2", lambda: ck.run_checkpointed(
                config, inp, kept, excl, **kw))
            if auto and len(calibrations) != before:
                fail("the auto-geometry resume calibrated again")
            summary[tag] = {"seconds": time.perf_counter() - t0, "received": res.received,
                            "geometry": state.geometry}
            if auto:
                keys = {tuple(k) for k in {**scan.SHAPE_LAUNCHES, **sort.SHAPE_LAUNCHES}}
                summary[tag]["new_shapes_checked"] = check_new_shapes(
                    rows, DeviceGeometry.from_dict(state.geometry), keys - known_keys, device)
            runs[tag] = (kept, excl, ckpt, [journal + ".1", journal + ".2"], n_chunks, not auto)
        if len(calibrations) != 1:
            fail(f"{len(calibrations)} calibrations over the checkpoint runs, expected 1")

        kept, excl, ckpt, journal = paths("commit_fault")
        FAULTS.inject("checkpoint.commit", OSError("injected commit fault"), times=1)
        retries0 = METRICS.get("resilience_retries_checkpoint_total")
        t0 = time.perf_counter()
        try:
            res = journaled(journal, lambda: ck.run_checkpointed(
                config, inp, kept, excl, ckpt_dir=ckpt, chunk_size=CKPT_EVERY, device=device))
        finally:
            fired = FAULTS.fired("checkpoint.commit")
            FAULTS.reset()
        retries = METRICS.get("resilience_retries_checkpoint_total") - retries0
        if retries != 1 or fired != 1:
            fail(f"checkpoint.commit armed once: {retries} retries, {fired} fires")
        summary["commit_fault"] = {"seconds": time.perf_counter() - t0, "retries": retries}
        runs["commit_fault"] = (kept, excl, ckpt, [journal], n_chunks, True)
    finally:
        ck._calibrate = real_calibrate

    for tag, (kept, excl, ckpt, journals, chunks, ordered) in runs.items():
        if os.path.exists(ckpt):
            fail(f"the {tag} run left its checkpoint directory")
        commits = sum(len(_journal_commits(j)) for j in journals)
        if commits != chunks:
            fail(f"the {tag} run's journal holds {commits} checkpoint commits for {chunks} chunks")
        for i, p in enumerate((kept, excl)):
            if ordered and pq.read_table(p).to_pylist() != ref["rows"][i]:
                fail(f"the {tag} run's {os.path.basename(p)} differs row for row from the "
                     "uninterrupted run's")
            if read_rows(p) != plain[i]:
                fail(f"the {tag} run's {os.path.basename(p)} differs from the "
                     "non-checkpointed run's")
        summary[tag]["commits"] = commits
    seconds = time.perf_counter() - t_phase
    print(f"checkpoint: {CLI_DOCS} documents, {CKPT_EVERY} a chunk; " + "; ".join(
        f"{tag} {json.dumps(v)}" for tag, v in summary.items())
          + f"; every run's rows equal the uninterrupted and the non-checkpointed runs', one "
          f"commit event a chunk, no directory left ({seconds:.1f} s)", flush=True)
    return {**summary, "seconds": seconds}


# --- fault phase --------------------------------------------------------------

#: The main path's kernels, each to be launched on every shard of a mesh run.
MESH_KERNELS = ("chain_scan", "fused_scan", "affine_scan", "dfa_scan", "sort2")
#: The mesh runs' documents: the first MESH_DOCS (2,000 until the gang
#: phase came), so that the gang phase fits the script's time.
MESH_DOCS = 1000
#: Rows of the stage-level batches (each bucket's corpus documents).
MESH_STAGE_ROWS = 16


def mesh_stage_checks(corpus, config, device: str = "cuda") -> dict:
    """For one packed batch of corpus documents per (bucket, phase) of the
    default ladder, the two-shard mesh ``[cuda:0, cuda:0]``'s stats dict
    against the single device's, ``torch.equal`` on every key (the
    documents are BMP-only, so the single device's u16 wire takes them)."""
    import torch

    from textblaster_tpu_torch.data_model import TextDocument
    from textblaster_tpu_torch.ops.packing import PACK_MARGIN, pack_documents
    from textblaster_tpu_torch.ops.pipeline import CompiledPipeline
    from textblaster_tpu_torch.parallel.mesh import data_mesh

    one = CompiledPipeline(config, device=device, batch_size=MESH_STAGE_ROWS)
    two = CompiledPipeline(config, batch_size=MESH_STAGE_ROWS, mesh=data_mesh([device] * 2))
    checked, lo = {}, 0
    for length in one.buckets:
        docs = [TextDocument(id=i, source="s", content=t) for i, t in corpus
                if max(lo, length // 4) < len(t) <= length - PACK_MARGIN
                and max(map(ord, t)) < 0x2E80][:MESH_STAGE_ROWS]
        lo = length
        batch = pack_documents(docs, MESH_STAGE_ROWS, length)
        for phase in range(len(one.phases)):
            want = one.run_batch(batch, phase)[0]
            got = two.run_batch(batch, phase)[0]
            if sorted(got) != sorted(want):
                fail(f"mesh stage b{length}/p{phase}: keys {sorted(got)} against {sorted(want)}")
            bad = [k for k in want
                   if not torch.equal(torch.from_numpy(got[k]), torch.from_numpy(want[k]))]
            if bad:
                fail(f"mesh stage b{length}/p{phase}: the two shards differ from one device "
                     f"at {bad}")
            checked[f"b{length}/p{phase}"] = len(want)
    return {"programs": checked, "shard_launches": two.counters["shard_launches"]}


def mesh_phase(rows, work: str, oracle, summary, device: str = "cuda") -> dict:
    """The data mesh: the main path (chain schedule) over the first
    ``MESH_DOCS`` documents on ``[cuda:0]``, ``[cuda:0, cuda:0]`` (two
    shards on two streams of the card) and the default mesh (every visible
    GPU), each at parity 1.0 against the host oracle, its kept and excluded
    rows those of the single-device windowed run with tails off over the
    subset (the mesh keeps every document on the device), restricted to
    its documents, and every main-path kernel launched on every shard; the
    stage level (:func:`mesh_stage_checks`); ``dryrun_multichip`` over
    every visible GPU and over two entries; the mesh runs' docs/s beside
    the single-device windowed and serial runs of the subset in this call.
    A CPU rehearsal (``device="cpu"``) takes three CPU entries for the
    default mesh."""
    import torch

    from textblaster_tpu_torch.config.pipeline import load_pipeline_config
    from textblaster_tpu_torch.graft_entry import dryrun_multichip
    from textblaster_tpu_torch.parallel.mesh import data_mesh

    t0 = time.perf_counter()
    config = load_pipeline_config(CONFIG)
    sub = rows[:MESH_DOCS]
    sub_inp = os.path.join(work, "corpus_mesh.parquet")
    write_parquet(sub_inp, sub)
    sub_ids = {r[0] for r in sub}
    host_kept, host_excl = oracle
    single = summary["chain_tails_off"]
    ref = [{r for r in read_set(p) if r[0] in sub_ids} for p in single["outputs"]]
    one = "cuda:0" if device == "cuda" else device
    meshes = (("mesh_1", data_mesh([one])), ("mesh_2", data_mesh([one, one])),
              ("mesh_default", data_mesh() if device == "cuda" else data_mesh([one] * 3)))
    out = {"documents": len(sub), "meshes": {}}
    for tag, mesh in meshes:
        run = device_run(config, sub_inp, work, tag, device, mesh=mesh)
        run["decision_parity"], equal = _parity(run, host_kept, host_excl, sub_ids)
        same = [read_set(p) for p in run["outputs"]] == ref
        shards = run["shard_launches"]
        print(f"mesh, {tag} ({[str(d) for d in mesh.devices]}): {run['received']} documents, "
              f"{run['device_docs_per_s']:.2f} docs/s ({run['device_seconds']:.2f} s), parity "
              f"{run['decision_parity']}, files equal to the single-device windowed run "
              f"{same}, batch sizes {run['geometry']['batch_sizes']} (buckets "
              f"{run['geometry']['buckets']}), host routes {json.dumps(run['host_routes'])}, "
              f"wire {run['wire']}, launches per shard "
              f"{[{k: s[k] for k in MESH_KERNELS} for s in shards]}", flush=True)
        if run["decision_parity"] != 1.0 or not equal or not same:
            fail(f"{tag}: parity {run['decision_parity']}, equal to the oracle {equal}, "
                 f"equal to the single-device run {same}")
        if run["overlapped"] or run["wire"] != "cp32" or run["host_routes"]["host_tail"]:
            fail(f"{tag}: a mesh run must be serial, on the int32 wire, with no host tails")
        check_report(run)
        if len(shards) != mesh.size:
            fail(f"{tag}: {len(shards)} shard launch tables for {mesh.size} entries")
        for i, s in enumerate(shards):
            for k in MESH_KERNELS:
                if s[k] <= 0 and device == "cuda":  # the CPU runs the plain versions
                    fail(f"{tag}: kernel {k} was never launched on shard {i}")
        for k in MESH_KERNELS:
            if run["launches"][k] != sum(s[k] for s in shards):
                fail(f"{tag}: {k}'s launches {run['launches'][k]} are not the shards' sum")
        for key in ("report", "outputs"):
            run.pop(key)
        out["meshes"][tag] = run
    t1 = time.perf_counter()
    out["stage"] = mesh_stage_checks(sub, config, device)
    print(f"mesh stage: {len(out['stage']['programs'])} (bucket, phase) programs, the two-shard "
          f"stats dict torch.equal to one device's on every key "
          f"({sum(out['stage']['programs'].values())} keys), launches per shard "
          f"{[{k: s[k] for k in MESH_KERNELS} for s in out['stage']['shard_launches']]} "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    for n in sorted({torch.cuda.device_count() if device == "cuda" else 3, 2}):
        dryrun_multichip(n, None if device == "cuda" else device)
    speeds = {tag: round(run["device_docs_per_s"], 2) for tag, run in out["meshes"].items()}
    for tag in ("chain_tails_off", "chain_serial"):
        speeds[tag] = round(summary[tag]["device_docs_per_s"], 2)
    out["docs_per_s"] = speeds
    out["seconds"] = time.perf_counter() - t0
    card = smi_line() if device == "cuda" else device
    print(f"mesh speed (docs/s, the meshes over the first {len(sub)} documents, the "
          f"single-device runs over the first {STAGED_SUBSET}, this call; "
          f"{card}): {json.dumps(speeds)}; mesh phase {out['seconds']:.1f} s", flush=True)
    return out


#: One rank of the gang: ``cli.main`` on the arguments after the JSON
#: path, with the kernels' launch counters set to 0 just before; the rank's
#: exit code, wall seconds, launches, exchanges posted and the device it
#: ran on go to the JSON file.
GANG_RANK = """
import json, sys, time
import torch
from textblaster_tpu_torch import cli
from textblaster_tpu_torch.ops import scan, sort
from textblaster_tpu_torch.utils.metrics import METRICS
out, argv = sys.argv[1], sys.argv[2:]
for d in (scan.LAUNCHES, sort.LAUNCHES):
    for k in d:
        d[k] = 0
t0 = time.perf_counter()
rc = cli.main(argv)
wall = time.perf_counter() - t0
with open(out, "w") as f:
    json.dump({"rc": rc, "wall_s": wall, "launches": {**scan.LAUNCHES, **sort.LAUNCHES},
               "exchanges": METRICS.get("multihost_exchange_posts_total"),
               "cuda": torch.cuda.is_initialized()}, f)
sys.exit(rc)
"""
GANG_PROCESSES = 2
GANG_TIMEOUT_S = 300


def _parquet_rows(path):
    import pyarrow.parquet as pq

    t = pq.read_table(path).to_pydict()
    return list(zip(t["id"], t["text"], t["metadata"]))


def gang_phase(rows, work: str, oracle, cli_run, device: str = "cuda") -> dict:
    """The multi-host gang on the card: two ranks as processes of the
    port's CLI (``--coordinator 127.0.0.1:<free port> --num-processes 2``,
    each through :data:`GANG_RANK`) over the CLI phase's documents, chain
    schedule, windowed, with ``--run-report``, ``--trace``,
    ``--events-file`` and ``--errors-file``; both on this card.  Both must
    exit 0 and leave no shard; the merged files must equal, row for row,
    the port's in-process windowed runs over each rank's stripe,
    concatenated in rank order, and the host oracle (parity 1.0); the
    merged report's counts the files' rows, with two hosts; both traces
    must hold the clock handshake; every rank must have launched every
    main-path kernel on the card.  Prints each rank's wall seconds and
    docs/s, the gang's wall beside the CLI phase's single-process run over
    the same documents, and the exchanges posted.  A CPU rehearsal
    (``device="cpu"``) passes ``--device cpu`` to the ranks."""
    import pyarrow.parquet as pq

    t_phase = time.perf_counter()
    config = load_config()
    inp = cli_run["input"]
    sub = rows[:CLI_DOCS]
    stride = -(-len(sub) // GANG_PROCESSES)
    refs = []
    for r in range(GANG_PROCESSES):
        part = os.path.join(work, f"corpus_gang{r}.parquet")
        write_parquet(part, sub[r * stride:(r + 1) * stride])
        run = device_run(config, part, work, f"gang_ref{r}", device)
        refs.append([_parquet_rows(p) for p in run["outputs"]])
    gang_dir = os.path.join(work, "gang")
    os.makedirs(gang_dir, exist_ok=True)
    for f in os.listdir(gang_dir):
        os.remove(os.path.join(gang_dir, f))
    kept, excl, errors = (os.path.join(gang_dir, f) for f in
                          ("kept.parquet", "excluded.parquet", "errors.parquet"))
    report, trace, events = (os.path.join(gang_dir, f) for f in
                             ("report.json", "trace.json", "events.jsonl"))
    port = _free_loopback_port()
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(GANG_PROCESSES):
            argv = ["run", "-i", inp, "-c", CONFIG, "-o", kept, "-e", excl,
                    "--errors-file", errors, "--run-report", report, "--trace", trace,
                    "--events-file", events, "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", str(GANG_PROCESSES), "--process-id", str(r)]
            if device != "cuda":
                argv += ["--device", device]
            logs.append(open(os.path.join(gang_dir, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", GANG_RANK, os.path.join(gang_dir, f"rank{r}.json"),
                 *argv], cwd=ROOT, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        codes = [p.wait(timeout=GANG_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    gang_wall = time.perf_counter() - t0
    outputs = []
    for r in range(GANG_PROCESSES):
        with open(os.path.join(gang_dir, f"rank{r}.log")) as f:
            outputs.append(f.read())
        for line in outputs[-1].splitlines():
            print(f"  gang rank {r} | {line}", flush=True)
    if codes != [0] * GANG_PROCESSES:
        fail(f"gang: the ranks exited {codes}")
    ranks = []
    for r in range(GANG_PROCESSES):
        with open(os.path.join(gang_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        m = re.search(r"^Processed (\d+) documents in \d+\.\d\ds \((\d+\.\d) docs/sec\)",
                      outputs[r], re.M)
        if not m:
            fail(f"gang: rank {r} printed no summary line")
        ranks[-1]["summary_docs_per_s"] = float(m.group(2))
    leftover = [f for f in os.listdir(gang_dir) if ".shard" in f]
    if leftover:
        fail(f"gang: shards left behind: {leftover}")
    got = [_parquet_rows(p) for p in (kept, excl)]
    want = [[row for ref in refs for row in ref[i]] for i in range(2)]
    if got != want:
        fail(f"gang: the merged files ({len(got[0])} kept, {len(got[1])} excluded rows) are "
             f"not the stripes' in-process runs in rank order ({len(want[0])}, {len(want[1])})")
    host_kept, host_excl = oracle
    ids = {r[0] for r in sub}
    want_kept = {r for r in host_kept if r[0] in ids}
    want_excl = {r for r in host_excl if r[0] in ids}
    agree = len(set(got[0]) & want_kept) + len(set(got[1]) & want_excl)
    parity = agree / max(len(want_kept) + len(want_excl), 1)
    if parity != 1.0 or set(got[0]) != want_kept or set(got[1]) != want_excl:
        fail(f"gang: parity {parity} against the host oracle")
    with open(report) as f:
        rep = json.load(f)
    n_errors = pq.ParquetFile(errors).metadata.num_rows
    if not (rep["num_hosts"] == GANG_PROCESSES and rep["counts"]["received"] == len(sub)
            and rep["counts"]["success"] == len(got[0])
            and rep["counts"]["filtered"] == len(got[1])
            and rep["counts"]["errors"] == n_errors
            and rep["config"]["num_processes"] == GANG_PROCESSES):
        fail(f"gang: report counts {rep['counts']}, {rep.get('num_hosts')} hosts, against "
             f"{len(got[0])} kept, {len(got[1])} excluded, {n_errors} errors")
    for path in [trace] + [f"{trace}.host{r}" for r in range(1, GANG_PROCESSES)]:
        with open(path) as f:
            if "trace_clock_offset" not in f.read():
                fail(f"gang: {path} holds no clock handshake")
    for r, rank in enumerate(ranks):
        if device == "cuda" and (not rank["cuda"]
                                 or any(rank["launches"][k] <= 0 for k in MESH_KERNELS)):
            fail(f"gang: rank {r} launched {rank['launches']} (cuda {rank['cuda']})")
    single_rate = float(re.match(SUMMARY_RE, cli_run["summary_line"]).group(2))
    out = {
        "documents": len(sub), "processes": GANG_PROCESSES, "gang_wall_s": gang_wall,
        "gang_docs_per_s": len(sub) / gang_wall,
        "single_process_docs_per_s": single_rate,
        "single_process_wall_s": cli_run["wall_seconds"],
        "ranks": [{"wall_s": rank["wall_s"], "docs": len(sub[r * stride:(r + 1) * stride]),
                   "docs_per_s": len(sub[r * stride:(r + 1) * stride]) / rank["wall_s"],
                   "summary_docs_per_s": rank["summary_docs_per_s"],
                   "exchanges": rank["exchanges"], "launches": rank["launches"]}
                  for r, rank in enumerate(ranks)],
        "kept": len(got[0]), "excluded": len(got[1]), "errors": n_errors,
        "decision_parity": parity,
    }
    out["seconds"] = time.perf_counter() - t_phase
    card = smi_line() if device == "cuda" else device
    print(f"gang ({card}): {GANG_PROCESSES} ranks over {len(sub)} documents in "
          f"{gang_wall:.2f} s ({out['gang_docs_per_s']:.2f} docs/s, process start "
          f"included) against the single-process CLI run's {single_rate} docs/s "
          f"({cli_run['wall_seconds']:.2f} s); ranks "
          + "; ".join(f"{r}: {x['wall_s']:.2f} s in cli.main, {x['docs_per_s']:.2f} docs/s, "
                      f"summary {x['summary_docs_per_s']} docs/s, {x['exchanges']:.0f} exchanges"
                      for r, x in enumerate(out["ranks"]))
          + f"; parity {parity}, files equal to the stripes' in-process runs; "
          f"launches by rank {[{k: x['launches'][k] for k in MESH_KERNELS} for x in out['ranks']]}"
          f"; phase {out['seconds']:.1f} s", flush=True)
    return out


FAULT_DOCS = 1000  # the retry, split and hang runs' documents
OUTAGE_DOCS = 500  # the outage and fatal runs' documents
HANG_DEADLINE_MIN_S = 0.5  # the hang run's least stage deadline
#: Documents longer than this are the real out-of-memory run's: every one
#: packs into the 65536 bucket, so only that bucket dispatches.
OOM_MIN_CHARS = 32768
#: The real out-of-memory runs take the first OOM_DOCS of them (three full
#: batches of 64 rows), so that the native phase fits the script's time.
OOM_DOCS = 192
#: The ladder and watchdog counters (the port's METRICS, JAX names).
LADDER = ("resilience_retries_device_total", "resilience_retry_exhausted_total",
          "resilience_ladder_split_total", "resilience_ladder_host_total",
          "resilience_breaker_trips_total", "watchdog_stalls_total",
          "watchdog_escalations_total")


def fault_config(depth=None):
    """The offline config with zero backoff and a breaker threshold of 2
    (``pipeline_depth`` set when given)."""
    from textblaster_tpu_torch.config.pipeline import load_pipeline_config

    config = load_pipeline_config(CONFIG)
    rc = config.resilience
    rc.backoff_base_s = rc.backoff_max_s = 0.0
    rc.breaker_threshold = 2
    if depth is not None:
        config.overlap.pipeline_depth = depth
    return config


def fault_run(config, inp, work, tag, arm=None, deadline=0.0, prepare=None, journal=False,
              **kw):
    """:func:`device_run` with ``device.execute`` armed by ``arm`` (the
    injector's keywords) and the watchdog at ``deadline`` for the run only;
    adds the ladder counters' deltas, the seam's fires and the slowest
    batch that completed: its ``run_batch`` seconds on the dispatch thread
    (what the ``device_fetch`` deadline bounds) and its CUDA-event
    seconds.  With ``journal``, the event journal and the trace are armed
    in memory for the run, and the journal's ``retry`` (device seam),
    ``ladder_split`` and ``watchdog_stall`` counts must equal the ladder
    counters', and the trace's instants the journal's."""
    from textblaster_tpu_torch.resilience import FAULTS, WATCHDOG
    from textblaster_tpu_torch.utils.events import EVENTS, validate_record
    from textblaster_tpu_torch.utils.metrics import METRICS
    from textblaster_tpu_torch.utils.trace import TRACER

    slowest = {"wall_s": 0.0, "device_s": 0.0}

    def timed(pipe):
        if prepare is not None:
            prepare(pipe)
        real = pipe.run_batch

        def run_batch(batch, phase=0, stream=None):
            out = real(batch, phase, stream)
            slowest["wall_s"] = max(slowest["wall_s"], out[1])
            slowest["device_s"] = max(slowest["device_s"], out[2])
            return out

        pipe.run_batch = run_batch

    before = {k: METRICS.get(k) for k in LADDER}
    FAULTS.reset()
    if arm is not None:
        FAULTS.inject("device.execute", **arm)
    WATCHDOG.configure(deadline)
    if journal:
        EVENTS.configure(None, ring=1 << 16)
        TRACER.configure(None, ring=1 << 20)
    try:
        run = device_run(config, inp, work, tag, "cuda", prepare=timed, **kw)
        run["fired"] = FAULTS.fired("device.execute")
    finally:
        FAULTS.reset()
        WATCHDOG.reset()
        records, instants = EVENTS.drain(), [e["name"] for e in TRACER.drain() if e["ph"] == "i"]
        EVENTS.close()
        TRACER.close()
    run["ladder"] = {k: METRICS.get(k) - before[k] for k in LADDER}
    run["slowest_batch"] = slowest
    if journal:
        for r in records:
            validate_record(r)
        kinds = {"retry": sum(r["kind"] == "retry" and r["data"]["seam"] == "device"
                              for r in records),
                 "ladder_split": sum(r["kind"] == "ladder_split" for r in records),
                 "watchdog_stall": sum(r["kind"] == "watchdog_stall" for r in records)}
        want = {"retry": run["ladder"]["resilience_retries_device_total"],
                "ladder_split": run["ladder"]["resilience_ladder_split_total"],
                "watchdog_stall": run["ladder"]["watchdog_stalls_total"]}
        seen = {k: instants.count(k) for k in kinds}
        if kinds != want or seen != kinds:
            fail(f"fault run {tag}: journal {kinds}, trace instants {seen}, ladder {want}")
        run["journal"] = kinds
    return run


def read_rows(path):
    """id -> the whole row (every column) of a kept or excluded file."""
    import pyarrow.parquet as pq

    return {r["id"]: r for r in pq.read_table(path).to_pylist()}


def _launched(run):
    """{(kernel, rows, width): launches} of a run, summed over variants."""
    out = {}
    for key, n in run["shape_launches"]:
        k = (key[0], key[1], key[2])
        out[k] = out.get(k, 0) + n
    return out


def fault_phase(rows, work, checked):
    """The degradation ladder, the breaker and the watchdog on the card:
    six fault runs, each held to a fault-free run of the same documents
    (kept and excluded rows equal by id, every column).  Every shape that
    a split rung launched, and that the fault-free run did not, must be
    among the shapes the kernel phase held to the plain versions
    (``checked``); ``sort2`` shapes that are not are checked here."""
    import gc
    import threading

    import numpy as np
    import pyarrow.parquet as pq
    import torch

    from textblaster_tpu_torch.resilience import DEADLETTER_SCHEMA, FAULTS

    os.makedirs(work, exist_ok=True)
    inputs = {}
    for name, part in (("fault", rows[:FAULT_DOCS]), ("outage", rows[:OUTAGE_DOCS]),
                       ("oom", [r for r in rows if len(r[1]) > OOM_MIN_CHARS][:OOM_DOCS])):
        inputs[name] = os.path.join(work, f"corpus_{name}.parquet")
        write_parquet(inputs[name], part)
    config = fault_config()
    summary, lines = {}, []

    def same_rows(run, ref):
        for i in (0, 1):
            if read_rows(run["outputs"][i]) != read_rows(ref["outputs"][i]):
                fail(f"fault run {run['schedule']} and its fault-free run "
                     f"{ref['schedule']} differ in {os.path.basename(run['outputs'][i])}")

    def split_launches(run, ref):
        new = {k: v for k, v in _launched(run).items() if k not in _launched(ref)}
        srng = np.random.default_rng(SEED + 5)
        for kernel, r, w in new:
            if (r, w) in checked[kernel]:
                continue
            if kernel != "sort2":
                fail(f"{kernel} launched at [{r}, {w}] by a split rung, a shape the kernel "
                     "phase did not hold to its plain version")
            check_sort2(srng, r, w, torch.device("cuda"))
            checked["sort2"].add((r, w))
        return {f"{k}[{r},{w}]": v for (k, r, w), v in sorted(new.items())}

    def report(tag, run, ref, **extra):
        run["docs_per_s_fault_free"] = ref["device_docs_per_s"]
        summary[tag] = {**{k: run[k] for k in ("received", "device_seconds",
                                               "device_docs_per_s", "ladder", "fired",
                                               "batches_by_bucket", "host_routes",
                                               "slowest_batch")},
                        "journal": run.get("journal"),
                        "fault_free_docs_per_s": ref["device_docs_per_s"],
                        "fault_free_slowest_batch": ref["slowest_batch"], **extra}
        line = (f"fault run {tag}: {run['received']} documents, {run['device_docs_per_s']:.2f} "
                f"docs/s (fault-free {ref['device_docs_per_s']:.2f}), fires "
                f"{run['fired']}, ladder {json.dumps(run['ladder'])}, slowest batch "
                f"{json.dumps(run['slowest_batch'])} (fault-free "
                f"{json.dumps(ref['slowest_batch'])})")
        if run.get("journal") is not None:
            line += f", journal {json.dumps(run['journal'])} = ladder"
        if extra:
            line += ", " + json.dumps(extra)
        print(line, flush=True)
        lines.append(line)

    # Fault-free runs of the fault runs' documents; the first writes
    # --errors-file, which must be a well-formed empty dead-letter file.
    errs = os.path.join(work, "fault_clean_errors.parquet")
    clean = fault_run(config, inputs["fault"], work, "fault_clean", errors_file=errs)
    t = pq.read_table(errs)
    if t.num_rows != 0 or t.schema.names != list(DEADLETTER_SCHEMA.names):
        fail(f"--errors-file of a fault-free run holds {t.num_rows} rows, columns "
             f"{t.schema.names}")
    if any(clean["ladder"].values()):
        fail(f"a fault-free run moved the ladder: {clean['ladder']}")
    # The retry and split faults land on the run's last dispatch, so that
    # the ladder's own attempts take the next fires (an earlier batch's
    # fire would go to the batches dispatched behind it in the window).
    last = sum(clean["batches_by_bucket"].values()) - 1

    retry = fault_run(config, inputs["fault"], work, "fault_retry",
                      arm=dict(exc=OSError("injected device fault"), times=2, after_calls=last),
                      journal=True)
    same_rows(retry, clean)
    lad = retry["ladder"]
    if (lad["resilience_retries_device_total"], lad["resilience_ladder_split_total"],
            lad["resilience_ladder_host_total"]) != (1, 0, 0):
        fail(f"retry run: ladder {lad}")
    report("retry", retry, clean)

    split = fault_run(config, inputs["fault"], work, "fault_split",
                      arm=dict(exc=OSError("injected device fault"), times=5, after_calls=last),
                      journal=True)
    same_rows(split, clean)
    lad = split["ladder"]
    if (lad["resilience_ladder_split_total"], lad["resilience_retry_exhausted_total"],
            lad["resilience_ladder_host_total"]) != (1, 1, 0):
        fail(f"split run: ladder {lad}")
    new = split_launches(split, clean)
    if not new:
        fail("the split run launched nothing at the split rows")
    report("split", split, clean, split_row_launches=new)

    clean_small = fault_run(config, inputs["outage"], work, "fault_clean_outage")
    outage = fault_run(config, inputs["outage"], work, "fault_outage",
                       arm=dict(exc=OSError("injected device outage"), times=10**6))
    same_rows(outage, clean_small)
    lad = outage["ladder"]
    # Every document the device would have taken went to the host rung:
    # no batch ran on the card.
    if (outage["device_rows"] != 0 or lad["resilience_ladder_host_total"] <= 0
            or lad["resilience_breaker_trips_total"] != 1 or outage["fired"] >= 1000):
        fail(f"outage run: ladder {lad}, fires {outage['fired']}, device rows "
             f"{outage['device_rows']}")
    report("outage", outage, clean_small,
           device_rows_fault_free=clean_small["device_rows"])

    # The hang run's deadline is twice the fault-free run's slowest batch
    # on the dispatch thread, so that the two injected hangs are its only
    # stalls: each is counted once, its batch redispatched, and nothing
    # falls to the host rung.
    hang_deadline = max(HANG_DEADLINE_MIN_S, 2 * clean["slowest_batch"]["wall_s"])
    hang = fault_run(fault_config(depth=3), inputs["fault"], work, "fault_hang",
                     arm=dict(kind="hang", times=2, after_calls=1), deadline=hang_deadline,
                     journal=True)
    same_rows(hang, clean)
    lad = hang["ladder"]
    if (lad["watchdog_stalls_total"] != 2 or lad["resilience_ladder_host_total"]
            or hang["fired"] != 2):
        fail(f"hang run at deadline {hang_deadline} s: ladder {lad}, fires {hang['fired']}")
    report("hang", hang, clean, depth=3, deadline_s=hang_deadline)

    # Real out-of-memory: a pilot measures each phase's peak device memory
    # per batch at the full rows and at the split rows; the run then caps
    # the allocator before each batch (its cache emptied) a quarter of the
    # way down from the full batch's peak to the half's, so every full
    # batch runs out of memory and every half fits with room for the
    # allocator's fragmentation.
    peaks = {}

    def record_peaks(pipe):
        real = pipe.run_batch

        def run_batch(batch, phase=0, stream=None):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = real(batch, phase, stream)
            key = (phase, batch.batch_size)
            peaks[key] = max(peaks.get(key, 0), torch.cuda.max_memory_allocated())
            return out

        pipe.run_batch = run_batch

    def settle():
        # The same device memory outside the batches in the three runs:
        # earlier pipelines collected, the allocator's cache emptied.
        gc.collect()
        torch.cuda.empty_cache()

    settle()
    clean_big = fault_run(config, inputs["oom"], work, "fault_clean_oom", prepare=record_peaks)
    full = clean_big["batches_by_bucket"]
    if set(full) != {"65536"}:
        fail(f"the out-of-memory run's documents dispatched {full}")
    full_rows = max(r for _, r in peaks)
    half_rows = -(-((full_rows + 1) // 2) // 8) * 8
    settle()
    fault_run(config, inputs["oom"], work, "fault_pilot_half", batch_size=half_rows,
              prepare=record_peaks)
    total = torch.cuda.get_device_properties(0).total_memory
    caps = {}
    for phase in sorted({p for p, r in peaks if r == full_rows}):
        lo, hi = peaks.get((phase, half_rows)), peaks[(phase, full_rows)]
        if lo is None or lo >= hi:
            fail(f"phase {phase}: peak {lo} bytes at {half_rows} rows, {hi} at {full_rows}")
        caps[phase] = (hi - (hi - lo) / 4) / total
    print(f"out-of-memory pilot: peak bytes by (phase, rows) "
          f"{ {f'{p}/{r}': v for (p, r), v in sorted(peaks.items())} }, caps "
          f"{ {p: round(c * total) for p, c in caps.items()} }", flush=True)

    def capped(pipe):
        real = pipe.run_batch

        def run_batch(batch, phase=0, stream=None):
            torch.cuda.empty_cache()
            torch.cuda.set_per_process_memory_fraction(caps.get(phase, 1.0))
            return real(batch, phase, stream)

        pipe.run_batch = run_batch

    settle()
    try:
        oom = fault_run(config, inputs["oom"], work, "fault_oom", prepare=capped)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    same_rows(oom, clean_big)
    n_full = sum(full.values())
    lad = oom["ladder"]
    if lad["resilience_ladder_split_total"] < n_full or lad["resilience_ladder_host_total"]:
        fail(f"out-of-memory run: ladder {lad} over {n_full} full batches")
    report("oom", oom, clean_big, full_batches=n_full,
           seconds_per_split=(oom["device_seconds"] - clean_big["device_seconds"])
           / max(1, lad["resilience_ladder_split_total"]),
           peak_bytes={f"{p}/{r}": v for (p, r), v in sorted(peaks.items())},
           caps_bytes={str(p): c * total for p, c in caps.items()},
           split_row_launches=split_launches(oom, clean_big))

    # A fatal error propagates, and no dispatch thread outlives the run.
    FAULTS.inject("device.execute", ValueError("injected fatal device fault"), times=10)
    t0 = time.perf_counter()
    try:
        device_run(config, inputs["outage"], work, "fault_fatal", "cuda")
    except ValueError as e:
        if "injected fatal device fault" not in str(e):
            raise
    else:
        fail("the fatal run did not raise")
    finally:
        fired = FAULTS.fired("device.execute")
        FAULTS.reset()
    alive = [t.name for t in threading.enumerate() if t.name.startswith("textblast-dispatch")]
    if alive or fired < 1:
        fail(f"fatal run: dispatch threads {alive}, fires {fired}")
    line = (f"fault run fatal: ValueError propagated after {time.perf_counter() - t0:.2f} s, "
            f"fires {fired}, no dispatch thread left")
    print(line, flush=True)
    summary["fatal"] = {"fired": fired, "seconds": time.perf_counter() - t0}
    summary["fault_free"] = {k: {"received": r["received"],
                                 "docs_per_s": r["device_docs_per_s"],
                                 "ladder": r["ladder"]}
                             for k, r in (("fault", clean), ("outage", clean_small),
                                          ("oom", clean_big))}
    return summary


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed", 2)
    if not torch.cuda.is_available():
        fail("CUDA is not available", 2)
    if not os.path.isdir(os.path.join(ROOT, "textblaster_tpu_torch")) or not os.path.exists(CONFIG):
        fail("the textblaster_tpu_torch package is not beside this script", 2)
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()

    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    from textblaster_tpu_torch.kernels import build as kb

    t0 = time.perf_counter()
    kb.build()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {kb.last_build_seconds:.2f} s)", flush=True)
    for lib, report in kb.ptxas_report.items():
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        print(f"  ptxas {lib}: " + " | ".join(regs), flush=True)
    kb.load("scan")
    names = {code: kb.error_name(code) for code in kb.CUDA_ERRORS}
    print(f"CUDA error names (the wrappers' messages): {names}", flush=True)
    if any(names[c][0] != kb.CUDA_ERRORS[c][0] for c in names):
        fail(f"the runtime names CUDA errors {names}, the wrappers' table {kb.CUDA_ERRORS}")
    native_info = native_build()

    t0 = time.perf_counter()
    rows = make_corpus(N_DOCS, SEED)
    print(f"corpus: {len(rows)} documents, {sum(len(r[1]) for r in rows)} chars, "
          f"{time.perf_counter() - t0:.1f} s to make", flush=True)

    errs, rep, per_shape, timers, checked = kernel_phase(rows)
    walk = time_dup_walk()
    print(f"dup walk (torch loop): {walk}", flush=True)

    work = os.path.join(ROOT, "build", "chip_smoke")
    summary, oracle = main_path("cuda", rows, work)
    losses = launch_losses(summary["chain"], per_shape, timers)
    profiled = profile_phase(summary, rows)
    cli_run = cli_phase(rows, work)
    cli_run["registry_op_us"] = registry_op_seconds() * 1e6
    print(f"metrics: one registry increment takes {cli_run['registry_op_us']:.3f} us "
          "on this host", flush=True)
    t0 = time.perf_counter()
    default_keys = set().union(*(_variant_keys(run) for run in summary.values()
                                 if isinstance(run, dict) and "shape_launches" in run))
    geometry, known_keys = auto_geometry_phase(rows, work, oracle, default_keys)
    print(f"auto-geometry phase: {time.perf_counter() - t0:.1f} s", flush=True)
    badwords = badwords_phase(rows, work, geometry)
    native = native_phase(rows, work, oracle, native_info)
    checkpoint = checkpoint_phase(rows, work, cli_run, known_keys)
    mesh = mesh_phase(rows, work, oracle, summary)
    gang = gang_phase(rows, work, oracle, cli_run)
    t0 = time.perf_counter()
    faults = fault_phase(rows, work, checked)
    print(f"fault phase: {time.perf_counter() - t0:.1f} s", flush=True)

    sources = {"affine_scan": "textblaster_tpu_torch/csrc/scan.cu",
               "dfa_scan": "textblaster_tpu_torch/csrc/scan.cu",
               "sort2": "textblaster_tpu_torch/csrc/sort.cu",
               "sort3": "textblaster_tpu_torch/csrc/sort.cu",
               "fused_scan": "textblaster_tpu_torch/csrc/fused.cu",
               "chain_scan": "textblaster_tpu_torch/csrc/chain.cu"}
    replaces = {"affine_scan": "textblaster_tpu/ops/pallas_scan.py:244",
                "dfa_scan": "textblaster_tpu/ops/pallas_scan.py:244",
                "sort2": "textblaster_tpu/ops/pallas_sort.py:160",
                "sort3": "textblaster_tpu/ops/pallas_sort.py:181",
                "fused_scan": "textblaster_tpu/ops/pallas_scan.py:435",
                "chain_scan": "textblaster_tpu/ops/pallas_scan.py:930"}
    kernels = []
    for k in ("affine_scan", "dfa_scan", "sort2", "sort3", "fused_scan", "chain_scan"):
        r = rep[k]
        kernels.append({
            "name": k, "route": "cuda", "source": sources[k], "replaces": replaces[k],
            "launches": summary["chain"]["launches"][k], "max_abs_err": errs[k],
            # Each path's own run: the chain main path, badwords path (a)
            # over its first 10,000 documents and path (b) in the Danish pipeline.
            "launches_by_path": {"chain": summary["chain"]["launches"][k],
                                 "badwords": badwords["whole_corpus"]["launches"][k],
                                 "danish_badwords": badwords["danish"]["launches"][k]},
            # The two-shard mesh run over the subset, shard by shard.
            "launches_by_shard": [s[k] for s in mesh["meshes"]["mesh_2"]["shard_launches"]],
            # The two-rank gang over the CLI phase's documents, rank by rank.
            "launches_by_rank": [r["launches"][k] for r in gang["ranks"]],
            "ms": r["ms"], "kernel_ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": r["shape"],
        })
    out_dir = os.environ.get("CHIP_SMOKE_OUT") or work
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "kernels": kernels,
                   "per_shape": per_shape, "launch_losses": losses, "dup_walk": walk,
                   "main_path": summary, "profile": profiled, "cli": cli_run,
                   "auto_geometry": geometry, "badwords": badwords, "native": native,
                   "checkpoint": checkpoint, "mesh": mesh, "gang": gang,
                   "fault_phase": faults,
                   "total_seconds": time.perf_counter() - t_start}, f, indent=1)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
