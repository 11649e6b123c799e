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
   flight, writer threads) and serial (``TEXTBLAST_NO_OVERLAP=1``), twice
   each in turns (windowed, serial, serial, windowed); over its first 5,000
   documents, windowed, under the fused schedule
   (``TEXTBLAST_DEPFUSE=off``), the staged one (``TEXTBLAST_FUSED=off``)
   and the chain schedule with ``TEXTBLAST_HOST_TAILS=off``;
   then once through the port's host oracle (sharded over the CPU cores,
   one process per shard).  Each run's kept and excluded sets must equal
   the oracle's id for id (text and metadata), parity exactly 1.0; each
   windowed chain run must write the same kept and excluded ids, and the
   same bytes, as each serial one; the chain run must dispatch every
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
5. Launches per shape: the first chain run's launches of every kernel by
   shape and variant, each beside the kernel's time at that shape
   (``sort2`` and the per-scan kernels are timed at every shape and
   variant the run launched them at), and per kernel the sum of
   launches x (kernel ms - bound ms), the device time the kernel loses on
   the main path against its bound.
6. The CLI: ``textblaster_tpu_torch.cli.main`` on ``cuda`` over the first
   2,000 documents with ``--run-report`` and ``--metrics-port`` on a free
   loopback port; one ``GET /metrics`` while the endpoint is up must pass
   the exposition rules (``utils/promlint.py``), the summary line must be
   the JAX package's, with the report's counts and the files' rows; a run
   over a missing input must exit 1 with ``Pipeline run failed:``.  Then
   the host seconds of one registry increment (the unit cost of a metric
   hook), over 200,000 of them.
7. Fault phase: the degradation ladder, the breaker and the watchdog,
   each run with zero backoff and a breaker threshold of 2 and held to a
   fault-free run of the same documents (kept and excluded rows equal by
   id, every column): over the first 2,000 documents a fault-free run
   writing ``--errors-file`` (a well-formed empty file), a retry run
   (``device.execute`` raises ``OSError`` twice at the run's last dispatch:
   one retry) and a split run (five times: the batch exhausts its retries
   and splits; every shape the halves launched that the fault-free run did
   not must have been held to its plain version); over the first 500 an
   outage (every dispatch fails: every document on the host rung, the
   breaker trips once); over the first 2,000 at depth 3 an injected hang
   twice under a 0.5 s stage deadline; over the documents longer than
   32,768 characters (only the 65536 bucket) a real out-of-memory run, the
   allocator capped before each batch between the half batch's and the
   full batch's peak of its phase (measured in two pilot runs), where
   every full batch must split and no document reach the host rung; and
   a fatal ``ValueError`` that must propagate with no dispatch thread
   left.  Each run prints docs/s beside its fault-free run's, the ladder
   and watchdog counters and the launches at the split rows.
8. Output: a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
   the last line ``{"ok": true, "device": {...}}``.

Long output (per-shape kernel timings, the main path's counters) is also
written to ``chip_smoke.json`` in ``$CHIP_SMOKE_OUT``
(default ``build/chip_smoke/``, where the scratch files go too).  The
script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "pipeline_config_offline.yaml")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM float32 outside the tensor cores (NVIDIA data sheet); the sheet
# gives no int32 rate, so the kernels' integer operations are held to it.
OPS_PER_S = 67e12
N_DOCS = int(os.environ.get("CHIP_SMOKE_DOCS", "20000"))
STAGED_SUBSET = 5000  # the documents of the runs over a subset
#: Windowed runs over the first STAGED_SUBSET documents: the fused and the
#: staged schedules, and the chain schedule with the host tails off.
SUBSET_RUNS = (("fused", {"TEXTBLAST_DEPFUSE": "off"}), ("staged", {"TEXTBLAST_FUSED": "off"}),
               ("chain_tails_off", {"TEXTBLAST_HOST_TAILS": "off"}))
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


def _host_shard(args):
    """One worker of the host oracle: every ``n``-th row from ``k``, through
    the port's host executor, into its own kept/excluded Parquet pair."""
    inp, k, n, work = args
    from textblaster_tpu_torch.config.pipeline import load_pipeline_config
    from textblaster_tpu_torch.orchestration import (
        aggregate_results_from_stream,
        process_documents_host,
    )
    from textblaster_tpu_torch.pipeline_builder import build_pipeline_from_config
    from textblaster_tpu_torch.io.parquet_reader import ParquetInputConfig, ParquetReader

    docs = ParquetReader(ParquetInputConfig(inp, "text", "id")).read_documents()
    mine = (d for j, d in enumerate(docs) if j % n == k)
    executor = build_pipeline_from_config(load_pipeline_config(CONFIG))
    out = (os.path.join(work, f"host_kept.{k}.parquet"), os.path.join(work, f"host_excl.{k}.parquet"))
    res = aggregate_results_from_stream(process_documents_host(executor, mine), *out)
    return out, res.received


def host_oracle(inp: str, work: str):
    """The port's host oracle over the whole file, sharded over the CPU cores
    (documents are independent; the outputs are compared as sets).  Every
    worker process is joined before this returns."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    n = max(1, min(8, os.cpu_count() or 1))
    kept, excl, received = set(), set(), 0
    with ProcessPoolExecutor(n, mp_context=mp.get_context("spawn")) as pool:
        for (k_path, e_path), got in pool.map(_host_shard, [(inp, k, n, work) for k in range(n)]):
            kept |= read_set(k_path)
            excl |= read_set(e_path)
            received += got
    return kept, excl, received


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


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the integer operations over the CUDA-core rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def scan_cost(kind, rows, width, variant):
    """(bytes, operations) of one per-scan kernel call: ``affine_scan``
    with ``variant`` = k accumulators reads m and k streams and writes k,
    one multiply for m and a multiply-add per accumulator per element;
    ``dfa_scan`` with ``variant`` = n_states reads and writes one stream,
    per element and state a nibble extract (shift, mask) and a
    lookup-insert (shift, mask, or)."""
    n = rows * width
    if kind == "affine_scan":
        return 4.0 * n * (1 + 2 * variant), 1.0 * n * (1 + 2 * variant)
    return 8.0 * n, 5.0 * n * variant


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


def fused_cost(groups):
    """(bytes, operations) the fused scan must spend on ``groups``: each
    input read once, each scanned output written once, each final carry
    written once; per element an affine group does 1 + 2k operations, an
    add stream 1, and a DFA group 5 per state."""
    b, n = groups[0]["xs"][0].shape
    n_bytes = ops = 0.0
    for g in groups:
        n_in = len(g["xs"])
        n_out = n_in - 1 if g["kind"] == "affine" else n_in
        last = g.get("emit") == "last"
        n_bytes += 4.0 * b * n * (n_in + (0 if last else n_out)) + (4.0 * b * n_out if last else 0)
        if g["kind"] == "affine":
            ops += b * n * (1 + 2 * (n_in - 1))
        elif g["kind"] == "add":
            ops += b * n * n_in
        else:
            ops += b * n * 5 * g["n_states"]
    return n_bytes, ops


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


def chain_cost(passes):
    """(bytes, operations) a chain launch must spend: each external operand
    read once, each emit-"scan" stream written once, each final carry
    written once (taps and workspace streams stay on chip in the bound);
    per element a prep does about one operation per dependency, and the
    scans as in :func:`fused_cost` (a segmented max 3, a copy none)."""
    from textblaster_tpu_torch.ops import scan

    _, ext, out_modes, _, _ = scan._chain_plan(passes)
    b, n = ext[0].shape
    n_bytes = 4.0 * b * n * (len(ext) + out_modes.count("scan")) + 4.0 * b * out_modes.count("last")
    ops = 0.0
    for p in passes:
        for g in p["groups"]:
            n_ops = g.get("n_ops", len(g["xs"]))
            per = len(g["xs"]) if "prep" in g else 0
            per += {"affine": 1 + 2 * (n_ops - 1), "add": n_ops, "segmax": 3, "copy": 0,
                    "dfa": 5 * g.get("n_states", 0)}[g["kind"]]
            ops += b * n * per
    return n_bytes, ops


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

    def offset_view(t):
        # The same values in a contiguous view 4 bytes past an aligned base:
        # the kernel takes its scalar loads and stores.
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

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
        lg = max(1, (width - 1).bit_length())
        # Two int32 keys in and out per element; the bitonic network's
        # width/2 * lg*(lg+1)/2 compare-exchanges per row, each a 64-bit
        # compare and two selects (3 operations).
        exchanges = rows * (1 << lg) // 2 * lg * (lg + 1) // 2
        return dict(
            shape=[rows, width],
            ms=graph_ms(lambda: sort.sort2(k1, k2)),
            call_ms=cuda_ms(lambda: sort.sort2(k1, k2)),
            plain_ms=cuda_ms(lambda: sort.sort2_plain(k1, k2), 3),
            library_ms=graph_ms(lambda: torch.sort(z, dim=1)),
            **bound(16.0 * rows * width, 3.0 * exchanges),
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
        lg = max(1, (width - 1).bit_length())
        # Three int32 keys in and out per element; each compare-exchange a
        # 96-bit compare (3 operations) and two selects.
        exchanges = 64 * (1 << lg) // 2 * lg * (lg + 1) // 2
        per_shape.append(dict(
            kernel="sort3", shape=[64, width],
            ms=graph_ms(lambda: sort.sort3(*ks)),
            call_ms=cuda_ms(lambda: sort.sort3(*ks)),
            plain_ms=cuda_ms(lambda: sort.sort3_plain(*ks), 3),
            library_ms=None, **bound(24.0 * 64 * width, 5.0 * exchanges),
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
               batch_size=None, prepare=None):
    """One run of the port's ``run`` entry point over ``inp``; every kernel
    launch counter and the dup-walk counters are set to 0 just before and
    read just after.  ``prepare(pipeline)`` runs before the run.  The
    run's report (``build_run_report``, relative to a ``metrics_snapshot``
    taken just before) rides along as ``report``."""
    from textblaster_tpu_torch.ops import scan, sort, stats
    from textblaster_tpu_torch.ops.pipeline import CompiledPipeline
    from textblaster_tpu_torch.runner import run_pipeline
    from textblaster_tpu_torch.utils.metrics import build_run_report, metrics_snapshot

    pipe = CompiledPipeline(config, device=device, batch_size=batch_size)
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
        "overlapped": config.overlap.enabled and os.environ.get("TEXTBLAST_NO_OVERLAP") != "1",
        "host_tails": os.environ.get("TEXTBLAST_HOST_TAILS") != "off",
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


def _ids(path: str):
    import pyarrow.parquet as pq

    return set(pq.read_table(path, columns=["id"]).column("id").to_pylist())


def main_path(device: str, rows, work: str):
    """The chain schedule (this port's default) windowed (the default) and
    serial (``TEXTBLAST_NO_OVERLAP=1``, as ``run --no-overlap``) over the
    whole corpus, twice each in turns (window, serial, serial, window: a
    drift of the host over the call weighs on both alike); then over the
    first ``STAGED_SUBSET`` documents, windowed, the fused schedule
    (``TEXTBLAST_DEPFUSE=off``), the staged one (``TEXTBLAST_FUSED=off``)
    and the chain schedule with ``TEXTBLAST_HOST_TAILS=off``.
    Every run is held against one host-oracle run, and each windowed chain
    run against each serial one: the same kept and excluded ids, and the
    same bytes."""
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

    serial = {"TEXTBLAST_NO_OVERLAP": "1"}
    runs = [env_run(config, inp, work, tag, device, env)
            for tag, env in (("chain", None), ("chain_serial", serial),
                             ("chain_serial_2", serial), ("chain_2", None))]
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
    for tag in ("chain", "chain_2"):
        for ser in ("chain_serial", "chain_serial_2"):
            for i in (0, 1):
                a, b = summary[tag]["outputs"][i], summary[ser]["outputs"][i]
                if _ids(a) != _ids(b):
                    fail(f"{tag} and {ser} keep or exclude different ids")
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    if fa.read() != fb.read():
                        fail(f"{tag} and {ser} wrote different bytes to {os.path.basename(a)}")
    if not all(summary[t]["overlapped"] for t in ("chain", "chain_2", *dict(SUBSET_RUNS))):
        fail("a windowed run ran serially")
    if any(summary[t]["overlapped"] for t in ("chain_serial", "chain_serial_2")):
        fail("a serial run was windowed")
    if summary["chain"]["host_routes"]["host_routed_astral"] <= 0:
        fail("the u16 wire routed no astral document to the host")
    if summary["chain_tails_off"]["host_routes"]["host_tail"] != 0:
        fail("TEXTBLAST_HOST_TAILS=off still routed tails to the host")
    print("main path: " + json.dumps(summary), flush=True)
    missing = [b for b in DEFAULT_BUCKETS if summary["chain"]["batches_by_bucket"].get(str(b), 0) == 0]
    if missing:
        fail(f"buckets never dispatched: {missing}")
    return summary


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
    finally:
        cli.setup_prometheus_metrics = real
        for server in servers:
            if server is not None:
                server.shutdown()
                server.server_close()
    problems = exposition_problems(body)
    if status != 200 or problems:
        fail(f"GET /metrics: status {status}, exposition problems {problems[:5]}")
    m = re.match(SUMMARY_RE, out.splitlines()[0] if out else "")
    if not m:
        fail(f"the CLI's summary line is not the JAX package's: {out[:300]!r}")
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
    rc_missing, out_missing, err_missing = _cli_main(
        ["run", "-i", missing, "-c", CONFIG, "-o", kept, "-e", excl, "--device", device])
    if rc_missing != 1 or not err_missing.startswith("Pipeline run failed:") \
            or "Traceback" in err_missing:
        fail(f"a missing input gave exit code {rc_missing}: {err_missing[:300]!r}")
    print(f"cli: {CLI_DOCS} documents on {device}, {rate} docs/s by the summary line "
          f"({wall:.2f} s with set-up); GET /metrics {status}, {len(body)} bytes, "
          f"{len(scraped)} samples, exposition clean; missing input -> exit 1, "
          f"{err_missing.strip()[:80]!r}", flush=True)
    return {"documents": CLI_DOCS, "wall_seconds": wall, "summary_line": m.group(0),
            "report": report, "scrape_bytes": len(body), "scrape_samples": len(scraped),
            "missing_input": err_missing.strip()}


# --- fault phase --------------------------------------------------------------

FAULT_DOCS = 2000  # the retry, split and hang runs' documents
OUTAGE_DOCS = 500  # the outage and fatal runs' documents
HANG_DEADLINE_MIN_S = 0.5  # the hang run's least stage deadline
#: Documents longer than this are the real out-of-memory run's: every one
#: packs into the 65536 bucket, so only that bucket dispatches.
OOM_MIN_CHARS = 32768
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


def fault_run(config, inp, work, tag, arm=None, deadline=0.0, prepare=None, **kw):
    """:func:`device_run` with ``device.execute`` armed by ``arm`` (the
    injector's keywords) and the watchdog at ``deadline`` for the run only;
    adds the ladder counters' deltas, the seam's fires and the slowest
    batch that completed: its ``run_batch`` seconds on the dispatch thread
    (what the ``device_fetch`` deadline bounds) and its CUDA-event
    seconds."""
    from textblaster_tpu_torch.resilience import FAULTS, WATCHDOG
    from textblaster_tpu_torch.utils.metrics import METRICS

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
    try:
        run = device_run(config, inp, work, tag, "cuda", prepare=timed, **kw)
        run["fired"] = FAULTS.fired("device.execute")
    finally:
        FAULTS.reset()
        WATCHDOG.reset()
    run["ladder"] = {k: METRICS.get(k) - before[k] for k in LADDER}
    run["slowest_batch"] = slowest
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
                       ("oom", [r for r in rows if len(r[1]) > OOM_MIN_CHARS])):
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
                        "fault_free_docs_per_s": ref["device_docs_per_s"],
                        "fault_free_slowest_batch": ref["slowest_batch"], **extra}
        line = (f"fault run {tag}: {run['received']} documents, {run['device_docs_per_s']:.2f} "
                f"docs/s (fault-free {ref['device_docs_per_s']:.2f}), fires "
                f"{run['fired']}, ladder {json.dumps(run['ladder'])}, slowest batch "
                f"{json.dumps(run['slowest_batch'])} (fault-free "
                f"{json.dumps(ref['slowest_batch'])})")
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
                      arm=dict(exc=OSError("injected device fault"), times=2, after_calls=last))
    same_rows(retry, clean)
    lad = retry["ladder"]
    if (lad["resilience_retries_device_total"], lad["resilience_ladder_split_total"],
            lad["resilience_ladder_host_total"]) != (1, 0, 0):
        fail(f"retry run: ladder {lad}")
    report("retry", retry, clean)

    split = fault_run(config, inputs["fault"], work, "fault_split",
                      arm=dict(exc=OSError("injected device fault"), times=5, after_calls=last))
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
                     arm=dict(kind="hang", times=2, after_calls=1), deadline=hang_deadline)
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
    print(f"device: {name} | nvidia-smi: {smi}", flush=True)

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

    t0 = time.perf_counter()
    rows = make_corpus(N_DOCS, SEED)
    print(f"corpus: {len(rows)} documents, {sum(len(r[1]) for r in rows)} chars, "
          f"{time.perf_counter() - t0:.1f} s to make", flush=True)

    errs, rep, per_shape, timers, checked = kernel_phase(rows)
    walk = time_dup_walk()
    print(f"dup walk (torch loop): {walk}", flush=True)

    work = os.path.join(ROOT, "build", "chip_smoke")
    summary = main_path("cuda", rows, work)
    losses = launch_losses(summary["chain"], per_shape, timers)
    cli_run = cli_phase(rows, work)
    cli_run["registry_op_us"] = registry_op_seconds() * 1e6
    print(f"metrics: one registry increment takes {cli_run['registry_op_us']:.3f} us "
          "on this host", flush=True)
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
            "ms": r["ms"], "kernel_ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": r["shape"],
        })
    out_dir = os.environ.get("CHIP_SMOKE_OUT") or work
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "kernels": kernels,
                   "per_shape": per_shape, "launch_losses": losses, "dup_walk": walk,
                   "main_path": summary, "cli": cli_run, "fault_phase": faults,
                   "total_seconds": time.perf_counter() - t_start}, f, indent=1)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
