#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final result line):

1. Environment: the card's name and power limit (``nvidia-smi``); exits
   with code 2 when CUDA is not available or the port is not beside this
   script.
2. Build: compiles ``textblaster_tpu_torch/csrc/*.cu`` with ``nvcc``
   (``sm_90a``), one compiler per source, all at once.
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, with ``torch.equal`` (exact: every value is int32), at the
   shapes the main path gives it; then CUDA-event timings of kernel, plain
   version and, where one exists, the single PyTorch call computing the
   same function, beside the bound: the larger of the bytes at 3.35 TB/s
   and the integer operations at 67 T/s.
4. Main path: a seeded synthetic Danish/English corpus of >= 20,000
   documents whose lengths fill all five default buckets is written to
   Parquet and run through the port's ``run`` entry point on ``cuda`` with
   ``configs/pipeline_config_offline.yaml``, then through the port's host
   oracle (sharded over the CPU cores, one process per shard).  The kept and excluded sets must be equal id for id (text and
   metadata), every default bucket must have been dispatched, and every
   kernel's launch counter must have grown during the device run.
5. Output: a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as
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
SEED = 20251016

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
    repeated-line boilerplate, 3% citations, 1% CJK and a few empty rows,
    lengths drawn from ``LENGTH_MIX``."""
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


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the integer operations over the CUDA-core rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_phase():
    """Exactness at every main-path shape, then timings per shape."""
    import numpy as np
    import torch

    from textblaster_tpu_torch.ops import scan, sort

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")

    def full_range(shape):
        return torch.from_numpy(
            rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64).astype(np.int32)
        ).to(dev)

    def packed_maps(shape, n_states):
        out = np.zeros(shape, dtype=np.int64)
        for s in range(n_states):
            out |= rng.integers(0, n_states, size=shape, dtype=np.int64) << (4 * s)
        return torch.from_numpy(out.astype(np.uint32).view(np.int32)).to(dev)

    def max_err(got, want):
        return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                   for g, w in zip(got, want))

    errs = {"affine_scan": 0, "dfa_scan": 0, "sort2": 0}
    per_shape = []
    scan_shapes = [(64, n) for n in (512, 2048, 8192, 32768, 65536)] + [(37, 1000)]
    for shape in scan_shapes:
        m, a1, a2 = full_range(shape), full_range(shape), full_range(shape)
        for accs in ((a1,), (a1, a2)):
            got = scan.affine_hash_scan(m, accs)
            torch.cuda.synchronize()
            want = scan.affine_hash_scan_plain(m, accs)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"affine_scan differs from its plain version at {shape} k={len(accs)}")
            errs["affine_scan"] = max(errs["affine_scan"], max_err(got, want))
        for ns in (4, 5, 8):
            f = packed_maps(shape, ns)
            got = scan.dfa_compose_scan(f, ns)
            torch.cuda.synchronize()
            want = scan.dfa_compose_scan_plain(f, ns)
            if not torch.equal(got, want):
                fail(f"dfa_scan differs from its plain version at {shape} n_states={ns}")
            errs["dfa_scan"] = max(errs["dfa_scan"], max_err((got,), (want,)))
    # sort2 rows as the main path stacks its 64-row batches: 2 jobs (line and
    # paragraph tables, widths max_lines), 4 and 5 jobs (n-gram tables,
    # widths max_words); 64 and 128 rows for the sort-table form's bucket
    # widths and a padded width.
    sort_shapes = [(128, w) for w in (128, 256, 1024, 4096, 8192)]
    sort_shapes += [(r, w) for r in (256, 320) for w in (256, 512, 2048, 8192, 16384)]
    sort_shapes += [(r, w) for r in (64, 128) for w in (32768, 65536, 1536)]
    for rows, width in sort_shapes:
        k1 = torch.from_numpy(rng.integers(-1000, 1000, size=(rows, width)).astype(np.int32)).to(dev)
        k2 = torch.from_numpy(rng.integers(0, 2**31 - 1, size=(rows, width)).astype(np.int32)).to(dev)
        got = sort.sort2(k1, k2)
        torch.cuda.synchronize()
        want = sort.sort2_plain(k1, k2)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"sort2 differs from its plain version at {[rows, width]}")
        errs["sort2"] = max(errs["sort2"], max_err(got, want))
    print(f"kernels exact: affine_scan and dfa_scan at {scan_shapes}, "
          f"sort2 at {sort_shapes}", flush=True)

    # Timings: per shape (written to the JSON file), and the representative
    # main-path call per kernel (the kernels line).
    def time_scan(shape):
        m, a1, a2 = full_range(shape), full_range(shape), full_range(shape)
        f = packed_maps(shape, 5)
        b, n = shape
        return {
            # k=2: reads m, a1, a2 and writes two scans; per element one
            # multiply for m and a multiply-add per accumulator.
            "affine_scan": dict(
                shape=list(shape), k=2,
                ms=cuda_ms(lambda: scan.affine_hash_scan(m, (a1, a2))),
                plain_ms=cuda_ms(lambda: scan.affine_hash_scan_plain(m, (a1, a2)), 3),
                library_ms=None,
                **bound(4.0 * b * n * (1 + 2 * 2), b * n * (1 + 2 * 2)),
            ),
            # Reads and writes one stream; per element and state a nibble
            # extract (shift, mask) and a lookup-insert (shift, mask, or).
            "dfa_scan": dict(
                shape=list(shape), n_states=5,
                ms=cuda_ms(lambda: scan.dfa_compose_scan(f, 5)),
                plain_ms=cuda_ms(lambda: scan.dfa_compose_scan_plain(f, 5), 3),
                library_ms=None,
                **bound(4.0 * b * n * 2, b * n * 5 * 5),
            ),
        }

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
            ms=cuda_ms(lambda: sort.sort2(k1, k2)),
            plain_ms=cuda_ms(lambda: sort.sort2_plain(k1, k2), 3),
            library_ms=cuda_ms(lambda: torch.sort(z, dim=1), 3),
            **bound(16.0 * rows * width, 3.0 * exchanges),
        )

    for shape in scan_shapes[:-1]:
        t = time_scan(shape)
        per_shape.append({"kernel": "affine_scan", **t["affine_scan"]})
        per_shape.append({"kernel": "dfa_scan", **t["dfa_scan"]})
    # Sort rows as the main path stacks them: 4 jobs x 64 rows for the
    # n-gram tables (widths = max_words of each bucket), 5 x 64 when the
    # dup gate fires at the widest bucket.
    for rows, width in ((256, 256), (256, 512), (256, 2048), (256, 8192),
                        (256, 16384), (320, 16384), (64, 32768), (64, 65536)):
        per_shape.append({"kernel": "sort2", **time_sort(rows, width)})
    for row in per_shape:
        print(f"  {row['kernel']:12s} {str(row['shape']):16s} kernel {row['ms']:.4f} ms"
              f"  plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms"
              + (f"  library {row['library_ms']:.4f} ms" if row["library_ms"] else ""),
              flush=True)
    rep = {
        "affine_scan": next(r for r in per_shape if r["kernel"] == "affine_scan" and r["shape"] == [64, 65536]),
        "dfa_scan": next(r for r in per_shape if r["kernel"] == "dfa_scan" and r["shape"] == [64, 65536]),
        "sort2": next(r for r in per_shape if r["kernel"] == "sort2" and r["shape"] == [256, 16384]),
    }
    return errs, rep, per_shape


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


def main_path(device: str, n_docs: int, work: str):
    from textblaster_tpu_torch.config.pipeline import load_pipeline_config
    from textblaster_tpu_torch.ops import scan, sort, stats
    from textblaster_tpu_torch.ops.packing import DEFAULT_BUCKETS
    from textblaster_tpu_torch.ops.pipeline import CompiledPipeline
    from textblaster_tpu_torch.runner import run_pipeline

    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    rows = make_corpus(n_docs, SEED)
    inp = os.path.join(work, "corpus.parquet")
    write_parquet(inp, rows)
    n_chars = sum(len(r[1]) for r in rows)
    print(f"corpus: {len(rows)} documents, {n_chars} chars, "
          f"{time.perf_counter() - t0:.1f} s to make", flush=True)

    config = load_pipeline_config(CONFIG)
    pipe = CompiledPipeline(config, device=device)
    if device == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats()
    dev_out = (os.path.join(work, "dev_kept.parquet"), os.path.join(work, "dev_excl.parquet"))
    for d in (scan.LAUNCHES, sort.LAUNCHES, stats.DUP_WALK):
        for k in d:
            d[k] = 0
    t0 = time.perf_counter()
    res = run_pipeline(config, inp, *dev_out, backend="device", pipeline=pipe)
    if device == "cuda":
        torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    launches = {**scan.LAUNCHES, **sort.LAUNCHES}

    t0 = time.perf_counter()
    host_kept, host_excl, host_received = host_oracle(inp, work)
    host_s = time.perf_counter() - t0

    dev_kept, dev_excl = read_set(dev_out[0]), read_set(dev_out[1])
    parity = dev_kept == host_kept and dev_excl == host_excl
    decided = len(host_kept) + len(host_excl)
    agree = len(dev_kept & host_kept) + len(dev_excl & host_excl)
    summary = {
        "documents": len(rows),
        "chars": n_chars,
        "kept": res.success,
        "excluded": res.filtered,
        "errors": res.errors,
        "device_seconds": dev_s,
        "device_docs_per_s": len(rows) / dev_s,
        "host_oracle_seconds": host_s,
        "decision_parity": agree / max(decided, 1),
        "batches_by_bucket": {str(k): v for k, v in sorted(pipe.counters["batches_by_bucket"].items())},
        "device_rows": pipe.counters["device_rows"],
        "host_fallback": pipe.counters["host_fallback"],
        "host_routed_dict_script": pipe.counters["host_routed_dict_script"],
        "host_overflow": pipe.counters["host_overflow"],
        "launches": launches,
        "seconds": pipe.counters["seconds"],
        "dup_walk": dict(stats.DUP_WALK),
        "peak_device_mib": (torch.cuda.max_memory_allocated() / 2**20) if device == "cuda" else None,
    }
    print("main path: " + json.dumps(summary), flush=True)
    if res.received != host_received or not parity:
        fail(f"device and host oracle outputs differ (parity {summary['decision_parity']})")
    missing = [b for b in DEFAULT_BUCKETS if pipe.counters["batches_by_bucket"].get(b, 0) == 0]
    if missing:
        fail(f"buckets never dispatched: {missing}")
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

    errs, rep, per_shape = kernel_phase()
    walk = time_dup_walk()
    print(f"dup walk (torch loop): {walk}", flush=True)

    work = os.path.join(ROOT, "build", "chip_smoke")
    summary = main_path("cuda", N_DOCS, work)
    for k, v in summary["launches"].items():
        if v <= 0:
            fail(f"kernel {k} was never launched on the main path")

    sources = {"affine_scan": "textblaster_tpu_torch/csrc/scan.cu",
               "dfa_scan": "textblaster_tpu_torch/csrc/scan.cu",
               "sort2": "textblaster_tpu_torch/csrc/sort.cu"}
    replaces = {"affine_scan": "textblaster_tpu/ops/pallas_scan.py:244",
                "dfa_scan": "textblaster_tpu/ops/pallas_scan.py:244",
                "sort2": "textblaster_tpu/ops/pallas_sort.py:160"}
    kernels = []
    for k in ("affine_scan", "dfa_scan", "sort2"):
        r = rep[k]
        kernels.append({
            "name": k, "route": "cuda", "source": sources[k], "replaces": replaces[k],
            "launches": summary["launches"][k], "max_abs_err": errs[k],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": r["shape"],
        })
    out_dir = os.environ.get("CHIP_SMOKE_OUT") or work
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "kernels": kernels,
                   "per_shape": per_shape, "dup_walk": walk, "main_path": summary,
                   "total_seconds": time.perf_counter() - t_start}, f, indent=1)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
