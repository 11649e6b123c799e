#!/usr/bin/env python3
"""A/B of this tree's ``sort2`` and ``chain_scan`` kernels against an earlier
tree's, on one NVIDIA GPU, in one process.

    git archive <commit> textblaster_tpu_torch/csrc | tar -x -C build/kernel_ab/parent
    python3 kernel_ab.py --parent build/kernel_ab/parent/textblaster_tpu_torch/csrc

The earlier ``sort.cu`` and ``chain.cu`` (with their ``scan_ops.cuh``) are
compiled with the flags of ``textblaster_tpu_torch/kernels/build.py`` into
``build/kernel_ab/old/`` and called through the earlier wrappers' steps
(the earlier ``chain_scan`` plans, encodes and checks its program on every
call; ``_chain_plan`` and ``_chain_code`` are unchanged, so this tree's are
used).  At every main-path shape -- ``sort2`` on 256 rows of 256 .. 16384
keys and 320 rows of 16384 (and 64 rows of 32768 and 65536, where both
trees run the same network), ``chain_scan`` with every call site's program
built by the sites' own builders on 64-row batches of each bucket -- the
two are held to the plain version with ``torch.equal`` and timed in turns,
earlier, new, new, earlier: the kernel replayed from a CUDA graph (device
time) and the wrapper's eager call (host cost included), as
``chip_smoke.py`` times them; for ``sort2`` also ``torch.sort`` of the
packed int64.  The table goes to standard output and to ``ab.json`` in
``$AB_OUT`` (default ``build/kernel_ab``).  Needs a GPU and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the corpus, site programs and timers)


def build_old(src_dir: str, out_dir: str):
    """The earlier sources' libraries, compiled concurrently."""
    from textblaster_tpu_torch.kernels import build as kb

    os.makedirs(out_dir, exist_ok=True)
    nvcc = kb.nvcc_path()
    procs = {}
    for name in ("sort", "chain"):
        out = os.path.join(out_dir, f"libold_{name}.so")
        procs[name] = (out, subprocess.Popen(
            [nvcc, *kb._FLAGS, "-o", out, os.path.join(src_dir, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  ptxas old {name}: " + " | ".join(regs), flush=True)
        if proc.returncode != 0:
            cs.fail(f"nvcc failed for the earlier {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    ip, pp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    libs["sort"].tb_sort2.argtypes = [p, p, p, p, p, i, i, i, p]
    libs["sort"].tb_sort2.restype = i
    libs["chain"].tb_chain_scan.argtypes = [ip, i, pp, i, pp, i, i, i, p]
    libs["chain"].tb_chain_scan.restype = i
    return libs


def old_sort2(lib, k1, k2):
    """The earlier ``sort2`` wrapper's steps on the earlier kernel."""
    import torch

    from textblaster_tpu_torch.kernels.build import check
    from textblaster_tpu_torch.ops import sort

    sort._check("sort2", (k1, k2))
    rows, m = k1.shape
    o1, o2 = torch.empty_like(k1), torch.empty_like(k2)
    mp = max(2, 1 << (m - 1).bit_length())
    scratch = (torch.empty((rows, mp), dtype=torch.int64, device=k1.device)
               if mp > sort.SMEM_WIDTH else None)
    with torch.cuda.device(k1.device):
        err = lib.tb_sort2(k1.data_ptr(), k2.data_ptr(), o1.data_ptr(), o2.data_ptr(),
                           scratch.data_ptr() if scratch is not None else None, rows, m, mp,
                           torch.cuda.current_stream(k1.device).cuda_stream)
    check(err, "old sort2")
    return o1, o2


def old_chain(lib, passes):
    """The earlier ``chain_scan`` wrapper's steps on the earlier kernel: plan,
    check and encode on every call, then launch."""
    import torch

    from textblaster_tpu_torch.kernels.build import check
    from textblaster_tpu_torch.ops import scan

    passes = list(passes)
    plan, ext, out_modes, n_scratch, layout = scan._chain_plan(passes)
    dev = ext[0].device
    scan._check("chain_scan", ext)
    code = scan._chain_code(plan, len(out_modes))
    rows, length = ext[0].shape
    outs = [torch.empty((rows, 1) if m == "last" else (rows, length), dtype=torch.int32,
                        device=dev) for m in out_modes]
    scratch = (torch.empty((n_scratch, rows, length), dtype=torch.int32, device=dev)
               if n_scratch else None)
    slots = [o.data_ptr() for o in outs] + [scratch[j].data_ptr() for j in range(n_scratch)]
    with torch.cuda.device(dev):
        err = lib.tb_chain_scan(
            (ctypes.c_int * len(code))(*code), len(code),
            (ctypes.c_void_p * len(ext))(*(x.data_ptr() for x in ext)), len(ext),
            (ctypes.c_void_p * len(slots))(*slots), len(slots), rows, length,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "old chain_scan")
    return [[tuple(outs[s] for s in g_slots) for g_slots in p_layout] for p_layout in layout]


def _flat(res):
    return [x for p in res for g in p for x in g]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="directory of the earlier csrc/ sources")
    ap.add_argument("--docs", type=int, default=4000, help="corpus documents for the batches")
    ap.add_argument("--kernels", default="sort2,chain_scan", help="comma-separated subset")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("CUDA is not available", 2)
    smi = cs.smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    from textblaster_tpu_torch.kernels import build as kb
    from textblaster_tpu_torch.ops import scan, sort

    out_dir = os.environ.get("AB_OUT") or os.path.join(ROOT, "build", "kernel_ab")
    kb.build()
    for name in ("sort", "chain"):
        regs = [ln.strip() for ln in kb.ptxas_report.get(name, "").splitlines() if "registers" in ln]
        print(f"  ptxas new {name}: " + " | ".join(regs), flush=True)
    old = build_old(os.path.abspath(args.parent), os.path.join(ROOT, "build", "kernel_ab", "old"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    rows_out = []

    def ab(kind, label, shape, bound, old_fn, new_fn, plain, library=None):
        for name, fn in (("old", old_fn), ("new", new_fn)):
            got = fn()
            torch.cuda.synchronize()
            if len(got) != len(plain) or not all(
                    g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, plain)):
                cs.fail(f"{kind} ({name}) differs from its plain version: {label}")
        t = {"old": [], "new": [], "old_call": [], "new_call": [], "library": []}
        for name in ("old", "new", "new", "old"):
            fn = old_fn if name == "old" else new_fn
            t[name].append(cs.graph_ms(fn))
            t[name + "_call"].append(cs.cuda_ms(fn))
            if library is not None and name == "new":
                t["library"].append(cs.graph_ms(library))
        row = {"kernel": kind, "label": label, "shape": list(shape), **bound,
               **{k: v for k, v in t.items() if v}}
        rows_out.append(row)
        lib_s = f"  torch.sort {min(t['library']):.4f}" if t["library"] else ""
        print(f"  {kind:10s} {label:28s} {str(list(shape)):14s} kernel old {t['old'][0]:.4f} "
              f"{t['old'][1]:.4f} new {t['new'][0]:.4f} {t['new'][1]:.4f} | call old "
              f"{t['old_call'][0]:.4f} {t['old_call'][1]:.4f} new {t['new_call'][0]:.4f} "
              f"{t['new_call'][1]:.4f} | bound {bound['bound_ms']:.4f}{lib_s}", flush=True)

    kernels = args.kernels.split(",")
    sort_shapes = ((256, 256), (256, 512), (256, 2048), (256, 8192), (256, 16384),
                   (320, 16384), (64, 32768), (64, 65536))
    for rows, width in sort_shapes if "sort2" in kernels else ():
        k1 = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(rows, width),
                                           dtype=np.int64).astype(np.int32)).to(dev)
        k2 = torch.from_numpy(rng.integers(0, 2**31 - 1, size=(rows, width))
                              .astype(np.int32)).to(dev)
        z = (k1.long() << 32) | k2.long()
        lg = max(1, (width - 1).bit_length())
        exchanges = rows * (1 << lg) // 2 * lg * (lg + 1) // 2
        ab("sort2", "", (rows, width), cs.bound(16.0 * rows * width, 3.0 * exchanges),
           lambda: old_sort2(old["sort"], k1, k2), lambda: sort.sort2(k1, k2),
           sort.sort2_plain(k1, k2), library=lambda: torch.sort(z, dim=1))

    t0 = time.perf_counter()
    corpus = cs.make_corpus(args.docs if "chain_scan" in kernels else 0, cs.SEED)
    print(f"corpus: {len(corpus)} documents, {time.perf_counter() - t0:.1f} s", flush=True)
    chain_shapes = ((64, 512), (64, 2048), (64, 8192), (64, 32768), (64, 65536))
    for shape in chain_shapes if "chain_scan" in kernels else ():
        for site, passes in cs.site_programs(corpus, shape, dev).items():
            width = tuple(scan._chain_plan(passes)[1][0].shape)
            ab("chain_scan", f"{site}@{shape[1]}", width, cs.bound(*cs.chain_cost(passes)),
               lambda: _flat(old_chain(old["chain"], passes)),
               lambda: _flat(scan.chain_scan(passes)), _flat(scan.chain_scan_plain(passes)))

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ab.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                   "rows": rows_out}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
