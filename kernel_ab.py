#!/usr/bin/env python3
"""A/B of this tree's kernels against an earlier tree's, on one NVIDIA GPU,
in one process.

    git archive <commit> textblaster_tpu_torch/csrc | tar -x -C build/kernel_ab/parent
    python3 kernel_ab.py --parent build/kernel_ab/parent/textblaster_tpu_torch/csrc \
        [--kernels affine_scan,dfa_scan,sort2,chain_scan] [--sweep]

The earlier ``scan.cu``, ``sort.cu`` and ``chain.cu`` (with their
``scan_ops.cuh``), those the chosen kernels need, are compiled with the
flags of ``textblaster_tpu_torch/kernels/build.py`` into
``build/kernel_ab/old/`` and called through the earlier wrappers' steps
(the earlier scan wrappers import ``kernels.build``, check and allocate on
every call; the earlier ``chain_scan`` -- commit 1137dbf's ABI -- plans,
encodes and checks its program on every call; ``_chain_plan`` and
``_chain_code`` are unchanged, so this tree's are used).  At every
main-path shape -- ``affine_scan`` (k = 1 and 2) and ``dfa_scan`` (4 and 5
states) on 64 rows of 512 .. 65536 lanes, ``sort2`` on 256 rows of 256 ..
16384 keys and 320 rows of 16384 (and 64 rows of 32768 and 65536),
``chain_scan`` with every call site's program, made by the site's own
code (``chip_smoke.site_programs``) on 64-row batches of each bucket --
the two are held to the plain version with ``torch.equal``
and timed in turns, earlier, new, new, earlier: the kernel replayed from a
CUDA graph (device time) and the wrapper's eager call (host cost
included), as ``chip_smoke.py`` times them; for ``sort2`` also
``torch.sort`` of the packed int64.  ``--sweep`` also times this tree's
scan kernels under other geometries than ``scan_geometry``'s at the same
shapes (each held to the plain version first).  The table goes to
standard output and to ``ab.json`` in ``$AB_OUT`` (default
``build/kernel_ab``).  Needs a GPU and ``nvcc``.
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


def build_old(src_dir: str, out_dir: str, names):
    """The earlier sources' libraries ``names``, compiled concurrently."""
    from textblaster_tpu_torch.kernels import build as kb

    os.makedirs(out_dir, exist_ok=True)
    nvcc = kb.nvcc_path()
    procs = {}
    for name in names:
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
    if "scan" in libs:
        libs["scan"].tb_affine_scan.argtypes = [p, p, p, p, p, i, i, i, p]
        libs["scan"].tb_affine_scan.restype = i
        libs["scan"].tb_dfa_scan.argtypes = [p, p, i, i, i, p]
        libs["scan"].tb_dfa_scan.restype = i
    if "sort" in libs:
        libs["sort"].tb_sort2.argtypes = [p, p, p, p, p, i, i, i, p]
        libs["sort"].tb_sort2.restype = i
    if "chain" in libs:
        libs["chain"].tb_chain_scan.argtypes = [ip, i, pp, i, pp, i, i, i, p]
        libs["chain"].tb_chain_scan.restype = i
    return libs


def old_affine(lib, m, accs):
    """The earlier ``affine_hash_scan`` wrapper's steps on the earlier
    kernel (one CTA per row over 2048-lane tiles)."""
    import torch

    from textblaster_tpu_torch.kernels.build import check
    from textblaster_tpu_torch.ops import scan

    scan._check("affine_hash_scan", (m,) + tuple(accs))
    outs = tuple(torch.empty_like(a) for a in accs)
    rows, length = m.shape
    two = len(accs) == 2
    with torch.cuda.device(m.device):
        err = lib.tb_affine_scan(m.data_ptr(), accs[0].data_ptr(),
                                 accs[1].data_ptr() if two else None, outs[0].data_ptr(),
                                 outs[1].data_ptr() if two else None, rows, length, len(accs),
                                 torch.cuda.current_stream(m.device).cuda_stream)
    check(err, "old affine_scan")
    return outs


def old_dfa(lib, fns, n_states):
    """The earlier ``dfa_compose_scan`` wrapper's steps on the earlier kernel."""
    import torch

    from textblaster_tpu_torch.kernels.build import check
    from textblaster_tpu_torch.ops import scan

    scan._check("dfa_compose_scan", (fns,))
    out = torch.empty_like(fns)
    rows, length = fns.shape
    with torch.cuda.device(fns.device):
        err = lib.tb_dfa_scan(fns.data_ptr(), out.data_ptr(), rows, length, n_states,
                              torch.cuda.current_stream(fns.device).cuda_stream)
    check(err, "old dfa_scan")
    return (out,)


def scan_with(kind, xs, variant, geo):
    """This tree's ``affine_scan`` (``variant`` = k) or ``dfa_scan``
    (``variant`` = n_states) launched with the geometry ``geo`` instead of
    ``scan_geometry``'s."""
    import torch

    from textblaster_tpu_torch.ops import scan

    lib = scan._scan_lib()
    fn = lib.tb_affine_scan if kind == "affine_scan" else lib.tb_dfa_scan
    rows, length = xs[0].shape
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "affine_scan":
        m, accs = xs[0], xs[1:]
        outs = tuple(torch.empty_like(a) for a in accs)
        two = variant == 2
        err = fn(m.data_ptr(), accs[0].data_ptr(), accs[1].data_ptr() if two else None,
                 outs[0].data_ptr(), outs[1].data_ptr() if two else None, rows, length,
                 variant, *geo, stream)
    else:
        outs = (torch.empty_like(xs[0]),)
        err = fn(xs[0].data_ptr(), outs[0].data_ptr(), rows, length, variant, *geo, stream)
    if err != 0:
        raise RuntimeError(f"{kind} with geometry {geo}: CUDA error {err}")
    return outs


#: Geometries the sweep tries beside scan_geometry's, by (op, row width):
#: (cluster, threads, segments).
SWEEP = {
    ("affine", 512): [(1, 64, 2), (1, 32, 4)],
    ("affine", 2048): [(1, 256, 2), (1, 1024, 1)],
    ("affine", 8192): [(1, 256, 8), (4, 256, 2), (2, 1024, 1)],
    ("affine", 32768): [(4, 256, 8), (8, 256, 4), (1, 1024, 8)],
    ("affine", 65536): [(4, 256, 16), (8, 256, 8), (1, 1024, 16)],
    ("dfa", 512): [(1, 64, 1)],
    ("dfa", 2048): [(1, 64, 2), (2, 64, 1)],
    ("dfa", 8192): [(4, 128, 1), (2, 256, 1)],
    ("dfa", 32768): [(8, 256, 1), (8, 64, 4)],
    ("dfa", 65536): [(8, 256, 2), (8, 64, 8)],
}


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
    ap.add_argument("--kernels", default="affine_scan,dfa_scan,sort2,chain_scan",
                    help="comma-separated subset")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the scan kernels under other geometries")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("CUDA is not available", 2)
    smi = cs.smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    from textblaster_tpu_torch.kernels import build as kb
    from textblaster_tpu_torch.ops import scan, sort

    out_dir = os.environ.get("AB_OUT") or os.path.join(ROOT, "build", "kernel_ab")
    libs = {"affine_scan": "scan", "dfa_scan": "scan", "sort2": "sort", "chain_scan": "chain"}
    names = sorted({libs[k] for k in kernels})
    kb.build()
    for name in names:
        regs = [ln.strip() for ln in kb.ptxas_report.get(name, "").splitlines() if "registers" in ln]
        print(f"  ptxas new {name}: " + " | ".join(regs), flush=True)
    old = build_old(os.path.abspath(args.parent), os.path.join(ROOT, "build", "kernel_ab", "old"),
                    names)
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

    def sweep(kind, variant, xs, geo, plain):
        got = scan_with(kind, xs, variant, geo)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, plain)):
            cs.fail(f"{kind} differs from its plain version under geometry {geo}")
        ms = cs.graph_ms(lambda: scan_with(kind, xs, variant, geo))
        rows_out.append({"kernel": kind, "label": f"sweep {variant}", "shape": list(xs[0].shape),
                         "geometry": list(geo), "new": [ms]})
        print(f"  {kind:10s} {'sweep ' + str(variant):28s} {str(list(xs[0].shape)):14s} "
              f"geometry {geo} kernel {ms:.4f}", flush=True)

    scan_widths = (512, 2048, 8192, 32768, 65536)
    for width in scan_widths:
        shape = (64, width)

        def full_range():
            return torch.from_numpy(rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64)
                                    .astype(np.int32)).to(dev)

        b, n = shape
        if "affine_scan" in kernels:
            m, a1, a2 = full_range(), full_range(), full_range()
            for k in (1, 2):
                accs = (a1, a2)[:k]
                plain = scan.affine_hash_scan_plain(m, accs)
                ab("affine_scan", f"k={k}", shape, cs.bound(*cs.scan_cost("affine_scan", b, n, k)),
                   lambda: old_affine(old["scan"], m, accs),
                   lambda: scan.affine_hash_scan(m, accs), plain)
                for geo in SWEEP[("affine", width)] if args.sweep else ():
                    sweep("affine_scan", k, (m,) + accs, geo, plain)
        if "dfa_scan" in kernels:
            for ns in (4, 5):
                f = cs.packed_maps(rng, shape, ns, dev)
                plain = (scan.dfa_compose_scan_plain(f, ns),)
                ab("dfa_scan", f"n_states={ns}", shape,
                   cs.bound(*cs.scan_cost("dfa_scan", b, n, ns)),
                   lambda: old_dfa(old["scan"], f, ns),
                   lambda: (scan.dfa_compose_scan(f, ns),), plain)
                for geo in SWEEP[("dfa", width)] if args.sweep else ():
                    sweep("dfa_scan", ns, (f,), geo, plain)

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
