#!/usr/bin/env python3
"""A/B of this tree's kernels against an earlier tree's, on one NVIDIA GPU,
in one process.

    git archive <commit> textblaster_tpu_torch/csrc | tar -x -C build/kernel_ab/parent
    python3 kernel_ab.py --parent build/kernel_ab/parent/textblaster_tpu_torch/csrc \
        [--kernels affine_scan,dfa_scan,sort2,sort3,chain_scan,fused_scan] [--sweep]

The earlier ``scan.cu``, ``sort.cu``, ``chain.cu`` and ``fused.cu`` (with
their ``scan_ops.cuh``), those the chosen kernels need, and this tree's are
compiled with the flags of ``textblaster_tpu_torch/kernels/build.py`` into
``build/kernel_ab/old/`` and ``build/kernel_ab/new/``, and the ``ptxas
-v`` lines of both (registers, stack, spills) are printed.  The earlier
sources are those of commit a44c680, or any later tree with the same C
interfaces: the per-scan kernels, ``sort2`` and ``chain_scan`` are called
through this tree's wrappers (unchanged since then), pointed at the
earlier or at this tree's library before every call of either;
``fused_scan`` through the earlier wrapper's steps (``load``, five ctypes
arrays, the earlier entry); ``sort2`` and ``sort3`` through this tree's
wrappers where the earlier ``sort.cu`` takes the layout from the caller,
else (69747ba and before) through the earlier wrappers' steps.  At every main-path shape -- ``affine_scan`` (k = 1 and 2) and
``dfa_scan`` (4 and 5 states) on 64 rows of 512 .. 65536 lanes, ``sort2``
on 256 rows of 256 .. 16384 keys and 320 rows of 16384 (and 64 rows of
32768 and 65536), ``sort3`` on 64 rows of 256 .. 32768 keys (ties and
both int32 extremes), ``chain_scan`` with every call site's program, made by
the site's own code (``chip_smoke.site_programs``) on 64-row batches of
each bucket, ``fused_scan`` with every call site's group list
(``chip_smoke.fused_site_lists``) on 64 rows of 512, 2048 and 8192 lanes
-- the two are held to the plain version with ``torch.equal`` and timed
in turns, earlier, new, new, earlier: the kernel replayed from a CUDA
graph (device time) and the wrapper's eager call (host cost included), as
``chip_smoke.py`` times them; for ``sort2`` also ``torch.sort`` of the
packed int64.  The sorts' wrapper is also timed in its two forms of the
device guard (always entered, or only off the current device) in turns.
``--sweep`` also times this tree's scan kernels under other geometries
than ``scan_geometry``'s, ``fused_scan`` under other thread counts than
``fused_geometry``'s, and ``sort3`` in every layout of a build of this
tree's ``sort.cu`` with ``-DTB_SORT_SWEEP`` (one warp a row up to 1024
keys; CTAs of 8 and 16 keys a thread in clusters of 1, 2 and 4) at
1024 .. 32768 keys, at the same shapes (each held to the plain version
first).  The table goes to standard output and to
``ab.json`` in ``$AB_OUT`` (default ``build/kernel_ab``).  Needs a GPU and
``nvcc``.
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


def ptxas_lines(log: str):
    """Each kernel of a ``ptxas -v`` report, demangled where ``c++filt``
    runs, with its registers, stack and spills."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill" in ln or "registers" in ln:
            out.append(ln.split(":", 1)[-1].strip() if "registers" in ln else ln.strip())
            if "registers" in ln and name:
                out[-1] = f"{name}: {out[-2] if len(out) > 1 else ''}; {out[-1]}"
                del out[-2]
                name = None
    try:
        res = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True, text=True,
                             timeout=60)
        if res.returncode == 0:
            out = [ln.replace("(anonymous namespace)::", "").replace("void ", "", 1)
                   for ln in res.stdout.splitlines()]
    except OSError:
        pass
    return out


def build_libs(src_dir: str, out_dir: str, names, side: str, flags=()):
    """``side``'s libraries ``names`` from the sources in ``src_dir``,
    compiled concurrently (with ``flags`` beside the build's own); prints
    each one's ``ptxas -v`` lines."""
    from textblaster_tpu_torch.kernels import build as kb

    os.makedirs(out_dir, exist_ok=True)
    nvcc = kb.nvcc_path()
    procs = {}
    for name in names:
        out = os.path.join(out_dir, f"lib{side}_{name}.so")
        procs[name] = (out, subprocess.Popen(
            [nvcc, *kb._FLAGS, *flags, "-o", out, os.path.join(src_dir, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        print(f"  ptxas {side} {name}:\n    " + "\n    ".join(ptxas_lines(log)), flush=True)
        if proc.returncode != 0:
            cs.fail(f"nvcc failed for the {side} {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(out)
        kb._declare(name, libs[name])
    p, i = ctypes.c_void_p, ctypes.c_int
    if "fused" in libs and side == "old":  # the earlier fused entry
        ip, pp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
        libs["fused"].tb_fused_scan.argtypes = [i, ip, ip, ip, ip, pp, i, pp, i, i, i, p]
        libs["fused"].tb_fused_scan.restype = i
    if "sort" in libs and side == "old" and not takes_layout(src_dir):
        libs["sort"].tb_sort2.argtypes = [p] * 5 + [i] * 3 + [p]  # the earlier entries
        libs["sort"].tb_sort3.argtypes = [p] * 7 + [i] * 3 + [p]
    return libs


def takes_layout(src_dir: str) -> bool:
    """Whether ``src_dir``'s ``sort.cu`` takes the register network's layout
    from the caller (this tree's entries), not the earlier entries."""
    with open(os.path.join(src_dir, "sort.cu")) as f:
        return "int rows_per_cta" in f.read()


def old_sort(lib, ks):
    """The earlier (69747ba) ``sort2`` / ``sort3`` wrapper's steps on the
    earlier library: a packed scratch buffer above 16384 keys (two keys) or
    8192 (three), the device guard as each wrapper had it."""
    import torch

    from textblaster_tpu_torch.kernels.build import check

    k1 = ks[0]
    rows, m = k1.shape
    outs = tuple(torch.empty_like(k1) for _ in ks)
    mp = max(2, 1 << (m - 1).bit_length())
    two = len(ks) == 2
    scratch = (torch.empty((rows, mp, len(ks) - 1), dtype=torch.int64, device=k1.device)
               if mp > (16384 if two else 8192) else None)
    fn = lib.tb_sort2 if two else lib.tb_sort3
    args = (*(t.data_ptr() for t in ks + outs), scratch.data_ptr() if scratch is not None
            else None, rows, m, mp, torch.cuda.current_stream(k1.device).cuda_stream)
    if two and k1.device.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(k1.device):
            err = fn(*args)
    check(err, "old sort")
    return outs


def guard_always(device, fn, args):
    """The other form of ``ops/sort.py``'s ``_on_device``: the device guard
    entered on every call."""
    import torch

    with torch.cuda.device(device):
        return fn(*args)


def sort3_layouts(width):
    """The sweep build's ``sort3`` layouts (keys, threads, ctas,
    rows_per_cta) at ``width`` keys: one warp a row up to 1024 keys, CTAs
    of 8 and 16 keys a thread in clusters of 1, 2 and 4."""
    out = [(width // 32, 32, 1, 4)] if width <= 1024 else []
    for keys in (8, 16):
        for ctas in (1, 2, 4):
            threads = width // keys // ctas
            if 32 <= threads <= 8192 // keys:
                out.append((keys, threads, ctas, 1))
    return out


def sort3_with(lib, ks, layout):
    """``lib``'s ``sort3`` kernel in the register layout ``layout``."""
    import torch

    rows, m = ks[0].shape
    outs = tuple(torch.empty_like(k) for k in ks)
    mp = max(2, 1 << (m - 1).bit_length())
    err = lib.tb_sort3(*(t.data_ptr() for t in ks + outs), None, rows, m, mp, *layout,
                       torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sort3 in layout {layout}: CUDA error {err}")
    return outs


#: Per side ("old", "new"): the libraries of this tree's per-scan, sort
#: and chain wrappers, and that side's cache of encoded chain programs (a
#: program's C handle belongs to one library).  Filled in main().
SIDES = {}


def use(side):
    """Points this tree's ``affine_scan``, ``dfa_scan``, ``sort2`` and
    ``chain_scan`` wrappers at ``side``'s libraries: a few stores, made
    before every call of either side."""
    from textblaster_tpu_torch.kernels import build as kb
    from textblaster_tpu_torch.ops import scan

    libs, programs = SIDES[side]
    kb._loaded.update(libs)
    scan._SCAN_LIB[:] = [libs["scan"]]
    scan._CHAIN_PROGRAMS = programs


def on(side, fn):
    """``fn`` called on ``side``'s libraries."""
    def call():
        use(side)
        return fn()

    return call


def old_fused(lib, groups):
    """The earlier ``fused_scan`` wrapper's steps on the earlier kernel (one
    CTA per row over 2048-lane shared-memory tiles)."""
    import torch

    from textblaster_tpu_torch.kernels.build import check
    from textblaster_tpu_torch.ops import scan

    specs = [scan._fused_spec(g) for g in groups]
    xs = tuple(x for g in groups for x in g["xs"])
    scan._check("fused_scan", xs)
    rows, length = xs[0].shape
    outs = []
    for _, _, _, emit_idx, emit_last in specs:
        shape = (rows, 1) if emit_last else (rows, length)
        outs.extend(torch.empty(shape, dtype=torch.int32, device=xs[0].device) for _ in emit_idx)

    def ints(vals):
        return (ctypes.c_int * len(vals))(*vals)

    kinds = ints([scan._KINDS[g["kind"]] for g in groups])
    n_in = ints([len(g["xs"]) for g in groups])
    last = ints([int(s[4]) for s in specs])
    n_states = ints([g.get("n_states", 0) for g in groups])
    in_ptrs = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    with torch.cuda.device(xs[0].device):
        err = lib.tb_fused_scan(len(groups), kinds, n_in, last, n_states, in_ptrs, len(xs),
                                out_ptrs, len(outs), rows, length,
                                torch.cuda.current_stream(xs[0].device).cuda_stream)
    check(err, "old fused_scan")
    return outs


def fused_with(groups, threads):
    """This tree's ``fused_scan`` kernel launched with ``threads`` threads a
    CTA instead of ``fused_geometry``'s; the emitted streams, flat."""
    import torch

    from textblaster_tpu_torch.ops import scan

    specs = [scan._fused_spec(g) for g in groups]
    xs = tuple(x for g in groups for x in g["xs"])
    rows, length = xs[0].shape
    outs = tuple(torch.empty((rows, 1) if s[4] else (rows, length), dtype=torch.int32,
                             device=xs[0].device) for s in specs for _ in s[3])
    code = [v for g, s in zip(groups, specs)
            for v in (scan._KINDS[g["kind"]], len(g["xs"]), int(s[4]), g.get("n_states", 0))]
    ptrs = [t.data_ptr() for t in xs + outs]
    err = scan._fused_lib().tb_fused_scan(
        (ctypes.c_int * len(code))(*code), len(groups), (ctypes.c_void_p * len(ptrs))(*ptrs),
        len(xs), len(outs), rows, length, threads, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_scan with {threads} threads: CUDA error {err}")
    return outs


def scan_with(kind, xs, variant, geo):
    """This tree's ``affine_scan`` (``variant`` = k) or ``dfa_scan``
    (``variant`` = n_states) launched with the geometry ``geo`` instead of
    ``scan_geometry``'s."""
    import torch

    lib = SIDES["new"][0]["scan"]
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
#: Threads a CTA the fused sweep tries, at every width.
FUSED_SWEEP = (64, 128, 256, 512)


def _flat(res):
    return [x for p in res for g in p for x in g]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="directory of the earlier csrc/ sources")
    ap.add_argument("--docs", type=int, default=4000, help="corpus documents for the batches")
    ap.add_argument("--kernels",
                    default="affine_scan,dfa_scan,sort2,sort3,chain_scan,fused_scan",
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
    from textblaster_tpu_torch.ops import cost, scan, sort

    out_dir = os.environ.get("AB_OUT") or os.path.join(ROOT, "build", "kernel_ab")
    libs = {"affine_scan": "scan", "dfa_scan": "scan", "sort2": "sort", "sort3": "sort",
            "chain_scan": "chain", "fused_scan": "fused"}
    names = sorted({libs[k] for k in kernels} | {"scan"})
    ab_dir = os.path.join(ROOT, "build", "kernel_ab")
    new = build_libs(os.path.join(ROOT, "textblaster_tpu_torch", "csrc"),
                     os.path.join(ab_dir, "new"), names, "new")
    old = build_libs(os.path.abspath(args.parent), os.path.join(ab_dir, "old"), names, "old")
    sweep_sort = (build_libs(os.path.join(ROOT, "textblaster_tpu_torch", "csrc"),
                             os.path.join(ab_dir, "sweep"), ["sort"], "sweep",
                             ["-DTB_SORT_SWEEP"])["sort"]
                  if args.sweep and "sort3" in kernels else None)
    if sweep_sort is not None:
        sweep_sort.tb_sort3_max_clusters.argtypes = [ctypes.c_int] * 3
        sweep_sort.tb_sort3_max_clusters.restype = ctypes.c_int
    wrapped = [n for n in names if n != "fused"]
    SIDES["old"] = ({n: old[n] for n in wrapped}, {})
    SIDES["new"] = ({n: new[n] for n in wrapped}, {})
    scan._FUSED_LIB[:] = [new["fused"]] if "fused" in new else []
    use("new")  # the chain sites' builders run chain_scan themselves
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    rows_out = []

    def ab(kind, label, shape, bound, old_fn, new_fn, plain, library=None):
        # old_fn / new_fn: the earlier and this tree's call (or two forms).
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

    def sweep(kind, label, shape, geo, fn, plain):
        got = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, plain)):
            cs.fail(f"{kind} differs from its plain version under geometry {geo}: {label}")
        ms = cs.graph_ms(fn)
        rows_out.append({"kernel": kind, "label": f"sweep {label}", "shape": list(shape),
                         "geometry": geo, "new": [ms]})
        print(f"  {kind:10s} {'sweep ' + label:28s} {str(list(shape)):14s} "
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
                call = lambda: scan.affine_hash_scan(m, accs)  # noqa: E731
                ab("affine_scan", f"k={k}", shape, cost.bound(*cost.scan_cost("affine_scan", b, n, k)),
                   on("old", call), on("new", call), plain)
                for geo in SWEEP[("affine", width)] if args.sweep else ():
                    sweep("affine_scan", str(k), shape, list(geo),
                          lambda: scan_with("affine_scan", (m,) + accs, k, geo), plain)
        if "dfa_scan" in kernels:
            for ns in (4, 5):
                f = cs.packed_maps(rng, shape, ns, dev)
                plain = (scan.dfa_compose_scan_plain(f, ns),)
                call = lambda: (scan.dfa_compose_scan(f, ns),)  # noqa: E731
                ab("dfa_scan", f"n_states={ns}", shape,
                   cost.bound(*cost.scan_cost("dfa_scan", b, n, ns)),
                   on("old", call), on("new", call), plain)
                for geo in SWEEP[("dfa", width)] if args.sweep else ():
                    sweep("dfa_scan", str(ns), shape, list(geo),
                          lambda: scan_with("dfa_scan", (f,), ns, geo), plain)

    def full_range_of(shape):
        return torch.from_numpy(rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    for width in (512, 2048, 8192) if "fused_scan" in kernels else ():
        shape = (64, width)
        lists = cs.fused_site_lists(full_range_of, lambda s, ns: cs.packed_maps(rng, s, ns, dev),
                                    shape)
        for site, make in lists.items():
            if site.startswith("generic") or site == "structure_wide":
                continue
            groups = make()
            plain = [x for g in scan.fused_scan_plain(groups) for x in g]
            ab("fused_scan", site, shape, cost.bound(*cost.fused_cost(groups)),
               lambda: old_fused(old["fused"], groups),
               lambda: [x for g in scan.fused_scan(groups) for x in g], plain)
            for threads in FUSED_SWEEP if args.sweep else ():
                sweep("fused_scan", site, shape, [threads],
                      lambda: fused_with(groups, threads), plain)

    sort_shapes = ((256, 256), (256, 512), (256, 2048), (256, 8192), (256, 16384),
                   (320, 16384), (64, 32768), (64, 65536))
    same_sort = takes_layout(os.path.abspath(args.parent))

    def sort_sides(ks):
        """The earlier and this tree's sort2 / sort3 calls on ``ks``."""
        call = lambda: (sort.sort2 if len(ks) == 2 else sort.sort3)(*ks)  # noqa: E731
        if same_sort:
            return on("old", call), on("new", call)
        return lambda: old_sort(old["sort"], ks), on("new", call)

    def guard_forms(ks):
        """This tree's wrapper with the guard always entered, and as kept."""
        call = lambda: (sort.sort2 if len(ks) == 2 else sort.sort3)(*ks)  # noqa: E731
        kept = sort._on_device

        def always():
            sort._on_device = guard_always
            try:
                return on("new", call)()
            finally:
                sort._on_device = kept

        return always, on("new", call)

    for rows, width in sort_shapes if "sort2" in kernels else ():
        k1 = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(rows, width),
                                           dtype=np.int64).astype(np.int32)).to(dev)
        k2 = torch.from_numpy(rng.integers(0, 2**31 - 1, size=(rows, width))
                              .astype(np.int32)).to(dev)
        z = (k1.long() << 32) | k2.long()
        bnd = cost.bound(*cost.sort_cost(2, rows, width))
        ab("sort2", "", (rows, width), bnd, *sort_sides((k1, k2)), sort.sort2_plain(k1, k2),
           library=lambda: torch.sort(z, dim=1))
        if (rows, width) in ((256, 256), (256, 2048)):
            ab("sort2", "guard always / kept", (rows, width), bnd, *guard_forms((k1, k2)),
               sort.sort2_plain(k1, k2))

    for width in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768) if "sort3" in kernels else ():
        ks = []
        for _ in range(3):
            k = rng.integers(-3, 3, size=(64, width)).astype(np.int32)
            k[rng.random(k.shape) < 0.05] = 2**31 - 1
            k[rng.random(k.shape) < 0.05] = -(2**31)
            ks.append(torch.from_numpy(k).to(dev))
        ks = tuple(ks)
        plain = sort.sort3_plain(*ks)
        bnd = cost.bound(*cost.sort_cost(3, 64, width))
        ab("sort3", str(sort.sort_geometry(width, 3)[1:]), (64, width), bnd, *sort_sides(ks),
           plain)
        if width in (256, 2048):
            ab("sort3", "guard always / kept", (64, width), bnd, *guard_forms(ks), plain)
        for layout in sort3_layouts(width) if sweep_sort is not None else ():
            held = (sweep_sort.tb_sort3_max_clusters(*layout[:3]) if layout[3] == 1 else None)
            sweep("sort3", f"({held} clusters at once)", (64, width), list(layout),
                  lambda: sort3_with(sweep_sort, ks, layout), plain)

    t0 = time.perf_counter()
    corpus = cs.make_corpus(args.docs if "chain_scan" in kernels else 0, cs.SEED)
    print(f"corpus: {len(corpus)} documents, {time.perf_counter() - t0:.1f} s", flush=True)
    chain_shapes = ((64, 512), (64, 2048), (64, 8192), (64, 32768), (64, 65536))
    for shape in chain_shapes if "chain_scan" in kernels else ():
        for site, passes in cs.site_programs(corpus, shape, dev).items():
            width = tuple(scan._chain_plan(passes)[1][0].shape)
            call = lambda: _flat(scan.chain_scan(passes))  # noqa: E731
            ab("chain_scan", f"{site}@{shape[1]}", width, cost.bound(*cost.chain_cost(passes)),
               on("old", call), on("new", call), _flat(scan.chain_scan_plain(passes)))

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ab.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                   "rows": rows_out}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
