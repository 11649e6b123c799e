"""The byte and operation model of the hand-written kernels' launches.

One model serves two readers: ``chip_smoke.py``'s bound column (the least
time the card could take for a launch: the larger of its bytes over the
memory rate and its operations over the CUDA-core rate) and the
profiler's shape-determined cost model (:mod:`..utils.profiler`), which
sums these figures over a program's launches.  Every figure is a function
of the launch's shapes and structure alone, never of the data, so it is
the same on every device.

* :func:`scan_cost`: ``affine_scan`` and ``dfa_scan`` (``csrc/scan.cu``);
* :func:`fused_cost`: ``fused_scan`` (``csrc/fused.cu``);
* :func:`chain_cost`: ``chain_scan`` (``csrc/chain.cu``);
* :func:`sort_cost`: ``sort2`` and ``sort3`` (``csrc/sort.cu``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

__all__ = [
    "HBM_BYTES_PER_S",
    "OPS_PER_S",
    "bound",
    "chain_cost",
    "fused_cost",
    "scan_cost",
    "sort_cost",
]

#: H100 SXM HBM3 (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 outside the tensor cores (NVIDIA data sheet); the sheet
#: gives no int32 rate, so the kernels' integer operations are held to it.
OPS_PER_S = 67e12


def bound(n_bytes: float, n_ops: float) -> Dict[str, object]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the integer operations over the CUDA-core rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def scan_cost(kind: str, rows: int, width: int, variant: int) -> Tuple[float, float]:
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


def fused_cost(groups: Sequence[dict]) -> Tuple[float, float]:
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


def chain_cost(passes: Sequence[dict]) -> Tuple[float, float]:
    """(bytes, operations) a chain launch must spend: each external operand
    read once, each emit-"scan" stream written once, each final carry
    written once (taps and workspace streams stay on chip in the bound);
    per element a prep does about one operation per dependency, and the
    scans as in :func:`fused_cost` (a segmented max 3, a copy none)."""
    from .scan import _chain_plan

    _, ext, out_modes, _, _ = _chain_plan(passes)
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


def sort_cost(n_keys: int, rows: int, width: int) -> Tuple[float, float]:
    """(bytes, operations) of one ``sort2`` (``n_keys`` = 2) or ``sort3``
    (3) call on ``[rows, width]`` keys: every int32 key read and written
    once; the bitonic network's width/2 * lg*(lg+1)/2 compare-exchanges a
    row (lg = log2 of the padded width), each a 64-bit compare and two
    selects for two keys (3 operations), a 96-bit compare and two selects
    for three (5)."""
    lg = max(1, (width - 1).bit_length())
    exchanges = rows * (1 << lg) // 2 * lg * (lg + 1) // 2
    return 8.0 * n_keys * rows * width, (3.0 if n_keys == 2 else 5.0) * exchanges
