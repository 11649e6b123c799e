"""Row-wise inclusive scans: the affine-hash scan and the DFA-composition scan.

The port's counterpart of the per-scan half of the JAX package's
``textblaster_tpu/ops/pallas_scan.py`` (``affine_hash_scan``,
``dfa_compose_scan``; their Pallas kernel is ``_pallas_scan_tuple``).  On a
CUDA tensor each wrapper launches its hand-written kernel
(``csrc/scan.cu``) or raises; on a CPU tensor it runs the plain PyTorch
version beside it, which follows the Hillis–Steele shift schedule of the
JAX ops (``_affine_op``, ``_dfa_op``).  Every schedule gives the same int32
result by integer associativity, so the two agree bit for bit.

``LAUNCHES`` counts kernel launches per kernel; only a launch on the card
adds to it.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .device import shift_scan_tuple

__all__ = [
    "LAUNCHES",
    "affine_hash_scan",
    "affine_hash_scan_plain",
    "dfa_compose_scan",
    "dfa_compose_scan_plain",
    "dfa_ident",
]

#: Kernel launches on the card, by kernel name.
LAUNCHES: Dict[str, int] = {"affine_scan": 0, "dfa_scan": 0}


def _affine_op(xs, ys):
    # h -> m*h + a composed earlier-then-later (pallas_scan._affine_op).
    mx, axs = xs[0], xs[1:]
    my, ays = ys[0], ys[1:]
    return (mx * my,) + tuple(ay + my * ax for ax, ay in zip(axs, ays))


def _dfa_op(n_states: int):
    def op(xs, ys):
        # (b . a)(s) = b[a[s]] over nibble-packed maps (pallas_scan._dfa_op).
        a, b = xs[0], ys[0]
        out = None
        for s in range(n_states):
            nib = (a >> (4 * s)) & 15
            term = ((b >> (nib << 2)) & 15) << (4 * s)
            out = term if out is None else out | term
        return (out,)

    return op


def dfa_ident(n_states: int) -> int:
    """The identity map: nibble ``s`` holds ``s``."""
    ident = 0
    for s in range(n_states):
        ident |= s << (4 * s)
    return ident


def affine_hash_scan_plain(
    m: torch.Tensor, accs: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch affine-hash scan (shift schedule)."""
    xs = (m.to(torch.int32),) + tuple(a.to(torch.int32) for a in accs)
    identities = (1,) + (0,) * len(accs)
    return shift_scan_tuple(_affine_op, identities, xs)[1:]


def dfa_compose_scan_plain(fns: torch.Tensor, n_states: int) -> torch.Tensor:
    """Plain PyTorch DFA-composition scan (shift schedule)."""
    (out,) = shift_scan_tuple(
        _dfa_op(n_states), (dfa_ident(n_states),), (fns.to(torch.int32),)
    )
    return out


def _check(name: str, ts: Sequence[torch.Tensor]) -> None:
    ref = ts[0]
    for t in ts:
        if t.device != ref.device:
            raise ValueError(f"{name}: operands on different devices")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if t.dim() != 2 or t.shape != ref.shape:
            raise ValueError(f"{name}: expected equal [rows, len] operands")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if ref.shape[0] > 2**31 - 1 or ref.shape[1] > 2**31 - 1:
        raise ValueError(f"{name}: shape {tuple(ref.shape)} too large")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def affine_hash_scan(
    m: torch.Tensor, accs: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of the shared-multiplier affine hash op along axis 1:
    returns the scanned accumulator streams (1 or 2 of them; the scanned
    multiplier is internal).  All operands are contiguous int32
    ``[rows, len]`` tensors on one device; any shape is taken."""
    accs = tuple(accs)
    if m.device.type == "cpu":
        return affine_hash_scan_plain(m, accs)
    if m.device.type != "cuda":
        raise ValueError(f"affine_hash_scan: unsupported device {m.device}")
    if len(accs) not in (1, 2):
        raise ValueError("affine_hash_scan: the kernel takes 1 or 2 accumulators")
    _check("affine_hash_scan", (m,) + accs)
    from ..kernels.build import check, load

    lib = load("scan")
    outs = tuple(torch.empty_like(a) for a in accs)
    rows, length = m.shape
    with torch.cuda.device(m.device):
        err = lib.tb_affine_scan(
            m.data_ptr(),
            accs[0].data_ptr(),
            accs[1].data_ptr() if len(accs) == 2 else None,
            outs[0].data_ptr(),
            outs[1].data_ptr() if len(accs) == 2 else None,
            rows,
            length,
            len(accs),
            _stream(m),
        )
    check(err, "affine_hash_scan")
    LAUNCHES["affine_scan"] += 1
    return outs


def dfa_compose_scan(fns: torch.Tensor, n_states: int) -> torch.Tensor:
    """Inclusive scan of nibble-packed DFA transition maps along axis 1, for
    ``n_states`` <= 8.  ``fns`` is a contiguous int32 ``[rows, len]``
    tensor whose nibbles hold states below ``n_states``."""
    if fns.device.type == "cpu":
        return dfa_compose_scan_plain(fns, n_states)
    if fns.device.type != "cuda":
        raise ValueError(f"dfa_compose_scan: unsupported device {fns.device}")
    if not 1 <= n_states <= 8:
        raise ValueError("dfa_compose_scan: the kernel takes 1..8 states")
    _check("dfa_compose_scan", (fns,))
    from ..kernels.build import check, load

    lib = load("scan")
    out = torch.empty_like(fns)
    rows, length = fns.shape
    with torch.cuda.device(fns.device):
        err = lib.tb_dfa_scan(
            fns.data_ptr(), out.data_ptr(), rows, length, n_states, _stream(fns)
        )
    check(err, "dfa_compose_scan")
    LAUNCHES["dfa_scan"] += 1
    return out
