"""Small DFAs over codepoint rows via associative function composition.

The port's counterpart of ``textblaster_tpu/ops/dfa.py``.  A DFA step is a
per-char transition map; runs of steps compose associatively, so a row is
evaluated with one scan.  Automata of at most 8 states use nibble-packed
maps composed by :func:`..ops.scan.dfa_compose_scan` (the CUDA kernel on the
card); larger automata keep the gather composition in plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import assoc_scan1, const_i32, latch_scan, use_sort_tables
from .scan import dfa_compose_scan

__all__ = ["dfa_packed_fns", "dfa_states", "citation_spans"]


def dfa_packed_fns(char_classes: torch.Tensor, transition: np.ndarray) -> torch.Tensor:
    """Nibble-packed per-char transition maps for a <= 8-state DFA (state
    ``s``'s successor in bits ``4s..4s+3``), int32 ``[B, L]``."""
    n_states = transition.shape[1]
    if n_states > 8:
        raise ValueError("packed DFA maps require <= 8 states")
    packed_rows = np.zeros(transition.shape[0], dtype=np.int64)
    for s in range(n_states):
        packed_rows |= transition[:, s].astype(np.int64) << (4 * s)
    table = const_i32(packed_rows.astype(np.uint32).view(np.int32), char_classes.device)
    return table[char_classes.long()]


def dfa_states(
    char_classes: torch.Tensor, transition: np.ndarray, start_state: int = 0
) -> torch.Tensor:
    """Inclusive per-position DFA state along axis 1.

    ``char_classes`` is ``[B, L]`` with per-char input symbols in ``[0, S)``,
    ``transition`` an ``[S, N]`` numpy table (next state per symbol and
    state).  Returns the int32 state *after* consuming each char.
    """
    n_states = transition.shape[1]
    if n_states <= 8:
        fns = dfa_packed_fns(char_classes, transition).contiguous()
        packed = dfa_compose_scan(fns, n_states)
        return (packed >> (4 * start_state)) & 15

    table = torch.as_tensor(np.asarray(transition, dtype=np.int32)).to(char_classes.device)
    fns = table[char_classes.long()]  # [B, L, N]

    def compose(a, b):
        # Apply a then b: (b . a)(s) = b[a[s]].
        return torch.gather(b, -1, a.long())

    ident = torch.arange(n_states, dtype=torch.int32, device=char_classes.device)
    composed = assoc_scan1(compose, ident, fns)
    return composed[..., start_state]


# Citation DFA symbols: 0=other, 1='[', 2=digit, 3=',', 4=space, 5=']'.
# States: 0=dead/outside, 1=after '[', 2=in digits, 3=after comma (spaces ok),
# 4=accept (just consumed ']' after digits).
_CIT_N = 5
_CIT_T = np.zeros((6, _CIT_N), dtype=np.int32)
_CIT_T[0, :] = 0
_CIT_T[1, :] = 1
_CIT_T[2, :] = [0, 2, 2, 2, 0]
_CIT_T[3, :] = [0, 0, 3, 0, 0]
_CIT_T[4, :] = [0, 0, 0, 3, 0]
_CIT_T[5, :] = [0, 0, 4, 0, 0]


def citation_spans(
    cps: torch.Tensor, digit_mask: torch.Tensor, ws_mask: torch.Tensor
) -> torch.Tensor:
    """Deletion mask for Wikipedia-style citations ``[1]``, ``[2, 3]``: the
    reference regex ``\\[\\d+(?:,\\s*\\d+)*\\]`` over each row, as a
    ``[B, L] bool`` mask of every char inside a match (brackets included)."""
    sym = torch.zeros_like(cps)
    sym = torch.where(digit_mask, 2, sym)
    sym = torch.where(cps == ord("["), 1, sym)
    sym = torch.where(cps == ord(","), 3, sym)
    sym = torch.where(ws_mask & (sym == 0), 4, sym)
    sym = torch.where(cps == ord("]"), 5, sym)

    states = dfa_states(sym, _CIT_T)
    accept = states == 4  # position of each closing ']'

    b, length = cps.shape
    positions = torch.arange(length, dtype=torch.int32, device=cps.device)[None, :]
    lb_pos = torch.where(cps == ord("["), positions, -1).to(torch.int32)
    last_lb = assoc_scan1(torch.maximum, -1, lb_pos)

    if use_sort_tables():
        # Scatter-free span fill: position p is inside a span iff the
        # nearest accept at/after p opened at or before p.
        start1 = torch.where(accept, last_lb + 1, 0).to(torch.int32)
        na = torch.flip(
            latch_scan(torch.flip(start1, (1,)), torch.flip(accept, (1,))), (1,)
        )
        return (na > 0) & (positions >= na - 1)

    rows = torch.arange(b, dtype=torch.int64, device=cps.device)[:, None]
    trash = b * (length + 1)
    flat_start = torch.where(accept, rows * (length + 1) + last_lb, trash)
    flat_end = torch.where(accept, rows * (length + 1) + positions + 1, trash)
    flat = torch.zeros(trash + 1, dtype=torch.int32, device=cps.device)
    flat.index_add_(0, flat_start.reshape(-1), accept.to(torch.int32).reshape(-1))
    flat.index_add_(0, flat_end.reshape(-1), -accept.to(torch.int32).reshape(-1))
    diff = flat[:-1].reshape(b, length + 1)
    return torch.cumsum(diff[:, :length], dim=1, dtype=torch.int32) > 0
