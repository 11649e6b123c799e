"""State carried across from the JAX package: the lookup tables.

The pipeline has no trained weights; its state is three tables — the
codepoint class table, the lowercase table and the language model's
quantized ``[65536, 5]`` log-prob table.  The port builds all three itself
with the same numpy builders (:func:`own_tables`).  :func:`tables_from_numpy`
turns the JAX package's numpy arrays (``device._class_table_np()``,
``device._lower_table_np()``, ``get_model().table_q``) into the port's
tensors on a device, so a test can show the two sets are equal and feed
both sides identical tables.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Tables", "tables_from_numpy", "own_tables"]


class Tables(NamedTuple):
    class_table: torch.Tensor  # [0x40000] uint8
    lower_table: torch.Tensor  # [0x40000] int32
    table_q: torch.Tensor  # [65536, 5] int32


def tables_from_numpy(class_table, lower_table, table_q, device="cpu") -> Tables:
    """The port's tensors for three numpy tables, on ``device``."""

    def conv(a, dtype):
        arr = np.ascontiguousarray(np.asarray(a, dtype=dtype))
        return torch.from_numpy(arr).to(device)

    return Tables(
        class_table=conv(class_table, np.uint8),
        lower_table=conv(lower_table, np.int32),
        table_q=conv(table_q, np.int32),
    )


def own_tables(device="cpu") -> Tables:
    """The tables the port builds and uses itself, on ``device``."""
    from .models.langid import get_model
    from .ops.device import _class_table_np, _lower_table_np

    return tables_from_numpy(
        _class_table_np(), _lower_table_np(), get_model().table_q, device
    )
