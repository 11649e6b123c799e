"""Device mesh and row sharding for the device pipeline.

The port's counterpart of ``textblaster_tpu/parallel/mesh.py``.  The JAX
package shards each packed batch along the ``data`` axis of a
``jax.sharding.Mesh``; one compiled program runs on every chip over its
rows, and the integer stat outputs are gathered back to the host.  Here a
mesh is an ordered tuple of ``torch.device``s along the same axis: shard
*i* of a batch of ``B`` rows is the contiguous rows ``[i*B/n, (i+1)*B/n)``
(the layout ``NamedSharding(mesh, P("data"))`` gives), uploaded to entry
*i*'s device, and the phase function runs there on a stream of that
device.  Every statistic is per row, so no collective is needed: the
gather is a concatenation along dim 0 in shard order.

A mesh may name one device more than once (each entry is a shard with a
stream of its own): torch has one CPU device, so the CPU tests and a
one-GPU machine still run N shards, as the JAX tests force N host devices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["DATA_AXIS", "DataMesh", "data_mesh", "gather_stats", "shard_batch",
           "shard_rows", "to_device"]

DATA_AXIS = "data"


class DataMesh:
    """An ordered, immutable 1-D mesh of devices along :data:`DATA_AXIS`.
    Every entry is ``cpu`` or every entry is an indexed ``cuda`` device."""

    __slots__ = ("_devices",)

    def __init__(self, devices: Sequence[torch.device]) -> None:
        object.__setattr__(self, "_devices", tuple(devices))

    def __setattr__(self, name, value):
        raise AttributeError("a DataMesh is immutable")

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return self._devices

    @property
    def size(self) -> int:
        """Entries (shards a batch splits into), as the JAX ``mesh.devices.size``."""
        return len(self._devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, DataMesh) and other._devices == self._devices

    def __hash__(self) -> int:
        return hash(self._devices)

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self._devices]})"


def _normalize(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"data_mesh: unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"data_mesh: {dev} named, but CUDA is not available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(
            f"data_mesh: {dev} is not one of the {torch.cuda.device_count()} visible GPUs"
        )
    # "cuda" and "cuda:0" are one device (and one key of every device cache).
    return torch.device("cuda", index)


def data_mesh(devices: Optional[Sequence] = None) -> DataMesh:
    """1-D mesh over every visible CUDA device, or over ``devices`` in their
    order (repeats allowed).  No CPU fallback: it raises with no CUDA
    device to default to, on an empty list, on a list mixing ``cpu`` and
    ``cuda`` entries, and on a ``cuda`` entry when CUDA is absent."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "data_mesh: CUDA is not available; pass the devices "
                "(e.g. ['cpu', 'cpu']) to shard on the CPU"
            )
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [_normalize(d) for d in devices]
    if not devs:
        raise ValueError("data_mesh: no devices")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"data_mesh: mixed device types {[str(d) for d in devs]}")
    return DataMesh(devs)


def shard_rows(mesh: DataMesh, n_rows: int) -> List[Tuple[int, int]]:
    """Shard *i*'s rows ``[lo, hi)``: ``[i*B/n, (i+1)*B/n)`` for ``B =
    n_rows`` and ``n = mesh.size``.  ``B`` must be a multiple of ``n`` (the
    pipeline rounds every batch size to one)."""
    n = mesh.size
    if n_rows % n:
        raise ValueError(f"shard_rows: {n_rows} rows do not split over {n} shards")
    per = n_rows // n
    return [(i * per, (i + 1) * per) for i in range(n)]


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``: pinned and copied ``non_blocking`` on the
    current stream of a CUDA device; as it is on the CPU."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def shard_batch(
    mesh: DataMesh, cps, lengths
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each shard's ``(cps, lengths)`` rows on its own device (the
    counterpart of the JAX ``shard_batch``), uploaded on each device's
    current stream."""
    cps_h = torch.as_tensor(np.ascontiguousarray(cps))
    len_h = torch.as_tensor(np.ascontiguousarray(lengths))
    return [
        (to_device(cps_h[lo:hi], dev), to_device(len_h[lo:hi], dev))
        for dev, (lo, hi) in zip(mesh.devices, shard_rows(mesh, cps_h.shape[0]))
    ]


def gather_stats(shards: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The shards' host stats as one batch's: every key concatenated along
    dim 0, in shard order."""
    if len(shards) == 1:
        return dict(shards[0])
    return {k: np.concatenate([s[k] for s in shards], axis=0) for k in shards[0]}
