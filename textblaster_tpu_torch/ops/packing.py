"""Packed document batches for device execution.

The device-side document store (SURVEY.md §7 stage 1): a batch of documents
becomes one dense ``[B, L] int32`` codepoint tensor plus per-document lengths.
Codepoints (UTF-32) rather than UTF-8 bytes are the device representation:
every filter decision is defined over *characters* (char classes, char
counts), so decoding once on the host (a single C-speed ``str.encode``) keeps
the kernels branch-free; the reference's byte-length quirks are recovered on
device from the codepoint values (1/2/3/4-byte UTF-8 width is a pure function
of the codepoint).

Batches are length-bucketed into a small set of static shapes so XLA compiles
one program per bucket (SURVEY.md §5 "ragged data on fixed shapes").
Documents longer than the largest bucket are flagged for the host fallback
path rather than truncated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..data_model import TextDocument

__all__ = [
    "PackedBatch",
    "DEFAULT_BUCKETS",
    "PACK_MARGIN",
    "pack_documents",
    "pack_documents_loop",
    "iter_packed_batches",
]

# Bucket char capacities.  Most CC documents are < 8k chars; the tail gets the
# big bucket and true outliers (>64k chars) fall back to the host oracle.
DEFAULT_BUCKETS: Tuple[int, ...] = (512, 2048, 8192, 32768, 65536)

#: Kernels need a little headroom past the content (e.g. the language-ID
#: stream wraps the text in boundary markers), so a bucket admits documents
#: only up to this many chars below its capacity.
PACK_MARGIN = 4


@dataclass
class PackedBatch:
    """One fixed-shape device batch.

    ``cps``    — ``[B, L] int32`` codepoints, zero-padded past ``lengths``.
    ``lengths`` — ``[B] int32`` document char counts.
    ``valid``  — ``[B] bool``; False rows are padding documents.
    ``docs``   — the host-side documents, index-aligned with rows.
    """

    cps: np.ndarray
    lengths: np.ndarray
    valid: np.ndarray
    docs: List[TextDocument]

    @property
    def batch_size(self) -> int:
        return self.cps.shape[0]

    @property
    def max_len(self) -> int:
        return self.cps.shape[1]


def _encode(text: str) -> np.ndarray:
    if not text:
        return np.empty(0, dtype=np.int32)
    return np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32).astype(np.int32)


def pack_documents_loop(
    docs: Sequence[TextDocument],
    batch_size: int,
    max_len: int,
) -> PackedBatch:
    """Per-document reference packer (one ``str.encode`` per row).

    Kept as the oracle for the vectorized ``pack_documents``: the property
    test asserts both produce byte-identical ``cps/lengths/valid``.
    """
    n = len(docs)
    assert n <= batch_size
    cps = np.zeros((batch_size, max_len), dtype=np.int32)
    lengths = np.zeros(batch_size, dtype=np.int32)
    valid = np.zeros(batch_size, dtype=bool)
    for i, doc in enumerate(docs):
        arr = _encode(doc.content)
        assert arr.shape[0] <= max_len, "over-length document reached the packer"
        cps[i, : arr.shape[0]] = arr
        lengths[i] = arr.shape[0]
        valid[i] = True
    return PackedBatch(cps=cps, lengths=lengths, valid=valid, docs=list(docs))


def pack_documents(
    docs: Sequence[TextDocument],
    batch_size: int,
    max_len: int,
) -> PackedBatch:
    """Pack documents into one ``[batch_size, max_len]`` tensor.

    Rows beyond ``len(docs)`` are zero padding with ``valid=False``.  Callers
    are responsible for routing over-length documents elsewhere.

    Vectorized: one concatenated ``encode("utf-32-le")`` for the whole batch
    (C speed, releases the GIL) plus a boolean-mask scatter, instead of a
    Python-level encode/copy per document.  ``len(str)`` equals the UTF-32
    codepoint count and utf-32-le carries no BOM, so the flat buffer's
    row-major scatter order is exactly the concatenation order.
    """
    n = len(docs)
    assert n <= batch_size
    cps = np.zeros((batch_size, max_len), dtype=np.int32)
    lengths = np.zeros(batch_size, dtype=np.int32)
    valid = np.zeros(batch_size, dtype=bool)
    if n:
        texts = [doc.content for doc in docs]
        counts = np.fromiter((len(t) for t in texts), dtype=np.int64, count=n)
        assert counts.max(initial=0) <= max_len, (
            "over-length document reached the packer"
        )
        flat = np.frombuffer(
            "".join(texts).encode("utf-32-le"), dtype="<u4"
        ).astype(np.int32)
        mask = np.arange(max_len, dtype=np.int64)[None, :] < counts[:, None]
        cps[:n][mask] = flat
        lengths[:n] = counts
        valid[:n] = True
    return PackedBatch(cps=cps, lengths=lengths, valid=valid, docs=list(docs))


def iter_packed_batches(
    docs: Iterator[TextDocument],
    batch_size: int = 256,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    route_fn=None,
    pack_fn=pack_documents,
    geometry=None,
    overflow_flush: int = 64,
) -> Iterator[Tuple[Optional[PackedBatch], List[TextDocument]]]:
    """Group a document stream into per-bucket batches.

    Yields ``(packed_batch, host_fallback_docs)`` pairs.  Documents longer
    than the largest bucket are returned in the fallback list (processed by
    the host oracle); everything else lands in the smallest bucket that fits.
    ``route_fn(doc) -> bool`` marks additional host-oracle documents (e.g.
    dictionary-script or astral rows, ops/pipeline.py): they join the same
    interleaved fallback stream, so their host processing overlaps in-flight
    device batches instead of serializing ahead of the first dispatch; the
    fallback list is flushed every ``overflow_flush`` documents.

    ``geometry`` (an ``ops.geometry.DeviceGeometry``) supersedes
    ``buckets``/``batch_size`` and assigns each bucket its own row count, so
    wide buckets dispatch fewer rows and narrow buckets more — equalizing
    padded-lane volume per dispatch.  Without it, behavior is the uniform
    seed geometry: one ``batch_size`` for every bucket.

    End-of-stream handling: a device program computes every padded row, so
    per-bucket partial flushes waste most of their cost.  Leftovers from all
    buckets are merged (sorted by length) and regrouped greedily: a group
    flushes once it reaches the batch size of the bucket its longest (most
    recent) document needs — with a uniform geometry this degenerates to
    exactly the historical ``batch_size``-sized slices.  Each group is
    packed at the smallest bucket that fits its longest document — one
    near-full batch instead of several near-empty ones.  Every group, however
    small, is packed: the port hands no leftover group to the host oracle.
    """
    if geometry is not None:
        buckets = tuple(geometry.buckets)
        rows_for = {b: geometry.batch_for(b) for b in buckets}
    else:
        buckets = tuple(sorted(buckets))
        rows_for = {b: batch_size for b in buckets}
    margin = PACK_MARGIN
    largest = buckets[-1] - margin
    pending: dict[int, List[TextDocument]] = {b: [] for b in buckets}
    overflow: List[TextDocument] = []

    for doc in docs:
        n_chars = len(doc.content)
        if n_chars > largest or (route_fn is not None and route_fn(doc)):
            overflow.append(doc)
            if len(overflow) >= overflow_flush:
                yield None, overflow
                overflow = []
            continue
        for b in buckets:
            if n_chars <= b - margin:
                pending[b].append(doc)
                if len(pending[b]) >= rows_for[b]:
                    batch_docs, pending[b] = pending[b], []
                    yield pack_fn(
                        batch_docs, batch_size=rows_for[b], max_len=b
                    ), []
                break

    leftovers = [d for b in buckets for d in pending[b]]
    leftovers.sort(key=lambda d: len(d.content))
    group: List[TextDocument] = []
    group_bucket = buckets[0]
    for doc in leftovers:
        need = next(b for b in buckets if len(doc.content) <= b - margin)
        # Ascending lengths mean `need` only grows and (with equalized
        # geometry) its row budget only shrinks; flush when the group
        # already fills the incoming document's budget.
        if group and len(group) >= rows_for[need]:
            yield pack_fn(
                group, batch_size=rows_for[group_bucket], max_len=group_bucket
            ), []
            group = []
        group.append(doc)
        group_bucket = need
        if len(group) >= rows_for[need]:
            yield pack_fn(group, batch_size=rows_for[need], max_len=need), []
            group = []
    if group:
        yield pack_fn(
            group, batch_size=rows_for[group_bucket], max_len=group_bucket
        ), []
    if overflow:
        yield None, overflow
