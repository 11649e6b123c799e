"""Entry points of a compile check and a multi-device dry run.

The port's counterpart of the repo root's ``__graft_entry__.py``:

* :func:`entry` returns the flagship device function — the full Danish
  cleaning pipeline (langid + gopher repetition/quality + C4 + FineWeb) as
  one function over a packed code point batch — with example arguments.
* :func:`dryrun_multichip` builds an ``n``-entry ``data`` mesh, runs every
  phase function of the same pipeline over it on a batch of 8 rows an
  entry, and materializes every output.

Both run on ``cuda`` unless the caller passes ``device="cpu"``.  The dry
run stays in this process: JAX forces a host device count in a fresh
subprocess, and a torch mesh may simply repeat a device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]

_PIPELINE_YAML = """
pipeline:
  - type: LanguageDetectionFilter
    min_confidence: 0.65
    allowed_languages: [ "dan" ]
  - type: GopherRepetitionFilter
    dup_line_frac: 0.3
    dup_para_frac: 0.3
    dup_line_char_frac: 0.2
    dup_para_char_frac: 0.2
    top_n_grams: [[2, 0.2], [3, 0.18], [4, 0.16]]
    dup_n_grams: [[5, 0.15], [6, 0.14], [7, 0.13], [8, 0.12], [9, 0.11], [10, 0.10]]
  - type: GopherQualityFilter
    min_doc_words: 50
    max_doc_words: 100000
    min_avg_word_length: 3.0
    max_avg_word_length: 10.0
    max_symbol_word_ratio: 0.1
    max_bullet_lines_ratio: 0.9
    max_ellipsis_lines_ratio: 0.3
    max_non_alpha_words_ratio: 0.8
    min_stop_words: 2
    stop_words: [ "og", "er", "det", "en", "vi", "at", "den", "i" ]
  - type: C4QualityFilter
    split_paragraph: true
    remove_citations: true
    filter_no_terminal_punct: true
    min_num_sentences: 5
    min_words_per_line: 3
    max_word_length: 1000
    filter_lorem_ipsum: true
    filter_javascript: true
    filter_curly_bracket: true
    filter_policy: true
  - type: FineWebQualityFilter
    line_punct_thr: 0.12
    line_punct_exclude_zero: false
    short_line_thr: 0.67
    short_line_length: 30
    char_duplicates_ratio: 0.01
    new_line_ratio: 0.3
"""

_SAMPLE_DOCS = [
    "Det er en rigtig god dag i dag, og vi skal ud at gå en lang tur i skoven. "
    "Solen skinner over byen, og der er mange mennesker på gaden i dag. "
    "Efter turen vil vi gerne drikke en kop kaffe og spise lidt brød hjemme. "
    "Det bliver en dejlig eftermiddag, fordi vejret er så godt i dag. "
    "Om aftenen skal vi lave mad sammen og se en god film i stuen.",
    "This is an English document about the weather and the people of the town.",
    "Samme linje her.\n" * 8,
    "Kort tekst.",
]

#: Rows of the compile check's batch, and of each mesh entry's shard.
ROWS = 8
BUCKET = 512


def _config():
    from .config.pipeline import parse_pipeline_config

    return parse_pipeline_config(_PIPELINE_YAML)


def _packed_example(batch_size: int, max_len: int):
    from .data_model import TextDocument
    from .ops.packing import pack_documents

    docs = [
        TextDocument(id=f"d{i}", source="s", content=_SAMPLE_DOCS[i % len(_SAMPLE_DOCS)])
        for i in range(batch_size)
    ]
    return pack_documents(docs, batch_size=batch_size, max_len=max_len)


def entry(device=None) -> Tuple[Callable[..., Dict[str, torch.Tensor]], Tuple[torch.Tensor, ...]]:
    """``(fn, example_args)``: the flagship pipeline's one device function
    (``phase_split`` off, so the check covers every step, not only the
    first phase) at bucket 512, and an 8-row packed batch on the
    pipeline's device as int32 ``(cps [8, 512], lengths [8])``."""
    from .ops.pipeline import CompiledPipeline

    pipeline = CompiledPipeline(
        _config(), buckets=(BUCKET,), batch_size=ROWS, device=device, phase_split=False
    )
    fn = pipeline._fn_for(BUCKET)
    batch = _packed_example(ROWS, BUCKET)
    dev = pipeline.device
    example_args = (
        torch.from_numpy(np.ascontiguousarray(batch.cps, dtype=np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(batch.lengths, dtype=np.int32)).to(dev),
    )
    return fn, example_args


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> None:
    """One step of every phase function of the flagship pipeline over an
    ``n_devices``-entry mesh, 8 rows an entry, every output materialized
    on the host; prints one line.  The entries cycle over every visible
    GPU (``device=None``) or repeat ``device`` (``"cpu"`` on the CPU)."""
    from .ops.pipeline import CompiledPipeline
    from .parallel.mesh import data_mesh

    if n_devices < 1:
        raise ValueError(f"dryrun_multichip: {n_devices} devices")
    pool = list(data_mesh().devices) if device is None else [device]
    mesh = data_mesh([pool[i % len(pool)] for i in range(n_devices)])
    batch_size = ROWS * n_devices
    pipeline = CompiledPipeline(_config(), buckets=(BUCKET,), batch_size=batch_size, mesh=mesh)
    assert pipeline.batch_size == batch_size, pipeline.geometry.describe()
    batch = _packed_example(batch_size, BUCKET)
    # Mesh runs are phased: every phase function runs over the mesh, each
    # on the whole batch.
    n_keys = 0
    for phase in range(len(pipeline.phases)):
        out, _, _ = pipeline.run_batch(batch, phase)
        bad = {k: v.shape for k, v in out.items() if v.shape[0] != batch_size}
        if bad:
            raise RuntimeError(f"dryrun_multichip: outputs without {batch_size} rows: {bad}")
        n_keys += len(out)
    if n_keys == 0:
        raise RuntimeError("dryrun_multichip: no stat outputs")
    print(
        f"dryrun_multichip OK: {n_devices}-device mesh "
        f"({', '.join(str(d) for d in mesh.devices)}), batch {batch_size}, "
        f"{len(pipeline.phases)} phases, {n_keys} stat outputs",
        flush=True,
    )
