"""Reader/writer interfaces (reference ``readers/base_reader.rs:4-6`` and
``writers/base_writer.rs:5-11``)."""

from __future__ import annotations

from typing import Iterator, Sequence, Union

from ..data_model import TextDocument
from ..errors import PipelineError

__all__ = ["BaseReader", "BaseWriter"]


class BaseReader:
    """Yields per-row ``TextDocument`` or ``PipelineError`` results —
    mirroring the reference's ``Iterator<Item = Result<TextDocument>>``."""

    def read_documents(self) -> Iterator[Union[TextDocument, PipelineError]]:
        raise NotImplementedError


class BaseWriter:
    def write_batch(self, documents: Sequence[TextDocument]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError
