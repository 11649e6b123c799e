"""Host-path pipeline executor.

Re-design of the reference executor (``/root/reference/src/executor.rs:8-70``):
``ProcessingStep`` is the op interface and ``PipelineExecutor`` threads a
document through the ordered steps, wrapping any failure in :class:`StepError`
naming the step and short-circuiting (executor.rs:30-57).

Architecture note: the reference makes steps ``async`` because its workers
interleave broker I/O with compute; here the host path is synchronous (the
throughput path is the compiled TPU pipeline in
:mod:`textblaster_tpu.ops.pipeline`, where "steps" are fused into one XLA
program and short-circuiting becomes mask intersection — see SURVEY.md §7
stage 3).  This host executor is the parity oracle and the fallback for
documents the device path cannot handle.

``run_batch`` returns results in *input order* — deliberately not inheriting
the reference's completion-order quirk (executor.rs:60-70; SURVEY.md §7
behavioral quirk #12).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Union

from .data_model import TextDocument
from .errors import PipelineError, StepError, UnexpectedError

__all__ = ["ProcessingStep", "PipelineExecutor"]


class ProcessingStep:
    """One pipeline op (reference ``executor.rs:8-15``).

    Subclasses set :attr:`name` and implement :meth:`process`, which either
    returns the (possibly mutated) document or raises a
    :class:`~textblaster_tpu.errors.PipelineError` —
    :class:`~textblaster_tpu.errors.DocumentFiltered` to drop the document.
    """

    name: str = "ProcessingStep"

    def process(self, document: TextDocument) -> TextDocument:
        raise NotImplementedError


class PipelineExecutor:
    """Ordered step list + short-circuiting runner (executor.rs:17-70)."""

    def __init__(self, steps: Sequence[ProcessingStep]):
        self.steps: List[ProcessingStep] = list(steps)

    def run_single(self, document: TextDocument) -> TextDocument:
        """Thread one document through every step (executor.rs:30-57).

        Any step failure is wrapped as ``StepError(step_name, source)`` and
        propagated immediately.
        """
        current = document
        for step in self.steps:
            try:
                current = step.process(current)
            except PipelineError as e:
                raise StepError(step.name, e) from e
            except Exception as e:  # non-pipeline bugs surface as Unexpected
                raise StepError(step.name, UnexpectedError(str(e))) from e
        return current

    def run_batch(
        self, documents: Iterable[TextDocument]
    ) -> List[Union[TextDocument, StepError]]:
        """Run many documents; per-document results in input order."""
        out: List[Union[TextDocument, StepError]] = []
        for doc in documents:
            try:
                out.append(self.run_single(doc))
            except StepError as e:
                out.append(e)
        return out
