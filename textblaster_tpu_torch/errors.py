"""Error taxonomy for the pipeline.

Mirrors the reference's ``PipelineError`` enum (``/root/reference/src/error.rs:9-61``)
including the load-bearing control-flow trick: a filter signaling "drop this
document" raises :class:`DocumentFiltered` carrying the (mutated) document and a
human-readable reason; the executor wraps any step failure in :class:`StepError`
naming the step (reference ``error.rs:39-43``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover
    from .data_model import TextDocument

__all__ = [
    "PipelineError",
    "ConfigError",
    "ConfigValidationError",
    "IoError",
    "ParquetError",
    "DocumentFiltered",
    "StepError",
    "QueueError",
    "SerializationError",
    "UnexpectedError",
    "CheckpointError",
    "RetryExhaustedError",
    "StallError",
    "PeerFailure",
    "GangReformed",
    "ReformationFailed",
]


class PipelineError(Exception):
    """Base class for every pipeline error (reference ``error.rs:10``)."""


class ConfigError(PipelineError):
    """Configuration error, e.g. unreadable/unparseable config file
    (reference ``error.rs:11-12``)."""

    def __str__(self) -> str:
        return f"Configuration error: {self.args[0] if self.args else ''}"


class ConfigValidationError(PipelineError):
    """Configuration validation error (reference ``error.rs:55-56``)."""

    def __str__(self) -> str:
        return f"Configuration validation error: {self.args[0] if self.args else ''}"


class IoError(PipelineError):
    """I/O error (reference ``error.rs:14-18``)."""


class ParquetError(PipelineError):
    """Parquet read/write error (reference ``error.rs:20-30``, merging the
    Parquet and Arrow variants — pyarrow has a single error surface)."""


class DocumentFiltered(PipelineError):
    """A step decided to drop the document (reference ``error.rs:33-37``).

    Carries the document *as mutated by the step* (status/reason metadata is
    stamped before raising — quirk #1 in SURVEY.md §7) plus the reason string
    that ends up in the excluded-file metadata and outcome.
    """

    def __init__(self, document: "TextDocument", reason: str) -> None:
        super().__init__(reason)
        self.document = document
        self.reason = reason

    def __str__(self) -> str:
        return f"Document '{self.document.id}' filtered out: {self.reason}"


class StepError(PipelineError):
    """A pipeline step failed; wraps the underlying error with the step name
    (reference ``error.rs:39-43``)."""

    def __init__(self, step_name: str, source: PipelineError) -> None:
        super().__init__(step_name, source)
        self.step_name = step_name
        self.source = source

    def __str__(self) -> str:
        return f"Error in processing step '{self.step_name}': {self.source}"

    def filtered(self) -> Optional[DocumentFiltered]:
        """Return the inner DocumentFiltered if this StepError wraps one."""
        return self.source if isinstance(self.source, DocumentFiltered) else None


class QueueError(PipelineError):
    """Result/feed transport error (reference ``error.rs:46-47``; in this
    framework the 'queue' is the host<->device feed/collective path)."""

    def __str__(self) -> str:
        return f"Queueing system error: {self.args[0] if self.args else ''}"


class SerializationError(PipelineError):
    """JSON (de)serialization error (reference ``error.rs:49-53``)."""


class UnexpectedError(PipelineError):
    """Catch-all (reference ``error.rs:58-59``)."""

    def __str__(self) -> str:
        return f"Unexpected error: {self.args[0] if self.args else ''}"


class CheckpointError(PipelineError):
    """Checkpoint/resume cursor error (no reference equivalent — the
    reference has no checkpointing, SURVEY.md §5)."""

    def __str__(self) -> str:
        return f"Checkpoint error: {self.args[0] if self.args else ''}"


class PeerFailure(PipelineError):
    """A multi-host exchange could not complete because of peer processes
    (no reference equivalent — the reference's workers are independent).

    Raised instead of hanging when a lockstep exchange's deadline expires
    (a peer never posted its row) or a peer posts malformed data.  Carries
    the exchange coordinates (``seq``, ``epoch``) and the rank lists so
    operators and supervisors can act on *which* process failed:
    ``dead_ranks`` are peers whose liveness lease had already expired when
    the deadline hit; ``missing_ranks`` are all peers that never posted
    (dead or merely slow).
    """

    def __init__(
        self,
        message: str,
        *,
        missing_ranks=(),
        dead_ranks=(),
        seq: Optional[int] = None,
        epoch: Optional[int] = None,
    ) -> None:
        super().__init__(message)
        self.missing_ranks = tuple(missing_ranks)
        self.dead_ranks = tuple(dead_ranks)
        self.seq = seq
        self.epoch = epoch

    def __str__(self) -> str:
        return f"Peer failure: {self.args[0] if self.args else ''}"


class GangReformed(PipelineError):
    """The gang reformed around dead peer(s); the interrupted exchange must
    be replayed over the survivor set (no reference equivalent).

    Raised by the file-lease exchange transport under ``--survive-peer-loss``
    *after* a successful reformation: the dead ranks' incarnations are
    fenced, the survivor set is elected, and both the membership and
    exchange epochs are bumped.  This is a control-flow signal, not a
    terminal failure — callers catch it at a round/phase boundary, trim to
    the resolved prefix, and re-enter the lockstep loop over ``members``.
    """

    def __init__(
        self,
        message: str,
        *,
        members=(),
        dead_ranks=(),
        epoch: Optional[int] = None,
    ) -> None:
        super().__init__(message)
        self.members = tuple(members)
        self.dead_ranks = tuple(dead_ranks)
        self.epoch = epoch

    def __str__(self) -> str:
        return f"Gang reformed: {self.args[0] if self.args else ''}"


class ReformationFailed(PipelineError):
    """The gang could not reform after a peer loss (no reference
    equivalent).

    Terminal, unlike :class:`GangReformed`: raised when the election never
    converges within its attempt budget, when this process finds its own
    incarnation fenced (it was suspected dead by a peer — continuing would
    risk split-brain), or when the last survivor fails its own liveness
    self-check (lease lost or heartbeat dead) so there is no gang left to
    reform.  Survivors exit typed instead of hanging on a dead exchange.
    """

    def __init__(self, message: str, *, rank: Optional[int] = None) -> None:
        super().__init__(message)
        self.rank = rank

    def __str__(self) -> str:
        return f"Gang reformation failed: {self.args[0] if self.args else ''}"


class RetryExhaustedError(PipelineError):
    """A guarded seam kept failing with transient faults until the retry
    budget ran out (no reference equivalent — the reference leans on broker
    redelivery).  Carries the seam name and the last underlying error; the
    inner message is preserved verbatim so transient-fault markers (e.g.
    ``RESOURCE_EXHAUSTED``) stay visible to the degradation ladder."""

    def __init__(self, seam: str, attempts: int, last: BaseException) -> None:
        super().__init__(seam, attempts, last)
        self.seam = seam
        self.attempts = attempts
        self.last = last

    def __str__(self) -> str:
        return (
            f"Retries exhausted at seam '{self.seam}' after {self.attempts} "
            f"attempt(s); last error: {self.last}"
        )


class StallError(PipelineError):
    """A host-side stage exceeded its watchdog deadline without making
    progress (no reference equivalent — the reference's broker consumers
    rely on AMQP heartbeats).

    Raised by the stall watchdog instead of blocking forever when a
    deadline-bounded wait (device fetch, pack-pool future, write-behind
    queue, reader prefetch) stops progressing.  Carries the stage name,
    how long the wait had been pending, and the deadline that expired, so
    operators see *where* the pipeline wedged rather than a silent hang.
    Classified retryable: a device-fetch stall descends the ordinary
    retry → split-half → host-oracle ladder, and on the lockstep path
    converts to a local fault verdict so the gang drains the window
    jointly instead of riding the exchange deadline to gang death.
    """

    def __init__(
        self,
        stage: str,
        *,
        elapsed_s: float,
        deadline_s: float,
        detail: str = "",
    ) -> None:
        super().__init__(stage, elapsed_s, deadline_s, detail)
        self.stage = stage
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s
        self.detail = detail

    def __str__(self) -> str:
        extra = f" ({self.detail})" if self.detail else ""
        return (
            f"Stage '{self.stage}' stalled: no progress after "
            f"{self.elapsed_s:.1f}s (deadline {self.deadline_s:.1f}s){extra}"
        )
