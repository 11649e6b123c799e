"""Host-path processing steps (the parity oracle for the TPU kernel library).

Each filter reproduces the decision logic, metadata stamping, and reason-string
formats of its reference counterpart under
``/root/reference/src/pipeline/filters/`` bit-for-bit.  The TPU kernels in
:mod:`textblaster_tpu.ops` are validated against these implementations.
"""

from .c4_badwords import C4BadWordsFilter
from .c4_quality import C4QualityFilter
from .fineweb_quality import FineWebQualityFilter
from .gopher_quality import GopherQualityFilter
from .gopher_repetition import GopherRepetitionFilter
from .language import LanguageDetectionFilter
from .token_counter import TokenCounter

__all__ = [
    "C4QualityFilter",
    "C4BadWordsFilter",
    "FineWebQualityFilter",
    "GopherQualityFilter",
    "GopherRepetitionFilter",
    "LanguageDetectionFilter",
    "TokenCounter",
]
