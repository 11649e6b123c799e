"""Language detection filter.

Re-implementation of ``LanguageDetectionFilter``
(``/root/reference/src/pipeline/filters/language_filter.rs:7-94``), backed by
the framework's own statistical model (:mod:`textblaster_tpu.models.langid`)
over the same hardcoded 5-language candidate set.  Reproduces:

* detected language + confidence always stamped into metadata, even on the
  filtered path (language_filter.rs:51-57; SURVEY.md §7 quirk #11);
* unknown ISO codes in ``allowed_languages`` silently dropped
  (language_filter.rs:14-21);
* reason strings verbatim, including the ``{:?}``-quoted language list and the
  reference's "not satified" typo (language_filter.rs:66-77).

Unlike the reference, the detector is built once per process, not per document
(a per-doc hot-path cost called out in SURVEY.md §2.3).
"""

from __future__ import annotations

from typing import List, Sequence

from ..data_model import TextDocument
from ..errors import DocumentFiltered
from ..executor import ProcessingStep
from ..models.langid import ISO_TO_NAME, NAME_TO_ISO, get_model
from .common import rust_float

__all__ = ["LanguageDetectionFilter"]


class LanguageDetectionFilter(ProcessingStep):
    name = "LanguageDetectionFilter"

    def __init__(self, min_confidence: float, allowed_languages: Sequence[str]) -> None:
        self.min_confidence = min_confidence
        # ISO-639-3 codes; unknown codes are dropped like the reference's
        # filter_map (language_filter.rs:14-21).
        self.allowed_languages: List[str] = [
            code for code in allowed_languages if code in ISO_TO_NAME
        ]
        self._model = get_model()

    def process(self, document: TextDocument) -> TextDocument:
        detection = self._model.detect(document.content)

        if detection is None:
            reason = "Language could not be confidently detected"
            raise DocumentFiltered(document, reason)

        lang_name, confidence = detection
        document.metadata["Detected language"] = lang_name
        document.metadata["Detected language confidence"] = rust_float(confidence)

        if NAME_TO_ISO[lang_name] not in self.allowed_languages:
            joined = "; ".join(self.allowed_languages)
            # {:?} on the joined String adds quotes (language_filter.rs:66-69).
            reason = f'Document is not any of the following languages: "{joined}"'
            raise DocumentFiltered(document, reason)

        if confidence < self.min_confidence:
            # "satified" typo preserved from language_filter.rs:75-78.
            reason = (
                f"Language detection confidence is not satified: "
                f"{rust_float(confidence)} < {rust_float(self.min_confidence)}"
            )
            raise DocumentFiltered(document, reason)

        return document
