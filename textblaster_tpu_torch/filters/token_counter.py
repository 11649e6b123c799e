"""Token counting step (never filters).

Re-implementation of ``TokenCounter``
(``/root/reference/src/pipeline/token/token_counter.rs:8-43``): loads a
HuggingFace tokenizer at build time, encodes content *with* special tokens,
and stamps ``metadata["token_count"]``.

Loading resolution order (the reference only supports hub fetch,
token_counter.rs:14; this build adds offline paths first since TPU pods are
often egress-less):

1. a local path to a ``tokenizer.json`` file or a directory containing one;
2. a local ``merges.txt`` (GPT-2 byte-level BPE), which needs the native C++
   BPE core; the port has no native core yet, so this route raises;
3. the HuggingFace hub cache / network via ``tokenizers.Tokenizer.from_pretrained``;
4. a vendored stand-in under ``textblaster_tpu_torch/data/tokenizers/<name>/`` —
   an in-repo-trained byte-level BPE shipped so the default config's
   ``TokenCounter(gpt2)`` executes on egress-less machines (see the README
   beside it; hub/cache wins whenever reachable).

A load failure raises ``UnexpectedError("Error in loading tokenizer")`` at
construction, matching the reference's build-time failure surface
(worker_logic.rs:115-122 panics on it).
"""

from __future__ import annotations

import os

from ..data_model import TextDocument
from ..errors import UnexpectedError
from ..executor import ProcessingStep

__all__ = ["TokenCounter"]


class TokenCounter(ProcessingStep):
    name = "TokenCounter"

    def __init__(self, tokenizer_name: str) -> None:
        self._tokenizer = None
        #: True when the in-repo-trained stand-in replaced an unreachable hub
        #: tokenizer: counts then differ from the reference's, and every
        #: document is stamped so divergent runs are identifiable
        #: (ADVICE r4).
        self._standin = False
        try:
            json_path = tokenizer_name
            merges_path = None
            if os.path.isdir(tokenizer_name):
                json_path = os.path.join(tokenizer_name, "tokenizer.json")
                merges_path = os.path.join(tokenizer_name, "merges.txt")
            elif tokenizer_name.endswith("merges.txt"):
                json_path = None
                merges_path = tokenizer_name
            if json_path is not None and os.path.isfile(json_path):
                from tokenizers import Tokenizer

                self._tokenizer = Tokenizer.from_file(json_path)
            elif merges_path is not None and os.path.isfile(merges_path):
                raise UnexpectedError(
                    f"Error in loading tokenizer: {merges_path} needs the native "
                    "BPE core, which is not ported yet; give a tokenizer.json"
                )
            else:
                from tokenizers import Tokenizer

                try:
                    self._tokenizer = Tokenizer.from_pretrained(tokenizer_name)
                except Exception:
                    vendored = os.path.join(
                        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "data",
                        "tokenizers",
                        tokenizer_name,
                        "tokenizer.json",
                    )
                    if not os.path.isfile(vendored):
                        raise
                    import logging

                    logging.getLogger(__name__).warning(
                        "tokenizer %r unavailable from hub/cache; using the "
                        "vendored stand-in at %s (counts differ from the hub "
                        "tokenizer — see its README)",
                        tokenizer_name,
                        vendored,
                    )
                    self._tokenizer = Tokenizer.from_file(vendored)
                    self._standin = True
                    from ..utils.metrics import METRICS

                    METRICS.inc("worker_tokenizer_standin_total")
        except UnexpectedError:
            raise
        except Exception as e:
            raise UnexpectedError("Error in loading tokenizer") from e

    def process(self, document: TextDocument) -> TextDocument:
        try:
            encoding = self._tokenizer.encode(document.content, add_special_tokens=True)
            count = len(encoding.tokens)
        except Exception as e:
            raise UnexpectedError(str(e)) from e
        document.metadata["token_count"] = str(count)
        if self._standin:
            # Not a reference metadata key: deliberately extra so downstream
            # consumers can tell stand-in counts from hub-gpt2 counts.
            document.metadata["token_count_tokenizer"] = "vendored-standin"
        return document
