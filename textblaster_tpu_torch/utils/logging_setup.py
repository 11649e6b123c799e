"""Structured logging: console WARN + daily-rolling JSON file.

Equivalent of the reference's two-layer tracing subscriber
(``src/bin/producer.rs:58-83``, ``bin/worker.rs:53-80``):
console at WARN, JSON lines to ``./log/<name>.log`` with daily rotation, and
the global level taken from an env var (``TEXTBLAST_LOG``, standing in for
``RUST_LOG``).

The port's copy of the JAX package's ``utils/logging_setup.py``, with its
handler that mirrors warnings into the port's operational event journal
(``utils/events.py`` ``JournalLogHandler``).
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
from datetime import datetime, timezone

__all__ = ["init_logging"]


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            # record.created, not now(): format time lags emit time whenever
            # the handler queue backs up, and post-mortem ordering depends
            # on the emit-time stamp.
            "timestamp": datetime.fromtimestamp(
                record.created, timezone.utc
            ).isoformat(),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exception"] = self.formatException(record.exc_info)
        for key in ("doc_id", "step", "worker_id"):
            if hasattr(record, key):
                payload[key] = getattr(record, key)
        return json.dumps(payload, ensure_ascii=False)


def init_logging(name: str, log_dir: str = "./log") -> None:
    level_name = os.environ.get("TEXTBLAST_LOG", "INFO").upper()
    level = getattr(logging, level_name, logging.INFO)

    root = logging.getLogger()
    root.setLevel(level)
    # Drop handlers from any previous init (idempotent for tests).
    for h in list(root.handlers):
        root.removeHandler(h)

    console = logging.StreamHandler()
    console.setLevel(logging.WARNING)
    console.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    root.addHandler(console)

    # WARNING+ records mirror into the operational event journal (kind
    # "log") once EVENTS is armed; the handler self-gates on
    # EVENTS.enabled, so an unarmed run pays one attribute check per
    # warning — not per log call.
    from .events import JournalLogHandler

    root.addHandler(JournalLogHandler())

    try:
        os.makedirs(log_dir, exist_ok=True)
        file_handler = logging.handlers.TimedRotatingFileHandler(
            os.path.join(log_dir, f"{name}.log"), when="midnight", utc=True
        )
        file_handler.setLevel(level)
        file_handler.setFormatter(_JsonFormatter())
        root.addHandler(file_handler)
    except OSError:
        logging.getLogger(__name__).warning(
            "Could not open log file in %s; console only.", log_dir
        )
