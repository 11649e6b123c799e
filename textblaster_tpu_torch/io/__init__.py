"""Columnar I/O: Parquet reader/writer with the reference schema
(``/root/reference/src/pipeline/readers/``, ``writers/``)."""

from .base import BaseReader, BaseWriter
from .parquet_reader import ParquetInputConfig, ParquetReader
from .parquet_writer import OUTPUT_SCHEMA, ParquetWriter

__all__ = [
    "BaseReader",
    "BaseWriter",
    "ParquetInputConfig",
    "ParquetReader",
    "ParquetWriter",
    "OUTPUT_SCHEMA",
]
