"""CSV/BIN input and the reference's ``.summary``/``.results`` output."""

from .readers import (
    FileSource, TruncatedInputError, data_shape, read_bin, read_csv,
    read_data, read_rows, read_summary, write_bin,
)
from .writers import stream_results, write_results, write_summary

__all__ = ["FileSource", "TruncatedInputError", "data_shape", "read_bin",
           "read_csv", "read_data", "read_rows", "read_summary", "write_bin",
           "stream_results", "write_results", "write_summary"]
