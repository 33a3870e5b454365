"""CSV/BIN input and the reference's ``.summary``/``.results`` output."""

from .readers import TruncatedInputError, read_bin, read_csv, read_data, write_bin
from .writers import stream_results, write_results, write_summary

__all__ = ["TruncatedInputError", "read_bin", "read_csv", "read_data",
           "write_bin", "stream_results", "write_results", "write_summary"]
