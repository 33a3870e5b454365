"""CSV/BIN input, pipelined ingestion, and the reference's
``.summary``/``.results`` output."""

from .pipeline import PipelinedBlockSource, streamed_moments
from .readers import (
    FileSource, TruncatedInputError, data_shape, read_bin, read_csv,
    read_data, read_rows, read_summary, write_bin,
)
from .writers import stream_results, write_results, write_summary

__all__ = ["FileSource", "PipelinedBlockSource", "TruncatedInputError",
           "data_shape", "read_bin", "read_csv", "read_data", "read_rows",
           "read_summary", "stream_results", "streamed_moments", "write_bin",
           "write_results", "write_summary"]
