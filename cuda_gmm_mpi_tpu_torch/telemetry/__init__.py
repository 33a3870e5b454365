"""Run-scoped observability of the port: event stream, metrics registry,
reporting.

The port's own copy of the JAX package's telemetry package, module for
module: ``schema`` is the wire contract (stream rev v2.8, the same field
tables), ``registry`` the numeric aggregates, ``recorder`` the event bus
with its ambient activation, ``report`` the offline renderer (plus the
``--follow`` live tailer), ``exporter`` the live OpenMetrics endpoint and
resource sampler, ``spans`` the trace-span emission, ``profiling`` the
compile watch (on torch: kernel builds and CUDA-graph captures, and the
caching allocator's watermarks), ``sketch`` the training envelope's
mergeable sketches, ``diff`` the cross-run analytics behind ``gmm diff``
/ ``gmm runs``, and ``timeline`` the Chrome trace export behind ``gmm
timeline``. A stream the port writes validates under either package's
``validate_stream``, and the same stream renders to the same bytes under
either package's ``gmm report``. ``utils.profiling.PhaseTimer`` is a thin
adapter over this package.

Not ported: the JAX package's ``ProfiledExecutable`` (a proxy over a jit
callable; the port has none) and ``drift`` (``gmm drift`` needs the
serving registry).
"""

from .diff import diff_main, runs_main, summarize_run
from .exporter import (MetricsExporter, ResourceSampler, current_exporter,
                       host_rss_bytes, live_plane, render_openmetrics)
from .profiling import CompileWatch, site_compile, watch
from .recorder import (RunRecorder, current, memory_stats, read_stream, use,
                       write_line)
from .registry import MetricsRegistry
from .report import (StreamTailer, follow_stream, render_follow,
                     render_phase_table, render_report, report_main)
from .schema import (EVENT_FIELDS, SCHEMA_VERSION, validate_record,
                     validate_stream)
from .spans import build_span_tree, mint_trace_id, span
from .spans import trace as trace_spans
from .timeline import (build_timeline, fit_alignment, summarize_trace,
                       timeline_main, validate_trace)

__all__ = [
    "RunRecorder", "MetricsRegistry", "current", "use", "write_line",
    "read_stream", "memory_stats",
    "render_phase_table", "render_report", "report_main",
    "StreamTailer", "follow_stream", "render_follow",
    "EVENT_FIELDS", "SCHEMA_VERSION", "validate_record", "validate_stream",
    "MetricsExporter", "ResourceSampler", "current_exporter",
    "host_rss_bytes", "live_plane", "render_openmetrics",
    "build_span_tree", "mint_trace_id", "span", "trace_spans",
    "CompileWatch", "site_compile", "watch",
    "diff_main", "runs_main", "summarize_run",
    "build_timeline", "fit_alignment", "summarize_trace",
    "timeline_main", "validate_trace",
]
