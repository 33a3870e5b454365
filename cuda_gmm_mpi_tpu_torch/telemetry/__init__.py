"""Run-scoped telemetry of the port: the JSONL event stream and its metrics
registry.

The port's copy of the JAX package's telemetry core: ``schema`` is the wire
contract (stream rev v2.8, the same field tables), ``registry`` the numeric
aggregates and ``recorder`` the event bus with its ambient activation. A
stream the port writes validates under the JAX package's ``validate_stream``
and renders with its ``gmm report``. The JAX package's profiling watch,
spans, exporter, report and diff are not ported.
"""

from .recorder import (RunRecorder, current, memory_stats, read_stream, use,
                       write_line)
from .registry import MetricsRegistry
from .schema import (EVENT_FIELDS, SCHEMA_VERSION, validate_record,
                     validate_stream)

__all__ = [
    "RunRecorder", "MetricsRegistry", "current", "use", "write_line",
    "read_stream", "memory_stats",
    "EVENT_FIELDS", "SCHEMA_VERSION", "validate_record", "validate_stream",
]
