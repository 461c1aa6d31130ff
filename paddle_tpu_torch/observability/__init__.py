"""paddle_tpu_torch.observability — the metrics registry, step tracing,
live performance attribution, and the failure flight recorder.

The port's copy of ``paddle_tpu/observability`` (ROADMAP A11 keeps the
rest: the TelemetryServer of ``server.py``, the Trainer's metrics and
spans, the analysis hooks):

- ``registry``: process-wide MetricsRegistry — labeled counters,
  gauges, and windowed histograms (nearest-rank p50/p90/p99) behind
  validated ``paddle_tpu_*`` names with mandatory help text. The serving
  and generation metrics publish here; ``retry_counters()`` and live
  CircuitBreakers mirror themselves in via collectors.
- ``trace``: spans over the profiler events — ``span(name)`` and
  ``step_trace(step)`` stamp every RecordEvent closed inside with a
  shared trace/span id.
- ``attribution``: live MFU (static cost-model FLOPs / wall / the card's
  peak) and the per-step phase histogram.
- ``flight_recorder``: bounded ring buffer of recent profiler events,
  dumping a chrome-trace + metrics bundle on failure triggers (breaker
  open, swap rollback, shed storm).

Quickstart::

    from paddle_tpu_torch import observability as obs

    print(obs.default_registry().render_prometheus())
"""
from . import attribution, trace  # noqa: F401
# the module's flight_recorder() accessor is not re-exported here — the
# name would shadow the submodule attribute; reach it via
# observability.flight_recorder.flight_recorder()
from .flight_recorder import (FlightRecorder,  # noqa: F401
                              record_failure, set_flight_recorder)
from . import flight_recorder  # noqa: F401

# The default recorder must be live before the first failure fires — a
# lazily-built one would dump an empty ring for the first failure.
# Built disabled (no listener) when PADDLE_TPU_FLIGHT_RECORDER=0.
flight_recorder.flight_recorder()
from .registry import (METRIC_NAME_RE, Counter, Gauge,  # noqa: F401,E402
                       Histogram, MetricsRegistry, add_global_collector,
                       default_registry, set_default_registry)
from .trace import (SpanContext, current, span, step_trace,  # noqa: F401,E402
                    use_span)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "default_registry", "set_default_registry", "add_global_collector",
    "METRIC_NAME_RE",
    "trace", "SpanContext", "step_trace", "span", "current", "use_span",
    "attribution", "flight_recorder",
    "FlightRecorder", "set_flight_recorder", "record_failure",
]
