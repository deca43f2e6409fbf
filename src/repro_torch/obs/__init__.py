"""Unified telemetry for the serving stack (port of `repro.obs`).

``Telemetry`` bundles the three pillars the engine threads through its
call sites:

- ``registry`` — a :class:`~repro_torch.obs.metrics.MetricsRegistry` holding
  every counter/gauge/histogram (always on; one float add per event).
- ``tracer`` — an optional :class:`~repro_torch.obs.tracing.Tracer`; when
  attached, ``spans`` (an :class:`~repro_torch.obs.tracing.EngineSpans`)
  records request-lifecycle and scheduler-step spans as Chrome trace
  events.  When absent, every ``spans`` method is a no-op.
- ``step_timing`` — when true, the engine also observes per-iteration
  phase durations (retire/admit/prefill/decode) into the
  ``engine_step_phase_seconds`` histogram.  Defaults to on exactly
  when a tracer is attached, giving three instrumentation levels:
  counters-only (default), metrics-only (``Telemetry.metrics_only()``),
  full span tracing (``Telemetry.tracing()``).

See docs/observability.md for the metric catalog and span hierarchy.
"""

from __future__ import annotations

from .metrics import (
    Counter,
    DEFAULT_TIME_BUCKETS,
    Gauge,
    Histogram,
    MetricsRegistry,
    summary_ms,
)
from .tracing import EngineSpans, Tracer
from . import export

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "EngineSpans",
    "Telemetry",
    "DEFAULT_TIME_BUCKETS",
    "summary_ms",
    "export",
]


class Telemetry:
    def __init__(self, registry=None, tracer=None, step_timing=None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self.spans = EngineSpans(tracer)
        if step_timing is None:
            step_timing = tracer is not None
        self.step_timing = bool(step_timing)

    @classmethod
    def metrics_only(cls):
        """Counters + per-step phase histograms, no span tracing."""
        return cls(step_timing=True)

    @classmethod
    def tracing(cls):
        """Full instrumentation: counters, phase timing, span tracing."""
        return cls(tracer=Tracer())

    def snapshot(self):
        return self.registry.snapshot()
