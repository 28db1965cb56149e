"""Unified observability layer (DESIGN.md §9) of the port: metrics
registry + request-scoped tracing, shared by ``QueryService`` and the
persistence layer; counterpart of ``repro.obs``.

* ``metrics`` — lock-cheap counters/gauges/bounded-bucket histograms
  behind one :class:`MetricsRegistry` (§9.1; a copy of the reference's);
* ``trace`` — per-request :class:`Span` trees (§9.2; the reference's,
  plus the port's own: each span entered with ``with`` is a
  ``torch.profiler`` range, and ``device_child`` spans carry the device
  time of a search's passes);
* ``exporter`` — the ``--metrics-port`` text endpoint (a copy).

:class:`Observability` bundles one registry + one tracer and is the
single knob a layer takes (``QueryService(obs=…)``).  The default is
metrics ON, tracing OFF; ``Observability.off()`` is the zero-cost null
bundle used as the no-obs baseline in overhead measurements (§9.4).
"""

from .metrics import (Counter, Gauge, Histogram,     # noqa: F401
                      MetricsRegistry, NULL_COUNTER, NULL_GAUGE,
                      NULL_HISTOGRAM, NULL_REGISTRY, DEFAULT_BOUNDS)
from .trace import (Span, Tracer, NULL_SPAN,         # noqa: F401
                    NULL_TRACER, STAGES, stage_totals)
from .exporter import MetricsServer, start_metrics_server  # noqa: F401

__all__ = [
    "Observability", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "Span", "Tracer", "NULL_SPAN", "NULL_TRACER", "NULL_COUNTER",
    "NULL_GAUGE", "NULL_HISTOGRAM", "NULL_REGISTRY", "DEFAULT_BOUNDS",
    "STAGES", "stage_totals", "MetricsServer", "start_metrics_server",
]


class Observability:
    """One registry + one tracer, the bundle every layer is handed.

    ``metrics=True, trace=False`` is the default everywhere: counters
    and gauges stay exact (``QueryService.cache_info()`` reads them)
    while the per-request span machinery stays on the null path.
    ``Observability.off()`` disables both — instruments become shared
    null singletons and counters read 0; it exists for overhead
    measurement, not production serving (DESIGN.md §9.4)."""

    def __init__(self, *, metrics: bool = True, trace: bool = False,
                 keep_traces: int = 256):
        self.metrics = MetricsRegistry(enabled=metrics)
        self.tracer = Tracer(enabled=trace, keep=keep_traces)

    @property
    def enabled(self) -> bool:
        """True when any instrument (metrics or tracing) is live."""
        return self.metrics.enabled or self.tracer.enabled

    @classmethod
    def off(cls) -> "Observability":
        """Fully disabled bundle: every instrument is a shared null
        singleton, every root span is :data:`NULL_SPAN`."""
        return cls(metrics=False, trace=False)
