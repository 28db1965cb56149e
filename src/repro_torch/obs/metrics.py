"""Lock-cheap metrics registry (DESIGN.md §9.1).

Three instrument kinds — :class:`Counter`, :class:`Gauge`,
:class:`Histogram` — behind one :class:`MetricsRegistry`.  Each
instrument carries its own tiny lock so a hot increment never contends
with an unrelated instrument or with a snapshot of the whole registry;
``registry.counter(name)`` is get-or-create and always returns the SAME
object for a name, so call sites hoist the lookup once and pay only the
lock+add afterwards.

The disabled path allocates nothing per call: a registry built with
``enabled=False`` hands out the module-level ``NULL_COUNTER`` /
``NULL_GAUGE`` / ``NULL_HISTOGRAM`` singletons whose methods are no-op
``pass`` bodies, so instrumented code runs the same lines either way and
the cost of "observability off" is one attribute call on a shared
object (DESIGN.md §9.4).
"""

from __future__ import annotations

import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_COUNTER", "NULL_GAUGE", "NULL_HISTOGRAM", "NULL_REGISTRY",
    "DEFAULT_BOUNDS",
]

# Latency-oriented default buckets, in seconds: 10us .. 10s.  Bounded —
# a histogram is a fixed-size array of ints, never a per-sample append.
DEFAULT_BOUNDS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
)


class Counter:
    """Monotone counter.  ``inc(n)`` under a per-instrument lock; reads
    (``value``) are lock-free int reads (atomic under the GIL)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        """Add ``n`` (default 1) to the counter."""
        with self._lock:
            self._value += n

    @property
    def value(self) -> int | float:
        """Current total."""
        return self._value

    def snapshot(self):
        """JSON-ready value (the running total)."""
        return self._value


class Gauge:
    """Point-in-time value: ``set`` overwrites, ``add`` nudges."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        """Overwrite the gauge with ``v``."""
        self._value = v

    def add(self, dv: float) -> None:
        """Adjust the gauge by ``dv`` (locked read-modify-write)."""
        with self._lock:
            self._value += dv

    @property
    def value(self) -> float:
        """Current value."""
        return self._value

    def snapshot(self):
        """JSON-ready value (the current reading)."""
        return self._value


class Histogram:
    """Bounded-bucket histogram: fixed cumulative bounds set at creation,
    one int per bucket (+ overflow), plus running count/sum/min/max and
    the most recent sample (``last`` — what live gauges like
    ``wal_last_fsync_s`` read).  ``observe`` is one lock + O(#buckets)
    scan; no allocation per sample."""

    __slots__ = ("name", "bounds", "_counts", "_lock", "_count", "_sum",
                 "_min", "_max", "_last")

    def __init__(self, name: str, bounds=DEFAULT_BOUNDS):
        self.name = name
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(self.bounds) + 1)   # +1 = overflow
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None
        self._last = None

    def observe(self, v: float) -> None:
        """Record one sample ``v`` into its bucket and the aggregates."""
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            self._last = v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        """Number of samples observed."""
        return self._count

    @property
    def sum(self) -> float:
        """Sum of all observed samples."""
        return self._sum

    @property
    def mean(self) -> float:
        """Mean sample value (0.0 when empty)."""
        return self._sum / self._count if self._count else 0.0

    @property
    def last(self):
        """Most recent sample, or None when empty."""
        return self._last

    @property
    def max(self):
        """Largest sample seen, or None when empty."""
        return self._max

    def snapshot(self) -> dict:
        """JSON-ready aggregate view (count/sum/mean/min/max/last plus
        per-bucket counts keyed by upper bound)."""
        with self._lock:
            counts = list(self._counts)
            out = {"count": self._count, "sum": self._sum,
                   "mean": self._sum / self._count if self._count else 0.0,
                   "min": self._min, "max": self._max, "last": self._last}
        out["buckets"] = {("+inf" if i == len(self.bounds)
                           else repr(self.bounds[i])): c
                          for i, c in enumerate(counts) if c}
        return out


class _NullCounter:
    """No-op counter handed out by disabled registries (shared
    singleton; ``value`` reads 0)."""
    __slots__ = ()
    name = "null"

    def inc(self, n=1):
        """No-op."""

    @property
    def value(self):
        """Always 0."""
        return 0

    def snapshot(self):
        """Always 0."""
        return 0


class _NullGauge:
    """No-op gauge singleton for the disabled path."""
    __slots__ = ()
    name = "null"

    def set(self, v):
        """No-op."""

    def add(self, dv):
        """No-op."""

    @property
    def value(self):
        """Always 0.0."""
        return 0.0

    def snapshot(self):
        """Always 0.0."""
        return 0.0


class _NullHistogram:
    """No-op histogram singleton for the disabled path."""
    __slots__ = ()
    name = "null"
    bounds = ()
    count = 0
    sum = 0.0
    mean = 0.0
    last = None
    max = None

    def observe(self, v):
        """No-op."""

    def snapshot(self):
        """Empty aggregate view."""
        return {"count": 0, "sum": 0.0, "mean": 0.0, "min": None,
                "max": None, "last": None, "buckets": {}}


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Name → instrument map.  ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent: same name → same object, so concurrent
    callers share one instrument); ``snapshot()`` returns a JSON-ready
    dict and ``render_text()`` a Prometheus-style exposition for the
    ``--metrics-port`` endpoint (DESIGN.md §9.1).

    ``MetricsRegistry(enabled=False)`` is the zero-allocation disabled
    path: every factory returns the shared null singleton and the
    registry stays empty."""

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        """Get or create the counter ``name`` (null singleton when the
        registry is disabled)."""
        if not self.enabled:
            return NULL_COUNTER
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        """Get or create the gauge ``name``."""
        if not self.enabled:
            return NULL_GAUGE
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds=DEFAULT_BOUNDS) -> Histogram:
        """Get or create the histogram ``name`` with cumulative bucket
        ``bounds`` (ignored if the histogram already exists)."""
        if not self.enabled:
            return NULL_HISTOGRAM
        return self._get(name, Histogram, bounds)

    def snapshot(self) -> dict:
        """JSON-ready ``{name: value-or-aggregate}`` over every
        registered instrument, sorted by name."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def render_text(self) -> str:
        """Prometheus-style text exposition: one ``name value`` line per
        counter/gauge, ``name_count`` / ``name_sum`` / ``name_last``
        lines per histogram (dots in names become underscores)."""
        lines = []
        for name, m in sorted(self.snapshot().items()):
            flat = name.replace(".", "_").replace("-", "_")
            if isinstance(m, dict):                     # histogram
                lines.append(f"{flat}_count {m['count']}")
                lines.append(f"{flat}_sum {m['sum']}")
                if m["last"] is not None:
                    lines.append(f"{flat}_last {m['last']}")
            else:
                lines.append(f"{flat} {m}")
        return "\n".join(lines) + "\n"


NULL_REGISTRY = MetricsRegistry(enabled=False)
