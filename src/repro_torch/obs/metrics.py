"""Typed host-side metrics registry: Counter / Gauge / Histogram (port
of `repro.obs.metrics`).

This is the single namespace behind every number the paged engine
reports: its scheduling counters, the page-pool gauges, ``SwapStore``
byte counters, prefix-cache hit counters and the chunk-fill histogram.
The stats dict and the Prometheus exposition read the same objects, so
there is one code path from instrumentation site to reported number.

Design constraints (the catalog is in docs/observability.md):

- Host-only.  Metric values are plain Python floats/ints; nothing here
  touches a tensor, so recording a metric never waits on the device.
- Instrument-site cost is one dict lookup + one float add.  Callers on
  the decode hot loop pre-bind series handles (``counter(...).series()``)
  once and call ``inc()`` / ``observe()`` on them per event.
- ``reset()`` zeroes values but keeps every registered metric and
  label-series object alive, so handles held by the engine survive the
  warmup/measure boundary (``engine.reset_stats()`` purity contract).
- Histograms keep fixed log-spaced buckets for the Prometheus
  exposition *and* a raw-sample reservoir so benchmark percentiles are
  exact (``numpy.percentile`` over raw samples), not bucket-interpolated.
"""

from __future__ import annotations

import threading

import numpy as np

__analysis__ = {
    "traced": (),
    "host_loop": (),
    "device_returning": (),
    "device_params": (),
    "host_objects": ("registry", "reg", "metric", "series"),
}

# Default histogram buckets: log-spaced, 10us .. ~84s (doubling).  Wide
# enough for TTFT on a cold compile and tight enough for inter-token
# latencies in the hundreds of microseconds.
DEFAULT_TIME_BUCKETS = tuple(1e-5 * 2.0 ** i for i in range(24))

# Cap on raw samples kept per histogram series.  Every benchmark in
# this repo observes far fewer samples than this, so percentiles stay
# exact in practice; past the cap new samples still update buckets,
# count and sum but are not retained raw.
RESERVOIR_CAP = 100_000

_VALID_KINDS = ("counter", "gauge", "histogram")


def _labels_key(labelnames, labels):
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared labelnames "
            f"{sorted(labelnames)}"
        )
    return tuple(str(labels[name]) for name in labelnames)


class _Metric:
    """Shared machinery: a family of label series under one name."""

    kind = "abstract"

    def __init__(self, name, help="", unit="", labelnames=()):
        self.name = name
        self.help = help
        self.unit = unit
        self.labelnames = tuple(labelnames)
        self._series = {}

    def series(self, **labels):
        """Get-or-create the series for a label combination.

        Series objects survive ``reset()``; hot paths bind them once.
        """
        key = _labels_key(self.labelnames, labels)
        s = self._series.get(key)
        if s is None:
            s = self._new_series()
            self._series[key] = s
        return s

    def _new_series(self):
        raise NotImplementedError

    def reset(self):
        for s in self._series.values():
            s.reset()

    def samples(self):
        """Yield ``(labels_dict, series)`` pairs in insertion order."""
        for key, s in self._series.items():
            yield dict(zip(self.labelnames, key)), s


class CounterSeries:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def inc(self, n=1.0):
        if n < 0:
            raise ValueError("counters can only increase")
        self._value += n

    def value(self):
        return self._value

    def reset(self):
        self._value = 0.0


class Counter(_Metric):
    kind = "counter"

    def _new_series(self):
        return CounterSeries()

    def inc(self, n=1.0, **labels):
        self.series(**labels).inc(n)

    def value(self, **labels):
        return self.series(**labels).value()

    def total(self):
        return sum(s.value() for s in self._series.values())


class GaugeSeries:
    __slots__ = ("_value",)

    def __init__(self):
        self._value = 0.0

    def set(self, v):
        self._value = float(v)

    def set_max(self, v):
        if v > self._value:
            self._value = float(v)

    def inc(self, n=1.0):
        self._value += n

    def dec(self, n=1.0):
        self._value -= n

    def value(self):
        return self._value

    def reset(self):
        self._value = 0.0


class Gauge(_Metric):
    kind = "gauge"

    def _new_series(self):
        return GaugeSeries()

    def set(self, v, **labels):
        self.series(**labels).set(v)

    def set_max(self, v, **labels):
        self.series(**labels).set_max(v)

    def value(self, **labels):
        return self.series(**labels).value()


class HistogramSeries:
    __slots__ = ("buckets", "counts", "count", "sum", "raw")

    def __init__(self, buckets):
        self.buckets = buckets          # upper bounds, ascending
        self.counts = [0] * (len(buckets) + 1)  # +1 for +Inf
        self.count = 0
        self.sum = 0.0
        self.raw = []

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        if len(self.raw) < RESERVOIR_CAP:
            self.raw.append(v)

    def percentile(self, p):
        """Exact percentile over the raw reservoir (numpy linear interp).

        Matches the hand-rolled ``np.percentile`` math the benchmarks
        the JAX package's benchmarks use.
        """
        if not self.raw:
            return float("nan")
        return float(np.percentile(np.asarray(self.raw), p))

    def mean(self):
        return self.sum / self.count if self.count else float("nan")

    def max(self):
        return max(self.raw) if self.raw else float("nan")

    def cumulative_counts(self):
        """Cumulative bucket counts as Prometheus expects (le semantics)."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def reset(self):
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.raw = []


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", unit="", labelnames=(), buckets=None):
        super().__init__(name, help=help, unit=unit, labelnames=labelnames)
        b = tuple(float(x) for x in (buckets or DEFAULT_TIME_BUCKETS))
        if list(b) != sorted(b):
            raise ValueError("histogram buckets must be ascending")
        self.buckets = b

    def _new_series(self):
        return HistogramSeries(self.buckets)

    def observe(self, v, **labels):
        self.series(**labels).observe(v)

    def percentile(self, p, **labels):
        return self.series(**labels).percentile(p)


def summary_ms(series):
    """p50/p99/mean/max of a :class:`HistogramSeries`, in milliseconds.

    Same keys and math as the reference's (``np.percentile`` over the
    raw samples, scaled to ms).
    """
    if not series.raw:
        return {"p50_ms": None, "p99_ms": None,
                "mean_ms": None, "max_ms": None, "n": 0}
    a = np.asarray(series.raw, np.float64) * 1e3
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean()), "max_ms": float(a.max()),
            "n": int(a.size)}


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Re-requesting a name returns the same object; requesting it with a
    different kind or label set is an error (one meaning per name).
    """

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, unit, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as {m.kind}"
                    )
                if m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{m.labelnames}, requested {tuple(labelnames)}"
                    )
                return m
            m = cls(name, help=help, unit=unit, labelnames=labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", unit="", labelnames=()):
        return self._get_or_create(Counter, name, help, unit, labelnames)

    def gauge(self, name, help="", unit="", labelnames=()):
        return self._get_or_create(Gauge, name, help, unit, labelnames)

    def histogram(self, name, help="", unit="", labelnames=(), buckets=None):
        return self._get_or_create(
            Histogram, name, help, unit, labelnames, buckets=buckets
        )

    def get(self, name):
        return self._metrics.get(name)

    def collect(self):
        """Metrics in registration order (export iterates this)."""
        return list(self._metrics.values())

    def reset(self):
        """Zero every value; registrations and series handles survive.

        This is the registry half of ``engine.reset_stats()``: the
        warmup/measure boundary must not leave warmup samples in any
        histogram or warmup increments in any counter.
        """
        for m in self._metrics.values():
            m.reset()

    def snapshot(self):
        """Plain-dict snapshot for embedding in JSON results."""
        out = {}
        for m in self._metrics.values():
            series = {}
            for labels, s in m.samples():
                key = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                if m.kind == "histogram":
                    series[key] = {
                        "count": s.count,
                        "sum": s.sum,
                        "p50": s.percentile(50),
                        "p99": s.percentile(99),
                        "max": s.max(),
                    }
                else:
                    series[key] = s.value()
            out[m.name] = {"kind": m.kind, "series": series}
        return out
