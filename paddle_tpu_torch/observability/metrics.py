"""Process-wide metrics registry (counters, gauges, histograms): the port
of the JAX package's ``observability/metrics.py``.

Exposition: a JSON dump (`MetricsRegistry.to_dict` / `dump_json`, read
by tools/ptpu_stats.py) and Prometheus text (`to_prometheus`, served at
``/metrics`` by ``endpoint.py``), both identical to the JAX package's
for the same sequence of updates.

Telemetry is OFF unless `PTPU_METRICS` is set (or `enable()` is called).
The disabled path is a no-op fast path: the module-level
`counter()/gauge()/histogram()` helpers hand back one shared null
metric, so instrumented hot loops allocate nothing per step. Going
through `registry()` directly bypasses the switch: explicit use is the
opt-in.

Threading: one lock per registry guards name -> metric creation, and
each metric guards its own mutation (`x += n` is not atomic across
threads). Both are named lock sites (``analysis.concurrency``), tracked
under ``PTPU_LOCK_CHECK=1``.
"""

import json
import math

from .. import flags as _flags
from ..analysis.concurrency import make_lock as _make_lock

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "counter", "gauge", "histogram", "enabled",
           "enable", "disable", "dump_json", "to_prometheus", "reset"]

# default histogram bucket upper bounds, in seconds: 100us .. ~100s
# exponential — wide enough for step times on one chip and compile times
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                   1.0, 3.0, 10.0, 30.0, 100.0)


class Counter:
    """Monotonically increasing count (Prometheus counter semantics)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = _make_lock("obs.metric")

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counter %r cannot decrease" % self.name)
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def to_dict(self):
        return self._value


class Gauge:
    """Last-set value (queue depth, module bytes, throughput)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0.0
        self._lock = _make_lock("obs.metric")

    def set(self, v):
        self._value = float(v)

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        return self._value

    def to_dict(self):
        return self._value


class Histogram:
    """Cumulative-bucket histogram with count/sum/min/max.

    min is float('inf') while empty: renderers print a placeholder for
    zero-observation histograms rather than leak the sentinel."""

    __slots__ = ("name", "buckets", "bucket_counts", "count", "sum",
                 "min", "max", "_lock")

    def __init__(self, name, buckets=None):
        self.name = name
        # float-normalized so the JSON bucket keys (repr of each bound)
        # round-trip through tools/ptpu_stats.py --prometheus even when
        # the caller passed integer bounds
        self.buckets = tuple(sorted(float(b)
                                    for b in (buckets or DEFAULT_BUCKETS)))
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = _make_lock("obs.metric")

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self.bucket_counts[i] += 1
                    return
            self.bucket_counts[-1] += 1

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q):
        """Bucket-interpolated quantile estimate (Prometheus
        histogram_quantile semantics: linear interpolation inside the
        bucket holding the q-th observation), clamped to the observed
        min/max so a wide first/last bucket cannot report a value outside
        the real range. The serving engine's p50/p99 gauges read this."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile %r outside [0, 1]" % (q,))
        if not self.count:
            return 0.0
        target = q * self.count
        cum = 0
        lo = 0.0
        for i, le in enumerate(self.buckets):
            n = self.bucket_counts[i]
            if n and cum + n >= target:
                v = lo + (le - lo) * (max(target - cum, 0.0) / n)
                return min(max(v, self.min), self.max)
            cum += n
            lo = le
        return self.max  # mass in the +Inf tail: best estimate is max

    def to_dict(self):
        d = {"count": self.count, "sum": self.sum, "avg": self.avg}
        if self.count:
            d["min"] = self.min
            d["max"] = self.max
            d["p50"] = self.quantile(0.50)
            d["p95"] = self.quantile(0.95)
            d["p99"] = self.quantile(0.99)
        return d | {"buckets": {
            ("+Inf" if i == len(self.buckets) else repr(self.buckets[i])): n
            for i, n in enumerate(self.bucket_counts)}}


class _NullMetric:
    """Shared no-op stand-in for every metric kind when telemetry is off:
    the instrumented call sites stay branch-free and allocation-free."""

    __slots__ = ()

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    @property
    def value(self):
        return 0


NULL_METRIC = _NullMetric()


class MetricsRegistry:
    """Name -> metric store. Names are slash-scoped ('executor/step_time');
    get-or-create, with a kind-conflict check so 'executor/step_time' can't
    be a counter in one file and a histogram in another."""

    def __init__(self):
        self._metrics = {}
        self._lock = _make_lock("obs.registry")

    def _get(self, name, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, *args)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError("metric %r is a %s, not a %s"
                            % (name, type(m).__name__, cls.__name__))
        return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name, buckets=None):
        if buckets is None:
            return self._get(name, Histogram)
        h = self._get(name, Histogram, buckets)
        if h.buckets != tuple(sorted(float(b) for b in buckets)):
            # a silent first-creation-wins would park every observation
            # in one bucket of the wrong scale; fail like kind conflicts
            raise ValueError(
                "histogram %r already exists with buckets %r"
                % (name, h.buckets))
        return h

    def metrics(self):
        with self._lock:
            return dict(self._metrics)

    def reset(self):
        with self._lock:
            self._metrics.clear()

    def to_dict(self):
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self.metrics().items()):
            kind = ("counters" if isinstance(m, Counter) else
                    "gauges" if isinstance(m, Gauge) else "histograms")
            out[kind][name] = m.to_dict()
        return out

    def dump_json(self, path):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        return path

    def to_prometheus(self, prefix="ptpu_"):
        """Prometheus text exposition format 0.0.4."""
        lines = []
        seen = {}  # mangled family name -> original metric name
        for name, m in sorted(self.metrics().items()):
            pn = prefix + _prom_name(name)
            other = seen.setdefault(pn, name)
            if other != name:
                # 'a/b' and 'a_b' both mangle to ptpu_a_b — merging them
                # silently would corrupt both series; fail like the
                # registry's kind-conflict check does
                raise ValueError(
                    "prometheus name collision: metrics %r and %r both "
                    "expose as %r" % (other, name, pn))
            if isinstance(m, Counter):
                lines.append("# TYPE %s_total counter" % pn)
                lines.append("%s_total %s" % (pn, _prom_num(m.value)))
            elif isinstance(m, Gauge):
                lines.append("# TYPE %s gauge" % pn)
                lines.append("%s %s" % (pn, _prom_num(m.value)))
            else:
                lines.append("# TYPE %s histogram" % pn)
                cum = 0
                for le, n in zip(m.buckets, m.bucket_counts):
                    cum += n
                    lines.append('%s_bucket{le="%s"} %d'
                                 % (pn, _prom_num(le), cum))
                lines.append('%s_bucket{le="+Inf"} %d' % (pn, m.count))
                lines.append("%s_sum %s" % (pn, _prom_num(m.sum)))
                lines.append("%s_count %d" % (pn, m.count))
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name):
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _prom_num(v):
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"  # int(nan) raises — a poisoned gauge must not
            # crash the scrape; ptpu_stats' NaN-hardened asserts catch it
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
    return repr(v)


# ---------------------------------------------------------------------------
# process-wide default registry + enablement switch
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def _env_on(name):
    """PTPU_* switch check through the flags registry (bool flags parse
    with the shared spellings; path-valued flags count as on when set
    non-empty)."""
    return bool(_flags.env(name))


_ENABLED = _env_on("PTPU_METRICS")


def enabled():
    """One-branch check instrumented hot paths gate on."""
    return _ENABLED


def enable():
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def registry():
    """The process-wide registry (live even when disabled — explicit use
    is an opt-in, the switch only mutes the instrumented hot paths)."""
    return _REGISTRY


def counter(name):
    return _REGISTRY.counter(name) if _ENABLED else NULL_METRIC


def gauge(name):
    return _REGISTRY.gauge(name) if _ENABLED else NULL_METRIC


def histogram(name, buckets=None):
    return _REGISTRY.histogram(name, buckets) if _ENABLED else NULL_METRIC


def dump_json(path):
    return _REGISTRY.dump_json(path)


def to_prometheus():
    return _REGISTRY.to_prometheus()


def reset():
    _REGISTRY.reset()
