"""Telemetry of the PyTorch port (the JAX package's ``observability``):
the metrics registry, span tracing, the flight recorder, the live
endpoint and the step cost accounting (``cost``: FLOPs and MFU).

  metrics  — process-wide counters/gauges/histograms with JSON and
             Prometheus exposition. Enable with PTPU_METRICS=1; set
             PTPU_METRICS_OUT=<path> to dump JSON at process exit.
  tracing  — nestable host spans exported as Chrome-trace/Perfetto
             JSON, each also a torch.profiler ``record_function`` and,
             on a CUDA build, an NVTX range. Enable with PTPU_TRACE=1,
             or PTPU_TRACE_DIR=<dir> to also write
             <dir>/ptpu_trace.json at process exit.
  endpoint — /metrics, /varz and /healthz on 127.0.0.1, started at
             import when PTPU_METRICS_PORT is set.

Instrumented hot paths (Executor.run's step time and feed/fetch bytes,
the step cache, lowering, the in-flight window, the pass pipeline, the
serving engine) check one module-level bool and touch shared null
objects when telemetry is off: the disabled path allocates nothing per
step. ``profiler`` (the Fluid profiler API and the device table by Fluid
op) builds on this layer.
"""

import atexit
import os
import time

from .. import flags as _flags
from . import flight_recorder, metrics, tracing
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, counter, gauge, histogram, registry)
from .tracing import span  # noqa: F401

__all__ = ["metrics", "tracing", "flight_recorder", "span", "counter",
           "gauge", "histogram", "registry", "enabled", "enable",
           "disable", "dump_metrics", "dump_chrome_trace", "step_scope",
           "Counter", "Gauge", "Histogram", "MetricsRegistry"]


def enabled():
    """True when any telemetry facility is on."""
    return metrics.enabled() or tracing.enabled()


def enable():
    """Turn on both metrics and tracing (the programmatic form of
    PTPU_METRICS=1 PTPU_TRACE=1)."""
    metrics.enable()
    tracing.enable()


def disable():
    metrics.disable()
    tracing.disable()


def dump_metrics(path):
    """Write the process-wide registry as JSON (tools/ptpu_stats.py
    renders it)."""
    return metrics.dump_json(path)


def dump_chrome_trace(path):
    """Write the collected spans as Chrome-trace JSON (open in
    Perfetto)."""
    return tracing.dump_chrome_trace(path)


class _StepScope:
    """One executor step's shared instrumentation: a `step` span plus the
    executor/step_time histogram and executor/steps counter, used by
    Executor.run and CompiledProgram._run alike. step_time is recorded
    only on a clean exit (an op raising mid-step would otherwise pollute
    the latency distribution)."""

    __slots__ = ("_rec", "_span", "_t0")

    def __enter__(self):
        self._rec = metrics.enabled()
        self._span = tracing.span("step")
        self._span.__enter__()
        self._t0 = time.perf_counter() if self._rec else 0.0
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        if self._rec and exc[0] is None:
            reg = metrics.registry()
            reg.histogram("executor/step_time").observe(
                time.perf_counter() - self._t0)
            reg.counter("executor/steps").inc()
        return False


def step_scope():
    """Context manager instrumenting one executor step; the shared no-op
    singleton when telemetry is off (no allocation)."""
    if not (metrics.enabled() or tracing.enabled()):
        return tracing.NULL_SPAN
    return _StepScope()


def _exit_dumps():
    out = _flags.env("PTPU_METRICS_OUT")
    if out:
        try:
            metrics.dump_json(out)
        except OSError:
            pass
    tdir = _flags.env("PTPU_TRACE_DIR")
    if tdir:
        try:
            os.makedirs(tdir, exist_ok=True)
            tracing.dump_chrome_trace(os.path.join(tdir, "ptpu_trace.json"))
        except OSError:
            pass


if _flags.env("PTPU_METRICS_OUT") or _flags.env("PTPU_TRACE_DIR"):
    atexit.register(_exit_dumps)

if _flags.env("PTPU_METRICS_PORT") is not None:
    # the live scrape surface: no flag, no import, no thread
    from . import endpoint as _endpoint  # noqa: E402

    _endpoint.start()
