"""Span-based host tracing with Chrome-trace/Perfetto JSON export (the
port of the JAX package's ``observability/tracing.py``).

``span("step")`` is a nestable, thread-safe context manager; each
completed span is recorded as one chrome://tracing complete ("X") event,
which Perfetto and chrome://tracing open directly. ``complete`` records
an already-timed region and ``instant`` a zero-length marker; requests
carry a ``trace_id`` (``new_trace_id``) that survives failover, so a
re-admitted request renders as one trace.

Device-side alignment (the JAX package's ``TraceAnnotation``): each
span also opens a ``torch.profiler.record_function(name)``, so spans
show up in a ``torch.profiler`` trace beside the CUDA kernels they
launch, and on a CUDA build of torch pushes an NVTX range
(``torch.cuda.nvtx.range_push``/``range_pop``) for Nsight Systems. A
CPU build has no NVTX, so it is never called there; on a CUDA build a
failure of it is not caught.

Enablement: OFF unless ``PTPU_TRACE=1`` or ``PTPU_TRACE_DIR=<dir>`` is
set (or ``enable()`` is called). When off, ``span()`` returns a shared
null context manager and ``complete``/``instant`` return at once, so
the disabled path allocates nothing and enters no range. The buffer is
a bounded ring (``MAX_EVENTS``): the newest spans win, the dump carries
a ``ptpuDroppedSpans`` count and ``trace/dropped_spans`` counts the
evictions. ``observability`` writes ``<PTPU_TRACE_DIR>/ptpu_trace.json``
at process exit.
"""

import collections
import itertools
import json
import os
import threading
import time

import torch

from .. import flags as _flags
from . import metrics as _metrics

__all__ = ["span", "complete", "instant", "new_trace_id", "enabled",
           "enable", "disable", "events", "dump_chrome_trace", "reset",
           "MAX_EVENTS"]

MAX_EVENTS = 200000

# ring buffer: the newest spans win; evictions are counted into the
# dump's ptpuDroppedSpans note
_events = collections.deque(maxlen=MAX_EVENTS)
_dropped = 0
# a leaf lock: the ring append nests no other lock
_lock = threading.Lock()
_pid = os.getpid()

# trace ids are minted once a request and survive failover re-dispatch;
# span ids once a recorded request-scoped span (itertools.count is one
# C-level operation, safe across threads)
_trace_seq = itertools.count(1)
_span_seq = itertools.count(1)


def new_trace_id():
    """Process-unique request trace id ("<pid>.<seq>" hex)."""
    return "%x.%x" % (_pid, next(_trace_seq))


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self  # chains like Span.set


NULL_SPAN = _NullSpan()


# NVTX exists on a CUDA build of torch only
_CUDA_BUILD = torch.version.cuda is not None


def _annotate(name):
    """Open the span's device-side ranges: a torch.profiler
    record_function, and on a CUDA build an NVTX range. Returns the
    record_function to close."""
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    if _CUDA_BUILD:
        torch.cuda.nvtx.range_push(name)
    return rf


def _close_annotation(rf, exc):
    if _CUDA_BUILD:
        torch.cuda.nvtx.range_pop()
    rf.__exit__(*exc)


class Span:
    __slots__ = ("name", "args", "trace_id", "span_id", "parent_id", "_t0",
                 "_ann")

    def __init__(self, name, args=None, trace_id=None, parent_id=None):
        self.name = name
        self.args = args
        self.trace_id = trace_id
        self.parent_id = parent_id
        # span ids exist on request-scoped spans only
        self.span_id = next(_span_seq) if trace_id is not None else None
        self._t0 = 0
        self._ann = None

    def set(self, **args):
        """Attach key/values shown in the trace viewer's args pane."""
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)
        return self

    def __enter__(self):
        self._ann = _annotate(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _close_annotation(self._ann, exc)
        ev = {"name": self.name, "ph": "X", "pid": _pid,
              "tid": threading.get_ident() % 100000, "ts": self._t0 // 1000,
              "dur": (t1 - self._t0) // 1000, "cat": "host"}
        args = self.args
        if self.trace_id is not None:
            args = dict(args) if args else {}
            args["trace_id"] = self.trace_id
            args["span_id"] = self.span_id
            if self.parent_id is not None:
                args["parent_id"] = self.parent_id
        if args:
            ev["args"] = args
        _record(ev)
        return False


def _record(ev):
    global _dropped
    evicted = False
    with _lock:
        if len(_events) == MAX_EVENTS:
            _dropped += 1  # deque evicts the oldest on append
            evicted = True
        _events.append(ev)
    if evicted:
        # outside the ring lock: the metric's own lock must not nest
        _metrics.counter("trace/dropped_spans").inc()


_ENABLED = bool(_flags.env("PTPU_TRACE") or _flags.env("PTPU_TRACE_DIR"))


def enabled():
    return _ENABLED


def enable():
    global _ENABLED
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def span(name, trace_id=None, parent_id=None, **args):
    """A context manager timing one named region; nested spans nest in
    the exported trace. The shared null span when disabled. A
    ``trace_id`` (from ``new_trace_id()``) stamps the span with a
    request identity: it gets a span id, and ``trace_id``/``span_id``/
    ``parent_id`` land in the event's args."""
    if not _ENABLED:
        return NULL_SPAN
    return Span(name, args or None, trace_id, parent_id)


def complete(name, t0_ns, t1_ns, trace_id=None, parent_id=None, **args):
    """Record an already-timed region (``perf_counter_ns`` bounds) as one
    complete event. Returns the span id (None when tracing is off or no
    trace_id was given)."""
    if not _ENABLED:
        return None
    span_id = next(_span_seq) if trace_id is not None else None
    ev = {"name": name, "ph": "X", "pid": _pid,
          "tid": threading.get_ident() % 100000, "ts": t0_ns // 1000,
          "dur": max(0, (t1_ns - t0_ns) // 1000), "cat": "host"}
    if trace_id is not None:
        args["trace_id"] = trace_id
        args["span_id"] = span_id
        if parent_id is not None:
            args["parent_id"] = parent_id
    if args:
        ev["args"] = args
    _record(ev)
    return span_id


def instant(name, trace_id=None, parent_id=None, **args):
    """Zero-duration marker event at now (readmit, deadline_expired)."""
    t = time.perf_counter_ns()
    return complete(name, t, t, trace_id=trace_id, parent_id=parent_id,
                    **args)


def events():
    """Snapshot of the recorded chrome-trace events."""
    with _lock:
        return list(_events)


def reset():
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0


def dump_chrome_trace(path):
    """Write {"traceEvents": [...]} Chrome-trace JSON. Returns the event
    count."""
    with _lock:
        evs = list(_events)
        dropped = _dropped
    doc = {"traceEvents": evs, "displayTimeUnit": "ms"}
    if dropped:
        doc["ptpuDroppedSpans"] = dropped
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(evs)
