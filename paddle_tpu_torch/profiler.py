"""Profiler (the port of the JAX package's ``profiler.py``; parity:
python/paddle/fluid/profiler.py, platform/profiler.cc and
tools/timeline.py).

A session (``start_profiler`` / ``stop_profiler``, or the ``profiler``
context) is one ``torch.profiler.profile`` over the CPU and, on the
card, CUDA activities, for every host thread where torch can. While it
is open the lowering wraps each Fluid op, forward and grad, in a
``record_function("fluid/<type>__<first output>")`` range
(``core/lowering.py`` `_op_scope_name`, the JAX package's identity), so
``device_op_profile`` can give each CUDA kernel of the trace to the op
that launched it: the innermost ``fluid/`` range containing the host
timestamp of the kernel's launch (the start of the host op that launched
it, named by the trace's "External id"; failing that, the runtime call's
own timestamp, found through the correlation id), on the launching
thread or, failing that, on any host thread —
``torch.autograd.grad`` on CUDA tensors launches the backward's kernels
from autograd's device thread while the issuing thread blocks inside its
grad op's range. Kernels outside every range form one ``(unattributed)``
row; none is dropped. With no session open the lowering enters no range.

Opening a second session while one is open raises. A session on the card
starts with a few hundred tiny launches outside every op (a session
opened late in a long process was seen to lose the records of its first
launches), so those show in the ``(unattributed)`` row. ``record_event`` is
the host-side event marker with the reference's calls / total / avg /
max / min table (printed by ``stop_profiler``); ``dump_chrome_trace``
writes the events it recorded inside sessions, from Python (the port has
no native collector).
"""

import bisect
import contextlib
import json
import math
import os
import tempfile
import threading
import time

import torch

from .core import lowering as _lowering
from .observability import metrics as _obs_metrics
from .observability import tracing as _obs_tracing

__all__ = ["cuda_profiler", "reset_profiler", "profiler", "start_profiler",
           "stop_profiler", "record_event", "dump_chrome_trace",
           "event_stats", "kernel_attribution", "device_op_profile",
           "print_device_op_profile", "session_open", "trace_events"]

# The legacy aggregator: each record_event name is one histogram in this
# always-on registry (the Fluid profiler API aggregates whenever it is
# used, outside the PTPU_METRICS switch).
_legacy = _obs_metrics.MetricsRegistry()
_session = None       # the open torch.profiler.profile
_trace_dir = None     # where stop_profiler writes the session's trace
_last = None          # the last closed session
_last_path = None     # where its trace was written, if it was
_last_events = None   # its chrome events, loaded on first use
_host_events = []     # record_event's chrome events inside sessions
_host_lock = threading.Lock()

TRACE_FILE = "torch_trace.json"
WARMUP_LAUNCHES = 512
UNATTRIBUTED = "(unattributed)"
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """nvprof-parity shim: a session over everything, its trace written
    to ``output_file``."""
    with profiler("All", "total", output_file):
        yield


def reset_profiler():
    """Forget the event table and the recorded host events."""
    _legacy.reset()
    with _host_lock:
        del _host_events[:]


def event_stats():
    """{event name: {'calls', 'total', 'avg', 'max', 'min'}} in seconds:
    the table _print_summary renders, as data."""
    out = {}
    for name, h in _legacy.metrics().items():
        out[name] = {"calls": h.count, "total": h.sum, "avg": h.avg,
                     "max": h.max if h.count else None,
                     "min": h.min if h.count else None}
    return out


def session_open():
    """True while a profiler session is open."""
    return _session is not None


def _new_session(cuda):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        config = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):  # a torch without the switch
        return torch.profiler.profile(activities=activities)
    return torch.profiler.profile(activities=activities,
                                  experimental_config=config)


def _warm_up_card():
    """Launches outside every op, synchronized, at a session's start: a
    session opened late in a long process was seen to lose the card's
    records of its first launches (43, the first ~5 ms of work, on an
    H100 with torch 2.11); these take that loss instead of the caller's
    ops."""
    w = torch.zeros(1 << 12, device=torch.cuda.current_device())
    for _ in range(WARMUP_LAUNCHES):
        w.add_(1.0)
    torch.cuda.synchronize()


def start_profiler(state="All", tracer_option=None, trace_dir=None):
    """Open a session. ``state`` "CPU" records the host only; "GPU" and
    "All" add the card's kernels when CUDA is available (after
    ``WARMUP_LAUNCHES`` warm-up launches, outside every op, whose records
    the session may lose). ``trace_dir``: where ``stop_profiler`` writes
    the chrome trace (``TRACE_FILE``)."""
    global _session, _trace_dir
    if state not in ("CPU", "GPU", "All"):
        raise ValueError("profiler state %r is not CPU, GPU or All"
                         % (state,))
    if _session is not None:
        raise RuntimeError("a profiler session is already open: "
                           "stop_profiler() it before starting another")
    cuda = state != "CPU" and torch.cuda.is_available()
    prof = _new_session(cuda)
    prof.__enter__()
    if cuda:
        _warm_up_card()
    _session = prof
    _trace_dir = trace_dir
    _lowering.set_op_ranges(True)


def stop_profiler(sorted_key=None, profile_path=None):
    """Close the session (a no-op when none is open), keep it for
    ``trace_events()``, write its chrome trace when a directory or a
    ``.json`` path was given, and print the event table."""
    global _session, _last, _last_path, _last_events, _trace_dir
    if _session is None:
        return
    prof, _session = _session, None
    _lowering.set_op_ranges(False)
    prof.__exit__(None, None, None)
    _last, _last_path, _last_events = prof, None, None
    path = _trace_dir or profile_path
    _trace_dir = None
    if path:
        if not path.endswith(".json"):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, TRACE_FILE)
        prof.export_chrome_trace(path)
        _last_path = path
    _print_summary(sorted_key)


def _print_summary(sorted_key=None):
    hists = _legacy.metrics()
    if not hists:
        return
    rows = []
    for name, h in hists.items():
        # zero-call events carry the histogram's +/-inf sentinels: keep
        # them sortable here and render them as '-' below
        rows.append((name, h.count, h.sum, h.avg,
                     h.max if h.count else 0.0,
                     h.min if h.count else 0.0))
    key_idx = {"calls": 1, "total": 2, "ave": 3, "max": 4, "min": 5}.get(
        sorted_key, 2)
    rows.sort(key=lambda r: r[key_idx], reverse=True)
    print("%-40s %8s %12s %12s %12s %12s" % (
        "Event", "Calls", "Total(ms)", "Avg(ms)", "Max(ms)", "Min(ms)"))
    for name, calls, total, avg, mx, mn in rows:
        if calls == 0:
            print("%-40s %8d %12.4f %12s %12s %12s" % (
                name, 0, 0.0, "-", "-", "-"))
            continue
        print("%-40s %8d %12.4f %12.4f %12.4f %12.4f" % (
            name, calls, total * 1e3, avg * 1e3, mx * 1e3, mn * 1e3))


@contextlib.contextmanager
def record_event(name):
    """Host-side RAII event marker (parity: platform/profiler.h
    RecordEvent): one row of the event table; inside a session also a
    range of the torch trace and an event of ``dump_chrome_trace``; with
    tracing on (PTPU_TRACE) a span of the observability trace."""
    active = _session is not None
    span = _obs_tracing.span(name)
    # a live span opens its own record_function
    rf = None
    if active and not _obs_tracing.enabled():
        rf = torch.profiler.record_function(name)
        rf.__enter__()
    t0 = time.perf_counter_ns()
    span.__enter__()
    try:
        yield
    finally:
        span.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        if rf is not None:
            rf.__exit__(None, None, None)
        if active:
            ev = {"name": name, "ph": "X", "pid": os.getpid(),
                  "tid": threading.get_ident() % 100000,
                  "ts": t0 // 1000, "dur": (t1 - t0) // 1000,
                  "cat": "host"}
            with _host_lock:
                _host_events.append(ev)
        _legacy.histogram(name).observe((t1 - t0) / 1e9)


def dump_chrome_trace(path):
    """Write the host events ``record_event`` recorded inside sessions as
    chrome://tracing JSON (parity: tools/timeline.py). Returns the number
    of events written."""
    with _host_lock:
        evs = list(_host_events)
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    return len(evs)


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             tracer_option=None):
    """Context profiler (parity: fluid.profiler.profiler): a session
    around the block, its trace written to ``profile_path`` (a directory
    or a ``.json`` file) when given."""
    start_profiler(state, tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


# ---------------------------------------------------------------------------
# the device table by Fluid op
# ---------------------------------------------------------------------------


def _load(path):
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def _exported(prof):
    """A profile's chrome events (torch exports a trace only once)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, TRACE_FILE)
        prof.export_chrome_trace(path)
        return _load(path)


def trace_events(trace=None):
    """The chrome events of `trace`: None (the last session), a
    ``torch.profiler.profile`` not exported before, a chrome-trace dict
    or event list, or a path (a ``.json`` file, or a directory holding
    ``TRACE_FILE``)."""
    global _last_events
    if trace is None or trace is _last:
        if _last is None:
            raise RuntimeError("no profiler session has been closed yet")
        if _last_events is None:
            _last_events = (_load(_last_path) if _last_path
                            else _exported(_last))
        return _last_events
    if isinstance(trace, dict):
        return trace.get("traceEvents", [])
    if isinstance(trace, list):
        return trace
    if isinstance(trace, str):
        if os.path.isdir(trace):
            trace = os.path.join(trace, TRACE_FILE)
        return _load(trace)
    return _exported(trace)


def _segments(ranges):
    """One thread's ranges (start, end, name) as the innermost range by
    time: ([boundary ts], [(name, start) | None]), each entry holding
    from its boundary (inclusive) to the next (exclusive)."""
    ranges.sort(key=lambda r: (r[0], -r[1]))
    times, owners, stack = [], [], []

    def emit(t, owner):
        if times and times[-1] >= t:
            owners[-1] = owner  # ranges that touch or overlap
        else:
            times.append(t)
            owners.append(owner)

    def close_until(t):
        while stack and stack[-1][1] <= t:
            end = stack.pop()[1]
            emit(end, (stack[-1][2], stack[-1][0]) if stack else None)

    for start, end, name in ranges:
        close_until(start)
        stack.append((start, end, name))
        emit(start, (name, start))
    close_until(math.inf)
    return times, owners


def _owner(segs, ts):
    times, owners = segs
    i = bisect.bisect_right(times, ts) - 1
    return owners[i] if i >= 0 else None


def _place(segs, tid, ts):
    """The innermost range around `ts` on thread `tid`, else on any
    other thread (the latest-opened of those that hold it): (name,
    start) or None."""
    owner = _owner(segs[tid], ts) if tid in segs else None
    if owner is None:
        found = [o for o in (_owner(s, ts) for t, s in segs.items()
                             if t != tid) if o is not None]
        owner = max(found, key=lambda o: o[1]) if found else None
    return owner


def _launch_of(launches, start):
    """The launch of a kernel among those of its correlation id: the last
    issued before the kernel started (a stale one, from earlier, is
    passed over), else the first (the card's clock was seen up to ~5 ms
    behind the host's, so a kernel can seem to start before its
    launch)."""
    before = [la for la in launches if la[0] <= start]
    if before:
        return max(before, key=lambda la: la[0])
    return min(launches, key=lambda la: la[0], default=None)


def _attribute(events, prefix="fluid/"):
    """([{"kernel", "op", "us"}], {op: range count}) for a trace's
    events: each CUDA kernel given the innermost `prefix` range around
    its launch (the launching thread first, then any host thread; None
    when no range holds it). A kernel is placed by the host op that
    launched it (the kernel's, else its runtime call's "External id"),
    whose timestamp is on the ranges' own clock; failing that, by the
    runtime call's own timestamp, taken by CUPTI on another clock."""
    ranges, hosts, launches, kernels = {}, {}, {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        name = str(ev.get("name", ""))
        args = ev.get("args") or {}
        where = (ev.get("pid"), ev.get("tid"))
        if cat in ("user_annotation", "cpu_op"):
            ts = float(ev["ts"])
            if args.get("External id"):
                hosts[args["External id"]] = (where, ts)
            if cat == "user_annotation" and name.startswith(prefix):
                ranges.setdefault(where, []).append(
                    (ts, ts + float(ev.get("dur", 0)), name[len(prefix):]))
        elif cat in _LAUNCH_CATS and "correlation" in args:
            launches.setdefault(args["correlation"], []).append(
                (float(ev["ts"]), args.get("External id"), where))
        elif cat == "kernel":
            kernels.append((name, args.get("correlation"),
                            float(ev.get("dur", 0)), float(ev["ts"]),
                            args.get("External id")))
    calls = {}
    for rs in ranges.values():
        for _, _, name in rs:
            calls[name] = calls.get(name, 0) + 1
    segs = {tid: _segments(rs) for tid, rs in ranges.items()}
    out = []
    for kname, corr, dur, start, kext in kernels:
        launch = _launch_of(launches.get(corr, ()), start)
        owner = None
        for ext in (kext, launch[1] if launch else None):
            if owner is None and ext in hosts:
                owner = _place(segs, *hosts[ext])
        if owner is None and launch is not None:
            owner = _place(segs, launch[2], launch[0])
        out.append({"kernel": kname,
                    "op": owner[0] if owner is not None else None,
                    "us": dur})
    return out, calls


def kernel_attribution(trace=None, prefix="fluid/"):
    """Every CUDA kernel of `trace` (see ``device_op_profile``) as
    {"kernel": name, "op": Fluid op identity or None, "us": duration};
    with another `prefix` (a span family such as "pp/"), "op" is the
    innermost range of that family around the kernel's launch, less the
    prefix."""
    return _attribute(trace_events(trace), prefix)[0]


def device_op_profile(trace=None, top=None):
    """The session's (or `trace`'s) CUDA kernel time by Fluid op, in the
    JAX package's row schema: {"op": "<type>__<first output>", "type",
    "calls": the op's runs in the trace, "total_us", "avg_us",
    "share_pct": of all kernel time}, sorted by total descending. Kernels
    outside every op range form the "(unattributed)" row ("calls" its
    kernel count). `trace`: None (the last session), a
    ``torch.profiler.profile``, a chrome-trace dict or path. A trace
    without CUDA kernels (a CPU session) gives []."""
    records, calls = _attribute(trace_events(trace))
    agg, stray, n_stray = {}, 0.0, 0
    for r in records:
        if r["op"] is None:
            stray += r["us"]
            n_stray += 1
        else:
            agg[r["op"]] = agg.get(r["op"], 0.0) + r["us"]
    grand = (sum(agg.values()) + stray) or 1.0
    rows = []
    for ident, total in agg.items():
        n = calls.get(ident, 0) or 1
        rows.append({"op": ident, "type": ident.split("__", 1)[0],
                     "calls": n, "total_us": round(total, 3),
                     "avg_us": round(total / n, 3),
                     "share_pct": round(100.0 * total / grand, 2)})
    if n_stray:
        rows.append({"op": UNATTRIBUTED, "type": UNATTRIBUTED,
                     "calls": n_stray, "total_us": round(stray, 3),
                     "avg_us": round(stray / n_stray, 3),
                     "share_pct": round(100.0 * stray / grand, 2)})
    rows.sort(key=lambda r: -r["total_us"])
    return rows[:top] if top else rows


def print_device_op_profile(trace=None, top=25):
    """Print device_op_profile in the reference PrintProfiler layout."""
    rows = device_op_profile(trace, top=top)
    if not rows:
        print("no CUDA kernels in the trace (a CPU session?)")
        return rows
    print("%-44s %8s %14s %12s %8s" % ("Event", "Calls", "Total(us)",
                                       "Ave(us)", "Ratio."))
    for r in rows:
        print("%-44s %8d %14.3f %12.3f %7.2f%%" % (
            r["op"][:44], r["calls"], r["total_us"], r["avg_us"],
            r["share_pct"]))
    return rows
