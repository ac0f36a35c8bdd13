"""Concurrency analysis for the threaded runtime (the port of the JAX
package's ``analysis/concurrency.py``), in the spirit of Eraser (Savage
et al., SOSP '97) and ThreadSanitizer: every tracked acquisition feeds a
process-global lock-order graph, and a *potential* deadlock (a cycle in
that graph) is reported the first time both orders have been observed,
even when the run never hangs.

The surface is a factory:

    from paddle_tpu_torch.analysis.concurrency import make_lock

    self._lock = make_lock("serving.kv_pool")
    self._cv = make_condition("serving.engine.cv")

With ``PTPU_LOCK_CHECK`` unset (the default) the factories return the
plain ``threading`` primitives: zero overhead, behaviorally identical.
With ``PTPU_LOCK_CHECK=1`` they return ``TrackedLock`` /
``TrackedRLock`` / ``TrackedCondition`` wrappers that record, per
thread, the held locks and a cheap acquisition stack, and check on
every acquisition:

  rule ``lock-order-cycle``      acquiring B while holding A adds edge
                                 A->B to the global order graph; a cycle
                                 reports both acquisition stacks, lock
                                 names and thread names
  rule ``self-deadlock``         an untimed blocking re-acquire of a
                                 non-reentrant lock the thread already
                                 holds (raised, since proceeding would
                                 hang; timed and non-blocking probes
                                 keep their plain semantics)
  rule ``same-class-nesting``    acquiring a second instance of a lock
                                 class while holding one: the class
                                 order graph cannot order instances
                                 (the lockdep rule)
  rule ``blocking-while-holding``a ``Condition.wait`` while holding a
                                 *different* tracked lock, or a declared
                                 ``blocking_region`` entered with a
                                 tracked lock held
  rule ``long-hold``             a lock held longer than
                                 ``PTPU_LOCK_HOLD_MS`` milliseconds
                                 (unset = off)
  rule ``pool-invariant`` /      runtime invariant hooks
  rule ``engine-invariant``      (``KVBlockPool.check_invariants``, the
                                 serving engine's step-boundary checks)
                                 report through the same channel

Violations are structured (:class:`LockViolation`), accumulated in the
tracker (``violations()``), surfaced once as a ``RuntimeWarning``, and
countable: ``publish_metrics()`` writes ``concurrency/{locks_tracked,
acquisitions,order_edges,violations,max_hold_ms}`` into the metrics
registry. ``assert_clean()`` raises :class:`LockCheckError`, after a
``lock_check_failed`` flight-recorder dump when the recorder is loaded.

Lock NAMES are stable per site ("serving.kv_pool", ...), not per
instance: the order graph reasons about lock *classes*, which is what
makes cross-instance ABBA observable at all. This module imports nothing
heavier than ``paddle_tpu_torch.flags`` at module level.
"""

import atexit
import sys
import threading
import time

from .. import flags as _flags

__all__ = [
    "LockCheckError", "LockViolation", "TrackedCondition", "TrackedLock",
    "TrackedRLock", "assert_clean", "blocking_region", "check_blocking",
    "make_condition", "make_lock", "make_rlock", "publish_metrics",
    "record_violation", "reset", "stats", "tracker", "tracking_enabled",
    "violations",
]

_OWN_FILE = __file__


def tracking_enabled():
    """True under PTPU_LOCK_CHECK=1 — read at CALL time, so the factory
    decides per lock creation (the env-unset path never builds a
    tracker)."""
    return bool(_flags.env("PTPU_LOCK_CHECK"))


# ---------------------------------------------------------------------------
# structured diagnostics
# ---------------------------------------------------------------------------


class LockViolation:
    """One structured concurrency diagnostic. ``locks``/``threads`` name
    every lock and thread involved; ``stacks`` carries the formatted
    acquisition stacks (also embedded in ``message``). ``key()`` is the
    dedup identity — each distinct hazard reports once; ``detail``
    distinguishes different hazards that share a lock set (e.g. two
    different pool-invariant breaks on the same pool — without it the
    second would be silently swallowed)."""

    __slots__ = ("rule", "message", "locks", "threads", "stacks",
                 "detail")

    def __init__(self, rule, message, locks=(), threads=(), stacks=(),
                 detail=None):
        self.rule = rule
        self.message = message
        self.locks = tuple(locks)
        self.threads = tuple(threads)
        self.stacks = tuple(stacks)
        self.detail = detail

    def key(self):
        return (self.rule, tuple(sorted(self.locks)), self.detail)

    def __repr__(self):
        loc = []
        if self.locks:
            loc.append("locks %s" % ", ".join(self.locks))
        if self.threads:
            loc.append("threads %s" % ", ".join(self.threads))
        return "[%s] %s%s" % (self.rule, self.message,
                              " (%s)" % "; ".join(loc) if loc else "")


class LockCheckError(RuntimeError):
    """Raised by ``assert_clean()`` (and on a would-hang self-deadlock).
    Carries the first violation's structured fields plus the full
    list."""

    def __init__(self, violations):
        self.violations = list(violations)
        first = self.violations[0] if self.violations else \
            LockViolation("unknown", "no violations recorded")
        self.rule = first.rule
        self.locks = first.locks
        self.threads = first.threads
        super().__init__(
            "concurrency check failed: %d violation(s)\n  %s"
            % (len(self.violations),
               "\n  ".join(repr(v) for v in self.violations[:8])))


def _capture_stack(limit=16):
    """Cheap acquisition stack: a raw frame walk (no linecache I/O —
    traceback.extract_stack costs ~100x more and this runs per
    acquisition under the flag). Frames inside this module are elided."""
    try:
        f = sys._getframe(1)
    except ValueError:  # pragma: no cover
        return ()
    out = []
    while f is not None and len(out) < limit:
        code = f.f_code
        if code.co_filename != _OWN_FILE:
            out.append((code.co_filename, f.f_lineno, code.co_name))
        f = f.f_back
    return tuple(out)


def _fmt_stack(stack, indent="      "):
    if not stack:
        return indent + "<no stack captured>"
    return "\n".join("%s%s:%d in %s" % (indent, fn, ln, fname)
                     for fn, ln, fname in stack)


class _Held:
    """One tracked lock a thread currently holds."""

    __slots__ = ("lock", "stack", "t0", "depth")

    def __init__(self, lock, stack, t0):
        self.lock = lock
        self.stack = stack
        self.t0 = t0
        self.depth = 1


class _EdgeInfo:
    """First observation of lock-order edge a -> b: who held a (and
    where it was acquired) when b was acquired (and where)."""

    __slots__ = ("thread", "stack_from", "stack_to")

    def __init__(self, thread, stack_from, stack_to):
        self.thread = thread
        self.stack_from = stack_from
        self.stack_to = stack_to


class LockTracker:
    """Process-global lock accounting: per-thread held sets, the lock
    order graph, violation accumulation. Internal state is guarded by a
    RAW ``threading.Lock`` — the tracker must never wait on a lock it
    tracks."""

    def __init__(self):
        self._mu = threading.Lock()          # raw on purpose
        self._tls = threading.local()
        self._locks_tracked = 0
        self._acquisitions = 0
        self._max_hold_ms = 0.0
        self._edges = {}        # (a, b) -> _EdgeInfo, first observation
        self._adj = {}          # a -> set of b
        self._violations = []
        self._seen_keys = set()

    # -- per-thread held list ------------------------------------------
    def _held(self):
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def held_names(self):
        """Names of the tracked locks the CALLING thread holds now."""
        return [h.lock.name for h in self._held()]

    # -- registration / acquisition ------------------------------------
    def register(self, lock):
        with self._mu:
            self._locks_tracked += 1

    def on_acquired(self, lock):
        held = self._held()
        for h in held:
            if h.lock is lock:
                h.depth += 1
                return
        stack = _capture_stack()
        now = time.perf_counter()
        with self._mu:
            self._acquisitions += 1
        for h in held:
            if h.lock.name != lock.name:
                self._add_edge(h, lock, stack)
            elif h.lock is not lock:
                # a SECOND instance of the same lock class nested inside
                # the first (two pools, two metric locks, ...): the
                # class-level order graph cannot order instances, so the
                # opposite nesting elsewhere would be an undetectable
                # ABBA — report the nesting itself (the lockdep rule:
                # a lock class nested within itself needs an explicit
                # instance order)
                self.record(LockViolation(
                    "same-class-nesting",
                    "thread %r acquires a second %r instance while "
                    "holding one — cross-instance order is undefined "
                    "(potential ABBA the class-level graph cannot "
                    "see)\n    first instance acquired at:\n%s\n"
                    "    second instance acquired at:\n%s"
                    % (threading.current_thread().name, lock.name,
                       _fmt_stack(h.stack), _fmt_stack(stack)),
                    locks=(lock.name,),
                    threads=(threading.current_thread().name,),
                    stacks=(_fmt_stack(h.stack), _fmt_stack(stack))))
        held.append(_Held(lock, stack, now))

    def check_self_deadlock(self, lock):
        """Called BEFORE a blocking acquire of a non-reentrant lock: a
        re-acquire by the holder would hang forever, so report and raise
        instead of deadlocking the process."""
        for h in self._held():
            if h.lock is lock:
                v = LockViolation(
                    "self-deadlock",
                    "thread %r re-acquires non-reentrant lock %r it "
                    "already holds — this would deadlock\n"
                    "    first acquired at:\n%s\n    re-acquired at:\n%s"
                    % (threading.current_thread().name, lock.name,
                       _fmt_stack(h.stack), _fmt_stack(_capture_stack())),
                    locks=(lock.name,),
                    threads=(threading.current_thread().name,),
                    stacks=(_fmt_stack(h.stack),
                            _fmt_stack(_capture_stack())))
                self.record(v)
                raise LockCheckError([v])

    def on_release(self, lock):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            h = held[i]
            if h.lock is lock:
                h.depth -= 1
                if h.depth == 0:
                    del held[i]
                    self._note_hold(lock, time.perf_counter() - h.t0,
                                    h.stack)
                return
        # releasing a lock this thread never tracked as held (e.g.
        # acquired before tracking reset): nothing to account

    def _note_hold(self, lock, dt, stack):
        ms = dt * 1000.0
        threshold = _flags.env("PTPU_LOCK_HOLD_MS")
        with self._mu:
            if ms > self._max_hold_ms:
                self._max_hold_ms = ms
        if threshold is not None and ms > float(threshold):
            self.record(LockViolation(
                "long-hold",
                "lock %r held %.1f ms (> PTPU_LOCK_HOLD_MS=%s) by thread "
                "%r\n    acquired at:\n%s"
                % (lock.name, ms, threshold,
                   threading.current_thread().name, _fmt_stack(stack)),
                locks=(lock.name,),
                threads=(threading.current_thread().name,),
                stacks=(_fmt_stack(stack),)))

    # -- condition-wait bookkeeping ------------------------------------
    def pause_held(self, lock):
        """``Condition.wait`` is about to release ``lock`` (fully, even
        for an RLock — ``_release_save`` drops every recursion level).
        Pop its held entry so hold-time and blocking checks see the
        truth; returns the entry for ``resume_held``."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is lock:
                h = held.pop(i)
                self._note_hold(lock, time.perf_counter() - h.t0, h.stack)
                return h
        return None

    def resume_held(self, lock, entry):
        if entry is None:
            return
        entry.t0 = time.perf_counter()
        self._held().append(entry)

    def check_blocking(self, kind, site, exclude=None):
        """A blocking operation (queue/cond wait, device sync) is about
        to run on the calling thread: holding any tracked lock other
        than ``exclude`` across it is a liveness hazard."""
        others = [h for h in self._held() if h.lock is not exclude]
        if not others:
            return
        names = tuple(h.lock.name for h in others)
        self.record(LockViolation(
            "blocking-while-holding",
            "thread %r blocks on %s%s while holding tracked lock(s) %s\n"
            "    blocking at:\n%s\n    holding %r acquired at:\n%s"
            % (threading.current_thread().name, kind,
               " (%s)" % site if site else "", ", ".join(names),
               _fmt_stack(_capture_stack()), names[0],
               _fmt_stack(others[0].stack)),
            # locks holds LOCK names only (the documented contract);
            # the blocking site keys the dedup via detail instead
            locks=names,
            threads=(threading.current_thread().name,),
            stacks=(_fmt_stack(_capture_stack()),
                    _fmt_stack(others[0].stack)),
            detail=(kind, site)))

    # -- order graph ----------------------------------------------------
    def _add_edge(self, held_entry, lock, stack_to):
        a, b = held_entry.lock.name, lock.name
        tname = threading.current_thread().name
        with self._mu:
            if (a, b) in self._edges:
                return
            self._edges[(a, b)] = _EdgeInfo(tname, held_entry.stack,
                                            stack_to)
            self._adj.setdefault(a, set()).add(b)
            cycle = self._find_path(b, a)
        if cycle is not None:
            self._report_cycle(a, b, held_entry, stack_to, cycle)

    def _find_path(self, src, dst):
        """Holding _mu: a path src -> ... -> dst in the order graph, or
        None. Iterative DFS — the graph holds lock CLASSES, so it stays
        tiny."""
        stack, seen = [(src, (src,))], {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + (nxt,)))
        return None

    def _report_cycle(self, a, b, held_entry, stack_to, path):
        # path is b -> ... -> a; closing edge a -> b makes the cycle
        cycle_names = (a,) + path
        rev = self._edges.get((path[0], path[1])) if len(path) > 1 \
            else None
        tname = threading.current_thread().name
        msg = [
            "potential deadlock: lock-order cycle %s"
            % " -> ".join(cycle_names),
            "    thread %r holds %r, acquired at:" % (tname, a),
            _fmt_stack(held_entry.stack),
            "    and acquires %r at:" % b,
            _fmt_stack(stack_to),
        ]
        if rev is not None:
            msg += [
                "    conflicting order: thread %r held %r, acquired at:"
                % (rev.thread, path[0]),
                _fmt_stack(rev.stack_from),
                "    and acquired %r at:" % path[1],
                _fmt_stack(rev.stack_to),
            ]
        threads = (tname,) + ((rev.thread,) if rev is not None else ())
        self.record(LockViolation(
            "lock-order-cycle", "\n".join(msg),
            locks=tuple(dict.fromkeys(cycle_names)),
            threads=tuple(dict.fromkeys(threads)),
            stacks=(_fmt_stack(held_entry.stack), _fmt_stack(stack_to))
            + ((_fmt_stack(rev.stack_from), _fmt_stack(rev.stack_to))
               if rev is not None else ())))

    # -- violation accumulation ----------------------------------------
    def record(self, violation):
        with self._mu:
            if violation.key() in self._seen_keys:
                return
            self._seen_keys.add(violation.key())
            self._violations.append(violation)
        import warnings

        warnings.warn("PTPU_LOCK_CHECK: %r" % violation, RuntimeWarning,
                      stacklevel=2)
        # no publish() here: record() can run inside an acquisition
        # callback, and publishing touches the (tracked) metrics-registry
        # lock — the atexit hook, the engine invariant hook and explicit
        # publish_metrics() calls flush the gauges instead

    def violations(self):
        with self._mu:
            return list(self._violations)

    def stats(self):
        with self._mu:
            return {
                "locks_tracked": self._locks_tracked,
                "acquisitions": self._acquisitions,
                "order_edges": len(self._edges),
                "violations": len(self._violations),
                "max_hold_ms": self._max_hold_ms,
            }

    def reset(self):
        with self._mu:
            self._locks_tracked = 0
            self._acquisitions = 0
            self._max_hold_ms = 0.0
            self._edges.clear()
            self._adj.clear()
            del self._violations[:]
            self._seen_keys.clear()
        self._tls = threading.local()

    def publish(self):
        """Write the counters into the metrics registry as
        ``concurrency/*`` gauges (re-publishing is idempotent). Explicit
        registry use: they land in the ``PTPU_METRICS_OUT`` dump even
        with ``PTPU_METRICS`` unset."""
        try:
            from ..observability import metrics as _metrics
        except ImportError:  # pragma: no cover - interpreter teardown
            return
        snap = self.stats()
        reg = _metrics.registry()
        reg.gauge("concurrency/locks_tracked").set(snap["locks_tracked"])
        reg.gauge("concurrency/acquisitions").set(snap["acquisitions"])
        reg.gauge("concurrency/order_edges").set(snap["order_edges"])
        reg.gauge("concurrency/violations").set(snap["violations"])
        reg.gauge("concurrency/max_hold_ms").set(snap["max_hold_ms"])


# ---------------------------------------------------------------------------
# tracked primitives
# ---------------------------------------------------------------------------


class TrackedLock:
    """Drop-in ``threading.Lock`` recording held-set membership and
    order-graph edges. ``name`` is the stable per-site lock class."""

    _reentrant = False

    def __init__(self, name, tracker_=None, raw=None):
        """``raw`` adopts an existing primitive of the matching kind
        (used by TrackedCondition to wrap a caller-supplied plain lock —
        the flag-off path accepts any lock there, so the flag-on path
        must too)."""
        self.name = str(name)
        self._tracker = tracker_ or tracker()
        self._raw = raw if raw is not None else self._make_raw()
        self._tracker.register(self)

    def _make_raw(self):
        return threading.Lock()

    def acquire(self, blocking=True, timeout=-1):
        # the self-deadlock guard fires only for UNTIMED blocking
        # re-acquires — the case that would hang forever. A timed
        # acquire by the holder legitimately returns False after the
        # wait under plain threading, and the wrappers may not change
        # behavior
        if blocking and timeout == -1 and not self._reentrant:
            self._tracker.check_self_deadlock(self)
        got = self._raw.acquire(blocking, timeout)
        if got:
            self._tracker.on_acquired(self)
        return got

    def release(self):
        self._tracker.on_release(self)
        self._raw.release()

    def locked(self):
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return "<%s %r>" % (type(self).__name__, self.name)


class TrackedRLock(TrackedLock):
    """Drop-in ``threading.RLock``: re-acquisition by the holder bumps
    the held entry's depth — no self-deadlock check, no new edges."""

    _reentrant = True

    def _make_raw(self):
        return threading.RLock()

    def locked(self):
        # drop-in parity: RLock grows locked() in Python 3.12 —
        # delegate where it exists, raise AttributeError where the
        # plain primitive would have none
        raw = getattr(self._raw, "locked", None)
        if raw is None:
            raise AttributeError(
                "RLock.locked() is not available on this Python")
        return raw()


class TrackedCondition:
    """Drop-in ``threading.Condition`` over a tracked lock (default: a
    fresh ``TrackedRLock``, matching ``threading.Condition()``'s default
    RLock). ``wait`` checks blocking-while-holding against every OTHER
    tracked lock the thread holds, and pauses the held entry for the
    duration (the lock genuinely is released while waiting)."""

    def __init__(self, name, lock=None, tracker_=None):
        self.name = str(name)
        self._tracker = tracker_ or tracker()
        if lock is None:
            lock = TrackedRLock(name, self._tracker)
        elif not isinstance(lock, TrackedLock):
            # a caller-supplied PLAIN primitive (legal with the flag
            # off, so legal here too): adopt it as the tracked lock's
            # raw — reentrant wrapper iff it is an RLock
            cls = TrackedLock if isinstance(
                lock, type(threading.Lock())) else TrackedRLock
            lock = cls(name, self._tracker, raw=lock)
        self._lock = lock
        self._cond = threading.Condition(self._lock._raw)

    # -- lock surface --------------------------------------------------
    def acquire(self, *args, **kwargs):
        return self._lock.acquire(*args, **kwargs)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    # -- condition surface ---------------------------------------------
    def wait(self, timeout=None):
        self._tracker.check_blocking("Condition.wait", self.name,
                                     exclude=self._lock)
        entry = self._tracker.pause_held(self._lock)
        try:
            return self._cond.wait(timeout)
        finally:
            self._tracker.resume_held(self._lock, entry)

    def wait_for(self, predicate, timeout=None):
        endtime = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = time.monotonic() + waittime
                else:
                    waittime = endtime - time.monotonic()
                    if waittime <= 0:
                        break
            self.wait(waittime)
            result = predicate()
        return result

    def notify(self, n=1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()

    def __repr__(self):
        return "<TrackedCondition %r>" % self.name


# ---------------------------------------------------------------------------
# the factory + module-level surface
# ---------------------------------------------------------------------------

_TRACKER = None
_TRACKER_MU = threading.Lock()


def tracker():
    """The process-global :class:`LockTracker`, created on first use."""
    global _TRACKER
    if _TRACKER is None:
        with _TRACKER_MU:
            if _TRACKER is None:
                t = LockTracker()
                atexit.register(t.publish)
                _TRACKER = t
    return _TRACKER


def make_lock(name):
    """A mutex named ``name``: ``threading.Lock()`` when
    ``PTPU_LOCK_CHECK`` is unset (identity), else a
    :class:`TrackedLock`."""
    if not tracking_enabled():
        return threading.Lock()
    return TrackedLock(name)


def make_rlock(name):
    if not tracking_enabled():
        return threading.RLock()
    return TrackedRLock(name)


def make_condition(name, lock=None):
    """A condition variable named ``name``: ``threading.Condition(lock)``
    when ``PTPU_LOCK_CHECK`` is unset, else a
    :class:`TrackedCondition` (over a tracked RLock by default, matching
    the plain Condition's default)."""
    if not tracking_enabled():
        return threading.Condition(lock)
    return TrackedCondition(name, lock=lock)


class _NullRegion:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_REGION = _NullRegion()


def blocking_region(kind, site=""):
    """Declare a blocking operation (``queue.get``, ``Semaphore``
    acquire, a forced device sync): entering it with any tracked lock
    held records a ``blocking-while-holding`` violation. No-op (a shared
    null context, zero allocation) when tracking is off."""
    t = _TRACKER
    if t is None:
        return _NULL_REGION
    t.check_blocking(kind, site)
    return _NULL_REGION


def check_blocking(kind, site=""):
    """Imperative form of :func:`blocking_region` for call sites where a
    context manager is awkward (e.g. inside a loop body)."""
    t = _TRACKER
    if t is not None:
        t.check_blocking(kind, site)


def record_violation(rule, message, locks=(), threads=None, stacks=(),
                     detail=None):
    """Report a violation through the tracker (the runtime invariant
    hooks use this). ``detail`` keys apart different hazards sharing a
    lock set — pass the invariant/check name so each distinct failure
    reports once instead of the first one shadowing the rest. No-op
    when tracking never started."""
    t = _TRACKER
    if t is None:
        return None
    if threads is None:
        threads = (threading.current_thread().name,)
    v = LockViolation(rule, message, locks=locks, threads=threads,
                      stacks=stacks, detail=detail)
    t.record(v)
    return v


def violations():
    """Accumulated violations (empty when tracking never started)."""
    t = _TRACKER
    return t.violations() if t is not None else []


def assert_clean():
    """Raise :class:`LockCheckError` if any violation accumulated."""
    vs = violations()
    if vs:
        # passive flight-recorder hook: concurrency must stay importable
        # without observability, and must never fail a clean process by
        # failing to dump a dirty one
        blackbox = sys.modules.get(
            "paddle_tpu_torch.observability.flight_recorder")
        if blackbox is not None:
            try:
                blackbox.record_event("lock_check_failed",
                                      violations=len(vs),
                                      first=str(vs[0]))
                blackbox.dump("lock_check_failed")
            except Exception:
                pass
        raise LockCheckError(vs)


def stats():
    t = _TRACKER
    return t.stats() if t is not None else {
        "locks_tracked": 0, "acquisitions": 0, "order_edges": 0,
        "violations": 0, "max_hold_ms": 0.0}


def publish_metrics():
    """Write the ``concurrency/*`` gauges into the observability
    registry now (also runs at process exit once a tracker exists)."""
    t = _TRACKER
    if t is not None:
        t.publish()


def reset():
    """Clear tracked state (tests). Locks already created stay tracked
    by the same tracker; counters, edges and violations start over."""
    t = _TRACKER
    if t is not None:
        t.reset()
