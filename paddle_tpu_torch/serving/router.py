"""`ServingRouter` — the fault-tolerant fleet front end (the port of the
JAX package's ``serving/router.py``).

One router fronts N in-process :class:`ServingEngine` replicas, each
with its own scopes, worker threads, schedulers and KV pools; on a CUDA
card each replica's workers issue on streams of their own, the one-card
analogue of a replica owning its chip. The replicas share one
``GenerationModel``: its weights are only read. The router owns:

  dispatch      — least-loaded routing over each replica's
                  ``ServingEngine.load()`` (queued + in-batch), healthy
                  replicas before suspect ones, index order on ties
                  (deterministic).
  health        — a per-replica state machine ``healthy -> suspect ->
                  dead`` driven by consecutive step failures (the
                  engine's in-place transient retry count) and a
                  step-progress watchdog: a replica with pending work
                  whose dispatched-step count stops advancing is suspect
                  at half the stall budget and dead at the full budget.
                  A dead replica is put down with ``ServingEngine.kill``
                  so its scheduler drains through ``fail_all`` and its
                  pool ends empty.
  re-admission  — every request of a dead replica is resubmitted on a
                  survivor as ``prompt + emitted tokens`` with the
                  remaining ``max_new_tokens``: greedy decode is
                  history-deterministic, so the continuation is
                  token-identical to an unfailed run (the emitted tokens
                  are those the engine delivered; steps it dispatched
                  but never read back count for nothing). Attempts spend
                  a bounded per-request retry budget with exponential
                  backoff (``RetryBudgetExceededError`` when spent);
                  transient request errors take the same path, while
                  request-scoped failures (deadline, validation)
                  propagate.
  degradation   — when every replica refuses admission the request is
                  shed with a structured ``AdmissionError``
                  (``router/shed_requests``); per-request deadlines ride
                  down to the engines and are backstopped by the
                  router's monitor, so a wedged replica cannot hold a
                  caller forever.

Locking: ``serving.router`` (the in-flight table) and
``serving.router.request`` (per-request state, reentrant). Engine
callbacks may run under a worker's ``serving.engine.cv``, so the only
order ever taken is cv -> request -> router; no router lock is held
across a call into an engine.

The online-update surface adds ``drain(i)``/``undrain(i)`` (a draining
replica takes no new work, the stall watchdog ignores it, death
detection stays armed) and ``set_canary(i, pct)`` (~pct% of new requests
pinned to the canary replica). Every dispatch latches the replica's
weight version on the request, and re-admission is version-consistent:
a survivor on the same version continues prompt + committed; when only
other-version survivors exist the request restarts from its prompt
(``router/version_restarts``).

Telemetry: ``router/{replicas_healthy,draining,failovers,readmitted,
retries,deadline_expired,shed_requests,version_restarts}`` and
``online/canary_requests``, mirrored by host-side counters in
:meth:`ServingRouter.stats` that stay live with metrics off. With the
endpoint on (``PTPU_METRICS_PORT``) the router registers its replicas'
states and loads, failovers and sheds at ``/healthz``.
"""

import itertools
import threading
import time
from collections import deque

from .. import resilience as _resil
from ..analysis import concurrency as _conc
from ..flags import env as _env
from ..observability import flight_recorder as _blackbox
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from .engine import ServingEngine
from .scheduler import (AdmissionError, DeadlineExceededError,
                        GenerationRequest, check_request_args)

__all__ = ["ServingRouter", "RouterRequest",
           "HEALTHY", "SUSPECT", "DRAINING", "DEAD"]

HEALTHY = "healthy"
SUSPECT = "suspect"
DRAINING = "draining"
DEAD = "dead"

_router_req_ids = itertools.count()


class _Deferred:
    """Sentinel installed as a request's current attempt while a retry
    for it is parked in the failure queue: other event sources (the
    ``_declare_dead`` stranded scan) recognize it and stand down — the
    parked retry already owns this request's recovery, and matching the
    sentinel from a second event would double-spend the budget."""

    __slots__ = ()


class _Replica:
    """Router-side view of one engine replica: the health state machine
    and the watchdog's PER-WORKER progress bookkeeping (an engine hosts
    one worker per model — a wedged worker must not hide behind a
    progressing sibling)."""

    __slots__ = ("idx", "engine", "state", "error", "progress")

    def __init__(self, idx, engine):
        self.idx = idx
        self.engine = engine
        self.state = HEALTHY
        self.error = None
        self.progress = {}   # worker name -> (steps, last_progress_t)


class RouterRequest:
    """One fleet-level generation request: survives replica failover.

    The committed token list spans every attempt — already-emitted
    tokens are never re-streamed, and the user ``stream`` callback sees
    one in-order token sequence no matter how many replicas served
    parts of it. ``wait()``/``finished``/``latency`` mirror the
    engine-level :class:`GenerationRequest`.
    """

    def __init__(self, router, prompt, max_new_tokens, eos_id, stream,
                 model, deadline_s):
        prompt = check_request_args(prompt, max_new_tokens, deadline_s)
        self.id = next(_router_req_ids)
        # ONE trace id for the request's whole fleet-level life: every
        # engine-side attempt (including failover re-dispatches onto a
        # survivor) carries it, so the Perfetto dump renders the full
        # story — queue_wait on the dying replica through readmit and
        # the survivor's decode windows — as a single trace
        self.trace_id = _tracing.new_trace_id() if _tracing.enabled() \
            else None
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.stream = stream
        self.model = model
        self.submit_time = time.perf_counter()
        self.deadline = (self.submit_time + float(deadline_s)
                         if deadline_s is not None else None)
        self.finish_time = None
        self.tokens = []            # committed across every attempt
        self.error = None
        self.retries = 0            # re-admission budget spent
        self.readmissions = 0       # successful re-admissions
        # weight version the committed tokens are attributable to
        # (latched at each dispatch).
        # version_restarts counts from-the-prompt restarts forced by a
        # re-admission that could only land on a different version.
        self.weight_version = None
        self.version_restarts = 0
        self._done = threading.Event()
        # reentrant: _on_finish finalizes (which re-takes it) while
        # holding it to keep the attempt hand-off atomic
        self._lock = _conc.make_rlock("serving.router.request")
        self._router = router
        self._attempt = None        # current engine-side request
        self._base_len = 0          # committed tokens when it started
        self._replica = None
        # user-stream ordering across failover: commits enqueue under
        # the lock, ONE drainer at a time delivers in queue order (a
        # dying replica's thread preempted between commit and callback
        # cannot let the survivor stream a later token first)
        self._stream_queue = deque()
        self._streaming = False

    # -- completion surface --------------------------------------------
    @property
    def finished(self):
        return self._done.is_set()

    def wait(self, timeout=None):
        """Block until the request completed (across any failovers);
        returns the full generated token list. Raises the routed
        error, if any."""
        if not self._done.wait(timeout):
            raise TimeoutError("router request %d not finished" % self.id)
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    @property
    def latency(self):
        if self.finish_time is None:
            return None
        return self.finish_time - self.submit_time

    def _finalize(self, error):
        """Idempotent terminal transition (engine threads, the monitor,
        or the submit path on total failure)."""
        with self._lock:
            if self._done.is_set():
                return False
            self.error = error
            self.finish_time = time.perf_counter()
            self._attempt = None     # orphan any straggler callbacks
            self._done.set()
        self._router._request_done(self, error)
        return True

    # -- engine-thread callbacks ---------------------------------------
    def _on_token(self, engine_req, token, final):
        """Stream tap: commit each token as its attempt emits it. A
        stale attempt (orphaned by failover) is dropped — its tokens
        were either already committed or will be regenerated
        identically by the re-admitted attempt. The user callback is
        delivered OUTSIDE the lock (it may block) but in commit order:
        tokens enqueue under the lock and a single drainer at a time
        delivers them, so a failover handing the stream from a dying
        worker to a survivor cannot reorder."""
        with self._lock:
            if self._attempt is not engine_req or self._done.is_set():
                return
            self.tokens.append(int(token))
            if self.stream is None:
                return
            self._stream_queue.append((int(token), bool(final)))
            if self._streaming:
                return  # the active drainer will deliver this in order
            self._streaming = True
        while True:
            with self._lock:
                if not self._stream_queue:
                    self._streaming = False
                    return
                tok, fin = self._stream_queue.popleft()
            try:
                self.stream(self, tok, fin)
            except Exception:
                pass  # a streaming consumer must not kill the engine

    def _on_finish(self, engine_req):
        """Attempt-completion hook (may run under the failing worker's
        cv lock — it never calls back into any engine). Success
        finalizes; failure is handed to the router's monitor thread,
        which decides propagate-vs-re-admit without engine locks
        held."""
        with self._lock:
            if self._attempt is not engine_req or self._done.is_set():
                return
            if engine_req.error is None:
                # reconcile against the attempt's authoritative token
                # list: the reap fallback can finish a sequence without
                # a final stream callback
                self.tokens[self._base_len:] = [
                    int(t) for t in engine_req.tokens]
        if engine_req.error is None:
            self._finalize(None)
        else:
            self._router._attempt_failed(self, engine_req,
                                         engine_req.error)


class ServingRouter:
    """Fault-tolerant request router over N ``ServingEngine`` replicas
    (see module docstring).

    ``models`` is whatever :class:`ServingEngine` accepts (one model, an
    artifact dir, or a ``{name: model}`` dict); every replica serves the
    same set. ``replicas`` defaults to ``$PTPU_SERVE_REPLICAS``,
    ``deadline_s`` to ``$PTPU_SERVE_DEADLINE_S`` and ``retry_budget``
    to ``$PTPU_SERVE_RETRY_BUDGET``; the remaining keyword arguments
    pass through to each engine.

    Watchdog contract: ``stall_timeout_s`` must exceed the worst-case
    single step time INCLUDING a kernel build at first use — the
    watchdog cannot see inside a dispatched step, so a build longer than
    the budget reads as a stall and the replica is put down. Build the
    kernels (``ops._build.build()``) or warm each replica with one
    primer request before tightening the budget.
    """

    def __init__(self, models, replicas=None, deadline_s=None,
                 retry_budget=None, backoff_base=None, backoff_max=2.0,
                 suspect_after=2, stall_timeout_s=10.0,
                 health_interval_s=0.05, **engine_kwargs):
        if replicas is None:
            replicas = _env("PTPU_SERVE_REPLICAS")
        replicas = int(replicas)
        if replicas < 1:
            raise ValueError("ServingRouter needs >= 1 replica, got %d"
                             % replicas)
        if deadline_s is None:
            deadline_s = _env("PTPU_SERVE_DEADLINE_S")
        if retry_budget is None:
            retry_budget = _env("PTPU_SERVE_RETRY_BUDGET")
        if backoff_base is None:
            backoff_base = _env("PTPU_RETRY_BACKOFF")
        self._deadline_s = deadline_s
        self._retry_budget = max(0, int(retry_budget))
        self._backoff_base = float(backoff_base)
        self._backoff_max = float(backoff_max)
        self._suspect_after = max(1, int(suspect_after))
        self._stall_timeout_s = float(stall_timeout_s)
        self._health_interval_s = float(health_interval_s)
        self._replicas = [
            _Replica(i, ServingEngine(models, deadline_s=deadline_s,
                                      **engine_kwargs))
            for i in range(replicas)]
        # host-side counters (live with metrics off; stats() reads them)
        self._failovers = 0
        self._readmitted = 0
        self._retries = 0
        self._shed = 0
        self._deadline_expired = 0
        self._completed = 0
        self._failed = 0
        self._submitted = 0
        self._version_restarts = 0
        self._canary_requests = 0
        # canary pinning: while an
        # OnlineUpdater rollout is in its canary phase this holds
        # (replica_idx, pct) — ~pct% of NEW requests are pinned to the
        # canary replica, the rest stay on incumbents. None (the
        # default, PTPU_SERVE_CANARY_PCT unset) leaves routing
        # bitwise-legacy.
        self._canary = None
        # per-weight-version outcome cohorts, accrued only while a
        # canary is pinned (the comparison window): version ->
        # [completed, failed, latency_sum_s]. The CanaryGate reads
        # these to judge the candidate against the incumbent.
        self._version_ledger = {}
        self._lock = _conc.make_lock("serving.router")
        self._inflight = set()
        self._failures = deque()    # (RouterRequest, attempt, error)
        self._wake = threading.Event()
        self._closed = False
        self._stopping = False
        _metrics.gauge("router/replicas_healthy").set(replicas)
        self._health_key = None
        from ..observability import endpoint as _endpoint

        if _endpoint.enabled():
            self._health_key = "router-%x" % id(self)
            _endpoint.register_health_provider(self._health_key,
                                               self._health_json)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="ptpu-serve-router",
            daemon=True)
        self._monitor.start()

    def _health_json(self):
        """Fleet health for ``/healthz``: each replica's state and load,
        and the counters that matter when paging (failovers, sheds)."""
        with self._lock:
            failovers, shed = self._failovers, self._shed
        return {
            "replicas": [{"idx": r.idx, "state": r.state,
                          "load": r.engine.load()}
                         for r in self._replicas],
            "replicas_healthy": sum(1 for r in self._replicas
                                    if r.state == HEALTHY),
            "failovers": failovers,
            "shed_requests": shed,
        }

    # -- public API -----------------------------------------------------
    @property
    def num_replicas(self):
        return len(self._replicas)

    def replica_states(self):
        """Health state per replica, index order."""
        return [r.state for r in self._replicas]

    def replica_engine(self, idx):
        """The idx-th replica's engine (testing/inspection surface)."""
        return self._replicas[idx].engine

    # -- online-update surface -------
    def drain(self, idx):
        """Mark replica ``idx`` draining: dispatch skips it, the stall
        watchdog ignores it (a draining replica legitimately idles),
        and its in-flight requests run to completion — or re-admit on
        survivors through the normal failover path if it dies
        mid-drain. The quiesce half of a weight swap. Idempotent;
        returns False when the replica is already dead."""
        rep = self._replicas[idx]
        if rep.state == DEAD:
            return False
        self._set_state(rep, DRAINING)
        self._update_draining_gauge()
        return True

    def undrain(self, idx):
        """Re-admit replica ``idx`` to dispatch after a drain (state
        back to healthy, watchdog bookkeeping reset so the idle drain
        period never reads as a stall). Returns False — never
        resurrecting — when the replica is not draining (e.g. it died
        mid-drain and the failover path already owns its requests)."""
        rep = self._replicas[idx]
        if rep.state != DRAINING:
            return False
        rep.progress.clear()
        self._set_state(rep, HEALTHY)
        self._update_draining_gauge()
        return True

    def wait_drained(self, idx, timeout=30.0):
        """Block until draining replica ``idx`` holds no queued or
        in-batch work (its in-flight requests finished on its current
        weights). Returns True when drained, False when the replica
        died first (its requests re-admit on survivors); raises
        ``TimeoutError`` when the budget runs out."""
        rep = self._replicas[idx]
        deadline = time.monotonic() + float(timeout)
        while True:
            if rep.state == DEAD:
                return False
            if rep.engine.load() == 0:
                return True
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    "replica %d still holds %d requests after %.1fs of "
                    "draining" % (idx, rep.engine.load(), timeout))
            time.sleep(0.005)

    def set_canary(self, idx, pct):
        """Pin ~``pct``% of NEW requests to replica ``idx`` (the canary
        serving a candidate weight version); the rest stay on the
        incumbent replicas as the control cohort. The OnlineUpdater
        sets this for the canary phase of every rollout
        (``$PTPU_SERVE_CANARY_PCT``) and clears it on promote or
        rollback."""
        with self._lock:
            self._version_ledger = {}
            self._canary = (int(idx), float(pct))

    def clear_canary(self):
        self._canary = None

    def version_ledger(self):
        """Per-weight-version request outcomes accrued while a canary
        was pinned: ``{version: (completed, failed, latency_sum_s)}``.
        The candidate cohort is the pinned traffic, the incumbent
        cohort everything else over the same window — the CanaryGate's
        raw signals."""
        with self._lock:
            return {v: tuple(led)
                    for v, led in self._version_ledger.items()}

    def _update_draining_gauge(self):
        _metrics.gauge("router/draining").set(
            sum(1 for r in self._replicas if r.state == DRAINING))

    def submit(self, prompt, max_new_tokens=32, eos_id=None, stream=None,
               model=None, deadline_s=None):
        """Route one request to the least-loaded live replica; returns
        the :class:`RouterRequest` handle. When every replica refuses
        admission the request is shed with :class:`AdmissionError`
        (``router/shed_requests``) — bounded degradation instead of an
        unbounded queue."""
        if self._closed:
            raise RuntimeError("ServingRouter is closed")
        if deadline_s is None:
            deadline_s = self._deadline_s
        rreq = RouterRequest(self, prompt, max_new_tokens, eos_id,
                             stream, model, deadline_s)
        with self._lock:
            self._inflight.add(rreq)
            self._submitted += 1
        errors = []
        cands = self._candidates()
        canary = self._canary
        canary_rep = None
        if canary is not None:
            # deterministic per-request pinning (a hash of the request
            # id, not a coin flip — replayable): pinned requests try
            # the canary first, the rest avoid it so the incumbent
            # cohort stays a clean control group. Availability beats
            # pinning: either cohort falls through to the other side
            # rather than shedding.
            idx, pct = canary
            rep = self._replicas[idx]
            if rep.state not in (DEAD, DRAINING):
                canary_rep = rep
                pinned = (rreq.id * 2654435761 % 100) < pct
                rest = [c for c in cands if c is not rep]
                cands = ([rep] + rest) if pinned else (rest + [rep])
        for rep in cands:
            try:
                self._dispatch(rreq, rep)
                if rep is canary_rep:
                    with self._lock:
                        self._canary_requests += 1
                    _metrics.counter("online/canary_requests").inc()
                return rreq
            except (AdmissionError, RuntimeError, KeyError) as e:
                errors.append(e)
        with self._lock:
            self._inflight.discard(rreq)
        admission = [e for e in errors if isinstance(e, AdmissionError)]
        if admission:
            # any saturated replica makes this a shed, even when other
            # candidates failed differently (e.g. killed-but-not-yet-
            # polled-DEAD replicas raise 'closed' during the failover
            # window) — a genuine capacity refusal must never surface
            # as a raw engine error or dodge the shed ledger
            with self._lock:
                self._shed += 1
            _metrics.counter("router/shed_requests").inc()
            raise AdmissionError(
                "router: all %d replicas refused admission (saturated "
                "fleet) — retry later, raise max_queue, or add "
                "replicas; last: %s" % (len(self._replicas),
                                        admission[-1]))
        if errors and all(isinstance(e, KeyError) for e in errors):
            raise errors[-1]  # request-scoped (unknown model), not fleet
        if errors:
            raise RuntimeError(
                "router: no live replica accepted the request "
                "(states: %r); last error: %r"
                % (self.replica_states(), errors[-1])) from errors[-1]
        raise RuntimeError("router: no live replicas "
                           "(states: %r)" % (self.replica_states(),))

    def result(self, request, timeout=None):
        """Block until `request` completed; returns its token list."""
        return request.wait(timeout)

    def generate(self, prompt, max_new_tokens=32, eos_id=None,
                 model=None, timeout=None, deadline_s=None):
        """Synchronous convenience: submit + wait."""
        return self.result(
            self.submit(prompt, max_new_tokens=max_new_tokens,
                        eos_id=eos_id, model=model,
                        deadline_s=deadline_s), timeout)

    def stats(self):
        """The router ledger plus per-replica engine stats."""
        with self._lock:
            inflight = len(self._inflight)
        return {
            "replicas": [{"idx": r.idx, "state": r.state,
                          "load": r.engine.load(),
                          "weight_version":
                              r.engine.weight_version(),
                          **{"model:%s" % k: v
                             for k, v in r.engine.stats().items()}}
                         for r in self._replicas],
            "replicas_healthy": sum(1 for r in self._replicas
                                    if r.state == HEALTHY),
            "replicas_draining": sum(1 for r in self._replicas
                                     if r.state == DRAINING),
            "failovers": self._failovers,
            "readmitted": self._readmitted,
            "retries": self._retries,
            "shed_requests": self._shed,
            "deadline_expired": self._deadline_expired,
            "requests_submitted": self._submitted,
            "requests_completed": self._completed,
            "requests_failed": self._failed,
            "canary_requests": self._canary_requests,
            "version_restarts": self._version_restarts,
            "inflight": inflight,
        }

    def close(self, timeout=30.0):
        """Drain and close every replica, then stop the health
        monitor — in that order, so a replica dying during the drain
        still has a live monitor to fail its requests over (or fail
        them out). Anything left un-finalized after the monitor exits
        is failed loudly rather than stranding a waiter forever."""
        if self._closed and self._stopping:
            return
        self._closed = True
        if self._health_key is not None:
            from ..observability import endpoint as _endpoint

            _endpoint.unregister_health_provider(self._health_key)
            self._health_key = None
        for rep in self._replicas:
            rep.engine.close(timeout)
        self._stopping = True
        self._wake.set()
        self._monitor.join(timeout)
        self._drain_failures()  # parked entries with no monitor left
        with self._lock:
            stranded = [r for r in self._inflight if not r.finished]
        for rreq in stranded:
            rreq._finalize(RuntimeError(
                "ServingRouter closed with request %d still in flight"
                % rreq.id))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatch -------------------------------------------------------
    def _candidates(self):
        """Dispatchable replicas, healthy before suspect, least-loaded
        first, index order on ties (deterministic routing). Draining
        replicas are skipped — they finish what they hold but take no
        new work (the rolling weight-swap contract) — as are dead
        ones."""
        live = [r for r in self._replicas
                if r.state not in (DEAD, DRAINING)]
        return sorted(live, key=lambda r: (r.state != HEALTHY,
                                           r.engine.load(), r.idx))

    def _dispatch(self, rreq, rep):
        """Build and submit one engine-side attempt. The attempt is
        attached under the request lock BEFORE the engine sees it, so
        no token can flow past an unattached recorder; no router lock
        is held across the engine call."""
        committed = list(rreq.tokens)
        attempt = GenerationRequest(
            rreq.prompt + committed,
            max_new_tokens=rreq.max_new_tokens - len(committed),
            eos_id=rreq.eos_id, stream=rreq._on_token,
            model=rreq.model, on_finish=rreq._on_finish,
            trace_id=rreq.trace_id)
        # carry the ABSOLUTE deadline across attempts (perf_counter
        # clock, same as GenerationRequest.submit_time)
        attempt.deadline = rreq.deadline
        with rreq._lock:
            rreq._attempt = attempt
            rreq._base_len = len(committed)
            # latch the serving weight version: every token this
            # attempt emits is attributable to it (swaps only apply to
            # drained replicas, so the version cannot move under a
            # dispatched attempt)
            rreq.weight_version = rep.engine.weight_version(rreq.model)
        rep.engine.submit_request(attempt)
        # the replica binding lands only once the submit DID: a
        # never-submitted attempt must stay invisible to
        # _declare_dead's stranded scan, or the scan and the caller's
        # try-next-candidate loop could each re-dispatch the same
        # request (a kill-driven fail_all covers everything that was
        # actually enqueued)
        with rreq._lock:
            rreq._replica = rep
        return attempt

    # -- failure intake (engine threads) --------------------------------
    def _attempt_failed(self, rreq, attempt, error):
        """Called from engine threads (possibly under a worker cv): park
        the failed attempt for the monitor thread, which owns the
        propagate-vs-re-admit decision. deque.append is atomic — no
        lock taken here."""
        self._failures.append((rreq, attempt, error))
        self._wake.set()

    def _request_done(self, rreq, error):
        # ledger increments live under the router lock: _finalize runs
        # on whichever thread got there (engine workers, the monitor),
        # and an unlocked += would lose counts under contention
        with self._lock:
            self._inflight.discard(rreq)
            if error is None:
                self._completed += 1
            else:
                self._failed += 1
                if isinstance(error, DeadlineExceededError):
                    self._deadline_expired += 1
            if self._canary is not None and rreq.weight_version is not None:
                led = self._version_ledger.setdefault(
                    rreq.weight_version, [0, 0, 0.0])
                if error is None:
                    led[0] += 1
                    if rreq.latency is not None:
                        led[2] += rreq.latency
                else:
                    led[1] += 1
        if isinstance(error, DeadlineExceededError):
            _metrics.counter("router/deadline_expired").inc()

    # -- the monitor: health state machine + re-admission ---------------
    def _monitor_loop(self):
        while not self._stopping:
            self._wake.wait(self._health_interval_s)
            self._wake.clear()
            if self._stopping:
                return
            try:
                self._poll_health()
                self._expire_deadlines()
                self._drain_failures()
            except Exception as e:
                # the monitor IS the failover path — it must survive a
                # bug in one iteration rather than silently leaving the
                # fleet unwatched (requests would hang forever)
                import warnings
                warnings.warn("serving-router monitor iteration failed "
                              "(fleet still watched): %r" % (e,),
                              RuntimeWarning)

    def _poll_health(self):
        now = time.monotonic()
        for rep in self._replicas:
            if rep.state == DEAD:
                continue
            h = rep.engine.health()
            death = next((w["error"] for w in h.values()
                          if w["error"] is not None), None)
            alive = all(w["alive"] for w in h.values())
            if death is None and not alive \
                    and (self._closed or rep.engine._closed):
                continue  # clean worker exit during close — not death
            if death is not None or not alive:
                self._declare_dead(rep, death or RuntimeError(
                    "replica %d worker thread died" % rep.idx))
                continue
            if rep.state == DRAINING:
                # death detection above still applies (a replica killed
                # mid-drain must fail over), but the stall watchdog and
                # the healthy/suspect transitions stand down: a
                # draining replica legitimately idles, and only
                # undrain() may put it back in dispatch
                continue
            # per-worker progress: a wedged worker must not be masked
            # by a progressing sibling model's step counter
            stalled_for = 0.0
            for name, w in h.items():
                last = rep.progress.get(name)
                if last is None or w["steps"] != last[0] \
                        or not w["busy"]:
                    rep.progress[name] = (w["steps"], now)
                else:
                    stalled_for = max(stalled_for, now - last[1])
            consec = max(w["consecutive_transient_errors"]
                         for w in h.values())
            if stalled_for >= self._stall_timeout_s:
                self._declare_dead(rep, RuntimeError(
                    "replica %d stalled: work pending but no step "
                    "dispatched for %.2fs (stall_timeout_s=%.2f)"
                    % (rep.idx, stalled_for, self._stall_timeout_s)))
            elif (stalled_for >= self._stall_timeout_s / 2.0
                    or consec >= self._suspect_after):
                self._set_state(rep, SUSPECT)
            else:
                self._set_state(rep, HEALTHY)
        _metrics.gauge("router/replicas_healthy").set(
            sum(1 for r in self._replicas if r.state == HEALTHY))
        self._update_draining_gauge()

    @staticmethod
    def _set_state(rep, new):
        """State write with flight-recorder breadcrumb on CHANGE only —
        the steady-state healthy->healthy poll must not flood the
        ring."""
        old = rep.state
        if old != new:
            rep.state = new
            _blackbox.record_event("health_transition", replica=rep.idx,
                                   previous=old, state=new)

    def _declare_dead(self, rep, error):
        """healthy/suspect -> dead: put the replica down (fail_all
        drains its scheduler and KV pool, delivering a failure event
        per in-flight request) and synthesize failure events for any
        request a truly wedged worker could never deliver."""
        if rep.state == DEAD:
            return
        self._set_state(rep, DEAD)
        rep.error = error
        self._failovers += 1
        _metrics.counter("router/failovers").inc()
        _blackbox.record_event("replica_dead", replica=rep.idx,
                               error=repr(error))
        _blackbox.dump("replica_dead")
        rep.engine.kill(error)
        with self._lock:
            # sentinel-held requests already have a parked retry in the
            # failure queue owning their recovery (the dead replica is
            # excluded from candidates once it lands) — synthesizing a
            # second event for them would double-spend the budget
            stranded = [r for r in self._inflight
                        if r._replica is rep and not r.finished
                        and not isinstance(r._attempt, _Deferred)]
        for rreq in stranded:
            # the attempt-identity check in _readmit dedupes against
            # the kill-driven event for the same attempt
            self._failures.append((rreq, rreq._attempt, error))
        if stranded:
            self._wake.set()

    def _expire_deadlines(self):
        """Router-side deadline backstop: the engine enforces deadlines
        at its step boundaries, but a wedged worker has no step
        boundaries — the monitor fails such requests directly."""
        now = time.perf_counter()
        with self._lock:
            expired = [r for r in self._inflight
                       if r.deadline is not None and now >= r.deadline
                       and not r.finished]
        for rreq in expired:
            rreq._finalize(DeadlineExceededError(
                "router request %d exceeded its deadline (%d/%d tokens "
                "emitted)" % (rreq.id, len(rreq.tokens),
                              rreq.max_new_tokens)))

    def _drain_failures(self):
        """Process each parked failure at most once per pass. Entries
        are ``(rreq, attempt, error)`` (fresh, from engine threads) or
        ``(rreq, attempt, error, ready_at, budget_spent)`` (deferred
        retries the monitor scheduled — backoff is a not-before
        timestamp checked here, never a blocking sleep: the monitor
        must keep polling health and deadlines while requests back
        off)."""
        now = time.monotonic()
        for _ in range(len(self._failures)):
            try:
                item = self._failures.popleft()
            except IndexError:
                return
            if len(item) == 3:
                rreq, attempt, error = item
                ready_at, budget_spent = 0.0, False
            else:
                rreq, attempt, error, ready_at, budget_spent = item
            if ready_at > now:
                self._failures.append(item)  # not due yet: next pass
                continue
            self._handle_failure(rreq, attempt, error, budget_spent)

    def _should_failover(self, error, rep):
        """Re-admit vs propagate: replica-scoped failures (the dead
        replica's own latched error, transients) fail over;
        request-scoped failures (deadline, validation) belong to the
        caller."""
        if isinstance(error, DeadlineExceededError):
            return False
        if _resil.is_transient_error(error):
            return True
        if rep is None or rep.state == DEAD or rep.error is error:
            return True
        # the error fail_all delivered is the worker's latched death
        # error — identity-match it even before the poll marks the
        # replica dead
        return any(error is w.error
                   for w in rep.engine._workers.values())

    def _handle_failure(self, rreq, attempt, error, budget_spent=False):
        with rreq._lock:
            if rreq.finished or rreq._attempt is not attempt:
                return  # already finalized or superseded (dedup)
            rreq._attempt = None
            rep = rreq._replica
            committed = len(rreq.tokens)
            hit_eos = bool(rreq.eos_id is not None and rreq.tokens
                           and rreq.tokens[-1] == rreq.eos_id)
        if committed >= rreq.max_new_tokens or hit_eos:
            # the replica died in the gap between committing the final
            # token and finishing the request — the work is complete,
            # and re-dispatching with a zero token budget would be
            # nonsense (GenerationRequest rejects it)
            rreq._finalize(None)
            return
        if not self._should_failover(error, rep):
            rreq._finalize(error)
            return
        if not budget_spent:
            if rreq.retries >= self._retry_budget:
                _blackbox.record_event("retry_budget_exhausted",
                                       request=rreq.id,
                                       retries=rreq.retries,
                                       error=repr(error))
                _blackbox.dump("retry_budget_exceeded")
                rreq._finalize(_resil.RetryBudgetExceededError(
                    "router re-admission budget (%d) exhausted for "
                    "request %d; last error: %r"
                    % (self._retry_budget, rreq.id, error)))
                return
            rreq.retries += 1
            self._retries += 1
            _metrics.counter("router/retries").inc()
            delay = min(self._backoff_max,
                        self._backoff_base
                        * (2.0 ** (rreq.retries - 1)))
            if delay > 0:
                # defer, never sleep: the monitor keeps watching the
                # fleet while this request backs off. The parked entry
                # carries a unique typed sentinel installed as the
                # current attempt: a stale event for this request fails
                # the identity check, and _declare_dead's stranded scan
                # skips sentinel-held requests outright instead of
                # synthesizing a second (budget-double-spending) event
                token = _Deferred()
                with rreq._lock:
                    rreq._attempt = token
                self._failures.append(
                    (rreq, token, error,
                     time.monotonic() + delay, True))
                return
        if rreq.deadline is not None \
                and time.perf_counter() >= rreq.deadline:
            rreq._finalize(DeadlineExceededError(
                "router request %d exceeded its deadline during "
                "failover" % rreq.id))
            return
        candidates = [r for r in self._candidates() if r is not rep]
        if not candidates and rep is not None and rep.state != DEAD:
            candidates = [rep]  # transient on a live replica: retry it
        if committed and rreq.weight_version is not None and candidates:
            # per-version token attribution: continuing prompt+committed
            # on a survivor
            # running DIFFERENT weights would split the stream across
            # two versions. Prefer same-version survivors (the common
            # case mid-rollout — a steady fleet is all one version, so
            # this filter is an identity there); when none exist,
            # restart from the prompt so the regenerated stream is
            # wholly attributable to the version that serves it.
            same = [r for r in candidates
                    if r.engine.weight_version(rreq.model)
                    == rreq.weight_version]
            if same:
                candidates = same
            else:
                with rreq._lock:
                    del rreq.tokens[:]
                rreq.version_restarts += 1
                with self._lock:
                    self._version_restarts += 1
                _metrics.counter("router/version_restarts").inc()
                _blackbox.record_event("version_restart",
                                       request=rreq.id,
                                       version=rreq.weight_version,
                                       committed=committed)
                committed = 0
        for cand in candidates:
            try:
                self._dispatch(rreq, cand)
            except (AdmissionError, RuntimeError, KeyError,
                    ValueError) as e:
                error = e
                continue
            self._readmitted += 1
            rreq.readmissions += 1
            _metrics.counter("router/readmitted").inc()
            _blackbox.record_event("readmit", request=rreq.id,
                                   replica=cand.idx,
                                   committed=committed)
            if rreq.trace_id is not None:
                _tracing.instant("readmit", trace_id=rreq.trace_id,
                                 request=rreq.id, replica=cand.idx,
                                 committed=committed)
            return
        if any(r.state != DEAD for r in self._replicas):
            # nowhere to land right now (saturated survivors): spend
            # another retry next pass — at least one monitor interval
            # away, so the survivor gets time to drain — rather than
            # dropping (sentinel attempt for the same dedup reason as
            # the backoff deferral above)
            token = _Deferred()
            with rreq._lock:
                rreq._attempt = token
            self._failures.append((rreq, token, error))
            return
        rreq._finalize(RuntimeError(
            "router: no surviving replica to re-admit request %d "
            "(states: %r); last error: %r"
            % (rreq.id, self.replica_states(), error)))
