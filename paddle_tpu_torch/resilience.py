"""Fault tolerance for training, serving and checkpoints (parity: the JAX
package's ``resilience.py``).

The trainer side (:86-1070):

  * guarded steps: ``ResilientTrainer`` dispatches steps asynchronously
    (``Executor.run(return_numpy=False)``, the in-flight window) and
    validates the fetched losses in batches at sync points: one host
    read per ``guard_every`` steps, no added per-step sync. NaN/Inf and
    loss-spike anomalies (``AnomalyDetector``) route through a policy
    (``warn | skip_batch | rollback | abort``, ``PTPU_ANOMALY_POLICY``);
  * rollback and retry: host snapshots of the scope at each validated
    boundary (``snapshot_scope``; every tensor copied off the card, so
    the next step's in-place update cannot reach it); on an anomaly or
    a transient failure the last-good snapshot is restored onto the
    devices and dtypes it was taken from, the window's good steps are
    replayed AT THEIR ORIGINAL ``__step_counter__`` and the poisoned
    step retried (``rollback``, spending a retry budget with
    exponential backoff) or dropped (``skip_batch``);
  * checkpoints: ``ResilientTrainer(checkpoint_dir=...)`` saves every
    ``checkpoint_every`` steps from the snapshot on a background thread
    (``checkpoint.CheckpointManager``); ``restore()`` loads the newest
    intact step, the data cursor (``__data_cursor__``) with it;
  * preemption: SIGTERM/SIGINT set a flag (``PreemptionGuard``); the
    trainer notices at the next step boundary, drains the window,
    validates, writes an emergency checkpoint and returns
    ``TrainResult.preempted=True``.

The trainer fires ``nan_at_step``, ``sigterm_at_step`` and
``transient_at_step``; the executor fires ``transient_compile`` at the
first run of a new step plan; the shard reader fires
``data_corrupt_shard`` and ``data_stall_shard``
(``maybe_inject_shard_fault``). As in the JAX package, ``nan_at_step``
poisons the step's first float feed value, and does nothing on a step
whose feeds hold none (an LM's token ids).

The serving side:

  * the error types the fleet raises and classifies:
    ``RetryBudgetExceededError`` (a router request spent its
    re-admission budget), ``InjectedTransientError`` and
    ``InjectedReplicaDeathError`` (what the fault sites raise);
  * ``is_transient_error``: which failures a serving worker retries in
    place and the router re-admits as transient;
  * ``FaultInjector``: deterministic one-shot fault sites
    (``$PTPU_FAULT_INJECT``, the JAX package's spec syntax), with
    ``global_injector`` / ``set_global_injector``;
  * the hooks the serving engine, the online updater and the canary gate
    call: ``maybe_inject_serve_fault``, ``maybe_inject_swap_death`` and
    ``maybe_inject_canary_anomaly``. The checkpoint writer and the
    artifact writer fire ``ckpt_torn_write`` and ``ckpt_torn_export``
    through ``global_injector()`` themselves.

Not ported yet: the ``data_peer_die_at_exchange`` hook of the sample
exchange (ROADMAP.md Queue 1 item 9); its site parses.
"""

import collections
import copy
import os
import signal
import threading
import time
import warnings

import numpy as np
import torch

from . import flags as _flags
from .analysis.concurrency import make_lock
from .async_engine import as_numpy
from .observability import flight_recorder as _blackbox
from .observability import metrics as _metrics

from .observability import tracing as _tracing

__all__ = ["POLICY_WARN", "POLICY_SKIP_BATCH", "POLICY_ROLLBACK",
           "POLICY_ABORT", "POLICIES", "anomaly_policy", "AnomalyDetector",
           "AnomalousStepError", "RetryBudgetExceededError",
           "InjectedTransientError", "InjectedReplicaDeathError",
           "is_transient_error", "FaultInjector", "global_injector",
           "set_global_injector", "maybe_inject_compile_fault",
           "maybe_inject_shard_fault", "maybe_inject_serve_fault",
           "maybe_inject_swap_death", "maybe_inject_canary_anomaly",
           "PreemptionGuard", "ScopeSnapshot", "snapshot_scope",
           "restore_scope_snapshot", "TrainResult", "ResilientTrainer"]


# ---------------------------------------------------------------------------
# anomaly policy
# ---------------------------------------------------------------------------

POLICY_WARN = "warn"
POLICY_SKIP_BATCH = "skip_batch"
POLICY_ROLLBACK = "rollback"
POLICY_ABORT = "abort"
POLICIES = (POLICY_WARN, POLICY_SKIP_BATCH, POLICY_ROLLBACK, POLICY_ABORT)


def anomaly_policy(value=None):
    """Resolve the anomaly policy: explicit arg > $PTPU_ANOMALY_POLICY >
    `rollback` (the trainer exists to recover, so recovery is the
    default)."""
    policy = value or _flags.env("PTPU_ANOMALY_POLICY") or POLICY_ROLLBACK
    if policy not in POLICIES:
        raise ValueError("unknown anomaly policy %r (want one of %s)"
                         % (policy, "|".join(POLICIES)))
    return policy


class AnomalousStepError(RuntimeError):
    """Raised under policy `abort` — carries the offending global step
    and the observed value."""

    def __init__(self, step, kind, value):
        super().__init__(
            "anomalous training step %d (%s): loss=%r" % (step, kind, value))
        self.step = step
        self.kind = kind
        self.value = value


class AnomalyDetector:
    """Cheap host-side NaN/Inf + loss-spike detector.

    `check(value)` returns None for a healthy loss, `"nonfinite"` for
    NaN/Inf, `"spike"` when the mean exceeds `spike_factor` x the running
    EMA (only after `warmup` healthy observations — a cold EMA would flag
    normal early-training noise). Healthy values fold into the EMA;
    anomalous ones never do, so one spike cannot drag the baseline up.
    Spike detection is off unless `spike_factor` (or $PTPU_SPIKE_FACTOR)
    is set — NaN/Inf detection is always on."""

    def __init__(self, spike_factor=None, spike_window=16, warmup=5):
        if spike_factor is None:
            spike_factor = _flags.env("PTPU_SPIKE_FACTOR") or 0.0
        self.spike_factor = float(spike_factor or 0.0)
        self.warmup = int(warmup)
        self._alpha = 2.0 / (max(2, int(spike_window)) + 1.0)
        self._ema = 0.0
        self._n = 0

    def check(self, value):
        try:
            arr = np.asarray(value, dtype=np.float64)
        except (TypeError, ValueError):
            return None  # non-numeric fetch: nothing to guard
        if arr.size == 0:
            return None
        if not np.isfinite(arr).all():
            return "nonfinite"
        mean = float(arr.mean())
        if (self.spike_factor > 0.0 and self._n >= self.warmup
                and abs(mean) > self.spike_factor * max(abs(self._ema),
                                                        1e-12)):
            return "spike"
        self._ema = (mean if self._n == 0
                     else (1.0 - self._alpha) * self._ema
                     + self._alpha * mean)
        self._n += 1
        return None

    def state(self):
        """Opaque EMA state, captured alongside scope snapshots so a
        rollback rewinds the baseline too — replayed losses must not
        fold into the EMA twice."""
        return (self._ema, self._n)

    def restore(self, state):
        self._ema, self._n = state


class RetryBudgetExceededError(RuntimeError):
    """A request (or run) consumed its whole retry budget: the failure is
    not transient, and surfacing it beats looping forever."""


class InjectedTransientError(RuntimeError):
    """What ``FaultInjector`` raises for the transient sites: a failure
    ``is_transient_error`` classifies as retryable."""


class InjectedReplicaDeathError(RuntimeError):
    """What the ``serve_die_at_step`` site raises in a serving worker: a
    fatal, NON-transient failure, so the engine dies and the router's
    failover path (not an in-place retry) must recover."""


def is_transient_error(exc):
    """True when ``exc`` is a runtime failure worth retrying in place:
    an injected transient, or ``torch.cuda.OutOfMemoryError`` (the
    caching allocator could not satisfy one request: the counterpart of
    XLA's RESOURCE_EXHAUSTED, which the JAX package retries; the CUDA
    context is intact and a retry after other work frees memory may
    pass).

    A sticky CUDA error is never transient: an illegal address, a
    launch failure or a device-side assert leaves the context dead, and
    every later call on it fails too, so retrying in place would only
    hide the death. Those errors (``torch.AcceleratorError`` or a
    ``RuntimeError`` naming a CUDA error) kill the replica, and the
    router re-admits its requests on a survivor. Compile, shape and
    user errors never match either."""
    if isinstance(exc, InjectedTransientError):
        return True
    return isinstance(exc, torch.cuda.OutOfMemoryError)


class FaultInjector:
    """Deterministic fault hooks, so every recovery path runs in CI.

    Spec syntax (also the ``$PTPU_FAULT_INJECT`` format): comma-separated
    ``site:N`` pairs. Step-keyed sites fire when the caller reaches step
    N; occurrence-keyed sites fire on the N-th time the hook site is
    reached (1-based). Every firing is ONE-SHOT. Match-and-consume is
    atomic (one lock around the armed-set lookup and discard): the
    serving sites are hit from several engine worker threads at once,
    and two workers racing one armed step give exactly one firing.

    Serving sites key on the engine worker's own dispatched-step count
    (0-based; the hook runs at the step boundary BEFORE dispatching step
    N). With several replicas the first worker to reach step N consumes
    the firing:

      serve_die_at_step:N        raise a fatal error in the serving
                                 step loop: replica death
      serve_transient_at_step:N  raise a retryable error in the serving
                                 step loop (the worker retries in place)
      serve_stall_at_step:N      stop making step progress WITHOUT
                                 raising, until the replica is aborted
                                 or closed

    Trainer sites (the trainer's global step is the scope's
    ``__step_counter__`` as the step is dispatched):

      nan_at_step:N              poison the step-N feed with a NaN (its
                                 first float value; none: no effect)
      sigterm_at_step:N          deliver SIGTERM to this process at
                                 step N
      transient_at_step:N        raise a retryable error at step N
      transient_compile:K        the K-th executor cache miss raises a
                                 retryable error

    Data-plane sites key on the shard's index in the dataset filelist:

      data_corrupt_shard:N       shard N's chunks all fail CRC
                                 verification (the containment path)
      data_stall_shard:N         opening shard N stalls briefly without
                                 failing

    Checkpoint and online-update sites:

      ckpt_torn_write:K          corrupt the K-th checkpoint after it
                                 lands (the digest manifest must catch
                                 it)
      ckpt_torn_export:K         corrupt the K-th published generation
                                 artifact after it lands (the rollout
                                 skips it)
      swap_die_mid_drain:K       kill the draining replica during the
                                 K-th rollout drain
      canary_anomaly_at_version:N
                                 the canary gate reports an anomaly for
                                 weight version N (the rollback drill)

    ``data_peer_die_at_exchange`` parses but has no hook in the port
    yet.
    """

    STEP_SITES = ("nan_at_step", "sigterm_at_step", "transient_at_step",
                  "serve_die_at_step", "serve_transient_at_step",
                  "serve_stall_at_step", "data_corrupt_shard",
                  "data_stall_shard", "data_peer_die_at_exchange",
                  "canary_anomaly_at_version")
    OCCURRENCE_SITES = ("transient_compile", "ckpt_torn_write",
                        "ckpt_torn_export", "swap_die_mid_drain")

    def __init__(self, spec=None):
        self._lock = make_lock("resilience.fault_injector")
        self._steps = {}        # site -> set of step numbers still armed
        self._targets = {}      # site -> set of occurrence indices armed
        self._occ = collections.Counter()
        for part in (spec or "").replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            site, _, num = part.partition(":")
            site = site.strip().replace("-", "_")
            if site not in self.STEP_SITES + self.OCCURRENCE_SITES:
                raise ValueError(
                    "unknown fault-injection site %r (want one of %s)"
                    % (site, ", ".join(self.STEP_SITES
                                       + self.OCCURRENCE_SITES)))
            try:
                n = int(num)
            except ValueError:
                raise ValueError("fault spec %r wants site:N" % part)
            bucket = (self._steps if site in self.STEP_SITES
                      else self._targets)
            bucket.setdefault(site, set()).add(n)

    @classmethod
    def from_env(cls):
        return cls(_flags.env("PTPU_FAULT_INJECT"))

    def active(self):
        return bool(self._steps or self._targets)

    def _fired(self, site):
        _metrics.counter("resilience/faults_injected").inc()
        _blackbox.record_event("fault_injected", site=site)
        warnings.warn("PTPU_FAULT_INJECT: firing %r" % site,
                      RuntimeWarning)

    def fire_at_step(self, site, step):
        """One-shot: True exactly once when ``step`` is armed for
        ``site``. Match-and-consume runs under the injector lock; the
        telemetry runs after its release."""
        with self._lock:
            armed = self._steps.get(site)
            hit = bool(armed and int(step) in armed)
            if hit:
                armed.discard(int(step))
        if hit:
            self._fired("%s:%d" % (site, step))
        return hit

    def fire_occurrence(self, site):
        """One-shot: True on the N-th call for each armed N (atomic, see
        ``fire_at_step``)."""
        with self._lock:
            armed = self._targets.get(site)
            if not armed:
                return False
            self._occ[site] += 1
            occ = self._occ[site]
            hit = occ in armed
            if hit:
                armed.discard(occ)
        if hit:
            self._fired("%s#%d" % (site, occ))
        return hit


_GLOBAL_INJECTOR = None


def global_injector():
    """The process-wide injector, built lazily from
    ``$PTPU_FAULT_INJECT``."""
    global _GLOBAL_INJECTOR
    if _GLOBAL_INJECTOR is None:
        _GLOBAL_INJECTOR = FaultInjector.from_env()
    return _GLOBAL_INJECTOR


def set_global_injector(injector):
    """Swap the process-wide injector (tests); returns the previous
    one."""
    global _GLOBAL_INJECTOR
    prev = _GLOBAL_INJECTOR
    _GLOBAL_INJECTOR = injector
    return prev


def maybe_inject_compile_fault():
    """The executor's cache-miss hook: raise a retryable error when the
    ``transient_compile`` site fires."""
    inj = global_injector()
    if inj.active() and inj.fire_occurrence("transient_compile"):
        raise InjectedTransientError(
            "RESOURCE_EXHAUSTED: injected transient compile failure "
            "(PTPU_FAULT_INJECT transient_compile)")


def maybe_inject_shard_fault(shard_index):
    """The shard reader's open hook: ``"corrupt"`` when
    ``data_corrupt_shard`` fires for this shard index (every chunk then
    fails CRC verification, exercising the containment policy on intact
    bytes), ``"stall"`` when ``data_stall_shard`` fires (the reader naps
    briefly), else None."""
    inj = global_injector()
    if not inj.active():
        return None
    if inj.fire_at_step("data_corrupt_shard", shard_index):
        return "corrupt"
    if inj.fire_at_step("data_stall_shard", shard_index):
        return "stall"
    return None


def maybe_inject_serve_fault(step):
    """The serving engine's step-boundary hook: raises for the
    ``serve_die_at_step`` / ``serve_transient_at_step`` sites, returns
    ``"stall"`` when ``serve_stall_at_step`` fires (the engine owns the
    stall loop: it must stay abortable), else None. The engine calls it
    BEFORE any scheduler mutation, so a retried tick after a transient
    is clean."""
    inj = global_injector()
    if not inj.active():
        return None
    if inj.fire_at_step("serve_die_at_step", step):
        raise InjectedReplicaDeathError(
            "injected serving replica death at step %d "
            "(PTPU_FAULT_INJECT serve_die_at_step)" % int(step))
    if inj.fire_at_step("serve_transient_at_step", step):
        raise InjectedTransientError(
            "UNAVAILABLE: injected transient serving step failure at "
            "step %d (PTPU_FAULT_INJECT serve_transient_at_step)"
            % int(step))
    if inj.fire_at_step("serve_stall_at_step", step):
        return "stall"
    return None


def maybe_inject_swap_death():
    """The online updater's drain hook: True when the
    ``swap_die_mid_drain`` site fires; the updater then kills the
    draining replica instead of swapping it (a host lost mid-rollout)."""
    inj = global_injector()
    return inj.active() and inj.fire_occurrence("swap_die_mid_drain")


def maybe_inject_canary_anomaly(version):
    """The canary gate's hook: True when ``canary_anomaly_at_version`` is
    armed for this weight version, so the rollback path runs
    deterministically."""
    inj = global_injector()
    return inj.active() and inj.fire_at_step("canary_anomaly_at_version",
                                             version)


# ---------------------------------------------------------------------------
# preemption handling
# ---------------------------------------------------------------------------


class PreemptionGuard:
    """SIGTERM/SIGINT -> drain-don't-die. Entering installs handlers that
    only SET A FLAG (no work in signal context — the trainer drains at
    its next step boundary); exiting restores the previous handlers. A
    second signal while draining restores default disposition and
    re-raises, so a stuck drain can still be killed. Outside the main
    thread (signal.signal would throw) the guard degrades to an inert
    flag holder."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self.triggered = None  # signal number once preempted
        self._previous = {}
        self._installed = False

    def _handle(self, signum, frame):
        if self.triggered is not None:
            # escalate: second signal behaves as if we never intercepted
            self.uninstall()
            if signum == signal.SIGINT:
                raise KeyboardInterrupt
            signal.raise_signal(signum)
            return
        self.triggered = signum

    def install(self):
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self  # signal.signal only works from the main thread
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


# ---------------------------------------------------------------------------
# scope snapshots (the rollback substrate)
# ---------------------------------------------------------------------------

_SCALARS = (type(None), bool, int, float, str, bytes)


def _host_copy(value):
    """A host-owned copy of one scope value. A tensor is COPIED off its
    buffer (``to("cpu", copy=True)``): the executor updates parameters in
    place, and on the CPU ``t.cpu()`` is ``t`` itself, so a snapshot
    taken that way would follow the next step's update."""
    if isinstance(value, _SCALARS):
        return value
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, np.ndarray):
        return value.copy()
    try:
        return copy.deepcopy(value)
    except Exception:
        return value  # uncopyable handle: keep the reference


class ScopeSnapshot:
    """Host copy of a scope's top-level state at a validated boundary.
    `devices` names the device each tensor came from (restore puts it
    back there, in its own dtype); `aux` carries caller bookkeeping that
    must rewind with the scope (the trainer parks its anomaly-detector
    EMA state there)."""

    __slots__ = ("step", "state", "devices", "aux")

    def __init__(self, step, state, devices=None, aux=None):
        self.step = int(step)
        self.state = state
        self.devices = devices or {}
        self.aux = aux

    @property
    def nbytes(self):
        return sum(int(getattr(v, "nbytes", 0) or 0)
                   for v in self.state.values())


def _step_of(scope):
    return int(np.asarray(scope.get("__step_counter__", 0) or 0).item())


def snapshot_scope(scope, step=None):
    """Copy every top-level scope value to host memory. On the card the
    copies wait for the steps that wrote the tensors; the trainer takes
    them at sync points only (after ``Executor.sync``), so the guarded
    loop adds no per-step sync."""
    if step is None:
        step = _step_of(scope)
    with _tracing.span("resilience/snapshot"):
        items = scope.items()
        state = {name: _host_copy(value) for name, value in items}
        devices = {name: value.device for name, value in items
                   if isinstance(value, torch.Tensor)}
    return ScopeSnapshot(step, state, devices)


def restore_scope_snapshot(snapshot, scope):
    """Write a snapshot back into `scope`: each tensor onto the device it
    was taken from, in its dtype, as a fresh copy; arrays and mutable
    containers copied too, so post-rollback training can never dirty the
    snapshot across repeated rollbacks. Returns the snapshot's step."""
    for name, value in snapshot.state.items():
        if isinstance(value, torch.Tensor):
            value = value.to(snapshot.devices.get(name, value.device),
                             copy=True)
        elif isinstance(value, np.ndarray):
            value = value.copy()
        elif not isinstance(value, _SCALARS):
            try:
                value = copy.deepcopy(value)
            except Exception:
                pass  # uncopyable handle: hand out the reference
        scope.set(name, value)
    return snapshot.step


# ---------------------------------------------------------------------------
# the resilient training loop
# ---------------------------------------------------------------------------


class TrainResult:
    """What `ResilientTrainer.run` returns: the last materialized fetches
    plus the recovery ledger (mirrored into `resilience/*` counters when
    metrics are on, live here even when they are off)."""

    __slots__ = ("step", "last_fetches", "preempted", "anomalies",
                 "rollbacks", "retries", "skipped_steps", "losses",
                 "checkpoints_saved")

    def __init__(self):
        self.step = 0
        self.last_fetches = None
        self.preempted = False
        self.anomalies = 0
        self.rollbacks = 0
        self.retries = 0
        self.skipped_steps = 0
        self.checkpoints_saved = 0
        self.losses = []

    def __repr__(self):
        return ("TrainResult(step=%d, preempted=%s, anomalies=%d, "
                "rollbacks=%d, retries=%d, skipped=%d, ckpts=%d)"
                % (self.step, self.preempted, self.anomalies,
                   self.rollbacks, self.retries, self.skipped_steps,
                   self.checkpoints_saved))


class _Pending:
    """One dispatched-but-unvalidated step."""

    __slots__ = ("gstep", "key", "feed", "fetches")

    def __init__(self, gstep, key, feed, fetches):
        self.gstep = gstep
        # batch identity, assigned once when the batch is pulled from
        # the feed iterator — step labels renumber under skip_batch, so
        # per-batch retry accounting must not key on gstep
        self.key = key
        self.feed = feed
        self.fetches = fetches


class ResilientTrainer:
    """Guarded, rollback-capable wrapper around `Executor.run`.

    The loop dispatches steps asynchronously (`return_numpy=False`) and
    validates fetched losses every `guard_every` steps, so the guard's
    only extra cost is the host-side isfinite/EMA check and a scope
    snapshot per validated boundary (``bench.bench_resilience_overhead``
    measures it).

        trainer = ResilientTrainer(exe, program, fetch_list=[loss],
                                   checkpoint_dir="ckpt", ...)
        trainer.restore()           # resume from the newest intact ckpt
        result = trainer.run(feed_batches)

    An anomalous or failed step rolls the scope back to the last
    validated snapshot and replays the window's good steps AT THEIR
    ORIGINAL step counters, so a successful retry is bitwise identical
    to a fault-free run."""

    def __init__(self, exe, program=None, fetch_list=None, scope=None,
                 policy=None, guard_every=8, guard_fetch_index=0,
                 snapshot_limit=1, checkpoint_dir=None, checkpoint_every=0,
                 max_to_keep=3, retry_budget=None, backoff_base=None,
                 backoff_max=30.0, max_step_retries=2, spike_factor=None,
                 spike_window=16, fault_injector=None,
                 handle_preemption=True):
        from . import framework
        from .core.scope import global_scope

        self.exe = exe
        self.program = (program if program is not None
                        else framework.default_main_program())
        self.fetch_list = list(fetch_list or [])
        if not self.fetch_list:
            raise ValueError("ResilientTrainer needs a fetch_list with the "
                             "loss to guard (guard_fetch_index names it)")
        self.scope = scope if scope is not None else global_scope()
        self.policy = anomaly_policy(policy)
        self.guard_every = max(1, int(guard_every))
        self.guard_fetch_index = int(guard_fetch_index)
        if retry_budget is None:
            retry_budget = _flags.env("PTPU_RETRY_BUDGET")
        self.retry_budget = int(retry_budget)
        if backoff_base is None:
            backoff_base = _flags.env("PTPU_RETRY_BACKOFF")
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.max_step_retries = int(max_step_retries)
        self.detector = AnomalyDetector(spike_factor=spike_factor,
                                        spike_window=spike_window)
        self.injector = (fault_injector if fault_injector is not None
                         else global_injector())
        self.handle_preemption = bool(handle_preemption)
        self._snapshots = collections.deque(maxlen=max(1,
                                                       int(snapshot_limit)))
        self.checkpoint_every = int(checkpoint_every)
        self._manager = None
        if checkpoint_dir:
            from .checkpoint import CheckpointManager

            self._manager = CheckpointManager(checkpoint_dir,
                                              max_to_keep=max_to_keep,
                                              async_save=True)
        self._retries_left = self.retry_budget
        self._batch_retries = collections.Counter()
        self._last_ckpt_step = None

    # -- checkpoint resume -------------------------------------------------
    def restore(self):
        """Load the newest INTACT checkpoint into the scope (corrupt or
        torn steps fall through to older ones). Tensors go onto the
        executor's device in their saved dtype (bf16 stays bf16); the
        step counter comes back a host int. Returns the restored global
        step, or None when the directory holds no usable checkpoint."""
        if self._manager is None:
            raise ValueError("ResilientTrainer has no checkpoint_dir")
        try:
            state = self._manager.restore()
        except FileNotFoundError:
            return None
        for name, value in state.items():
            if isinstance(value, torch.Tensor):
                value = value.to(self.exe.device)
            self.scope.set(name, value)
        step = _step_of(self.scope)
        self.scope.set("__step_counter__", step)
        self._last_ckpt_step = step
        return step

    # -- internals ---------------------------------------------------------
    def _current_step(self):
        return _step_of(self.scope)

    def _maybe_corrupt(self, feed, gstep):
        """`nan_at_step` injection: poison the first float feed value of
        step `gstep` (a copy — never the caller's array or tensor); a
        feed without one is returned as it is."""
        if not self.injector.fire_at_step("nan_at_step", gstep):
            return feed
        poisoned = dict(feed)
        for name, value in poisoned.items():
            if isinstance(value, torch.Tensor):
                if value.is_floating_point() and value.numel():
                    value = value.clone()
                    value.view(-1)[0] = float("nan")
                    poisoned[name] = value
                    break
                continue
            arr = np.array(value)
            if arr.dtype.kind == "f" and arr.size:
                arr.reshape(-1)[0] = np.nan
                poisoned[name] = arr
                break
        return poisoned

    def _consume_retry(self, what):
        if self._retries_left <= 0:
            _blackbox.record_event("retry_budget_exhausted",
                                   budget=self.retry_budget,
                                   error=repr(what))
            _blackbox.dump("retry_budget_exceeded")
            raise RetryBudgetExceededError(
                "retry budget (%d) exhausted while handling %s"
                % (self.retry_budget, what))
        self._retries_left -= 1
        attempt = self.retry_budget - self._retries_left
        delay = min(self.backoff_max,
                    self.backoff_base * (2.0 ** (attempt - 1)))
        if delay > 0:
            time.sleep(delay)

    def _dispatch(self, feed, gstep):
        """One guarded exe.run, returning the step's fetches on the
        device. A transient failure (injected, or the caching allocator's
        out-of-memory) propagates: the caller rolls back and replays."""
        if self.injector.fire_at_step("transient_at_step", gstep):
            raise InjectedTransientError(
                "UNAVAILABLE: injected transient step failure "
                "(PTPU_FAULT_INJECT transient_at_step)")
        return self.exe.run(self.program, feed=feed,
                            fetch_list=self.fetch_list, scope=self.scope,
                            return_numpy=False)

    def _rollback(self, result):
        """Restore the newest snapshot into the scope. The executor's
        in-flight window is already quiesced by the materialization that
        preceded every rollback decision.

        The data-plane cursor (``__data_cursor__``) is exempt: it tracks
        the PULL frontier of the record stream, and a rollback replays
        the window from the in-memory feed buffer — it never re-reads
        the stream — so the frontier must survive the restore. Rewinding
        it with the weights would leave the next boundary's checkpoint
        one window behind the state it describes, and a resume would
        double-train that window."""
        snap = self._snapshots[-1]
        with _tracing.span("resilience/rollback", step=snap.step):
            from .data_plane import DatasetCursor

            self.exe.sync()
            cursor_val = self.scope.get(DatasetCursor.SCOPE_KEY)
            restore_scope_snapshot(snap, self.scope)
            if cursor_val is not None:
                self.scope.set(DatasetCursor.SCOPE_KEY, cursor_val)
        if snap.aux is not None:
            # rewind the spike-EMA baseline too: the replay re-checks
            # the same healthy losses, which must not fold in twice
            self.detector.restore(snap.aux)
        result.rollbacks += 1
        _metrics.counter("resilience/rollbacks").inc()
        _blackbox.record_event("rollback", step=snap.step)
        return snap.step

    def _replay(self, records, result):
        """Re-dispatch a list of (gstep, key, feed) records after a
        rollback, re-entering the transient-retry path if the replay
        itself fails. Returns fresh pending entries."""
        pending = []
        for gstep, key, feed in records:
            try:
                fetches = self._dispatch(feed, gstep)
            except Exception as exc:  # noqa: BLE001 — classified below
                if not is_transient_error(exc):
                    raise
                result.retries += 1
                _metrics.counter("resilience/retries").inc()
                # roll back BEFORE spending the budget: if the budget is
                # exhausted the raised error must leave the scope at
                # last-good state
                self._rollback(result)
                self._consume_retry(exc)
                # restart the whole replay from the snapshot (the
                # partially-replayed prefix was rolled back too);
                # recursion depth is bounded by the retry budget
                return self._replay(records, result)
            pending.append(_Pending(gstep, key, feed, fetches))
        return pending

    def _validate(self, pending, result):
        """Materialize the window's fetches (ONE sync point), scan the
        guarded loss for anomalies, apply the policy, and on a clean
        window advance the snapshot/checkpoint boundary. Returns the new
        pending list. An empty window is a no-op — the last boundary
        already snapshotted this exact state."""
        if not pending:
            return []
        while pending:
            gi = self.guard_fetch_index
            values = [as_numpy(p.fetches[gi]) for p in pending]
            bad_index = bad_kind = None
            for i, value in enumerate(values):
                kind = self.detector.check(value)
                if kind is not None:
                    bad_index, bad_kind = i, kind
                    break
            if bad_index is not None:
                bad = pending[bad_index]
                result.anomalies += 1
                _metrics.counter("resilience/anomalies").inc()
                _blackbox.record_event("anomaly", step=bad.gstep,
                                       kind=bad_kind, policy=self.policy)
                if self.policy == POLICY_ABORT:
                    raise AnomalousStepError(bad.gstep, bad_kind,
                                             values[bad_index])
                if self.policy == POLICY_WARN:
                    warnings.warn(
                        "anomalous step %d (%s): loss=%r — policy=warn, "
                        "continuing with poisoned state"
                        % (bad.gstep, bad_kind, values[bad_index]),
                        RuntimeWarning)
                    # warn accepts the whole window, so the scan must
                    # finish it: later healthy losses still fold into
                    # the EMA. The window counts as ONE anomaly
                    for i in range(bad_index + 1, len(values)):
                        self.detector.check(values[i])
            if bad_index is None or self.policy == POLICY_WARN:
                # clean window (or warn-mode acceptance of a dirty one):
                # record it and advance the snapshot boundary
                for v in values:
                    result.losses.append(float(np.asarray(v).ravel()[0])
                                         if v.size else float("nan"))
                result.last_fetches = as_numpy(pending[-1].fetches)
                result.step = pending[-1].gstep + 1
                self._mark_boundary(result)
                return []
            bad = pending[bad_index]
            # skip_batch / rollback: rebuild from the last-good snapshot
            self._rollback(result)
            retry_bad = (self.policy == POLICY_ROLLBACK
                         and self._batch_retries[bad.key]
                         < self.max_step_retries)
            records = [(p.gstep, p.key, p.feed)
                       for p in pending[:bad_index]]
            if retry_bad:
                # retrying can loop on a deterministic failure, so it
                # spends the global budget (and backs off); skipping
                # always makes forward progress and costs nothing
                self._consume_retry("%s at step %d" % (bad_kind,
                                                       bad.gstep))
                self._batch_retries[bad.key] += 1
                result.retries += 1
                _metrics.counter("resilience/retries").inc()
                records.append((bad.gstep, bad.key, bad.feed))
                # steps after the retried one keep their original counters
                records.extend((p.gstep, p.key, p.feed)
                               for p in pending[bad_index + 1:])
            else:
                result.skipped_steps += 1
                _metrics.counter("resilience/skipped_steps").inc()
                # dropping the batch shifts every later step down one
                # counter slot — replay them contiguously so the scope's
                # __step_counter__ stays dense
                records.extend((p.gstep - 1, p.key, p.feed)
                               for p in pending[bad_index + 1:])
            pending = self._replay(records, result)
            # loop: re-validate the replayed window (a second poisoned
            # batch in the same window is caught on the next pass)
        # every batch in the window was dropped: the scope is exactly the
        # snapshot state — no new boundary to mark
        return []

    def _snapshot(self):
        self.exe.sync()
        snap = snapshot_scope(self.scope)
        snap.aux = self.detector.state()
        return snap

    def _mark_boundary(self, result):
        """A validated (all-healthy) sync point: snapshot the scope and
        roll the checkpoint cadence."""
        snap = self._snapshot()
        self._snapshots.append(snap)
        _metrics.gauge("resilience/snapshot_bytes").set(snap.nbytes)
        if (self._manager is not None and self.checkpoint_every > 0
                and (self._last_ckpt_step is None
                     or snap.step - self._last_ckpt_step
                     >= self.checkpoint_every)):
            self._save_checkpoint(snap, result)

    def _save_checkpoint(self, snap, result, blocking=False):
        with _tracing.span("resilience/checkpoint", step=snap.step):
            # snapshot state is already a private host copy
            self._manager.save(snap.state, snap.step, blocking=blocking,
                               host_copied=True)
        self._last_ckpt_step = snap.step
        result.checkpoints_saved += 1
        _metrics.counter("resilience/checkpoints").inc()

    def _drain_preempted(self, pending, result, signum):
        """SIGTERM/SIGINT path: finish what is in flight, validate it,
        write an emergency checkpoint from the last validated state, and
        hand control back to the caller."""
        result.preempted = True
        _metrics.counter("resilience/preemptions").inc()
        _blackbox.record_event("preemption_drain", signum=signum,
                               in_flight=len(pending))
        with _tracing.span("resilience/preemption_drain"):
            self._validate(pending, result)
            self.exe.sync()
            if self._manager is not None:
                snap = (self._snapshots[-1] if self._snapshots
                        else self._snapshot())
                self._save_checkpoint(snap, result, blocking=True)
                self._manager.wait()
        _blackbox.dump("sigterm_drain")
        warnings.warn(
            "preemption signal %d: drained %d in-flight steps, state "
            "checkpointed at step %d" % (signum, len(pending),
                                         result.step), RuntimeWarning)

    # -- the loop ----------------------------------------------------------
    def run(self, feeds, steps=None):
        """Drive `feeds` (an iterable of feed dicts) through the guarded
        loop; `steps` bounds how many batches are consumed. Returns a
        `TrainResult` (check `.preempted` before assuming completion)."""
        result = TrainResult()
        result.step = self._current_step()
        # retry accounting is per run(): the budget replenishes, and the
        # batch-ordinal retry keys from a previous run's feeds must not
        # bleed onto this run's unrelated batches
        self._retries_left = self.retry_budget
        self._batch_retries = collections.Counter()
        guard = PreemptionGuard() if self.handle_preemption else None
        if guard is not None:
            guard.install()
        pending = []
        try:
            # the pre-run state is the rollback floor: an anomaly in the
            # FIRST window must have somewhere good to return to
            self._snapshots.append(self._snapshot())
            if self._manager is not None and self._last_ckpt_step is None:
                # cadence counts from here — the pre-run state is not a
                # checkpoint worth paying a write for
                self._last_ckpt_step = self._current_step()
            it = iter(feeds)
            dispatched = 0  # batches consumed; doubles as batch identity
            while steps is None or dispatched < steps:
                # the scope counter advances synchronously at each
                # dispatch, so it IS the step number the next run uses
                gstep = self._current_step()
                if self.injector.fire_at_step("sigterm_at_step", gstep):
                    os.kill(os.getpid(), signal.SIGTERM)
                if guard is not None and guard.triggered is not None:
                    self._drain_preempted(pending, result, guard.triggered)
                    return result
                try:
                    feed = next(it)
                except StopIteration:
                    break
                # dispatch the (possibly injection-poisoned) copy but
                # remember the ORIGINAL: a retry after rollback re-feeds
                # clean data, exactly like a transient corruption
                dispatch_feed = self._maybe_corrupt(feed, gstep)
                try:
                    fetches = self._dispatch(dispatch_feed, gstep)
                except Exception as exc:  # noqa: BLE001 — classified below
                    if not is_transient_error(exc):
                        raise
                    result.retries += 1
                    _metrics.counter("resilience/retries").inc()
                    # rollback first: a budget-exhausted raise must leave
                    # the scope at last-good state (see _replay)
                    self._rollback(result)
                    self._consume_retry(exc)
                    records = [(p.gstep, p.key, p.feed) for p in pending]
                    records.append((gstep, dispatched, feed))
                    pending = self._replay(records, result)
                    dispatched += 1
                    if len(pending) >= self.guard_every:
                        pending = self._validate(pending, result)
                    continue
                pending.append(_Pending(gstep, dispatched, feed, fetches))
                dispatched += 1
                if len(pending) >= self.guard_every:
                    pending = self._validate(pending, result)
            if guard is not None and guard.triggered is not None:
                self._drain_preempted(pending, result, guard.triggered)
                return result
            self._validate(pending, result)
            if self._manager is not None and self._snapshots:
                snap = self._snapshots[-1]
                if self._last_ckpt_step != snap.step:
                    self._save_checkpoint(snap, result, blocking=True)
                self._manager.wait()
        finally:
            if guard is not None:
                guard.uninstall()
        return result
