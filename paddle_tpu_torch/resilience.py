"""Fault tolerance for serving and checkpoints: the serving and
checkpoint subset of the JAX package's ``resilience.py``.

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

Not ported yet: the trainer side (``ResilientTrainer``, the anomaly
detector and policies, scope snapshots, ``PreemptionGuard``) and the
data-plane hooks. Their sites parse, as in the JAX package, so a spec
written for it is accepted, but nothing in the port fires them.
"""

import collections
import warnings

import torch

from . import flags as _flags
from .analysis.concurrency import make_lock
from .observability import flight_recorder as _blackbox
from .observability import metrics as _metrics

__all__ = ["RetryBudgetExceededError", "InjectedTransientError",
           "InjectedReplicaDeathError", "is_transient_error",
           "FaultInjector", "global_injector", "set_global_injector",
           "maybe_inject_serve_fault", "maybe_inject_swap_death",
           "maybe_inject_canary_anomaly"]


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

    The trainer and data-plane sites of the JAX package (nan_at_step,
    sigterm_at_step, transient_at_step, transient_compile,
    data_corrupt_shard, data_stall_shard, data_peer_die_at_exchange)
    parse but have no hook in the port yet.
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
