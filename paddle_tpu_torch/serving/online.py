"""Online updates: canary-gated live weight hot swap across the serving
fleet, with structured rollback (the port of the JAX package's
``serving/online.py``).

The :class:`OnlineUpdater` closes the loop between a trainer that
checkpoints and a :class:`ServingRouter` fleet: it polls the checkpoint
directory, exports every new intact checkpoint through
``inference.export_generation_model`` into a versioned, digest-verified
artifact (``publish_dir/v<N>``; the publish is atomic, so a torn export
is DETECTED and SKIPPED, never served), then rolls the version across
the fleet one replica at a time: ``drain`` -> hot swap
(:meth:`ServingEngine.swap_weights` installs the weights and flushes the
prefix cache in one critical section) -> ``undrain``. In-flight requests
finish on the weights they started on; queued requests wait out the
swap, so every request's tokens come from exactly ONE weight version.

A :class:`CanaryGate` fronts every rollout when a canary percentage is
configured (``canary_pct=`` / ``$PTPU_SERVE_CANARY_PCT``): the first
replica takes the candidate version, the router pins ~pct% of new
traffic to it, and the gate compares the candidate cohort against the
incumbent cohort over the same window — non-finite weights, failure
rate, latency, and the speculative accept rate. An anomaly triggers a
structured rollback through the same drain/swap/undrain path to the
incumbent source captured at rollout start; otherwise the remaining
replicas are promoted one at a time. A canary window that expires
without enough traffic to judge promotes (a quiet fleet must still take
updates). With no updater attached and ``$PTPU_SERVE_CANARY_PCT`` unset,
the router and engine behave as without this module.

Fault sites (``$PTPU_FAULT_INJECT``): ``ckpt_torn_export`` tears the
artifact after publish (verification catches it; the rollout never
starts), ``swap_die_mid_drain`` kills the replica being drained (the
failover path re-admits its requests and the rollout continues on the
rest), ``canary_anomaly_at_version:N`` forces the gate's verdict for
weight version N.

    updater = OnlineUpdater(router, checkpoint_dir="ckpts",
                            publish_dir="published", program=train_prog)
    updater.start()          # background poll loop
    ...                      # the trainer keeps checkpointing
    updater.stop()
"""

import os
import threading
import time

import numpy as np
import torch

from .. import checkpoint as _ckpt
from .. import inference as _inference
from .. import resilience as _resil
from ..core.scope import Scope
from ..flags import env as _env
from ..observability import flight_recorder as _blackbox
from ..observability import metrics as _metrics
from .model import GenerationArtifactError, verify_generation_artifact
from .router import DEAD

__all__ = ["OnlineUpdater", "CanaryGate"]


def _has_nonfinite(state):
    """True when any float leaf of a checkpoint state carries a
    non-finite value — the static half of the gate's finite-logit
    signal (a NaN/Inf weight cannot produce finite logits)."""
    for value in state.values():
        if isinstance(value, torch.Tensor):
            if value.is_floating_point() and \
                    not bool(torch.isfinite(value).all()):
                return True
            continue
        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.floating) and \
                not np.all(np.isfinite(arr)):
            return True
    return False


class CanaryGate:
    """Per-rollout anomaly detector comparing the canary (candidate
    weight version) cohort against the incumbent cohort accrued over
    the same pinning window (``ServingRouter.version_ledger``).

    Signals, in evaluation order:

    1. injected — the ``canary_anomaly_at_version:N`` chaos site
       (deterministic rollback drill).
    2. non-finite weights — static finite-logit check on the
       checkpoint the candidate was exported from; fires without
       needing any traffic.
    3. failure rate — candidate failure rate exceeds the incumbent's
       by more than ``failure_delta`` (both cohorts must hold at
       least ``min_requests`` outcomes).
    4. latency — candidate mean request latency exceeds
       ``latency_factor`` x the incumbent's.
    5. accept rate — with speculative decoding on, the canary
       engine's draft accept rate fell more than ``accept_delta``
       below the incumbent replicas' (a weight update that breaks
       drafter/target agreement shows up here first).

    ``evaluate`` returns ``None`` (no anomaly) or a dict naming the
    ``signal`` plus the numbers behind the verdict — what the
    ``canary_rollback`` flight-recorder event carries.
    """

    def __init__(self, min_requests=8, failure_delta=0.25,
                 latency_factor=3.0, accept_delta=0.2):
        self.min_requests = max(1, int(min_requests))
        self.failure_delta = float(failure_delta)
        self.latency_factor = float(latency_factor)
        self.accept_delta = float(accept_delta)

    def evaluate(self, router, canary_idx, candidate, incumbent,
                 nonfinite=False):
        if _resil.maybe_inject_canary_anomaly(candidate):
            return {"signal": "injected", "version": candidate}
        if nonfinite:
            return {"signal": "nonfinite_weights", "version": candidate}
        ledger = router.version_ledger()
        cand = ledger.get(candidate)
        inc = ledger.get(incumbent)
        if not cand or not inc:
            return None
        c_n, i_n = cand[0] + cand[1], inc[0] + inc[1]
        if c_n < self.min_requests or i_n < self.min_requests:
            return None
        c_fail, i_fail = cand[1] / c_n, inc[1] / i_n
        if c_fail > i_fail + self.failure_delta:
            return {"signal": "failure_rate", "candidate_value": c_fail,
                    "incumbent_value": i_fail}
        if cand[0] and inc[0]:
            c_lat, i_lat = cand[2] / cand[0], inc[2] / inc[0]
            if i_lat > 0 and c_lat > self.latency_factor * i_lat:
                return {"signal": "latency", "candidate_value": c_lat,
                        "incumbent_value": i_lat}
        accept = self._accept_rates(router, canary_idx)
        if accept is not None:
            c_acc, i_acc = accept
            if c_acc < i_acc - self.accept_delta:
                return {"signal": "accept_rate", "candidate_value": c_acc,
                        "incumbent_value": i_acc}
        return None

    def _accept_rates(self, router, canary_idx):
        """(canary, incumbent-mean) spec accept rates, or None when
        speculative decoding is off / there is no proposal volume yet
        on both sides."""
        def rate(idx):
            proposed = accepted = 0
            for row in router.replica_engine(idx).stats().values():
                proposed += row.get("spec_proposed", 0)
                accepted += row.get("spec_accepted", 0)
            if proposed < self.min_requests:
                return None
            return accepted / proposed
        c = rate(canary_idx)
        if c is None:
            return None
        others = [rate(i) for i in range(router.num_replicas)
                  if i != canary_idx
                  and router.replica_states()[i] != DEAD]
        others = [r for r in others if r is not None]
        if not others:
            return None
        return c, sum(others) / len(others)


class OnlineUpdater:
    """Streaming-train -> serve loop: publish each new intact trainer
    checkpoint as a versioned generation artifact and roll it across
    the fleet behind the :class:`CanaryGate` (the module docstring has
    the state machine).

    ``router`` is the live fleet; ``checkpoint_dir`` the directory a
    trainer checkpoints into (``checkpoint.save_checkpoint``);
    ``publish_dir`` receives one ``v<N>`` artifact directory per
    published version; ``program`` is the training ``Program`` the
    checkpoints belong to (``export_generation_model`` walks it to find
    the decoder weights).
    Single-(default-)model fleets only — the updater swaps the
    router's default model entry.

    ``canary_pct=None`` reads ``$PTPU_SERVE_CANARY_PCT``; unset means
    NO canary phase (straight rolling swap) and leaves the router
    bitwise-legacy. ``poll_s=None`` reads ``$PTPU_ONLINE_POLL_S``.
    """

    def __init__(self, router, checkpoint_dir, publish_dir, program,
                 max_seq_len=None, canary_pct=None, gate=None,
                 canary_window_s=5.0, drain_timeout_s=30.0,
                 swap_timeout_s=30.0, poll_s=None):
        if canary_pct is None:
            canary_pct = _env("PTPU_SERVE_CANARY_PCT")
        if poll_s is None:
            poll_s = _env("PTPU_ONLINE_POLL_S")
        self.router = router
        self.checkpoint_dir = checkpoint_dir
        self.publish_dir = publish_dir
        self.program = program
        self.max_seq_len = max_seq_len
        self.canary_pct = None if canary_pct is None else float(canary_pct)
        self.gate = gate if gate is not None else CanaryGate()
        self.canary_window_s = float(canary_window_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.swap_timeout_s = float(swap_timeout_s)
        self.poll_s = float(poll_s)
        # version 0 is the weights the fleet was built with; capture a
        # host copy NOW so the first rollout's rollback target exists
        # even though v0 was never exported as an artifact
        self._incumbent_version = 0
        self._incumbent_source = router.replica_engine(0).export_weights()
        self._next_version = 1
        self._last_step = None       # newest checkpoint step consumed
        # host-side ledger (lives with metrics off; stats() reads it)
        self.swaps = 0
        self.rollbacks = 0
        self.versions_published = 0
        self.torn_exports = 0
        self.promotions = 0
        self.drain_timeouts = 0
        self._stop = threading.Event()
        self._thread = None

    # -- publish: checkpoint -> verified versioned artifact -------------
    def poll_once(self):
        """One updater iteration: consume the newest unseen checkpoint
        (intermediate ones are superseded — streaming serving wants the
        freshest weights, not every step), export + verify it, and run
        the rollout. Returns a summary dict, or ``None`` when there is
        nothing new."""
        try:
            steps = _ckpt.checkpoints_after(self.checkpoint_dir,
                                            self._last_step)
        except OSError:
            return None
        if not steps:
            return None
        step = steps[-1]
        self._last_step = step
        try:
            state = _ckpt.restore_checkpoint(
                os.path.join(self.checkpoint_dir, "step_%d" % step))
        except _ckpt.CheckpointCorruptionError:
            # restore counted resilience/ckpt_corrupt_detected via its
            # own path only for directory scans; a direct step read
            # failing just means this interval's update is skipped —
            # the next checkpoint supersedes it
            return {"step": step, "published": False,
                    "reason": "corrupt_checkpoint"}
        version = self._next_version
        vdir = os.path.join(self.publish_dir, "v%d" % version)
        scope = Scope()
        for name, value in state.items():
            scope.set(name, value)
        _inference.export_generation_model(vdir, self.program,
                                           scope=scope,
                                           max_seq_len=self.max_seq_len)
        try:
            verify_generation_artifact(vdir)
        except GenerationArtifactError as exc:
            self.torn_exports += 1
            _metrics.counter("online/torn_exports").inc()
            _blackbox.record_event("torn_export_skipped", version=version,
                                   step=step, reason=str(exc)[:200])
            # the version number is NOT consumed: the next checkpoint
            # republishes over the torn directory (per-file atomic
            # replace, manifest last)
            return {"step": step, "version": version, "published": False,
                    "reason": "torn_export"}
        self._next_version = version + 1
        self.versions_published += 1
        _metrics.counter("online/versions_published").inc()
        _blackbox.record_event("version_published", version=version,
                               step=step, dirname=vdir)
        promoted = self._rollout(vdir, version,
                                 nonfinite=_has_nonfinite(state))
        return {"step": step, "version": version, "published": True,
                "promoted": promoted}

    # -- rollout state machine ------------------------------------------
    def _swap_replica(self, idx, source, version):
        """The ONE drain path every transition uses (canary, promote,
        AND rollback): drain -> wait quiesced -> swap -> undrain.
        Returns False when the replica died (failover owns its
        requests) or could not quiesce in time — the caller moves on;
        survivors keep serving either way."""
        if not self.router.drain(idx):
            return False
        try:
            if _resil.maybe_inject_swap_death():
                self.router.replica_engine(idx).kill(
                    _resil.InjectedReplicaDeathError(
                        "injected swap_die_mid_drain: replica %d killed "
                        "while draining for v%d" % (idx, version)))
                return False
            try:
                if not self.router.wait_drained(
                        idx, timeout=self.drain_timeout_s):
                    return False           # died mid-drain
            except TimeoutError:
                self.drain_timeouts += 1
                return False               # stays on its old version
            self.router.replica_engine(idx).swap_weights(
                source, version=version, timeout=self.swap_timeout_s)
            self.swaps += 1
            return True
        finally:
            # idempotent: a no-op unless the replica is still DRAINING
            # (a replica that died on any path above stays DEAD)
            self.router.undrain(idx)

    def _live(self):
        return [i for i, s in enumerate(self.router.replica_states())
                if s != DEAD]

    def _rollout(self, source, version, nonfinite=False):
        """Roll ``version`` across the fleet; True when promoted to
        incumbent, False on rollback / no live replica took it."""
        _blackbox.record_event("rollout_begin", version=version,
                               incumbent=self._incumbent_version,
                               canary_pct=self.canary_pct)
        live = self._live()
        canary = None
        if self.canary_pct is not None:
            for idx in live:
                if self._swap_replica(idx, source, version):
                    canary = idx
                    break
            if canary is None:
                return False    # fleet (what's left of it) on incumbent
            verdict = self._canary_phase(canary, version, nonfinite)
            if verdict is not None:
                self._rollback(canary, version, verdict)
                return False
            rest = [i for i in self._live() if i != canary]
        else:
            rest = live
        for idx in rest:
            self._swap_replica(idx, source, version)
        self._incumbent_source = source
        self._incumbent_version = version
        self.promotions += 1
        _blackbox.record_event("rollout_promoted", version=version)
        return True

    def _canary_phase(self, canary, version, nonfinite):
        """Pin traffic, watch the gate. Returns the anomaly verdict, or
        ``None`` to promote — after a full healthy cohort, or when the
        window expires without enough traffic to judge (the gate
        detects anomalies; it does not block a quiet fleet)."""
        self.router.set_canary(canary, self.canary_pct)
        try:
            deadline = time.monotonic() + self.canary_window_s
            while True:
                verdict = self.gate.evaluate(
                    self.router, canary, version,
                    self._incumbent_version, nonfinite=nonfinite)
                if verdict is not None:
                    return verdict
                if self.router.replica_states()[canary] == DEAD:
                    return None   # canary died: failover re-admitted
                                  # its requests; nothing left to judge
                led = self.router.version_ledger().get(version)
                if led and led[0] + led[1] >= self.gate.min_requests:
                    return None
                if time.monotonic() >= deadline:
                    return None
                time.sleep(0.02)
        finally:
            self.router.clear_canary()

    def _rollback(self, canary, version, verdict):
        """Structured rollback: the canary goes back to the incumbent
        source through the SAME drain path a forward swap uses. The
        rest of the fleet never left the incumbent, so afterwards every
        live replica serves it again."""
        self.rollbacks += 1
        _metrics.counter("online/rollbacks").inc()
        _blackbox.record_event("canary_rollback", version=version,
                               incumbent=self._incumbent_version,
                               **{k: v for k, v in verdict.items()
                                  if k in ("signal", "candidate_value",
                                           "incumbent_value")})
        self._swap_replica(canary, self._incumbent_source,
                           self._incumbent_version)

    # -- background loop -------------------------------------------------
    def start(self):
        """Run the poll loop in a daemon thread until :meth:`stop`."""
        if self._thread is not None:
            raise RuntimeError("OnlineUpdater already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="ptpu-online-updater",
                                        daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:
                # the updater must outlive one bad iteration (a
                # mid-write checkpoint race, a replica dying under it):
                # the fleet keeps serving the incumbent either way
                import warnings
                warnings.warn("online-updater iteration failed (fleet "
                              "still serving): %r" % (e,),
                              RuntimeWarning)
            self._stop.wait(self.poll_s)

    def stop(self, timeout=30.0):
        """Stop the background loop (idempotent; safe if never
        started)."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)

    def stats(self):
        """Host-side ledger snapshot (lives with metrics off)."""
        return {"incumbent_version": self._incumbent_version,
                "versions_published": self.versions_published,
                "swaps": self.swaps,
                "rollbacks": self.rollbacks,
                "promotions": self.promotions,
                "torn_exports": self.torn_exports,
                "drain_timeouts": self.drain_timeouts,
                "last_step": self._last_step}
