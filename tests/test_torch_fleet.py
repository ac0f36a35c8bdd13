"""The serving fleet of paddle_tpu_torch held against the JAX package on
the CPU, case by case after ``tests/test_serving_fleet.py``: the
``ServingRouter`` (least-loaded dispatch, the healthy -> suspect -> dead
machine, the stall watchdog, re-admission, the retry budget, shedding,
the deadline backstop), the engine's fleet surface (the three model
forms, per-model stats, deadlines, health, kill, the in-place transient
retry) and the serving subset of ``resilience`` (the fault injector and
``is_transient_error``).

Both packages serve one model (vocab 64, d_model 32, 2 heads, 2 layers),
the JAX model's weights carried across with ``from_jax_weights``. Where
a count is compared, both routers get the same injector spec and the
same pinned arrivals: every prompt is submitted while each replica's
worker is held settled (``test_torch_pinned_arrivals.settled``), so
least-loaded dispatch and the requests in flight at a fault do not
depend on thread timing. Stall budgets are seconds, not tenths."""

import contextlib
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu import resilience as jres
from paddle_tpu import serving as jserving
from paddle_tpu_torch import resilience as pres
from paddle_tpu_torch import serving as port

from test_torch_pinned_arrivals import settled

CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_seq_len=64)
_PAIR = {}


def model_pair():
    """(JAX model, the port's model on the CPU) over the same weights,
    the JAX decode step warmed (its compile must not read as a stall)."""
    if not _PAIR:
        jm = jserving.GenerationModel.random(
            jserving.GenerationConfig(**CFG), seed=0, name="fleet")
        weights = {k: np.asarray(v) for k, v in jm.weights.items()}
        pm = port.GenerationModel.from_jax_weights(
            port.GenerationConfig(**CFG), weights, name="fleet",
            device="cpu")
        with jserving.ServingEngine(jm, max_batch=2, max_seq_len=64,
                                    block_size=4) as warm:
            warm.generate([1, 2], max_new_tokens=2, timeout=300)
        _PAIR["jax"], _PAIR["port"] = jm, pm
    return _PAIR["jax"], _PAIR["port"]


def _prompts(n, seed=7, lo=3, hi=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"], size=rng.randint(lo, hi))
            .tolist() for _ in range(n)]


def _router(pkg, model, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("block_size", 4)
    kw.setdefault("health_interval_s", 0.02)
    kw.setdefault("backoff_base", 0.0)
    if pkg is port:
        kw["device"] = "cpu"
    return pkg.ServingRouter(model, **kw)


def _engine(pkg, model, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("block_size", 4)
    if pkg is port:
        kw["device"] = "cpu"
    return pkg.ServingEngine(model, **kw)


def _warm(*models):
    """One request through a throwaway port engine per model: the
    router's contract (``serving/router.py``) asks for warm replicas
    before a stall budget near a cold step's time."""
    for m in models:
        with _engine(port, m) as eng:
            eng.generate([1, 2], max_new_tokens=4, timeout=120)


class _inject:
    """Arm one package's process-global injector for a with-block."""

    def __init__(self, res, spec):
        self.res, self.spec = res, spec

    def __enter__(self):
        self._prev = self.res.set_global_injector(
            self.res.FaultInjector(self.spec))
        self._warns = warnings.catch_warnings()
        self._warns.__enter__()
        warnings.simplefilter("ignore", RuntimeWarning)
        return self

    def __exit__(self, *exc):
        self._warns.__exit__(*exc)
        self.res.set_global_injector(self._prev)
        return False


def _res(pkg):
    return pres if pkg is port else jres


@contextlib.contextmanager
def pinned(router):
    """Hold every replica's worker settled: submits made inside land
    before any worker's next admission."""
    with contextlib.ExitStack() as stack:
        for i in range(router.num_replicas):
            stack.enter_context(settled(router.replica_engine(i)))
        yield


def _pinned_submit(router, prompts, max_new, **kw):
    with pinned(router):
        return [router.submit(p, max_new_tokens=max_new, **kw)
                for p in prompts]


def _assert_drained(engine):
    for w in engine._workers.values():
        assert w.pool.check_invariants() == []
        st = w.pool.stats()
        assert st["blocks_in_use"] == 0 and st["blocks_reserved"] == 0, st


LEDGER = ("failovers", "readmitted", "retries", "shed_requests",
          "deadline_expired", "requests_submitted", "requests_completed",
          "requests_failed", "version_restarts", "canary_requests")


def _ledger(st):
    return {k: st[k] for k in LEDGER}


# ---------------------------------------------------------------------------
# the serving subset of resilience
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "serve_die_at_step:3,serve_transient_at_step:5,serve_stall_at_step:7",
    "ckpt_torn_write:1;ckpt_torn_export:2,swap_die_mid_drain:1",
    "canary_anomaly_at_version:3", "nan_at_step:1", "",
    "serve_explode_at_step:1", "serve_die_at_step:x"])
def test_injector_spec_parses_as_jax(spec):
    """``test_injector_serving_sites_parse``: the same specs parse (or
    raise ValueError) in both packages, and arm the same sites."""
    try:
        want = jres.FaultInjector(spec)
    except ValueError:
        with pytest.raises(ValueError):
            pres.FaultInjector(spec)
        return
    got = pres.FaultInjector(spec)
    assert got.active() == want.active()
    assert got._steps == want._steps and got._targets == want._targets


@pytest.mark.parametrize("kind", ["step", "occurrence"])
def test_injector_one_shot_firing_is_atomic(kind):
    """``test_injector_one_shot_firing_is_atomic``: 8 threads racing one
    armed step (or occurrence) give exactly one firing."""
    inj = pres.FaultInjector("serve_die_at_step:5" if kind == "step"
                             else "swap_die_mid_drain:8")
    fired = []
    start = threading.Barrier(8)

    def hammer():
        start.wait()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for _ in range(4):
                hit = (inj.fire_at_step("serve_die_at_step", 5)
                       if kind == "step"
                       else inj.fire_occurrence("swap_die_mid_drain"))
                if hit:
                    fired.append(threading.get_ident())

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(fired) == 1


def test_maybe_inject_serve_fault_sites():
    """``test_maybe_inject_serve_fault_sites``: the hook's outcome at
    each step equals the JAX hook's under the same spec (raise the
    death, raise a transient, "stall", then nothing: one-shot)."""
    spec = ("serve_die_at_step:2,serve_transient_at_step:3,"
            "serve_stall_at_step:4")

    def outcomes(res):
        out = []
        with _inject(res, spec):
            for step in (0, 2, 3, 4, 2, 4):
                try:
                    out.append(res.maybe_inject_serve_fault(step))
                except Exception as e:
                    out.append((type(e).__name__,
                                res.is_transient_error(e)))
        return out

    assert outcomes(pres) == outcomes(jres) == [
        None, ("InjectedReplicaDeathError", False),
        ("InjectedTransientError", True), "stall", None, None]


def test_is_transient_error_takes_oom_not_sticky_cuda_errors():
    """The port's classification: an injected transient and CUDA's
    out-of-memory (RESOURCE_EXHAUSTED's counterpart) are retried in
    place; a sticky CUDA error (its context is dead) and an ordinary
    error are not."""
    assert pres.is_transient_error(pres.InjectedTransientError("x"))
    assert pres.is_transient_error(torch.cuda.OutOfMemoryError("oom"))
    sticky = [RuntimeError("CUDA error: an illegal memory access was "
                           "encountered"),
              RuntimeError("CUDA error: unspecified launch failure")]
    if hasattr(torch, "AcceleratorError"):
        sticky.append(torch.AcceleratorError(
            "CUDA error: an illegal memory access was encountered"))
    for e in sticky + [ValueError("shape"),
                       pres.InjectedReplicaDeathError("dead")]:
        assert not pres.is_transient_error(e), e


def test_kernel_launch_counts_survive_worker_threads():
    """Every replica's worker counts its K2 launches in one shared dict:
    16 threads counting 2000 launches each, with the interpreter
    switching threads every microsecond, lose no count."""
    import sys

    from paddle_tpu_torch.ops import paged_attention as pa

    saved = dict(pa.paged_attention.window_launches)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pa.paged_attention.window_launches.clear()
        threads = [threading.Thread(target=lambda c=c: [
            pa._count_launch(c) for _ in range(2000)]) for c in [1, 7] * 8]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert pa.paged_attention.window_launches == {1: 16000, 7: 16000}
    finally:
        sys.setswitchinterval(interval)
        pa.paged_attention.window_launches.clear()
        pa.paged_attention.window_launches.update(saved)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_router_basic_identity_and_spread():
    """``test_router_basic_identity_and_spread``: routed outputs equal
    both packages' ``reference_decode``; both routers spread the pinned
    arrivals over both replicas with the same ledger."""
    jm, pm = model_pair()
    prompts = _prompts(6)
    refs = [port.reference_decode(pm, p, 6) for p in prompts]
    assert refs == [jserving.reference_decode(jm, p, 6) for p in prompts]
    ledgers, steps = [], []
    for pkg, m in ((port, pm), (jserving, jm)):
        with _router(pkg, m) as router:
            reqs = _pinned_submit(router, prompts, 6)
            assert [r.wait(120) for r in reqs] == refs
            st = router.stats()
        assert st["replicas_healthy"] == 2
        ledgers.append(_ledger(st))
        steps.append([r["model:default"]["steps"] for r in st["replicas"]])
    assert ledgers[0] == ledgers[1]
    assert ledgers[0]["requests_completed"] == 6
    assert all(s > 0 for s in steps[0]), steps


def test_clean_close_is_not_a_failover():
    """``test_clean_close_is_not_a_failover``."""
    _, pm = model_pair()
    router = _router(port, pm)
    try:
        assert router.generate([1, 2, 3], max_new_tokens=4, timeout=120) \
            == port.reference_decode(pm, [1, 2, 3], 4)
    finally:
        router.close()
    assert router._failovers == 0
    assert "dead" not in router.replica_states()


def test_multi_model_stall_not_masked_by_sibling():
    """``test_multi_model_stall_not_masked_by_sibling``: one wedged model
    worker inside a replica fails over while its sibling model keeps
    stepping (per-worker watchdog progress)."""
    _, pm = model_pair()
    pb = port.GenerationModel.random(pm.config, seed=21, name="fleet-b",
                                     device="cpu")
    ref = port.reference_decode(pb, [4, 5, 6], 6)
    _warm(pm, pb)
    with _inject(pres, "serve_stall_at_step:2"):
        with _router(port, {"a": pm, "b": pb}, stall_timeout_s=1.5) \
                as router:
            bg = [router.submit([1, 2, 3], max_new_tokens=24, model="a")
                  for _ in range(4)]
            out = router.generate([4, 5, 6], max_new_tokens=6, model="b",
                                  timeout=300)
            for r in bg:
                r.wait(300)
            st = router.stats()
    assert out == ref
    assert st["failovers"] >= 1, st
    assert set(st["replicas"][0]) >= {"model:a", "model:b"}


def test_router_load_shedding_is_structured_and_metered(monkeypatch):
    """``test_router_load_shedding_is_structured_and_metered``: every
    replica refusing admission sheds the request with AdmissionError,
    counted as the JAX router counts it."""
    jm, pm = model_pair()
    ledgers = []
    for pkg, m in ((port, pm), (jserving, jm)):
        with _router(pkg, m) as router:
            for rep in router._replicas:
                def full(request, _pkg=pkg):
                    raise _pkg.AdmissionError("queue full (test)")
                monkeypatch.setattr(rep.engine, "submit_request", full)
            with pytest.raises(pkg.AdmissionError, match="saturated"):
                router.submit([1, 2, 3], max_new_tokens=4)
            st = router.stats()
        assert st["inflight"] == 0
        ledgers.append(_ledger(st))
    assert ledgers[0] == ledgers[1]
    assert ledgers[0]["shed_requests"] == 1


def test_env_flags_configure_router(monkeypatch):
    """``test_env_flags_configure_router``: the same flags, the same
    defaults."""
    from paddle_tpu.flags import env as jenv
    from paddle_tpu_torch.flags import env as penv

    for name in ("PTPU_SERVE_REPLICAS", "PTPU_SERVE_DEADLINE_S",
                 "PTPU_SERVE_RETRY_BUDGET", "PTPU_RETRY_BACKOFF",
                 "PTPU_SERVE_CANARY_PCT", "PTPU_ONLINE_POLL_S",
                 "PTPU_FAULT_INJECT"):
        monkeypatch.delenv(name, raising=False)
        assert penv(name) == jenv(name), name
    _, pm = model_pair()
    monkeypatch.setenv("PTPU_SERVE_REPLICAS", "2")
    monkeypatch.setenv("PTPU_SERVE_RETRY_BUDGET", "5")
    monkeypatch.setenv("PTPU_SERVE_DEADLINE_S", "123.0")
    with port.ServingRouter(pm, max_batch=2, max_seq_len=64, block_size=4,
                            device="cpu") as router:
        assert router.num_replicas == 2 and router._retry_budget == 5
        req = router.submit([1, 2, 3], max_new_tokens=2)
        assert req.deadline is not None
        assert req.wait(120) == port.reference_decode(pm, [1, 2, 3], 2)


# ---------------------------------------------------------------------------
# failover: death, transient, stall
# ---------------------------------------------------------------------------


def _failover_run(pkg, model, spec, prompts, max_new, **kw):
    streamed = {i: [] for i in range(len(prompts))}
    with _inject(_res(pkg), spec):
        with _router(pkg, model, **kw) as router:
            cbs = [lambda req, tok, final, _i=i: streamed[_i].append(
                int(tok)) for i in range(len(prompts))]
            with pinned(router):
                reqs = [router.submit(p, max_new_tokens=max_new,
                                      stream=cb)
                        for p, cb in zip(prompts, cbs)]
            outs = [r.wait(300) for r in reqs]
            st = router.stats()
            dead = [r for r in router._replicas if r.state == "dead"]
            for rep in dead:
                for w in rep.engine._workers.values():
                    w._thread.join(30)
                _assert_drained(rep.engine)
    return outs, streamed, st, dead, reqs


def test_replica_death_failover_token_identity():
    """``test_replica_death_failover_token_identity``: a replica dies at
    step 6; its requests re-admit on the survivor from what they had
    received, every stream is the reference once and in order, and the
    failovers, re-admissions and retries equal the JAX router's."""
    jm, pm = model_pair()
    prompts = _prompts(8, seed=11)
    refs = [port.reference_decode(pm, p, 12) for p in prompts]
    runs = {}
    for pkg, m in ((port, pm), (jserving, jm)):
        outs, streamed, st, dead, reqs = _failover_run(
            pkg, m, "serve_die_at_step:6", prompts, 12)
        assert outs == refs and streamed == dict(enumerate(refs))
        assert len(dead) == 1 and st["replicas_healthy"] == 1
        assert sum(r.readmissions for r in reqs) == st["readmitted"]
        runs[pkg.__name__] = _ledger(st)
    got, want = runs["paddle_tpu_torch.serving"], runs["paddle_tpu.serving"]
    assert got == want
    assert got["failovers"] == 1 and got["readmitted"] == 4
    assert got["requests_completed"] == len(prompts)


def test_transient_step_failure_retried_in_place():
    """``test_transient_step_failure_retried_in_place``: a transient at
    step 4 is retried at the boundary (no failover), as often as in the
    JAX router."""
    jm, pm = model_pair()
    prompts = _prompts(4, seed=3)
    refs = [port.reference_decode(pm, p, 8) for p in prompts]
    retried = []
    for pkg, m in ((port, pm), (jserving, jm)):
        with _inject(_res(pkg), "serve_transient_at_step:4"):
            with _router(pkg, m) as router:
                outs = [router.generate(p, max_new_tokens=8, timeout=300)
                        for p in prompts]
                st = router.stats()
        assert outs == refs
        assert st["failovers"] == 0 and st["replicas_healthy"] == 2
        retried.append(sum(r["model:default"]["transient_retries"]
                           for r in st["replicas"]))
    assert retried[0] == retried[1] == 1


def test_stall_watchdog_failover():
    """``test_stall_watchdog_failover``: a replica that stops stepping
    without raising is declared dead by the watchdog (1.5 s budget) and
    its requests fail over; the ledger equals the JAX router's."""
    jm, pm = model_pair()
    prompts = _prompts(6, seed=5)
    refs = [port.reference_decode(pm, p, 10) for p in prompts]
    _warm(pm)
    runs = []
    for pkg, m in ((port, pm), (jserving, jm)):
        outs, _, st, dead, _ = _failover_run(
            pkg, m, "serve_stall_at_step:5", prompts, 10,
            stall_timeout_s=1.5)
        assert outs == refs
        assert len(dead) == 1 and "stalled" in str(dead[0].error)
        runs.append(_ledger(st))
    assert runs[0] == runs[1]
    assert runs[0]["failovers"] == 1 and runs[0]["readmitted"] == 3


def test_failover_readmission_rides_prefix_cache():
    """``test_failover_readmission_rides_prefix_cache``: the survivor
    adopts the cached prefix for the re-admitted prompt + emitted."""
    _, pm = model_pair()
    shared = list(range(1, 17))
    prompt = shared + [7, 9]
    ref = port.reference_decode(pm, prompt, 10)
    with _router(port, pm, prefill_chunk=4, prefix_cache=True) as router:
        for w in [router.submit(shared + [3], max_new_tokens=2),
                  router.submit(shared + [5], max_new_tokens=2)]:
            w.wait(300)
        st0 = router.stats()
        assert all(r["model:default"]["steps"] > 0
                   for r in st0["replicas"])
        reused0 = {r["idx"]: r["model:default"]["prefix_blocks_reused"]
                   for r in st0["replicas"]}
        steps_now = max(r["model:default"]["steps"]
                        for r in st0["replicas"])
        with _inject(pres, "serve_die_at_step:%d" % (steps_now + 3)):
            assert router.submit(prompt, max_new_tokens=10).wait(300) == ref
            st1 = router.stats()
        survivor = [r for r in st1["replicas"] if r["state"] != "dead"]
    assert len(survivor) == 1 and st1["readmitted"] >= 1
    assert (survivor[0]["model:default"]["prefix_blocks_reused"]
            > reused0[survivor[0]["idx"]])


def test_retry_budget_exhausted():
    """``test_retry_budget_exhausted_is_the_pr4_shape``: budget 0 and a
    dead replica give RetryBudgetExceededError, nothing spent, in both
    packages."""
    jm, pm = model_pair()
    for pkg, m in ((port, pm), (jserving, jm)):
        res = _res(pkg)
        with _inject(res, "serve_die_at_step:2"):
            with _router(pkg, m, replicas=1, retry_budget=0) as router:
                req = router.submit(list(range(1, 6)), max_new_tokens=10)
                with pytest.raises(res.RetryBudgetExceededError):
                    req.wait(300)
                st = router.stats()
        assert st["requests_failed"] == 1 and st["retries"] == 0


def test_no_surviving_replica_fails_loudly():
    """``test_no_surviving_replica_fails_loudly``."""
    _, pm = model_pair()
    with _inject(pres, "serve_die_at_step:2"):
        with _router(port, pm, replicas=1, retry_budget=2) as router:
            req = router.submit(list(range(1, 6)), max_new_tokens=10)
            with pytest.raises(RuntimeError, match="no surviving replica"):
                req.wait(300)


def test_abort_drops_inflight_steps_unread():
    """The async window under death: a worker killed while steps are in
    flight drops them unread. The request keeps only the tokens it was
    delivered (a prefix of the reference), the in-flight list is empty,
    and the pool drains."""
    _, pm = model_pair()
    prompt = [5, 9, 13]
    ref = port.reference_decode(pm, prompt, 40)
    gate, seen = threading.Event(), threading.Event()

    def cb(req, tok, final):
        if len(req.tokens) == 3:
            seen.set()
            gate.wait(30)      # hold the worker with steps in flight

    with _engine(port, pm, async_depth=4) as eng:
        req = eng.submit(prompt, max_new_tokens=40, stream=cb)
        assert seen.wait(60)
        w = eng._workers["default"]
        assert w._inflight            # dispatched, not read back
        eng.kill(pres.InjectedReplicaDeathError("killed"))
        gate.set()
        with pytest.raises(pres.InjectedReplicaDeathError):
            req.wait(60)
        w._thread.join(30)
        assert w._inflight == [] and not w._thread.is_alive()
        assert req.tokens == ref[:len(req.tokens)]
        assert 3 <= len(req.tokens) < 40
        _assert_drained(eng)


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


def test_deadline_validation():
    """``test_deadline_validation``: one rule set for the engine's and
    the router's submit."""
    _, pm = model_pair()
    with _engine(port, pm) as eng:
        for bad in (0, -1.0):
            with pytest.raises(ValueError):
                eng.submit([1, 2], max_new_tokens=2, deadline_s=bad)
    with _router(port, pm) as router:
        with pytest.raises(ValueError):
            router.submit([1, 2], max_new_tokens=2, deadline_s=-1.0)
        with pytest.raises(ValueError):
            router.submit([], max_new_tokens=2)
        with pytest.raises(ValueError):
            router.submit([1, 2], max_new_tokens=0)


def test_engine_deadline_expires_queued_request():
    """``test_engine_deadline_expires_queued_request``: a queued request
    past its deadline fails with DeadlineExceededError; the blocker is
    untouched; both engines count one expiry."""
    jm, pm = model_pair()
    for pkg, m in ((port, pm), (jserving, jm)):
        with _engine(pkg, m, max_batch=1) as eng:
            blocker = eng.submit(list(range(1, 6)), max_new_tokens=40)
            doomed = eng.submit(list(range(1, 6)), max_new_tokens=40,
                                deadline_s=0.02)
            with pytest.raises(pkg.DeadlineExceededError):
                doomed.wait(120)
            blocker.wait(120)
            assert eng._workers["default"]._track_deadlines
            st = eng.stats()["default"]
        assert st["deadline_expired"] == 1 and doomed.finished


def test_engine_deadline_expires_mid_batch_and_pool_drains():
    """``test_engine_deadline_expires_mid_batch_and_pool_drains``."""
    _, pm = model_pair()
    with _engine(port, pm, max_batch=1) as eng:
        req = eng.submit(list(range(1, 6)), max_new_tokens=50,
                         deadline_s=60.0)
        req.deadline = time.perf_counter() - 1.0
        with pytest.raises(port.DeadlineExceededError):
            req.wait(120)
        w = eng._workers["default"]
        deadline = time.time() + 30
        while w.pool.stats()["blocks_in_use"] and time.time() < deadline:
            time.sleep(0.005)
        _assert_drained(eng)
        st = eng.stats()["default"]
    assert st["deadline_expired"] == 1 and len(req.tokens) < 50


def test_router_deadline_backstop_on_wedged_replica():
    """``test_router_deadline_backstop_on_wedged_replica``: a wedged
    worker has no step boundary; the router's monitor fails the
    request."""
    _, pm = model_pair()
    with _inject(pres, "serve_stall_at_step:2"):
        with _router(port, pm, replicas=1, retry_budget=0,
                     stall_timeout_s=60.0) as router:
            req = router.submit(list(range(1, 6)), max_new_tokens=30,
                                deadline_s=0.25)
            with pytest.raises(port.DeadlineExceededError):
                req.wait(120)
            st = router.stats()
    assert st["deadline_expired"] == 1


# ---------------------------------------------------------------------------
# the drain path: killed mid-prefill, mid-spec-window
# ---------------------------------------------------------------------------


def test_replica_killed_mid_prefill_drains_pool():
    """``test_replica_killed_mid_prefill_drains_pool``."""
    _, pm = model_pair()
    with _inject(pres, "serve_die_at_step:5"):
        with _engine(port, pm) as eng:
            req = eng.submit(list(range(1, 33)), max_new_tokens=8)
            with pytest.raises(pres.InjectedReplicaDeathError):
                req.wait(120)
            assert eng._workers["default"].error is not None
            assert req.tokens == []
            _assert_drained(eng)


def test_replica_killed_mid_spec_window_drains_pool():
    """``test_replica_killed_mid_spec_window_drains_pool``."""
    _, pm = model_pair()
    prompt = [3, 5, 7, 9] * 3
    with _inject(pres, "serve_die_at_step:%d" % (len(prompt) + 2)):
        with _engine(port, pm, spec_k=3) as eng:
            req = eng.submit(prompt, max_new_tokens=24)
            with pytest.raises(pres.InjectedReplicaDeathError):
                req.wait(120)
            assert eng._workers["default"].scheduler.spec_steps >= 1
            _assert_drained(eng)


# ---------------------------------------------------------------------------
# the engine's model forms and defaults-off identity
# ---------------------------------------------------------------------------


def test_engine_model_forms_and_stats_layout(tmp_path):
    """The engine takes JAX's three model forms (a model, an artifact
    directory, a ``{name: model}`` dict); ``stats()`` is keyed by model
    name and carries every key of the JAX engine's."""
    jm, pm = model_pair()
    art = str(tmp_path / "art")
    port.save_generation_artifact(art, pm.config, pm.weights)
    with jserving.ServingEngine(jm, max_batch=2, max_seq_len=64,
                                block_size=4) as jeng:
        jkeys = set(jeng.stats()["default"])
    for models, names in ((pm, ["default"]), (art, ["default"]),
                          ({"a": pm, "b": art}, ["a", "b"])):
        with _engine(port, models) as eng:
            assert eng.model_names == names
            for name in names:
                assert eng.generate([1, 2, 3], max_new_tokens=3,
                                    model=name, timeout=120) == \
                    port.reference_decode(pm, [1, 2, 3], 3)
            st = eng.stats()
            assert list(st) == names
            for name in names:
                assert jkeys <= set(st[name])
            # generate returns when the request is done; the worker frees
            # its slot a moment later, on its own thread
            deadline = time.monotonic() + 30.0
            while eng.load() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert eng.load() == 0
            health = eng.health()
            assert all(h["alive"] and h["error"] is None
                       for h in health.values())


def test_fleet_off_defaults_bitwise_legacy(monkeypatch):
    """``test_fleet_off_defaults_bitwise_legacy``: with the fleet flags
    unset the engine runs no deadline scan and no retry, and its tokens,
    steps and every shared stat equal the JAX engine's on the same
    pinned arrivals; the router stays one replica by default."""
    for name in ("PTPU_SERVE_REPLICAS", "PTPU_SERVE_DEADLINE_S",
                 "PTPU_SERVE_RETRY_BUDGET", "PTPU_FAULT_INJECT"):
        monkeypatch.delenv(name, raising=False)
    jm, pm = model_pair()
    prompts = _prompts(4, seed=13)
    refs = [port.reference_decode(pm, p, 6) for p in prompts]
    stats = []
    for pkg, m in ((port, pm), (jserving, jm)):
        prev = _res(pkg).set_global_injector(_res(pkg).FaultInjector(""))
        try:
            with _engine(pkg, m) as eng:
                w = eng._workers["default"]
                with settled(eng):
                    reqs = [eng.submit(p, max_new_tokens=6)
                            for p in prompts]
                assert all(r.deadline is None for r in reqs)
                assert [r.wait(120) for r in reqs] == refs
                with settled(eng):
                    st = eng.stats()["default"]
                assert w._track_deadlines is False
                assert w._transient_retries == 0
        finally:
            _res(pkg).set_global_injector(prev)
        stats.append(st)
    shared = set(stats[1]) - {"weight_store"}
    assert {k: stats[0][k] for k in shared} == \
        {k: stats[1][k] for k in shared}
    assert stats[0]["deadline_expired"] == stats[0]["transient_retries"] \
        == stats[0]["weight_version"] == 0
    from paddle_tpu_torch.flags import env
    assert env("PTPU_SERVE_REPLICAS") == 1
    assert env("PTPU_SERVE_DEADLINE_S") is None
