"""The port's lock-order detector (``analysis/concurrency.py``) held
against the JAX package's: the factories' flag-off identity, each rule
of the tracker on the same scenario in both (the same rules and lock
names), the metrics it publishes, the blocking hooks of the async
pipeline, and the serving engine under ``PTPU_LOCK_CHECK=1``: clean,
its invariant hook live, and token-identical to the JAX engine under
pinned arrivals.
"""

import threading
import time
import warnings

import numpy as np
import pytest

from paddle_tpu import serving as jax_serving
from paddle_tpu.analysis import concurrency as jconc

from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch import serving as port
from paddle_tpu_torch.analysis import concurrency as pconc
from test_torch_pinned_arrivals import submit_pinned
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

BOTH = (jconc, pconc)


@pytest.fixture
def tracking(monkeypatch):
    """PTPU_LOCK_CHECK=1 with both trackers fresh before and after."""
    monkeypatch.setenv("PTPU_LOCK_CHECK", "1")
    for c in BOTH:
        c.reset()
    yield
    for c in BOTH:
        c.reset()


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*args, **kwargs)


def _in_thread(fn, name):
    t = threading.Thread(target=lambda: _quiet(fn), name=name)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


def _abba(conc):
    a, b = conc.make_lock("test.A"), conc.make_lock("test.B")

    def fwd():
        with a, b:
            pass

    def rev():
        with b, a:
            pass

    _in_thread(fwd, "abba-fwd")
    _in_thread(rev, "abba-rev")


def _three_cycle(conc):
    a, b, c = (conc.make_lock("t3." + n) for n in "abc")
    for first, second in ((a, b), (b, c), (c, a)):
        def order(x=first, y=second):
            with x, y:
                pass

        _in_thread(order, "t3")


def _same_class(conc):
    p1, p2 = conc.make_lock("test.pool"), conc.make_lock("test.pool")
    with p1:
        _quiet(p2.acquire)
        p2.release()


def _self_deadlock(conc):
    lk = conc.make_lock("test.self")
    with lk:
        with pytest.raises(conc.LockCheckError):
            _quiet(lk.acquire)


def _cond_wait_holding(conc):
    other = conc.make_lock("test.other")
    cv = conc.make_condition("test.cv")
    with other, cv:
        _quiet(cv.wait, 0.01)


def _long_hold(conc):
    lk = conc.make_lock("test.slow")
    with lk:
        time.sleep(0.03)
    with lk:
        pass


SCENARIOS = {
    "abba": (_abba, [("lock-order-cycle", ("test.A", "test.B"))]),
    "three_lock_cycle": (_three_cycle, [
        ("lock-order-cycle", ("t3.a", "t3.b", "t3.c"))]),
    "same_class_nesting": (_same_class, [
        ("same-class-nesting", ("test.pool",))]),
    "self_deadlock": (_self_deadlock, [("self-deadlock", ("test.self",))]),
    "condition_wait_while_holding": (_cond_wait_holding, [
        ("blocking-while-holding", ("test.other",))]),
    "long_hold": (_long_hold, [("long-hold", ("test.slow",))]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_rule_matches_jax(name, tracking, monkeypatch):
    """The same scenario gives the same violations (rule and lock names,
    each hazard once) in both trackers, without hanging; assert_clean
    then raises with that rule."""
    if name == "long_hold":
        monkeypatch.setenv("PTPU_LOCK_HOLD_MS", "10")
    scenario, want = SCENARIOS[name]
    got = {}
    for conc in BOTH:
        scenario(conc)
        got[conc] = [(v.rule, tuple(sorted(v.locks)))
                     for v in conc.violations()]
        with pytest.raises(conc.LockCheckError) as ei:
            conc.assert_clean()
        assert ei.value.rule == want[0][0]
    assert got[pconc] == got[jconc] == want


def test_abba_names_both_threads_and_stacks(tracking):
    _abba(pconc)
    v, = pconc.violations()
    assert set(v.threads) == {"abba-fwd", "abba-rev"}
    assert len(v.stacks) == 4
    assert "fwd" in v.message and "rev" in v.message


def test_factory_off_returns_plain_primitives(monkeypatch):
    """Flag unset: the factories and the runtime's lock sites are the
    plain threading primitives."""
    monkeypatch.delenv("PTPU_LOCK_CHECK", raising=False)
    assert type(pconc.make_lock("x")) is type(threading.Lock())
    assert type(pconc.make_rlock("x")) is type(threading.RLock())
    cv = pconc.make_condition("x")
    assert isinstance(cv, threading.Condition)
    mine = threading.Lock()
    assert pconc.make_condition("x", lock=mine)._lock is mine
    pool = port.KVBlockPool(1, 1, 4, 4, num_blocks=4, device="cpu")
    assert type(pool._lock) is type(threading.Lock())
    assert pconc.blocking_region("x") is pconc.blocking_region("y")


def test_flags_registered_like_jax():
    from paddle_tpu import flags as jflags

    for name in ("PTPU_LOCK_CHECK", "PTPU_LOCK_HOLD_MS", "PTPU_METRICS_OUT",
                 "PTPU_METRICS_PORT"):
        mine, theirs = pflags._ENV_REGISTRY[name], jflags._ENV_REGISTRY[name]
        assert (mine.type, mine.default) == (theirs.type, theirs.default)


def test_factory_on_and_publish_metrics(tracking):
    from paddle_tpu_torch.observability import metrics

    lk = pconc.make_lock("t.lock")
    rl = pconc.make_rlock("t.rlock")
    cv = pconc.make_condition("t.cv")
    assert isinstance(lk, pconc.TrackedLock)
    assert isinstance(rl, pconc.TrackedRLock)
    assert isinstance(cv, pconc.TrackedCondition)
    with lk, rl:
        with rl:
            pass
    pconc.publish_metrics()
    g = metrics.registry().to_dict()["gauges"]
    try:
        assert g["concurrency/locks_tracked"] == 3
        assert g["concurrency/order_edges"] == 1
        assert g["concurrency/violations"] == 0
        assert g["concurrency/acquisitions"] == 2
    finally:
        metrics.reset()


def test_tracked_condition_producer_consumer(tracking):
    cv = pconc.make_condition("t.pc")
    items, got = [], []

    def consume():
        with cv:
            while len(got) < 5:
                cv.wait_for(lambda: items, timeout=5)
                got.extend(items)
                del items[:]

    t = threading.Thread(target=consume)
    t.start()
    for i in range(5):
        with cv:
            items.append(i)
            cv.notify()
        time.sleep(0.001)
    t.join(timeout=30)
    assert not t.is_alive() and got == list(range(5))
    assert pconc.violations() == []


def test_prefetcher_blocking_hooks_fire(tracking):
    """The prefetcher's declared blocking points report when reached
    with a tracked lock held."""
    from paddle_tpu_torch.async_engine import FeedPrefetcher

    held = pconc.make_lock("t.ae.lock")
    pf = FeedPrefetcher("cpu", depth=1)
    try:
        pf.put({"x": np.zeros(2, np.float32)})
        with held:
            _quiet(pf.get)
    finally:
        pf.close()
    v, = pconc.violations()
    assert v.rule == "blocking-while-holding" and v.locks == ("t.ae.lock",)


def _serve(srv, model, prompts, **kw):
    with srv.ServingEngine(model, max_batch=4, max_seq_len=64, block_size=4,
                           prefill_chunk=4, prefix_cache=True, **kw) as eng:
        worker = eng._workers["default"]
        toks = [r.wait(300) for r in submit_pinned(eng, prompts, 8)]
        assert worker.pool.check_invariants() == []
        return toks, worker


def test_serving_engine_clean_and_equal_jax_under_lock_check(tracking):
    """A fast-path serving run (chunked prefill, prefix cache) under both
    trackers: the port's lock sites are tracked, its step-boundary audit
    runs clean, and its tokens equal the JAX engine's under pinned
    arrivals and its own untracked run's."""
    cfg = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
               max_seq_len=64)
    jax_model = jax_serving.GenerationModel.random(
        jax_serving.GenerationConfig(**cfg), seed=3, name="lockcheck")
    model = port.GenerationModel.from_jax_weights(
        port.GenerationConfig(**cfg),
        {k: np.asarray(v) for k, v in jax_model.weights.items()},
        device="cpu")
    rng = np.random.RandomState(11)
    shared = rng.randint(0, 64, size=8).tolist()
    prompts = [shared + rng.randint(0, 64, size=rng.randint(2, 8)).tolist()
               for _ in range(8)]
    toks, worker = _serve(port, model, prompts, device="cpu")
    assert isinstance(worker._cv, pconc.TrackedCondition)
    assert isinstance(worker.pool._lock, pconc.TrackedLock)
    assert worker._lock_check
    want, _ = _serve(jax_serving, jax_model, prompts)
    assert toks == want
    assert pconc.violations() == [] and jconc.violations() == []
    snap = pconc.stats()
    assert snap["locks_tracked"] >= 3
    assert snap["acquisitions"] >= len(prompts)
    assert snap["order_edges"] >= 1  # submit: engine.cv -> request_queue
    from paddle_tpu_torch.observability import metrics

    try:
        # the audit published the gauges at the step boundaries
        assert metrics.registry().to_dict()["gauges"][
            "concurrency/violations"] == 0
    finally:
        metrics.reset()


def test_engine_invariant_hook_fires_on_corruption(tracking):
    """A pool corrupted mid-run is reported by the step-boundary audit
    as a pool-invariant violation."""
    model = port.GenerationModel.random(
        port.GenerationConfig(vocab_size=64, d_model=32, n_heads=2,
                              n_layers=2, d_ff=64, max_seq_len=64),
        seed=4, device="cpu")
    with port.ServingEngine(model, max_batch=2, max_seq_len=64,
                            block_size=4, device="cpu") as eng:
        worker = eng._workers["default"]
        with worker.pool._lock._raw:  # the sabotage bypasses tracking
            worker.pool._free.pop()
        _quiet(eng.generate, [1, 2, 3], max_new_tokens=4, timeout=120)
    assert any(v.rule == "pool-invariant" for v in pconc.violations())
