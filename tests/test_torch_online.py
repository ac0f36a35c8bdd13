"""Online updates of paddle_tpu_torch held against the JAX package on the
CPU, case by case after ``tests/test_online.py``: the atomic generation
artifact (publish, verify, the ``ckpt_torn_export`` site),
``ServingEngine.swap_weights`` (per-version token consistency, the
prefix-cache flush, sources and errors, new tensors installed while the
old ones, shared with other replicas, stay untouched), router
drain/undrain, the ``CanaryGate`` signals (the same verdicts as the JAX
gate on the same ledgers) and the ``OnlineUpdater`` chaos matrix (torn
export, corrupt checkpoint, swap death, canary anomaly), plus
``inference.export_generation_model`` of the port's
``transformer_fluid`` Program: bitwise the JAX package's export from the
same startup state.

The serving cases use one model pair (vocab 64, d_model 32, 2 heads, 2
layers); the updater cases one Fluid program (vocab 64, d_model 16, 1
layer), as the JAX file does."""

import json
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu import serving as jserving
from paddle_tpu import unique_name as j_unique
from paddle_tpu.models import transformer_fluid as j_tf

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import checkpoint as pckpt
from paddle_tpu_torch.async_engine import as_numpy
from paddle_tpu_torch import inference as pinference
from paddle_tpu_torch import resilience as pres
from paddle_tpu_torch import serving as port
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import transformer_fluid as p_tf

CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_seq_len=64)
PROG = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=1, d_ff=32,
            seq_len=8)

_MODELS = {}


def model_pair():
    """Two same-geometry port models (v0 / v1 stand-ins) on the CPU, the
    JAX package's random weights at seeds 0 and 1."""
    if not _MODELS:
        for key, seed in (("a", 0), ("b", 1)):
            jm = jserving.GenerationModel.random(
                jserving.GenerationConfig(**CFG), seed=seed)
            _MODELS[key] = port.GenerationModel.from_jax_weights(
                port.GenerationConfig(**CFG),
                {k: np.asarray(v) for k, v in jm.weights.items()},
                name="online-" + key, device="cpu")
    return _MODELS["a"], _MODELS["b"]


def _router(model, **kw):
    kw.setdefault("replicas", 2)
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("block_size", 4)
    kw.setdefault("health_interval_s", 0.02)
    kw.setdefault("backoff_base", 0.0)
    return port.ServingRouter(model, device="cpu", **kw)


def _engine(model, **kw):
    return port.ServingEngine(model, max_batch=2, max_seq_len=64,
                              block_size=4, device="cpu", **kw)


class _inject:
    """Arm the port's process-global injector for a with-block."""

    def __init__(self, spec):
        self.spec = spec

    def __enter__(self):
        self._prev = pres.set_global_injector(pres.FaultInjector(self.spec))
        self._warns = warnings.catch_warnings()
        self._warns.__enter__()
        warnings.simplefilter("ignore", RuntimeWarning)
        return self

    def __exit__(self, *exc):
        self._warns.__exit__(*exc)
        pres.set_global_injector(self._prev)
        return False


# ---------------------------------------------------------------------------
# the atomic artifact
# ---------------------------------------------------------------------------


def test_artifact_manifest_verify_roundtrip(tmp_path):
    """``test_artifact_manifest_verify_roundtrip``: a port-written
    artifact verifies in both packages, also republished over itself, and
    loads back with the same weights."""
    m, _ = model_pair()
    d = str(tmp_path / "art")
    port.save_generation_artifact(d, m.config, m.weights)
    assert port.verify_generation_artifact(d) is True
    port.save_generation_artifact(d, m.config, m.weights)
    assert port.verify_generation_artifact(d) is True
    assert jserving.verify_generation_artifact(d) is True
    loaded = port.load_generation_artifact(d, device="cpu")
    assert sorted(loaded.weights) == sorted(m.weights)


def test_artifact_corruption_raises_structured_error(tmp_path):
    """``test_artifact_corruption_raises_structured_error``."""
    m, _ = model_pair()
    d = str(tmp_path / "art")
    port.save_generation_artifact(d, m.config, m.weights)
    npz = os.path.join(d, port.model.GENERATION_WEIGHTS)
    blob = bytearray(open(npz, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(npz, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(port.GenerationArtifactError) as e:
        port.verify_generation_artifact(d)
    assert e.value.dirname == d and d in str(e.value)
    with pytest.raises(port.GenerationArtifactError):
        port.load_generation_artifact(d, device="cpu")


def test_torn_export_injection_is_detected(tmp_path):
    """``test_torn_export_injection_is_detected``: ``ckpt_torn_export:1``
    tears the publish after it lands; both packages' verifiers and the
    loader refuse it, and a manifest-less artifact stays loadable
    (``test_artifact_without_manifest_is_legacy_not_error``)."""
    m, _ = model_pair()
    d = str(tmp_path / "art")
    with _inject("ckpt_torn_export:1"):
        port.save_generation_artifact(d, m.config, m.weights)
    for verify in (port.verify_generation_artifact,
                   jserving.verify_generation_artifact):
        with pytest.raises((port.GenerationArtifactError,
                            jserving.GenerationArtifactError)):
            verify(d)
    with pytest.raises(port.GenerationArtifactError):
        port.load_generation_artifact(d, device="cpu")
    legacy = str(tmp_path / "legacy")
    port.save_generation_artifact(legacy, m.config, m.weights)
    os.remove(os.path.join(legacy, port.model.GENERATION_MANIFEST))
    assert port.verify_generation_artifact(legacy) is False
    port.load_generation_artifact(legacy, device="cpu")


# ---------------------------------------------------------------------------
# ServingEngine.swap_weights
# ---------------------------------------------------------------------------


def test_swap_weights_per_version_token_consistency():
    """``test_swap_weights_per_version_token_consistency``: a request
    mid-generation when the swap is asked finishes wholly on its version;
    later requests serve wholly on the new one."""
    m0, m1 = model_pair()
    prompt = [3, 4, 5]
    ref0 = port.reference_decode(m0, prompt, 24)
    ref1 = port.reference_decode(m1, prompt, 8)
    with _engine(m0) as eng:
        assert eng.weight_version() == 0
        seen = threading.Event()

        def cb(req, tok, final):
            if len(req.tokens) >= 3:
                seen.set()

        inflight = eng.submit(prompt, max_new_tokens=24, stream=cb)
        assert seen.wait(120)
        assert eng.swap_weights(m1) == 1 and eng.weight_version() == 1
        assert inflight.wait(0.1) == ref0
        assert eng.generate(prompt, max_new_tokens=8, timeout=120) == ref1
        assert eng.stats()["default"]["weight_version"] == 1


def test_swap_weights_flushes_prefix_cache():
    """``test_swap_weights_flushes_prefix_cache``: a warm prefix from the
    old weights never serves after the swap."""
    m0, m1 = model_pair()
    prompt = list(range(1, 17)) + [7, 9]
    ref1 = port.reference_decode(m1, prompt, 8)
    with _engine(m0, prefill_chunk=4, prefix_cache=True) as eng:
        eng.generate(prompt, max_new_tokens=4, timeout=300)
        w = eng._workers["default"]
        assert w.pool.blocks_cached > 0
        eng.swap_weights(m1)
        assert w.pool.blocks_cached == 0
        assert eng.generate(prompt, max_new_tokens=8, timeout=300) == ref1


def test_swap_weights_sources_and_errors(tmp_path):
    """``test_swap_weights_sources_and_errors``: an artifact directory, a
    dict and a Scope swap in; a wrong weight set, shape or dtype, a
    non-source and an unknown model raise before anything swaps; a
    closed engine refuses."""
    m0, m1 = model_pair()
    d = str(tmp_path / "art")
    port.save_generation_artifact(d, m1.config, m1.weights)
    ref1 = port.reference_decode(m1, [5, 6], 6)
    with _engine(m0) as eng:
        assert eng.swap_weights(d, version=7) == 7
        assert eng.weight_version() == 7
        assert eng.generate([5, 6], max_new_tokens=6, timeout=120) == ref1
        eng.swap_weights({k: v.numpy() for k, v in m0.weights.items()})
        scope = Scope()
        for k, v in m1.weights.items():
            scope.set(k, v)
        assert eng.swap_weights(scope) == 9
        with pytest.raises(ValueError):
            eng.swap_weights({"bogus": np.zeros(2)})
        bad = dict(m1.weights)
        k = next(iter(bad))
        bad[k] = np.zeros((1, 1), np.float32)
        with pytest.raises(ValueError):
            eng.swap_weights(bad)
        bad[k] = m1.weights[k].numpy().astype(np.int8)
        with pytest.raises(ValueError):
            eng.swap_weights(bad)
        with pytest.raises(TypeError):
            eng.swap_weights(42)
        with pytest.raises(KeyError):
            eng.swap_weights(m1, model="nope")
        assert eng.weight_version() == 9
    with pytest.raises(RuntimeError):
        eng.swap_weights(m1)


def test_swap_installs_new_tensors_and_spares_shared_ones(tmp_path):
    """The replicas of a router share the model's tensors: a swap on one
    replica installs new tensors in its scope and never writes the old
    ones, so the other replica keeps serving the old weights."""
    m0, m1 = model_pair()
    d = str(tmp_path / "art")
    port.save_generation_artifact(d, m1.config, m1.weights)
    before = {k: v.clone() for k, v in m0.weights.items()}
    with _router(m0) as router:
        s0, s1 = (router.replica_engine(i).model_scope() for i in (0, 1))
        name = "l0/wqkv"
        assert s0.get(name) is s1.get(name) is m0.weights[name]
        assert router.drain(1) and router.wait_drained(1, timeout=30)
        router.replica_engine(1).swap_weights(d)
        router.undrain(1)
        assert s1.get(name) is not m0.weights[name]
        assert torch.equal(s1.get(name), m1.weights[name])
        assert s0.get(name) is m0.weights[name]
        for k, v in m0.weights.items():
            assert torch.equal(v, before[k]), k
        reqs = [router.submit([2, 3, 4], max_new_tokens=5)
                for _ in range(4)]
        for r in reqs:
            ref = port.reference_decode((m0, m1)[r.weight_version],
                                        [2, 3, 4], 5)
            assert r.wait(120) == ref
        assert {r.weight_version for r in reqs} == {0, 1}


# ---------------------------------------------------------------------------
# router drain / undrain
# ---------------------------------------------------------------------------


def _warm(model):
    """One request through a throwaway engine of the router's geometry:
    the router's contract (``serving/router.py``) asks for warm replicas
    before a stall budget below a cold step's time."""
    eng = _engine(model)
    try:
        eng.generate([1, 2], max_new_tokens=4, timeout=120)
    finally:
        eng.close()


def test_drain_excludes_dispatch_watchdog_stands_down():
    """``test_drain_excludes_dispatch_watchdog_stands_down``; the model
    is warmed first, so the 0.3 s budget times warm steps only."""
    m0, _ = model_pair()
    _warm(m0)
    with _router(m0, stall_timeout_s=0.3) as router:
        steps0 = router.stats()["replicas"][1]["model:default"]["steps"]
        assert router.drain(1)
        assert router.replica_states() == ["healthy", "draining"]
        assert router.wait_drained(1, timeout=5) is True
        for _ in range(3):
            router.generate([1, 2], max_new_tokens=4, timeout=120)
        time.sleep(0.5)
        st = router.stats()
        assert st["replicas"][1]["model:default"]["steps"] == steps0
        assert st["replicas_draining"] == 1
        assert router.replica_states()[1] == "draining"
        assert router.undrain(1) and router.undrain(1) is False
        assert router.stats()["replicas_draining"] == 0
        for r in [router.submit([1, 2], max_new_tokens=8)
                  for _ in range(6)]:
            r.wait(120)
        assert router.stats()["replicas"][1]["model:default"]["steps"] \
            > steps0


def test_drain_kill_undrain_never_double_spends_budget():
    """``test_drain_kill_undrain_never_double_spends_budget``."""
    m0, _ = model_pair()
    prompt = [2, 3, 4]
    ref = port.reference_decode(m0, prompt, 20)
    with _router(m0) as router:
        gate, seen = threading.Event(), threading.Event()

        def cb(rreq, token, final):
            seen.set()
            gate.wait(30)

        req = router.submit(prompt, max_new_tokens=20, stream=cb)
        assert seen.wait(30)
        victim = req._replica.idx
        assert router.drain(victim)
        router.replica_engine(victim).kill(
            pres.InjectedReplicaDeathError("killed mid-drain"))
        gate.set()
        assert req.wait(300) == ref
        assert req.retries == 1
        assert router.wait_drained(victim, timeout=5) is False
        assert router.undrain(victim) is False
        assert router.replica_states()[victim] == "dead"
        st = router.stats()
        assert st["retries"] == 1
        assert st["requests_submitted"] == \
            st["requests_completed"] + st["requests_failed"]
    assert router.drain(victim) is False


# ---------------------------------------------------------------------------
# the CanaryGate signals: the JAX gate's verdicts
# ---------------------------------------------------------------------------


class _FakeEngine:
    def __init__(self, rows):
        self._rows = rows

    def stats(self):
        return self._rows


class _FakeRouter:
    num_replicas = 2

    def __init__(self, ledger, stats=None):
        self._ledger = ledger
        self._stats = stats or [{}, {}]

    def version_ledger(self):
        return self._ledger

    def replica_states(self):
        return ["healthy", "healthy"]

    def replica_engine(self, idx):
        return _FakeEngine(self._stats[idx])


ACCEPT = [{"default": {"spec_proposed": 40, "spec_accepted": 8}},
          {"default": {"spec_proposed": 40, "spec_accepted": 36}}]


@pytest.mark.parametrize("ledger,stats,kw,want", [
    ({1: (2, 0, 0.2), 0: (9, 0, 0.9)}, None, dict(min_requests=4), None),
    ({1: (2, 3, 0.2), 0: (10, 0, 1.0)}, None, dict(min_requests=4),
     "failure_rate"),
    ({1: (5, 0, 5.0), 0: (10, 0, 1.0)}, None, dict(min_requests=4),
     "latency"),
    ({1: (5, 0, 0.5), 0: (10, 0, 1.0)}, None, dict(min_requests=4), None),
    ({1: (5, 0, 0.5), 0: (10, 0, 1.0)}, ACCEPT,
     dict(min_requests=4, accept_delta=0.2), "accept_rate"),
], ids=["thin", "failure", "latency", "healthy", "accept"])
def test_canary_gate_signals_match_jax(ledger, stats, kw, want):
    """``test_canary_gate_failure_and_latency_signals`` and
    ``test_canary_gate_accept_rate_signal``: the port's gate gives the
    JAX gate's verdict, numbers included."""
    got = port.CanaryGate(**kw).evaluate(_FakeRouter(ledger, stats),
                                         0, 1, 0)
    ref = jserving.CanaryGate(**kw).evaluate(_FakeRouter(ledger, stats),
                                             0, 1, 0)
    assert got == ref
    assert (got or {}).get("signal") == want


def test_canary_gate_nonfinite_and_injected_signals():
    """``test_canary_gate_nonfinite_and_injected_signals``."""
    r = _FakeRouter({})
    assert port.CanaryGate().evaluate(r, 0, 1, 0, nonfinite=True) == \
        jserving.CanaryGate().evaluate(r, 0, 1, 0, nonfinite=True)
    with _inject("canary_anomaly_at_version:3"):
        assert port.CanaryGate().evaluate(r, 0, 3, 2)["signal"] == \
            "injected"
        assert port.CanaryGate().evaluate(r, 0, 3, 2) is None


# ---------------------------------------------------------------------------
# export_generation_model: bitwise the JAX package's
# ---------------------------------------------------------------------------


def _programs():
    """The JAX and the port's Program of one build, the JAX startup
    state carried into the port's scope by name."""
    jmain, jstart = jfluid.Program(), jfluid.Program()
    with j_unique.guard(), jfluid.program_guard(jmain, jstart):
        j_tf.build(remat=False, **PROG)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    pmain, pstart = pfluid.Program(), pfluid.Program()
    with p_unique.guard(), pfluid.program_guard(pmain, pstart):
        p_tf.build(remat=False, **PROG)
    pscope = pfluid.Scope()
    pfluid.Executor("cpu").run(pstart, scope=pscope)
    scope_from_numpy(pscope, {p.name: np.asarray(jscope.get(p.name))
                              for p in pmain.all_parameters()})
    return (jmain, jscope), (pmain, pscope)


def test_export_generation_model_bitwise_jax(tmp_path):
    """The port's ``export_generation_model`` of its ``transformer_fluid``
    Program gives the JAX package's export of the same startup state
    bitwise: the same weight names and bytes, the same meta, the same
    manifest digests; ``load_generation_model`` serves it."""
    (jmain, jscope), (pmain, pscope) = _programs()
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = jinference.export_generation_model(jd, jmain, jscope,
                                              max_seq_len=32)
    pcfg = pinference.export_generation_model(pd, pmain, pscope,
                                              max_seq_len=32)
    assert pcfg.to_dict() == jcfg.to_dict()
    with np.load(os.path.join(jd, port.model.GENERATION_WEIGHTS)) as j, \
            np.load(os.path.join(pd, port.model.GENERATION_WEIGHTS)) as p:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].dtype == j[k].dtype == np.float32, k
            assert p[k].tobytes() == j[k].tobytes(), k
    for name in (port.model.GENERATION_META, port.model.GENERATION_MANIFEST):
        with open(os.path.join(jd, name)) as fj, \
                open(os.path.join(pd, name)) as fp:
            want, got = json.load(fj), json.load(fp)
        if name == port.model.GENERATION_MANIFEST:
            want, got = want["digests"], got["digests"]
        assert got == want, name
    model = pinference.load_generation_model(pd, device="cpu")
    with port.ServingEngine(model, max_batch=2, max_seq_len=32,
                            block_size=4, device="cpu") as eng:
        assert eng.generate([1, 2, 3], max_new_tokens=4, timeout=120) == \
            jserving.reference_decode(
                jinference.load_generation_model(jd), [1, 2, 3], 4)


# ---------------------------------------------------------------------------
# the OnlineUpdater chaos matrix
# ---------------------------------------------------------------------------


_FLUID = {}


def fluid_program():
    """One port program + startup scope per pytest process."""
    if not _FLUID:
        prog, sprog = pfluid.Program(), pfluid.Program()
        with pfluid.program_guard(prog, sprog):
            p_tf.build(remat=False, **PROG)
        scope = pfluid.Scope()
        pfluid.Executor("cpu").run(sprog, scope=scope)
        _FLUID["prog"], _FLUID["scope"] = prog, scope
    return _FLUID["prog"], _FLUID["scope"]


def _scope_state(scope, seed):
    """A checkpoint-shaped state: the scope's values, perturbed."""
    rng = np.random.RandomState(seed)
    state = {}
    for name in scope.local_var_names():
        v = as_numpy(scope.get(name))
        if np.issubdtype(v.dtype, np.floating):
            v = v + rng.normal(0, 0.02, v.shape).astype(v.dtype)
        state[name] = v
    return state


def _versions(router):
    return [router.replica_engine(i).weight_version() for i in range(2)]


def test_online_updater_chaos_matrix(tmp_path):
    """``test_online_updater_chaos_matrix``: (A) publish -> canary ->
    promote with per-version token identity; (B) a torn export skipped
    with no rollout, republished at the next checkpoint; (C) an injected
    canary anomaly rolled back to the incumbent with no request dropped;
    (D) a replica killed mid-drain: the rollout completes on the
    survivor."""
    prog, scope = fluid_program()
    ckpt_dir, pub_dir = str(tmp_path / "ckpts"), str(tmp_path / "pub")
    v0_dir = str(tmp_path / "v0")
    os.makedirs(ckpt_dir)
    pinference.export_generation_model(v0_dir, prog, scope, max_seq_len=32)

    def load(v):
        return pinference.load_generation_model(
            os.path.join(pub_dir, "v%d" % v), device="cpu")

    router = port.ServingRouter(v0_dir, replicas=2, max_batch=2,
                                max_seq_len=32, block_size=4,
                                health_interval_s=0.02, backoff_base=0.0,
                                device="cpu")
    try:
        upd = port.OnlineUpdater(router, ckpt_dir, pub_dir, prog,
                                 max_seq_len=32, canary_pct=50.0,
                                 canary_window_s=0.4)
        assert upd.poll_once() is None

        # A: the happy path
        pckpt.save_checkpoint(ckpt_dir, _scope_state(scope, 1), 1)
        out = upd.poll_once()
        assert out["published"] and out["promoted"] and \
            out["version"] == 1, out
        assert _versions(router) == [1, 1]
        assert router.submit([3, 4, 5], max_new_tokens=6).wait(120) == \
            port.reference_decode(load(1), [3, 4, 5], 6)
        assert upd.poll_once() is None

        # B: a torn export
        with _inject("ckpt_torn_export:1"):
            pckpt.save_checkpoint(ckpt_dir, _scope_state(scope, 2), 2)
            out = upd.poll_once()
        assert not out["published"] and out["reason"] == "torn_export"
        assert upd.torn_exports == 1 and _versions(router) == [1, 1]
        pckpt.save_checkpoint(ckpt_dir, _scope_state(scope, 3), 3)
        out = upd.poll_once()
        assert out["published"] and out["version"] == 2, out
        assert _versions(router) == [2, 2]

        # C: a canary anomaly -> structured rollback
        with _inject("canary_anomaly_at_version:3"):
            pckpt.save_checkpoint(ckpt_dir, _scope_state(scope, 4), 4)
            stop, errs = threading.Event(), []

            def pump():
                while not stop.is_set():
                    try:
                        router.submit([1, 2], max_new_tokens=4).wait(120)
                    except Exception as e:      # pragma: no cover
                        errs.append(e)
                    time.sleep(0.005)

            t = threading.Thread(target=pump)
            t.start()
            try:
                out = upd.poll_once()
            finally:
                stop.set()
                t.join()
        assert out["published"] and not out["promoted"], out
        assert upd.rollbacks == 1 and errs == []
        assert _versions(router) == [2, 2]
        assert router.submit([9, 1], max_new_tokens=5).wait(120) == \
            port.reference_decode(load(2), [9, 1], 5)
        st = router.stats()
        assert st["requests_submitted"] == \
            st["requests_completed"] + st["requests_failed"]

        # D: a replica killed mid-drain
        with _inject("swap_die_mid_drain:1"):
            pckpt.save_checkpoint(ckpt_dir, _scope_state(scope, 5), 5)
            out = upd.poll_once()
        assert out["published"] and out["promoted"], out
        states = router.replica_states()
        assert states.count("dead") == 1, states
        live = next(i for i, s in enumerate(states) if s != "dead")
        assert router.replica_engine(live).weight_version() == 4
        assert router.submit([2, 7], max_new_tokens=5).wait(120) == \
            port.reference_decode(load(4), [2, 7], 5)
        st = router.stats()
        assert st["requests_submitted"] == \
            st["requests_completed"] + st["requests_failed"]
        assert upd.stats()["incumbent_version"] == 4
    finally:
        router.close()


def test_online_updater_skips_corrupt_checkpoint(tmp_path):
    """``test_online_updater_skips_corrupt_checkpoint``: a checkpoint
    torn on disk costs one update interval, never a rollout."""
    prog, scope = fluid_program()
    ckpt_dir, v0_dir = str(tmp_path / "ckpts"), str(tmp_path / "v0")
    pinference.export_generation_model(v0_dir, prog, scope, max_seq_len=32)
    with _inject("ckpt_torn_write:1"):
        pckpt.save_checkpoint(ckpt_dir, _scope_state(scope, 1), 1)
    with port.ServingRouter(v0_dir, replicas=1, max_batch=2,
                            max_seq_len=32, block_size=4,
                            health_interval_s=0.02, backoff_base=0.0,
                            device="cpu") as router:
        upd = port.OnlineUpdater(router, ckpt_dir, str(tmp_path / "pub"),
                                 prog, max_seq_len=32, canary_pct=None)
        out = upd.poll_once()
        assert out is None or (out["published"] is False and
                               out["reason"] == "corrupt_checkpoint")
        assert router.replica_engine(0).weight_version() == 0
        assert upd.versions_published == 0
        pckpt.save_checkpoint(ckpt_dir, _scope_state(scope, 2), 2)
        out = upd.poll_once()
        assert out["published"] and out["promoted"], out
        assert router.replica_engine(0).weight_version() == 1


def test_online_off_defaults_bitwise_legacy(monkeypatch):
    """``test_online_off_defaults_bitwise_legacy``: no updater and no
    canary flag: no pin, no ledger, every replica on version 0, the
    router's tokens the reference's."""
    monkeypatch.delenv("PTPU_SERVE_CANARY_PCT", raising=False)
    m0, _ = model_pair()
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    refs = [port.reference_decode(m0, p, 6) for p in prompts]
    with _router(m0) as router:
        assert router._canary is None
        reqs = [router.submit(p, max_new_tokens=6) for p in prompts]
        assert [r.wait(120) for r in reqs] == refs
        assert router.version_ledger() == {}
        st = router.stats()
    assert st["canary_requests"] == st["version_restarts"] == 0
    assert st["replicas_draining"] == 0
    assert all(r["weight_version"] == 0 for r in st["replicas"])
    from paddle_tpu.flags import env as jenv
    from paddle_tpu_torch.flags import env as penv
    assert penv("PTPU_SERVE_CANARY_PCT") is jenv("PTPU_SERVE_CANARY_PCT") \
        is None
