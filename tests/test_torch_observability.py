"""The port's telemetry plane held against the JAX package's: the metrics
registry's JSON and Prometheus exposition, span tracing's chrome-trace
schema, the executor's step and cache telemetry, the op identities the
profiler's ranges carry, the serving engine's request-scoped events, the
live endpoint and the exit dumps; and the defaults-off contract (no
record_function, no NVTX, no allocation with telemetry off).
"""

import contextlib
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import observability as jobs
from paddle_tpu import serving as jax_serving
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core import lowering as j_lowering
from paddle_tpu.models import transformer_fluid as j_tf

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import observability as pobs
from paddle_tpu_torch import serving as port
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.core import lowering as p_lowering
from paddle_tpu_torch.models import transformer_fluid as p_tf
from paddle_tpu_torch.observability import endpoint as pendpoint
from paddle_tpu_torch.observability import flight_recorder as precorder
from test_torch_pinned_arrivals import CFG as SERVE_CFG
from test_torch_pinned_arrivals import submit_pinned
from torch_parity import (  # noqa: F401 (the autouse fixtures)
    one_torch_thread, pin_jax_init_draw)

# executor/* and compile_cache/* metrics only the JAX package records:
# its AOT compile's split and its StableHLO module's size (the port
# compiles nothing)
JAX_ONLY = {"compile_cache/trace_time", "compile_cache/compile_time",
            "compile_cache/stablehlo_module_bytes"}


@contextlib.contextmanager
def telemetry(*modules, metrics=True, tracing=True):
    """Both packages' switches as asked, their registries and rings
    empty; everything restored after."""
    saved = [(m, m.metrics.enabled(), m.tracing.enabled()) for m in modules]
    for m in modules:
        m.registry().reset()
        m.tracing.reset()
        (m.metrics.enable if metrics else m.metrics.disable)()
        (m.tracing.enable if tracing else m.tracing.disable)()
    try:
        yield
    finally:
        for m, was_m, was_t in saved:
            (m.metrics.enable if was_m else m.metrics.disable)()
            (m.tracing.enable if was_t else m.tracing.disable)()
            m.registry().reset()
            m.tracing.reset()


def _fill(reg):
    reg.counter("executor/steps").inc()
    reg.counter("executor/steps").inc(4)
    reg.counter("a.b/c").inc(7)
    reg.gauge("serving/queue_depth").set(3)
    reg.gauge("g/frac").set(0.125)
    reg.gauge("g/up").inc(2.5)
    reg.gauge("g/up").dec(1)
    reg.gauge("g/nan").set(float("nan"))
    reg.gauge("g/inf").set(float("inf"))
    reg.gauge("g/ninf").set(float("-inf"))
    reg.gauge("g/big").set(3e17)
    h = reg.histogram("executor/step_time")
    for v in (2e-4, 5e-3, 0.07, 0.07, 2.0, 250.0):
        h.observe(v)
    reg.histogram("empty/hist")
    c = reg.histogram("custom/bytes", buckets=(1024, 16, 4096))
    for v in (1, 16, 17, 5000, 1024):
        c.observe(v)


def test_registry_dict_and_prometheus_equal_jax():
    """The same inc/set/observe sequence gives the same to_dict() (NaN
    and inf gauges included) and byte-identical Prometheus text."""
    from paddle_tpu.observability.metrics import MetricsRegistry as JReg
    from paddle_tpu_torch.observability.metrics import MetricsRegistry

    j, p = JReg(), MetricsRegistry()
    _fill(j)
    _fill(p)
    assert json.dumps(p.to_dict(), sort_keys=True) == \
        json.dumps(j.to_dict(), sort_keys=True)
    assert p.to_prometheus() == j.to_prometheus()
    assert "ptpu_g_nan NaN" in p.to_prometheus()
    assert "ptpu_g_ninf -Inf" in p.to_prometheus()


@pytest.mark.parametrize("first,second", [("a/b", "a_b"),
                                           ("x.y", "x/y")])
def test_prometheus_name_collision_raises_like_jax(first, second):
    from paddle_tpu.observability.metrics import MetricsRegistry as JReg
    from paddle_tpu_torch.observability.metrics import MetricsRegistry

    msgs = []
    for reg in (JReg(), MetricsRegistry()):
        reg.counter(first).inc()
        reg.gauge(second).set(1)
        with pytest.raises(ValueError, match="collision") as ei:
            reg.to_prometheus()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_kind_and_bucket_conflicts_raise_like_jax():
    from paddle_tpu.observability.metrics import MetricsRegistry as JReg
    from paddle_tpu_torch.observability.metrics import MetricsRegistry

    for reg in (JReg(), MetricsRegistry()):
        reg.counter("k")
        with pytest.raises(TypeError):
            reg.gauge("k")
        reg.histogram("h", buckets=(1, 2))
        with pytest.raises(ValueError, match="already exists"):
            reg.histogram("h", buckets=(1, 3))
        with pytest.raises(ValueError):
            reg.counter("c").inc(-1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantile_equal_jax(seed):
    from paddle_tpu.observability.metrics import Histogram as JHist
    from paddle_tpu_torch.observability.metrics import Histogram

    rng = np.random.RandomState(seed)
    vals = np.exp(rng.uniform(-10, 5, size=200))
    buckets = (None, (0.01, 0.1, 1.0, 10.0))[seed % 2]
    j, p = JHist("h", buckets), Histogram("h", buckets)
    for v in vals:
        j.observe(float(v))
        p.observe(float(v))
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert p.quantile(q) == j.quantile(q)
    for h in (j, p):
        with pytest.raises(ValueError):
            h.quantile(1.5)
    assert JHist("e").quantile(0.5) == Histogram("e").quantile(0.5) == 0.0


def _span_scene(tracing):
    """One span tree: a step with a nested execute (args set on it), a
    request span with a retroactive child and an instant marker."""
    import time

    with tracing.span("step"):
        with tracing.span("execute").set(fetches=2):
            time.sleep(0.001)
    tid = tracing.new_trace_id()
    with tracing.span("request", trace_id=tid, model="m") as req:
        t0 = time.perf_counter_ns()
        time.sleep(0.001)
        tracing.complete("queue_wait", t0, time.perf_counter_ns(),
                         trace_id=tid, parent_id=req.span_id, request=3)
        tracing.instant("admit", trace_id=tid, request=3, slot=0)
    tracing.instant("marker")
    return tracing.events()


def _schema(events):
    rows = []
    for ev in events:
        args = ev.get("args", {})
        rows.append((ev["name"], ev["ph"], ev["cat"], tuple(sorted(args)),
                     "trace_id" in args, sorted(k for k in ev)))
    return rows


def _encloses(outer, inner):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_chrome_trace_schema_equal_jax(tmp_path):
    """The same span tree records the same events in both packages:
    names, ph, cat, arg keys, trace_id / span_id on request spans only,
    and the nesting; the dump's document shape too."""
    with telemetry(jobs, pobs, metrics=False):
        j_evs = _span_scene(jobs.tracing)
        p_evs = _span_scene(pobs.tracing)
        assert _schema(p_evs) == _schema(j_evs)
        for evs in (j_evs, p_evs):
            by = {e["name"]: e for e in evs}
            assert _encloses(by["step"], by["execute"])
            assert _encloses(by["request"], by["queue_wait"])
            assert by["queue_wait"]["args"]["parent_id"] == \
                by["request"]["args"]["span_id"]
            assert "args" not in by["step"]
        n = pobs.dump_chrome_trace(str(tmp_path / "p.json"))
        jobs.dump_chrome_trace(str(tmp_path / "j.json"))
        docs = [json.load(open(tmp_path / f)) for f in ("p.json", "j.json")]
        assert n == len(p_evs) == len(docs[0]["traceEvents"])
        assert sorted(docs[0]) == sorted(docs[1])


def _lm(fluid, tf, unique_name):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = tf.build(remat=True, dtype="bfloat16", vocab_size=64,
                              d_model=32, n_heads=2, n_layers=2, d_ff=64,
                              seq_len=16)
        fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.Adam(1e-3), init_loss_scaling=1.0,
            use_dynamic_loss_scaling=False).minimize(loss)
    return main


def test_op_scope_names_equal_jax_on_the_lm():
    """Every op of the same LM program (remat, bf16 AMP, Adam) built by
    both front ends, forward and grad ops and the ops inside the
    recompute segments, gets the same profiler identity."""
    jmain = _lm(jfluid, j_tf, j_unique)
    pmain = _lm(pfluid, p_tf, p_unique)
    jn = [j_lowering._op_scope_name(op) for b in jmain.blocks
          for op in b.ops]
    pn = [p_lowering._op_scope_name(op) for b in pmain.blocks
          for op in b.ops]
    assert pn == jn
    assert any(n.startswith("fused_multihead_attention__") for n in pn)
    assert any(n.startswith("recompute_grad__") for n in pn)
    assert all(n.replace("_", "").replace(".", "").replace("-", "")
               .isalnum() for n in pn)


def _fit_a_line(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss


def _run_steps(fluid, exe, scope, runs):
    main, startup, loss = _fit_a_line(fluid)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    for _ in range(runs):
        feed = {"x": rng.rand(8, 13).astype(np.float32),
                "y": rng.rand(8, 1).astype(np.float32)}
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


@pytest.mark.parametrize("runs", [1, 4])
def test_executor_counters_equal_jax(runs):
    """After the startup program and N runs of the same program, the
    executor/* and compile_cache/* counters and the step histogram's
    count are the JAX executor's; the names only JAX records are
    exactly its compile split and module size."""
    with telemetry(jobs, pobs, tracing=False):
        from paddle_tpu.core.scope import Scope as JScope

        with j_unique.guard():
            _run_steps(jfluid, jfluid.Executor(jfluid.CPUPlace()),
                       JScope(), runs)
        with p_unique.guard():
            _run_steps(pfluid, pfluid.Executor("cpu"), pfluid.Scope(), runs)
        jd, pd = jobs.registry().to_dict(), pobs.registry().to_dict()

    def ours(d):
        return {k: v for kind in d.values() for k, v in kind.items()
                if k.startswith(("executor/", "compile_cache/"))}

    j, p = ours(jd), ours(pd)
    assert set(p) <= set(j)
    assert set(j) - set(p) == JAX_ONLY
    for name in p:
        if name in pd["counters"]:
            assert p[name] == j[name], name
    assert p["executor/steps"] == runs + 1
    assert pd["histograms"]["executor/step_time"]["count"] == \
        jd["histograms"]["executor/step_time"]["count"] == runs + 1
    assert p["compile_cache/miss"] == 2
    assert p.get("compile_cache/hit", 0) == runs - 1


def test_executor_spans_nest_like_jax():
    """With tracing on, each run is a step span holding execute; a miss
    adds optimize (with its pass spans) and lower; a plan's first run
    is also a compile span."""
    with telemetry(pobs):
        with p_unique.guard():
            _run_steps(pfluid, pfluid.Executor("cpu"), pfluid.Scope(), 3)
        evs = pobs.tracing.events()
    names = [e["name"] for e in evs]
    assert names.count("step") == names.count("execute") == 4
    assert names.count("lower") == names.count("compile") == 2
    assert names.count("optimize") >= 1
    assert any(n.startswith("pass:") for n in names)
    steps = [e for e in evs if e["name"] == "step"]
    for e in evs:
        if e["name"] in ("execute", "lower", "optimize", "compile"):
            assert any(_encloses(s, e) for s in steps), e


def test_telemetry_disabled_is_noop_fast_path():
    """Switches off: the instrumented call sites get shared null
    singletons and nothing registers."""
    with telemetry(pobs, metrics=False, tracing=False):
        assert pobs.counter("x") is pobs.metrics.NULL_METRIC
        assert pobs.histogram("y") is pobs.gauge("z")
        assert pobs.span("z") is pobs.tracing.NULL_SPAN
        assert pobs.step_scope() is pobs.tracing.NULL_SPAN
        pobs.span("z").set(a=1)
        with pobs.span("z"):
            pass
        assert "x" not in pobs.registry().metrics()
        assert pobs.tracing.complete("c", 0, 1) is None


def _record_calls(monkeypatch):
    """Patch record_function and the NVTX push/pop to record their
    calls (and to act as null contexts)."""
    calls = []

    class Range:
        def __init__(self, name):
            calls.append(("range", name))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop", None)))
    return calls


def test_step_enters_no_range_and_no_nvtx_when_off(monkeypatch):
    """Telemetry off and no profiler session: a step enters no
    record_function and calls no NVTX. Tracing on: each span opens one
    record_function, and NVTX only on a CUDA build of torch (this CPU
    build has none; with the build flag forced, one push and one pop a
    span)."""
    calls = _record_calls(monkeypatch)
    with telemetry(pobs, metrics=False, tracing=False):
        with p_unique.guard():
            _run_steps(pfluid, pfluid.Executor("cpu"), pfluid.Scope(), 2)
        assert calls == []
        pobs.tracing.enable()
        with p_unique.guard():
            _run_steps(pfluid, pfluid.Executor("cpu"), pfluid.Scope(), 1)
        ranges = [n for k, n in calls if k == "range"]
        assert torch.version.cuda is None
        assert [k for k, _ in calls if k != "range"] == []
        assert ranges.count("step") == 2 and "execute" in ranges
        assert not any(n.startswith("fluid/") for n in ranges)
        del calls[:]
        monkeypatch.setattr(pobs.tracing, "_CUDA_BUILD", True)
        with pobs.span("outer"):
            with pobs.span("inner"):
                pass
        assert calls == [("range", "outer"), ("push", "outer"),
                         ("range", "inner"), ("push", "inner"),
                         ("pop", None), ("pop", None)]


def _trace_by_request(tracing, reqs):
    evs = [e for e in tracing.events() if "trace_id" in e.get("args", {})]
    out = []
    for r in reqs:
        mine = sorted((e for e in evs if e["args"]["trace_id"] == r.trace_id),
                      key=lambda e: (e["ts"], e["name"]))
        out.append([e["name"] for e in mine])
    return out


def test_serving_request_events_equal_jax():
    """Eight requests through a 3-slot engine with tracing on, arrivals
    pinned: each request's trace holds the JAX engine's events in the
    same order (queue_wait, admit, one prefill / decode event a step it
    rode), the serving_step spans equal the dispatched steps, and the
    tokens are the untraced run's."""
    jax_model = jax_serving.GenerationModel.random(
        jax_serving.GenerationConfig(**SERVE_CFG), seed=5)
    model = port.GenerationModel.from_jax_weights(
        port.GenerationConfig(**SERVE_CFG),
        {k: np.asarray(v) for k, v in jax_model.weights.items()},
        device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 64, size=rng.randint(2, 9)).tolist()
               for _ in range(8)]
    kw = dict(max_batch=3, max_seq_len=64, block_size=4)
    runs = {}
    with telemetry(jobs, pobs, metrics=False):
        for name, mod, eng_kw in (("jax", jobs, {}),
                                  ("port", pobs, dict(device="cpu"))):
            m = jax_model if name == "jax" else model
            srv = jax_serving if name == "jax" else port
            with srv.ServingEngine(m, **kw, **eng_kw) as eng:
                reqs = submit_pinned(eng, prompts, 6)
                toks = [r.wait(300) for r in reqs]
                steps = eng.stats()["default"]["steps"]
            runs[name] = (toks, _trace_by_request(mod.tracing, reqs), steps,
                          sum(e["name"] == "serving_step"
                              for e in mod.tracing.events()))
    with port.ServingEngine(model, **kw, device="cpu") as eng:
        plain = [r.wait(300) for r in submit_pinned(eng, prompts, 6)]
    toks, traces, steps, spans = runs["port"]
    assert toks == runs["jax"][0] == plain
    assert traces == runs["jax"][1]
    assert spans == steps == runs["jax"][2] == runs["jax"][3]
    for names in traces:
        assert names[:2] == ["queue_wait", "admit"]
        assert "prefill_chunk" in names and "decode_window" in names


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture
def live_endpoint():
    port_no = pendpoint.start(port=0)
    try:
        yield port_no
    finally:
        pendpoint.stop()


def test_endpoint_routes(live_endpoint, monkeypatch):
    """/metrics is the registry's Prometheus text, /varz its JSON,
    /healthz 200 over the providers (an engine built while the endpoint
    runs registers itself, and unregisters at close), 503 when one
    raises; an unknown route 404, a failing scrape 500. Bound on
    loopback only."""
    assert pendpoint.url("/x").startswith("http://127.0.0.1:%d"
                                          % live_endpoint)
    with telemetry(pobs, tracing=False):
        pobs.counter("t/c").inc(2)
        pobs.gauge("t/g").set(float("nan"))
        status, body = _get(pendpoint.url("/metrics"))
        assert status == 200 and body == pobs.metrics.to_prometheus()
        status, body = _get(pendpoint.url("/varz"))
        assert status == 200 and body == json.dumps(
            pobs.registry().to_dict(), sort_keys=True)
        model = port.GenerationModel.random(
            port.GenerationConfig(**SERVE_CFG), seed=1, device="cpu")
        with port.ServingEngine(model, max_batch=2, max_seq_len=64,
                                block_size=4, device="cpu") as eng:
            eng.generate([1, 2, 3], max_new_tokens=3, timeout=300)
            status, body = _get(pendpoint.url("/healthz"))
            doc = json.loads(body)
            assert status == 200 and doc["status"] == "ok"
            (key, snap), = doc["providers"].items()
            assert key.startswith("engine-")
            assert snap["models"]["default"]["alive"] is True

            def broken():
                raise RuntimeError("replica wedged")

            pendpoint.register_health_provider("broken", broken)
            status, body = _get(pendpoint.url("/healthz"))
            doc = json.loads(body)
            assert status == 503 and doc["status"] == "degraded"
            assert doc["providers"]["broken"] == {"error": "replica wedged"}
            pendpoint.unregister_health_provider("broken")
        assert json.loads(_get(pendpoint.url("/healthz"))[1])[
            "providers"] == {}
        assert _get(pendpoint.url("/nope"))[0] == 404

        def boom():
            raise RuntimeError("scrape bug")

        monkeypatch.setattr(pobs.metrics, "to_prometheus", boom)
        status, body = _get(pendpoint.url("/metrics"))
        assert status == 500 and "scrape bug" in body
    assert pendpoint._server.server_address[0] == "127.0.0.1"


def test_endpoint_off_by_default():
    """No flag, no thread: the endpoint is not running and an engine
    registers no provider."""
    assert pendpoint.port() is None and pendpoint.url() is None
    assert os.environ.get("PTPU_METRICS_PORT") is None
    assert not pendpoint.enabled()


def test_exit_dumps(tmp_path, monkeypatch):
    """PTPU_METRICS_OUT and PTPU_TRACE_DIR: the exit hook writes the
    registry's JSON (tools/ptpu_stats.py's schema) and the chrome
    trace."""
    out = tmp_path / "m.json"
    tdir = tmp_path / "trace"
    monkeypatch.setenv("PTPU_METRICS_OUT", str(out))
    monkeypatch.setenv("PTPU_TRACE_DIR", str(tdir))
    with telemetry(pobs):
        with pobs.step_scope():
            pass
        pobs._exit_dumps()
        assert json.load(open(out)) == json.loads(json.dumps(
            pobs.registry().to_dict()))
    trace = json.load(open(tdir / "ptpu_trace.json"))
    assert [e["name"] for e in trace["traceEvents"]] == ["step"]


def test_lock_check_failure_dumps_before_raising(tmp_path, monkeypatch):
    """concurrency.assert_clean's hook: a LockCheckError ships a
    lock_check_failed flight-recorder dump first."""
    from paddle_tpu_torch.analysis import concurrency

    was = precorder.enabled()
    precorder.enable(str(tmp_path))
    try:
        monkeypatch.setattr(
            concurrency, "violations",
            lambda: [concurrency.LockViolation("order",
                                               "synthetic violation")])
        with pytest.raises(concurrency.LockCheckError):
            concurrency.assert_clean()
        assert "lock_check_failed" in [e["type"]
                                       for e in precorder.events()]
        assert [f for f in os.listdir(tmp_path)
                if f.endswith("_lock_check_failed.json")]
    finally:
        precorder.reset()
        if not was:
            precorder.disable()


def test_dropped_spans_counted(monkeypatch):
    """The ring keeps the newest spans; evictions land in the dump's
    note and the trace/dropped_spans counter."""
    monkeypatch.setattr(pobs.tracing, "MAX_EVENTS", 4)
    import collections

    monkeypatch.setattr(pobs.tracing, "_events",
                        collections.deque(maxlen=4))
    with telemetry(pobs):
        for i in range(7):
            pobs.tracing.instant("e%d" % i)
        assert [e["name"] for e in pobs.tracing.events()] == \
            ["e3", "e4", "e5", "e6"]
        assert pobs.registry().to_dict()["counters"][
            "trace/dropped_spans"] == 3
