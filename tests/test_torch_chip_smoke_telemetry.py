"""chip_smoke.py's phase 15 (the telemetry plane) without the card: its
legs on the CPU at a small size, its gates, and planted faults each gate
must catch.

  * 15a: the LM (2 layers, d_model 32, seq 16) inside a profiler session:
    a step with the session closed enters no fluid/ range, a CPU session
    holds no CUDA kernel; K1's attribution gate on a synthetic card trace
    passes, and fails when K1's backward kernels fall outside every range
    or a forward is missing; ``fluid_benchmark --profile`` runs;
  * 15b: the decoder (2 layers, d_model 32) served traced with the live
    endpoint: every request's events, the serving_step spans, /healthz,
    /metrics and /varz, tokens equal the untraced run's; an engine that
    drops one decode_window fails;
  * 15c: the same leg in a child under PTPU_LOCK_CHECK=1 is clean; a
    child that takes two lock sites in both orders fails;
  * 15d: the native step's span and host-event split, and a fresh
    process's first-program split;
  * tools/ptpu_stats.py (the JAX package's tool, not edited) reads the
    port's /varz, /metrics and PTPU_METRICS_OUT dump."""

import contextlib
import importlib.util
import io
import pathlib
import sys

import pytest
import torch

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import endpoint
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
from test_torch_profiler import synthetic_trace
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LM = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          seq_len=16)
SERVE = dict(cfg=dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                      d_ff=64, max_seq_len=64),
             seed=3, requests=6, max_new=5, device="cpu")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_telemetry_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profiled_lm_leg_on_the_cpu(smoke):
    leg = smoke._child(smoke.PROFILE_FLAG, "phase15_profile",
                       {"batch": 2, "steps": 2, "overhead_steps": 1,
                        "cfg": LM, "device": "cpu"}, None, 300)
    assert smoke.check_profiled_lm(leg) == {}
    assert leg["records"] == [] and leg["rows"] == []
    assert leg["closed_session_ranges"] == []
    assert (leg["k1_fwd"], leg["k1_bwd"]) == (0, 0)
    assert set(leg["overhead"]) == {"off", "spans"}
    leg["closed_session_ranges"] = ["fluid/mul__x"]
    with pytest.raises(SystemExit):
        smoke.check_profiled_lm(leg)


def _k1_trace(**kw):
    """The synthetic card trace with K1's kernel names (tests/
    test_torch_profiler.py): one forward and one backward launch (delta,
    dK/dV, dQ kernels) of the attention op."""
    doc = synthetic_trace(**kw)
    for ev in doc["traceEvents"]:
        if ev["name"] == "flash_fwd_tc_kernel":
            ev["name"] = "void flash_tc_fwd<64>"
        elif ev["name"] == "flash_bwd_tc_kernel":
            ev["name"] = "void flash_tc_dkdv<64>"
        elif ev["name"] == "flash_bwd_dq_kernel":
            ev["name"] = "void flash_tc_dq<64>"
    return doc


def test_k1_attribution_gate(smoke):
    from paddle_tpu_torch import profiler

    records = profiler.kernel_attribution(_k1_trace())
    assert smoke.check_k1_attribution(records, 1, 1) == 40 + 60 + 20
    with pytest.raises(SystemExit):        # a forward launch not seen
        smoke.check_k1_attribution(records, 2, 1)
    outside = profiler.kernel_attribution(_k1_trace(backward_outside=True))
    with pytest.raises(SystemExit):        # K1's backward outside a range
        smoke.check_k1_attribution(outside, 1, 1)


def test_k1_attribution_gate_ignores_the_order_of_float_sums(smoke):
    """K1's kernels all under their rows pass whatever their times: the
    sum of the forward rows plus that of the grad rows need not equal
    the sum over every K1 kernel in float arithmetic."""
    from paddle_tpu_torch import profiler

    records = profiler.kernel_attribution(_k1_trace())
    times = iter((1128.684, 1884.383, 824.288))
    for r in records:
        if "flash_tc_" in r["kernel"]:
            r["us"] = next(times)
    fwd = [r["us"] for r in records if "flash_tc_fwd" in r["kernel"]]
    bwd = [r["us"] for r in records if "flash_tc_d" in r["kernel"]]
    assert sum(fwd + bwd) != sum(fwd) + sum(bwd)
    assert smoke.check_k1_attribution(records, 1, 1) == pytest.approx(3837.355)


def test_coverage_gate(smoke):
    """The 95% gate over a card leg's records, and the K1 launch count a
    step."""
    from paddle_tpu_torch import profiler

    records = profiler.kernel_attribution(_k1_trace())
    leg = {"closed_session_ranges": [], "on_card": True, "records": records,
           "rows": [], "layers": 1, "steps": 1, "k1_fwd": 1, "k1_bwd": 1}
    got = smoke.check_profiled_lm(leg, min_pct=95.0)
    assert got["attributed_pct"] == pytest.approx(100 * 135 / 137)
    with pytest.raises(SystemExit):
        smoke.check_profiled_lm(leg, min_pct=99.0)
    with pytest.raises(SystemExit):
        smoke.check_profiled_lm(dict(leg, k1_fwd=2), min_pct=95.0)


def test_fluid_benchmark_profile_leg(smoke):
    leg = smoke.fluid_benchmark_profile_leg(
        ("--model", "mnist", "--device", "CPU", "--profile",
         "--batch_size", "4", "--skip_batch_num", "1", "--iterations", "2"))
    smoke.check_fluid_benchmark_profile(leg, on_card=False)
    assert leg["iteration_rows"] and leg["device_rows"] == []
    with pytest.raises(SystemExit):
        smoke.check_fluid_benchmark_profile(dict(leg, returncode=1))


@pytest.fixture(scope="module")
def plain_tokens(smoke):
    return smoke.traced_serving_leg(torch, pa, traced=False,
                                    **SERVE)["tokens"]


def test_traced_serving_leg(smoke, plain_tokens):
    leg = smoke.traced_serving_leg(torch, pa, **SERVE)
    smoke.check_traced_serving(leg, plain_tokens, on_card=False)
    assert leg["healthz"]["status"] == 200
    (key, snap), = leg["healthz"]["doc"]["providers"].items()
    assert key.startswith("engine-") and snap["models"]["default"]["alive"]
    assert endpoint.port() is None and not obs.tracing.enabled()
    with pytest.raises(SystemExit):
        smoke.check_traced_serving(leg, plain_tokens[::-1], on_card=False)


def test_dropped_decode_window_fails(smoke, plain_tokens, monkeypatch):
    """An engine that loses one request's decode_window event."""
    from paddle_tpu_torch.serving import engine

    keep, dropped = engine._ModelWorker._trace_windows, []

    def lossy(self, plan, t0, t1, chunked):
        decode = [p for p in plan if p[1] is not None]
        if decode and not dropped:
            dropped.append(decode[0])
            plan = [p for p in plan if p is not decode[0]]
        keep(self, plan, t0, t1, chunked)

    monkeypatch.setattr(engine._ModelWorker, "_trace_windows", lossy)
    leg = smoke.traced_serving_leg(torch, pa, **SERVE)
    assert len(dropped) == 1
    with pytest.raises(SystemExit):
        smoke.check_traced_serving(leg, plain_tokens, on_card=False)


def test_lockcheck_child(smoke, plain_tokens):
    got = smoke.run_lockcheck_child(SERVE, timeout=300)
    smoke.check_lockcheck(got, plain_tokens, on_card=False)
    assert got["lockcheck"]["order_edges"] >= 1


def test_reversed_lock_order_in_the_child_fails(smoke, plain_tokens):
    got = smoke.run_lockcheck_child(dict(SERVE, reverse_locks=True),
                                    timeout=300)
    assert got["lockcheck"]["violations"] >= 1
    assert "lock-order-cycle" in got["lockcheck"]["violations_list"][0]
    with pytest.raises(SystemExit):
        smoke.check_lockcheck(got, plain_tokens, on_card=False)


def test_native_wait_leg_on_the_cpu(smoke):
    leg = smoke.native_wait_leg(torch, fa, device="cpu", batch=1, steps=2,
                                seq=8)
    assert len(leg["spans_ms"]["native_step"]) == 2
    assert len(leg["spans_ms"]["loss_read"]) == 2
    assert len(leg["per_step"]) == 2
    for s in leg["per_step"]:
        assert s["main_ops_top"] and s["launches"] == 0
        assert s["blocked_launch_ms"] == 0.0
    assert leg["k1_fwd"].get("tc", 0) == 0


def test_first_program_child(smoke):
    got = smoke._child(smoke.FIRST_FLAG, "phase15_first",
                       {"batch": 2, "steps": 2, "cfg": LM, "device": "cpu"},
                       None, 300)
    smoke.check_first_program(got)
    first, second = got["steps"]
    assert "lower" in first and "compile" in first
    assert "lower" not in second and "compile" not in second
    ranges = got["first_step_host"]["op_ranges_top"]
    assert ranges and all(r["name"].startswith("fluid/") for r in ranges)
    with pytest.raises(SystemExit):
        smoke.check_first_program({"steps": [second]})


def _stats(*argv):
    sys.path.insert(0, str(ROOT / "tools"))
    import ptpu_stats

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ptpu_stats.main(list(argv))
    return rc, buf.getvalue()


def test_ptpu_stats_reads_the_port(smoke, tmp_path, monkeypatch):
    """tools/ptpu_stats.py over the port's live /varz and /metrics and its
    PTPU_METRICS_OUT dump: the tables render, assertions gate, and the
    dump re-exposes as the port's own Prometheus text."""
    import paddle_tpu_torch as fluid

    out = tmp_path / "m.json"
    monkeypatch.setenv("PTPU_METRICS_OUT", str(out))
    was = obs.metrics.enabled(), obs.tracing.enabled()
    obs.registry().reset()
    obs.enable()
    endpoint.start(port=0)
    try:
        main, startup, loss = smoke.build_lm(fluid, cfg=LM)
        exe, scope = fluid.Executor("cpu"), fluid.Scope()
        exe.run(startup, scope=scope)
        import numpy as np

        toks = np.zeros((2, LM["seq_len"]), np.int32)
        for _ in range(3):
            exe.run(main, feed={"tokens": toks, "labels": toks},
                    fetch_list=[loss], scope=scope)
        obs.histogram("t/h").observe(0.5)
        obs.gauge("t/nan").set(float("nan"))
        rc, text = _stats("--url", endpoint.url("/varz"),
                          "--assert-has", "executor/steps",
                          "--assert-min", "executor/steps=4")
        assert rc == 0 and "executor/step_time" in text
        rc, text = _stats("--url", endpoint.url("/metrics"),
                          "--assert-has", "ptpu_executor_steps_total")
        assert rc == 0 and "ptpu_executor_steps_total" in text
        rc, _ = _stats("--url", endpoint.url("/varz"),
                       "--assert-min", "executor/steps=99")
        assert rc == 1
        obs._exit_dumps()
        rc, text = _stats("--prometheus", str(out))
        assert rc == 0 and text == obs.metrics.to_prometheus()
        rc, text = _stats(str(out), "--assert-has", "compile_cache/miss",
                          "lowering/ops_traced")
        assert rc == 0
    finally:
        endpoint.stop()
        obs.disable()
        (obs.metrics.enable if was[0] else obs.metrics.disable)()
        (obs.tracing.enable if was[1] else obs.tracing.disable)()
        obs.registry().reset()
        obs.tracing.reset()
