"""The port's headline training bench held against bench.py's own on the
CPU: `paddle_tpu_torch.bench.bench_transformer_fluid(**TINY,
place="cpu")` and `bench.bench_transformer_fluid(**TINY)` run each
training leg of bench.py (async, sync, noopt, fp32, amp) and the port's
amp_fp16 leg (bench.py's amp leg with ``amp.decorate(dtype="float16")``)
from the same initial weights, with host feeds through the prefetcher
as bench.py's ``--tiny`` runs them, and give the same last loss.

Both bench functions build their programs and scopes themselves: the
test runs each under a fresh name counter, so the two programs name
their vars alike, takes the JAX startup program's weights as it runs
and loads them into the port's scope right after its startup run.
"""

import functools
import json

import numpy as np
import pytest

import bench as jbench
import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import bench as pbench
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.io import scope_from_numpy
from torch_parity import (  # noqa: F401 (the autouse fixture)
    pin_jax_init_draw as _pin_jax_init_draw)

LEGS = {
    "async": dict(async_exec=True),
    "sync": dict(async_exec=False),
    "noopt": dict(async_exec=False, program_opt=False),
    "fp32": dict(async_exec=False, dtype="float32", amp=False),
    "amp": dict(async_exec=False, dtype="float32", amp=True),
    "amp_fp16": dict(async_exec=False, dtype="float32", amp="float16"),
}
# last-loss tolerance (rtol) after TINY's 7 SGD steps from equal weights:
# fp32 sums in another order (the train parity test's 1e-5); bf16 and
# fp16 round at other places in the two packages (its bf16 1e-3)
RTOL = {"fp32": 1e-5}


def _run_jax(monkeypatch, leg, kw):
    """bench.py's function for `leg`; returns (its result, the weights
    its startup program made)."""
    start = {}
    run = jfluid.Executor.run

    def capture(self, program=None, *a, **k):
        out = run(self, program, *a, **k)
        if not start:  # the first run is the startup program
            scope = k.get("scope") or jfluid.global_scope()
            start.update({v.name: np.array(scope.get(v.name), copy=True)
                          for v in program.global_block().vars.values()
                          if v.persistable})
        return out

    with monkeypatch.context() as m:
        m.setattr(jfluid.Executor, "run", capture)
        if leg == "amp_fp16":
            m.setattr(jfluid.amp, "decorate", functools.partial(
                jfluid.amp.decorate, dtype="float16"))
        with j_unique.guard():
            result = jbench.bench_transformer_fluid(**kw)
    return result, start


def _run_port(monkeypatch, kw, start):
    run = pfluid.Executor.run
    seen = []

    def load(self, program=None, *a, **k):
        out = run(self, program, *a, **k)
        if not seen:
            seen.append(program)
            scope_from_numpy(k["scope"], start)
        return out

    with monkeypatch.context() as m:
        m.setattr(pfluid.Executor, "run", load)
        with p_unique.guard():
            result = pbench.bench_transformer_fluid(place="cpu", **kw)
    return result


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_bench_leg_matches_bench_py(monkeypatch, leg):
    kw = dict(jbench.TINY, feed_mode="host", **LEGS[leg])
    (j_tps, j_loss, j_step, j_compile), start = _run_jax(monkeypatch, leg,
                                                          kw)
    tps, loss, step_s, compile_s = _run_port(monkeypatch, kw, start)
    assert pbench.TINY == jbench.TINY
    np.testing.assert_allclose(loss, j_loss, rtol=RTOL.get(leg, 1e-3))
    stats = pbench.last_leg
    losses = stats["losses"]
    assert len(losses) == kw["steps"] + kw["warmup"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert loss == losses[-1] and tps > 0 and step_s > 0
    assert compile_s is not None and compile_s > 0
    if leg == "async":
        # every step stayed in flight: 7 steps, a window of 12
        assert stats["window_peak"] == len(losses)
    if leg == "amp_fp16":
        # no overflow at this size: the scale stays at 2**15, every step
        # counted good
        assert stats["found_inf"] == [0] * len(losses)
        assert stats["scaling"] == {"loss_scale": 2.0 ** 15,
                                    "good_steps": float(len(losses)),
                                    "bad_steps": 0.0}


def test_main_prints_bench_py_training_keys(capsys):
    """`main(["--tiny"])` runs the async, sync and noopt legs and, as
    bench.py's --tiny does, the resilience leg (guarded vs unguarded
    step time), and prints bench.py's keys for them, with no
    vs_baseline; `--amp-only` the fp32, amp and amp_fp16 legs."""
    pbench.main(["--tiny", "--place", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "transformer_base_tokens_per_sec_per_chip"
    assert "vs_baseline" not in out
    for key in ("value", "sync_tokens_per_sec", "step_time_sync_s",
                "noopt_tokens_per_sec", "async_tokens_per_sec",
                "compile_time_s_opt", "compile_time_s_noopt"):
        assert out[key] > 0, key
    assert out["value"] == out["async_tokens_per_sec"]
    assert [g["leg"] for g in out["legs"]] == [
        "async", "sync", "noopt", "resilience_unguarded",
        "resilience_guarded"]
    for key in ("step_time_guarded_s", "step_time_unguarded_s"):
        assert out[key] > 0, key
    assert "guard_overhead_pct" in out and "not_ported" not in out
    pbench.main(["--tiny", "--amp-only", "--place", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [g["leg"] for g in out["legs"]] == ["fp32", "amp", "amp_fp16"]
    for key in ("fp32_tokens_per_sec", "amp_tokens_per_sec",
                "amp_speedup_vs_fp32", "amp_fp16_tokens_per_sec"):
        assert out[key] > 0, key
    assert out["legs"][2]["loss_scale"] == 2.0 ** 15


def test_main_zero_only_prints_bench_py_zero_line(capsys):
    """`main(["--zero-only"])` runs bench.py's bench_zero receipt (the
    MLP through every ShardedAdam rung) on a data group of one CPU rank
    and prints bench.py's --zero-only keys, every rung close to the
    bucketed ZeRO-1 leg's parameters and every leg's loss falling; the
    ``bench/zero_*`` gauges carry the same numbers."""
    from paddle_tpu_torch.observability import metrics as obs_metrics
    from paddle_tpu_torch.parallel.mesh import destroy_data_group

    try:
        pbench.main(["--zero-only", "--place", "cpu"])
    finally:
        destroy_data_group()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "zero_overlap_speedup" and out["world"] == 1
    for key in ("value", "step_time_overlap_s", "step_time_no_overlap_s",
                "step_time_per_leaf_s", "step_time_zero3_s",
                "step_time_offload_s"):
        assert out[key] > 0, key
    assert out["zero2_close"] and out["zero3_close"] and out["offload_close"]
    assert out["loss_decreasing"]
    assert sorted(out["losses"]) == ["zero1_bucketed", "zero1_per_leaf",
                                     "zero2_overlap", "zero3",
                                     "zero_offload"]
    gauges = obs_metrics.registry().to_dict()["gauges"]
    assert gauges["bench/zero2_close"] == 1.0
    assert gauges["bench/zero_step_time_overlap"] == pytest.approx(
        out["step_time_overlap_s"], abs=1e-6)
