"""The port's serving bench legs held against bench.py's own on the CPU:
``paddle_tpu_torch.bench.bench_serving``, ``bench_serving_fastpath``,
``bench_serving_spec``, ``bench_serving_quant``, ``bench_serving_fleet``
and ``bench_serving_online`` (``place="cpu"``) beside bench.py's
functions of the same names, at the same reduced sizes and bench.py's
seeds. Both sides build the same random model (seed 0), so every count
and identity field must be equal: outputs_match, total tokens, steps,
tokens a step, draft steps, accept rates, reuse, hit rate, token
agreement, replicas used, failovers, sheds, requests lost, versions
published, swaps and final versions. No rate or time is compared.

A finished request completes before its round counts its tokens, so the
JAX engine's stats are read here once its worker has settled, as the
port's bench reads its own (bench.py's reads race that round).
"""

import json

import pytest

import bench as jbench
from paddle_tpu import serving as jax_serving
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch import bench as pbench
from test_torch_pinned_arrivals import settled

# reduced sizes: the model of each function at d_model 32 over 2 heads,
# 2 layers (bench.py's defaults are d_model 64)
SMALL = dict(d_model=32, n_heads=2, n_layers=2, d_ff=64)
SERVING = dict(SMALL, n_requests=8, max_new_tokens=6, max_batch=4,
               vocab=64, max_seq_len=64)
FASTPATH = dict(SMALL, n_requests=5, max_new_tokens=4, prefix_len=32,
                max_batch=4, vocab=64, max_seq_len=64)
SPEC = dict(SMALL, n_requests=3, max_new_tokens=16, max_seq_len=96)
QUANT = dict(SMALL, n_requests=6, max_new_tokens=6, max_batch=4, vocab=64,
             max_seq_len=64)
FLEET = dict(SMALL, n_requests=6, max_new_tokens=6, vocab=64, max_seq_len=64)
ONLINE = dict(n_requests=8, max_new_tokens=4)


@pytest.fixture(autouse=True)
def _settled_jax_stats(monkeypatch):
    """The JAX engine's stats read once its worker has settled, and its
    metrics off (bench.py then reports no step flops)."""
    stats = jax_serving.ServingEngine.stats

    def settled_stats(self):
        with settled(self):
            return stats(self)

    monkeypatch.setattr(jax_serving.ServingEngine, "stats", settled_stats)
    was = jmetrics.enabled()
    jmetrics.disable()
    yield
    if was:
        jmetrics.enable()


def test_bench_serving_matches_bench_py():
    got = pbench.bench_serving(place="cpu", **SERVING)
    want = jbench.bench_serving(**SERVING)
    assert len(got) == len(want) == 8
    # outputs_match, total_tokens; batched_step_flops None (metrics off)
    assert (got[2], got[5], got[7]) == (want[2], want[5], want[7])
    assert got[2] is True and got[7] is None
    assert got[5] == SERVING["n_requests"] * SERVING["max_new_tokens"]
    legs = pbench.last_serving
    assert sorted(legs) == ["batched", "serial"]
    assert legs["batched"]["generated_tokens"] == got[5]
    assert legs["serial"]["stats"]["default"]["steps"] >= got[5]


def test_bench_serving_fastpath_matches_bench_py():
    got = pbench.bench_serving_fastpath(place="cpu", **FASTPATH)
    want = jbench.bench_serving_fastpath(**FASTPATH)
    assert set(got) == set(want)
    for leg in ("legacy", "fast"):
        assert set(got[leg]) == set(want[leg])
        for key in ("outputs_match", "prefix_blocks_reused"):
            assert got[leg][key] == want[leg][key], (leg, key)
    assert got["prefix_hit_rate"] == want["prefix_hit_rate"] == 1.0
    assert got["outputs_match"] is want["outputs_match"] is True
    assert got["legacy"]["prefix_blocks_reused"] == 0


def test_bench_serving_spec_matches_bench_py():
    got = pbench.bench_serving_spec(place="cpu", **SPEC)
    want = jbench.bench_serving_spec(**SPEC)
    assert set(got) == set(want)
    for leg in ("legacy", "spec", "tree", "int8"):
        assert set(got[leg]) == set(want[leg])
        for key in ("outputs_match", "tokens_per_step", "steps",
                    "draft_steps", "accept_rate"):
            assert got[leg][key] == want[leg][key], (leg, key)
        assert got[leg]["outputs_match"] is True
    for key in ("tree_shape", "tokens_per_step_speedup",
                "tree_speedup_vs_linear", "accept_rate", "outputs_match"):
        assert got[key] == want[key], key
    assert got["tree"]["draft_steps"] > 0
    int8 = pbench.last_serving["int8"]["stats"]["default"]
    assert int8["weight_only_int8"]
    assert int8["weight_store"]["n_int8"] == 2 + 4 * SMALL["n_layers"]
    tree = pbench.last_serving["tree"]["stats"]["default"]
    assert not tree["weight_only_int8"]


def test_bench_serving_quant_matches_bench_py():
    got = pbench.bench_serving_quant(place="cpu", **QUANT)
    want = jbench.bench_serving_quant(**QUANT)
    assert len(got) == len(want) == 5
    # int8 matches its reference, agreement with fp32, total tokens
    assert got[2:] == want[2:]
    assert got[2] is True
    assert pbench.last_serving["int8"]["stats"]["default"]["weight_only_int8"]


def test_bench_serving_fleet_matches_bench_py():
    got = pbench.bench_serving_fleet(place="cpu", **FLEET)
    want = jbench.bench_serving_fleet(**FLEET)
    assert set(got) == set(want)
    for leg in ("one", "two"):
        assert set(got[leg]) == set(want[leg])
        for key in ("outputs_match", "replicas_used", "failovers",
                    "shed_requests"):
            assert got[leg][key] == want[leg][key], (leg, key)
    assert got["outputs_match"] is want["outputs_match"] is True
    assert got["two"]["replicas_used"] == 2
    router = pbench.last_serving["2r"]["router"]
    assert all(r["model:default"]["steps"] > 0 for r in router["replicas"])


def test_bench_serving_online_matches_bench_py():
    got = pbench.bench_serving_online(place="cpu", **ONLINE)
    want = jbench.bench_serving_online(**ONLINE)
    assert set(got) == set(want)
    for key in ("outputs_match", "requests_lost", "versions_published",
                "swaps", "final_versions"):
        assert got[key] == want[key], key
    assert got["outputs_match"] is True
    assert (got["requests_lost"], got["versions_published"], got["swaps"],
            got["final_versions"]) == (0, 1, 2, [1, 1])


def test_main_fleet_online_keys_match_bench_py(monkeypatch, capsys,
                                               tmp_path):
    """``main --fleet-only --online-only`` runs bench.py's fleet and
    online pairs: bench.py's leg entries (``--fleet-only``'s and
    ``--online-only``'s legs files) and its ``serving_fleet_*`` keys,
    the online numbers under ``serving_online_*``, nothing
    ``not_ported``; ``--online-only`` alone reports bench.py's
    ``online_rollout_throughput_ratio`` metric."""
    _tiny(pbench, monkeypatch)
    _tiny(jbench, monkeypatch)
    got = pbench.main(["--fleet-only", "--online-only", "--place", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    want_legs = []
    for flag in ("--fleet-only", "--online-only"):
        legs_out = str(tmp_path / ("legs%s.json" % flag))
        jbench.main([flag, "--legs-out", legs_out])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        if flag == "--fleet-only":
            want = line
        else:
            want_online = line
        with open(legs_out) as f:
            want_legs += json.load(f)
    assert [g["leg"] for g in got["legs"]] == [g["leg"] for g in want_legs]
    for g, w in zip(got["legs"], want_legs):
        assert set(g) - {"step_time_s"} == set(w) - {"step_time_s"}, \
            g["leg"]
        for key in ("outputs_match", "replicas_used", "requests_lost",
                    "swaps", "final_versions"):
            assert g.get(key) == w.get(key), (g["leg"], key)
    fleet_keys = {k for k in want if k.startswith("serving_fleet_")}
    assert fleet_keys <= set(got)
    assert got["serving_fleet_outputs_match"] is \
        want["serving_fleet_outputs_match"] is True
    assert got["value"] == got["serving_fleet_tokens_per_sec_2r"]
    assert got["serving_online_outputs_match"] is \
        want_online["outputs_match"] is True
    for key in ("requests_lost", "versions_published"):
        assert got["serving_online_" + key] == want_online[key]
    assert got["serving_online_swaps"] == 2
    assert "not_ported" not in got
    alone = pbench.main(["--online-only", "--place", "cpu"])
    capsys.readouterr()
    assert alone["metric"] == want_online["metric"]
    assert alone["value"] == round(
        alone["serving_online_rollout_throughput_ratio"], 4)


def _tiny(module, monkeypatch):
    for name, kw in (("bench_serving", SERVING),
                     ("bench_serving_fastpath", FASTPATH),
                     ("bench_serving_spec", SPEC),
                     ("bench_serving_quant", QUANT),
                     ("bench_serving_fleet", FLEET),
                     ("bench_serving_online", ONLINE)):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda _fn=fn, _kw=kw, **k: _fn(**_kw, **k))


def test_main_serving_legs_keys_match_bench_py(monkeypatch, capsys,
                                               tmp_path):
    """``main --serving-only --spec-only --quant-only`` prints bench.py's
    leg entries and result keys for the serving legs and the int8
    predictor pair (bench_quant_predictor, ported), and names nothing
    under ``not_ported``; the fleet pair is not named either
    (``--fleet-only`` runs it: the test above)."""
    _tiny(pbench, monkeypatch)
    _tiny(jbench, monkeypatch)
    predictor = {"fp32_examples_per_sec": 1.0, "int8_examples_per_sec": 1.0,
                 "speedup_vs_fp32": 1.0, "max_abs_err": 0.0,
                 "top1_agreement": 1.0, "weight_bytes_saved_ratio": 0.5}
    # the predictor pair's numbers do not matter here, only its keys
    # (tests/test_torch_inference.py runs both functions)
    monkeypatch.setattr(jbench, "bench_quant_predictor", lambda: predictor)
    monkeypatch.setattr(pbench, "bench_quant_predictor",
                        lambda place=None: predictor)
    flags = ["--serving-only", "--spec-only", "--quant-only"]
    got = pbench.main(flags + ["--place", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    legs_out = str(tmp_path / "legs.json")
    jbench.main(flags + ["--legs-out", legs_out])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(legs_out) as f:
        want_legs = json.load(f)
    assert [g["leg"] for g in got["legs"]] == [g["leg"] for g in want_legs]
    for g, w in zip(got["legs"], want_legs):
        assert set(g) == set(w), g["leg"]
        for key in ("outputs_match", "tokens_per_step", "draft_steps",
                    "tree_shape", "prefix_hit_rate", "token_agreement",
                    "top1_agreement", "weight_bytes_saved_ratio"):
            assert g.get(key) == w.get(key), (g["leg"], key)
    port_only = {"card", "legs"}
    jax_only = {"vs_baseline"}
    assert set(got) - port_only == set(want) - jax_only
    for key in want:
        if key.endswith(("outputs_match", "hit_rate", "tokens_per_step",
                         "draft_steps", "accept_rate")):
            assert got[key] == want[key], key
    assert got["value"] == got["serving_tokens_per_sec_batched"]
    assert "not_ported" not in got
