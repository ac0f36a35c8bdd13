"""chip_smoke.py's phases that run without the card, here on the CPU at
a small width:

  * the card-vs-CPU step check with two CPU executors (vocab 256,
    d_model 128, 2 heads of 64, 2 layers, d_ff 256, seq 128): it passes
    when the two runs agree, and its fp32 leg fails on each fault
    planted in the first run — an SGD update skipped, an update 1% too
    large, flash attention's dQ 1% too large;
  * phase 6e (training as users configure it) at that width, batch 2:
    its remat, no_remat and dropout legs pass their gates on the CPU and
    the dropout grads agree across remat; the gates fail an Adam update
    skipped for some parameters, K1 at 6 + 6 a step under remat and a
    remat peak not below the no-remat peak; its fp32 Adam card-vs-CPU
    check passes when the runs agree and fails the clip left out, the
    decay left out or Adam skipped in the first run;
  * phase 6f (the stacked flagship) at that width, batch 2: its stacked
    and unrolled legs pass their gates on the CPU, and the gates fail K1
    at 6 + 6 a step (no replay), a copied operand and a predicate read;
    its fp32 card-vs-CPU check (Adam on piecewise_decay under
    GradientMergeOptimizer, an EMA) passes when the runs agree and fails
    a replay that drops layer 0's stacked-weight grads, a Switch that
    takes the wrong case and a merge that updates on every run, each
    planted in the first run;
  * phase 9 (image classification) on CPU executors: its fp32 and amp
    legs (cifar ResNet-8 plus a bottleneck stage, batch 4) pass their
    gates, and the gates fail a loss that does not fall, a moving
    statistic that never moved and a test clone that moved one; 9b's
    step runs the mnist builders; its card-vs-CPU check (two Adam steps
    of the same program) passes when the runs agree and fails each fault
    planted in the first run — the moving statistics' update skipped,
    the moving variance from the unbiased batch variance (cuDNN's
    running statistic), a TF32 convolution (both operands rounded to 10
    mantissa bits);
  * the int8 card-vs-CPU check with two CPU executors (the same width,
    fp32, full-int8): it passes when the two runs agree, reads the
    bound for a 1% act-scale fault, and fails on such a fault planted
    in the first run's fused int8 matmuls;
  * the speculative serving phase (vocab 128, d_model 64, 2 heads, 2
    layers, d_ff 128; 6 repetitive prompts, 24 new tokens): its three
    legs run token-identical to ``reference_decode`` with clean pools,
    and a planted wrong verify-window token fails it, printing the
    reference's top-2 logit margin at the differing position; its wide
    legs (spec_k 16, a 4x8 tree) serve token-identically too, and so do
    its legs over chunked prefill (spec_k 6, and a 2x6 tree drafted by a
    ModelDrafter over the target, accepted whole here); the launch
    accounting of those legs (the drafter's launches read from their
    sum) sees a missing launch.
  * the serving fast path (phase 4c) at vocab 128, d_model 64: its three
    legs agree and equal ``reference_decode``, the fast leg reuses every
    shared block, and a planted wrong chunk-step token fails it;
  * the serving bench legs (phase 4d) at vocab 128, d_model 32 with
    bench.py's traffic: every function's identity flags hold, both int8
    legs serve the int8 store, and a planted wrong int8 token fails it
    naming the request; the launch accounting of a bench call (target
    steps by kind, a drafter's catch-ups and draft steps read from their
    sum) sees a missing launch;
  * the fleet and online phase (phase 4e) at the same width: its four
    legs pass; its launch accounting across replicas (a dead replica's
    steps included) sees a missing launch; its failover gates fail each
    planted fault (a second failover, a lost or failed request, no dead
    replica, a dead pool holding a block, a wrong token);
  * phase 10 (the inference predictor) on the CPU: 10a's four legs on
    the small ResNet at batch 4, 10b's mnist cnn in full_int8 and 10c's
    bench keys pass; 10a fails a skipped fold, K4 bypassed (the
    classifier in fp32) and a 1% act-scale fault, 10b the act-scale
    fault, and its gates on the card a missing, extra or fp32-leg K4
    launch and a fold beyond its limit."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops import int8_matmul as im
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import paged_attention_tree as pat
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.serving import GenerationModel

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256,
           seq_len=128)
SPEC_CFG = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, d_ff=128,
                max_seq_len=128)


@pytest.fixture
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.TRAIN = dict(CFG)
    mod.SPEC = dict(mod.SPEC, cfg=SPEC_CFG, n_requests=6, max_new_tokens=24,
                    max_batch=4, block_size=4)
    return mod


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * 1.01


def _skip_sgd(impl, ctx, ins, attrs):
    return {"ParamOut": [ins["Param"][0]]}


def _lr_one_percent(impl, ctx, ins, attrs):
    return impl(ctx, dict(ins, LearningRate=[ins["LearningRate"][0] * 1.01]),
                attrs)


def _dq_one_percent(impl, ctx, ins, attrs):
    return impl(ctx, dict(ins, Q=[_ScaleGrad.apply(ins["Q"][0])]), attrs)


def _act_scale_one_percent(impl, ctx, ins, attrs):
    return impl(ctx, ins, dict(attrs, act_scale=attrs["act_scale"] / 1.01))


FAULTS = {"skip_sgd": ("sgd", _skip_sgd),
          "lr_1pct": ("sgd", _lr_one_percent),
          "dq_1pct": ("flash_attention", _dq_one_percent)}


def _plant(monkeypatch, smoke, op, wrong, feed="lm_feed"):
    """Run `wrong` in place of op `op` while the first executor runs:
    the phases make the first executor's feed (`feed`, the phase's feed
    function) before its run and the second's after it."""
    feeds = []
    make_feed = getattr(smoke, feed)

    def counted(*args, **kw):
        feeds.append(args[-1])
        return make_feed(*args, **kw)

    opdef = registry.get(op)
    impl = opdef.impl

    def planted(ctx, ins, attrs):
        if len(feeds) == 1:
            return wrong(impl, ctx, ins, attrs)
        return impl(ctx, ins, attrs)

    monkeypatch.setattr(smoke, feed, counted)
    monkeypatch.setattr(opdef, "impl", planted)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_card_vs_cpu_passes_when_the_runs_agree(smoke, dtype, capsys):
    smoke.card_vs_cpu_phase(torch, fluid, smoke.build_lm(fluid, dtype),
                            dtype, devices=("cpu", "cpu"))
    assert '"dtype": "%s"' % dtype in capsys.readouterr().out


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_card_vs_cpu_fp32_catches_a_planted_fault(smoke, fault, monkeypatch,
                                                  capsys):
    program = smoke.build_lm(fluid, "float32")
    _plant(monkeypatch, smoke, *FAULTS[fault])
    with pytest.raises(SystemExit):
        smoke.card_vs_cpu_phase(torch, fluid, program, "float32",
                                devices=("cpu", "cpu"))
    assert "card vs CPU float32" in capsys.readouterr().err


def test_int8_card_vs_cpu_passes_when_the_runs_agree(smoke, capsys):
    """Two CPU runs of one int8 program agree; the phase's reading of a
    1% act-scale fault fails the logits bound (else the phase fails)."""
    smoke.int8_card_vs_cpu_phase(torch, fluid, im,
                                 smoke.build_lm(fluid, "float32"),
                                 devices=("cpu", "cpu"))
    out = capsys.readouterr().out
    assert '"layers_not_bitwise": []' in out
    assert '"loss_rel_diff": 0.0' in out
    assert '"logits_excess_and_rows_differing": [[0.0, 0.0]]' in out
    assert '"act_scale_1pct_fault_layers_caught": 5' in out


def test_int8_card_vs_cpu_catches_a_planted_fault(smoke, monkeypatch,
                                                  capsys):
    """Every fused int8 matmul of the first run quantizes its activation
    at a scale 1% off: the logits check fails."""
    program = smoke.build_lm(fluid, "float32")
    _plant(monkeypatch, smoke, "fused_int8_matmul", _act_scale_one_percent)
    with pytest.raises(SystemExit):
        smoke.int8_card_vs_cpu_phase(torch, fluid, im, program,
                                     devices=("cpu", "cpu"))
    assert "dense layers are not bitwise" in capsys.readouterr().err


def test_spec_serving_phase_on_the_cpu(smoke, capsys):
    """Three legs on one model: every request token-identical to
    reference_decode, verify windows ran in the linear and tree legs,
    tree slots were verified, each leg printed its line."""
    _, legs = smoke.spec_serving_phase(torch, pa, pat, device="cpu")
    assert [name for name, _ in smoke.SPEC["legs"]] == \
        ["legacy", "linear", "tree"] == list(legs)
    for leg in legs.values():
        assert leg["reference_identical"] == leg["requests"] == 6
        assert leg["generated_tokens"] == 6 * 24
    assert legs["legacy"]["verify_windows"] == 0
    assert legs["linear"]["verify_windows"] > 0
    assert legs["tree"]["verify_windows"] > 0
    assert legs["tree"]["tree_slots"] > 0
    assert legs["linear"]["accept_rate"] > 0
    assert capsys.readouterr().out.count("spec_serving ") == 3


def test_spec_serving_phase_fails_on_a_wrong_token(smoke, monkeypatch,
                                                   capsys):
    """One verify window's greedy token planted wrong: the linear leg
    fails, naming the request, the position and the margin there."""
    calls = []
    spec_step = GenerationModel.spec_step

    def planted(self, *args, **kwargs):
        out = spec_step(self, *args, **kwargs)
        calls.append(1)
        if len(calls) == 3:
            out = (out + 1) % self.config.vocab_size
        return out

    monkeypatch.setattr(GenerationModel, "spec_step", planted)
    with pytest.raises(SystemExit):
        smoke.spec_serving_phase(torch, pa, pat, device="cpu")
    err = capsys.readouterr().err
    assert "spec linear" in err and "differs from reference_decode" in err
    assert "top-2 logit margin" in err


def test_spec_wide_phase_on_the_cpu(smoke, capsys):
    """The windows past the kernels' former limits (spec_k=16: C=17; a
    4x8 tree: C=33) served by the engine on the CPU: every request
    token-identical to reference_decode, windows and tree slots ran."""
    from paddle_tpu_torch.serving import GenerationConfig

    model = GenerationModel.random(GenerationConfig(**SPEC_CFG), seed=0,
                                   device="cpu")
    legs = smoke.spec_wide_phase(torch, pa, pat, model)
    assert list(legs) == ["linear16", "tree4x8"]
    for leg in legs.values():
        assert leg["reference_identical"] == leg["requests"] == 4
        assert leg["verify_windows"] > 0
    assert legs["tree4x8"]["tree_slots"] > 0
    assert capsys.readouterr().out.count("spec_serving ") == 2


def test_spec_chunk_phase_on_the_cpu(smoke, capsys):
    """The legs over chunked prefill: token-identical to reference_decode,
    chunk steps ran in both, the ModelDrafter drafted for the tree leg
    and (the target drafting for itself, on the CPU) every draft was
    accepted."""
    from paddle_tpu_torch.serving import GenerationConfig

    model = GenerationModel.random(GenerationConfig(**SPEC_CFG), seed=0,
                                   device="cpu")
    legs = smoke.spec_chunk_phase(torch, pa, pat, model)
    assert list(legs) == ["linear_c8", "tree_model"]
    for leg in legs.values():
        assert leg["reference_identical"] == leg["requests"] == 6
        assert leg["chunk_steps"] > 0 and leg["verify_windows"] > 0
    assert legs["linear_c8"]["draft_steps"] == 0
    assert legs["tree_model"]["draft_steps"] > 0
    assert legs["tree_model"]["tree_slots"] > 0
    assert legs["tree_model"]["accept_rate"] == 1.0
    assert capsys.readouterr().out.count("spec_serving ") == 2


def _engine(steps, chunk, spec, spec_k=0, tree=None, draft=0, dchunk=None,
            prefill_chunk=8):
    """One engine's entry for ``engine_launches``."""
    return {"stats": {"default": {
                "steps": steps, "prefill_chunk_steps": chunk,
                "prefill_chunk": prefill_chunk, "spec_steps": spec,
                "spec_k": spec_k, "spec_tree": tree,
                "spec_draft_steps": draft}},
            "drafter_chunk": dchunk}


def test_spec_launches_accounts_for_the_drafter(smoke):
    """A tree leg with a ModelDrafter over 6 layers: 10 steps, 4 of them
    tree windows and 3 chunk steps at C=8; 5 draft steps, 3 catch-ups at
    C=8 and 2 draft steps of 5 one-token steps. The expected counts
    equal what such a run launches, and one launch fewer is seen."""
    L = 6
    tree = {"tree_model": _engine(10, 3, 4, spec_k=6, tree="2x6", draft=5,
                                  dchunk=8)}
    k2 = {1: L * (3 + 2 * 5), 8: L * (3 + 3)}
    assert smoke.engine_launches(L, tree, k2) == (k2, 4 * L)
    short = {1: k2[1] - 1, 8: k2[8]}
    assert smoke.engine_launches(L, tree, short)[0] != short
    tree["tree_model"]["stats"]["default"]["spec_draft_steps"] = 6
    assert smoke.engine_launches(L, tree, k2)[0] != k2
    linear = {"linear_c8": _engine(10, 3, 4, spec_k=6)}
    assert smoke.engine_launches(L, linear, {}) == \
        ({1: 3 * L, 8: 3 * L, 7: 4 * L}, 0)


@pytest.fixture
def fast_smoke(smoke):
    smoke.FAST = dict(smoke.FAST, cfg=SPEC_CFG, max_batch=4, block_size=4,
                      prefix_len=32, n_requests=8, max_new_tokens=6,
                      reference_checked=3, chunk=8,
                      legs=(("legacy", {"prefill_chunk": 0,
                                        "prefix_cache": False}),
                            ("chunked", {"prefill_chunk": 8,
                                         "prefix_cache": False}),
                            ("fast", {"prefill_chunk": 8,
                                      "prefix_cache": True})))
    return smoke


def test_fastpath_phase_on_the_cpu(fast_smoke, capsys):
    legs = fast_smoke.fastpath_phase(torch, pa, device="cpu")
    assert list(legs) == ["legacy", "chunked", "fast"]
    for leg in legs.values():
        assert leg["requests"] == 8 and leg["reference_identical"] == 3
        assert leg["generated_tokens"] == 8 * 6
    assert legs["legacy"]["chunk_steps"] == 0
    assert legs["chunked"]["chunk_steps"] > 0
    assert legs["fast"]["prefix_hit_rate"] == 1.0
    assert legs["fast"]["blocks_cached"] >= 8
    assert legs["chunked"]["prefix_blocks_reused"] == 0
    assert legs["fast"]["steps"] < legs["chunked"]["steps"] < \
        legs["legacy"]["steps"]
    assert capsys.readouterr().out.count("fastpath {") == 3


def test_fastpath_phase_fails_on_a_wrong_token(fast_smoke, monkeypatch,
                                               capsys):
    """The chunk steps' greedy tokens planted wrong past the chunked
    leg's priming request: that leg fails against the reference."""
    calls = []
    prefill_step = GenerationModel.prefill_step

    def planted(self, *args, **kwargs):
        out = prefill_step(self, *args, **kwargs)
        calls.append(1)
        if len(calls) > 8:
            out = (out + 1) % self.config.vocab_size
        return out

    monkeypatch.setattr(GenerationModel, "prefill_step", planted)
    with pytest.raises(SystemExit):
        fast_smoke.fastpath_phase(torch, pa, device="cpu")
    err = capsys.readouterr().err
    assert "fastpath chunked" in err and "differs" in err


BENCH_SMALL = dict(vocab=128, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                   max_seq_len=128)


def test_bench_serving_phase_on_the_cpu(smoke, capsys):
    k2, k3 = smoke.bench_serving_phase(torch, pa, pat, device="cpu",
                                       width=BENCH_SMALL)
    assert list(k2) == list(smoke.BENCH_FUNCTIONS) == list(k3)
    # the plain versions run on the CPU: no kernel launch is counted
    assert all(not c for c in k2.values()) and not any(k3.values())
    lines = [json.loads(line.split(" ", 1)[1])
             for line in capsys.readouterr().out.splitlines()
             if line.startswith("bench_serving ")]
    assert [s["function"] for s in lines] == list(smoke.BENCH_FUNCTIONS)
    by_fn = {s["function"]: s for s in lines}
    assert by_fn["bench_serving"]["outputs_match"] is True
    assert by_fn["bench_serving_fastpath"]["prefix_hit_rate"] == 1.0
    spec = by_fn["bench_serving_spec"]
    assert spec["outputs_match"] is True
    assert spec["tree"]["draft_steps"] > 0
    int8 = {g["leg"]: g for g in spec["legs"]}["int8"]
    assert int8["weight_only_int8"]
    assert int8["weight_store"]["n_int8"] == 2 + 4 * BENCH_SMALL["n_layers"]
    quant = by_fn["bench_serving_quant"]
    assert quant["outputs_match"] is True and quant["total_tokens"] > 0


def test_bench_serving_phase_fails_on_a_wrong_int8_token(smoke, monkeypatch,
                                                         capsys):
    """The int8 model's decode steps planted wrong: bench_serving_quant's
    int8 leg fails against the reference, naming the request and the
    reference's margin there."""
    decode_step = GenerationModel.decode_step

    def planted(self, *args, **kwargs):
        out = decode_step(self, *args, **kwargs)
        if self.weight_only_int8:
            out = (out + 1) % self.config.vocab_size
        return out

    monkeypatch.setattr(GenerationModel, "decode_step", planted)
    monkeypatch.setattr(smoke, "BENCH_FUNCTIONS", ("bench_serving_quant",))
    with pytest.raises(SystemExit):
        smoke.bench_serving_phase(torch, pa, pat, device="cpu",
                                  width=BENCH_SMALL)
    err = capsys.readouterr().err
    assert "bench bench_serving_quant int8: request 0 differs" in err
    assert "top-2 logit margin" in err


def test_bench_launches_accounts_for_every_engine(smoke):
    """One bench call's engines over 6 layers: a legacy leg over chunk 8
    (20 steps, 4 chunk steps), a linear k=6 leg (12 steps: 4 chunk, 5
    windows) and a 2x6 tree drafted by a ModelDrafter with catch-up chunk
    16 (9 steps: 4 chunk, 3 tree windows; 5 draft steps: 3 catch-ups and
    2 draft steps of 5 one-token steps). The expected counts equal what
    the call launches; one launch fewer, or a draft step more, is
    seen."""
    L = 6
    legs = {"legacy": _engine(20, 4, 0), "spec": _engine(12, 4, 5, spec_k=6),
            "tree": _engine(9, 4, 3, spec_k=6, tree="2x6", draft=5,
                            dchunk=16)}
    k2 = {1: L * (16 + 3 + 2 + 2 * 5), 8: L * 12, 7: L * 5, 16: L * 3}
    assert smoke.engine_launches(L, legs, k2) == (k2, 3 * L)
    short = {**k2, 16: k2[16] - 1}
    assert smoke.engine_launches(L, legs, short)[0] != short
    legs["tree"]["stats"]["default"]["spec_draft_steps"] = 6
    assert smoke.engine_launches(L, legs, k2)[0] != k2


ONLINE_SMALL = dict(model_kwargs=dict(d_model=32, n_heads=2, n_layers=2,
                                      d_ff=64, seq_len=8))


def test_fleet_phase_on_the_cpu(smoke, capsys):
    """Phase 4e at vocab 128, d_model 32 with bench.py's traffic: the
    fleet pair uses both replicas, the failover leg loses nothing over
    one failover, the online leg publishes one version and ends on
    [1, 1], the swap leg serves both versions, every output the
    reference's (the CPU route launches no kernel)."""
    assert smoke.fleet_phase(torch, pa, pat, device="cpu",
                             width=BENCH_SMALL,
                             online_kwargs=ONLINE_SMALL) == 0
    lines = [json.loads(line.split(" ", 1)[1])
             for line in capsys.readouterr().out.splitlines()
             if line.startswith("fleet ")]
    legs = {g["leg"]: g for g in lines}
    assert list(legs) == ["bench_serving_fleet", "failover",
                          "bench_serving_online", "swap"]
    fleet = legs["bench_serving_fleet"]
    assert fleet["outputs_match"] and fleet["replicas_used"] == [1, 2]
    failover = legs["failover"]
    assert failover["failovers"] == 1 and failover["outputs_match"]
    assert sorted(failover["states"]) == ["dead", "healthy"]
    assert failover["readmitted"] >= 1
    online = legs["bench_serving_online"]
    assert online["outputs_match"] and online["updater"]["swaps"] == 2
    assert legs["swap"]["final_versions"] == [0, 1]
    assert set(legs["swap"]["served_by_version"]) == {0, 1}


def _router_stats(steps, states=None):
    """A router's stats for ``fleet_launches``: one decode-only engine a
    replica."""
    states = states or ["healthy"] * len(steps)
    return {"replicas": [
        {"idx": i, "state": s, "model:default": {
            "steps": n, "prefill_chunk_steps": 0, "prefill_chunk": 0,
            "spec_steps": 0, "spec_k": 0, "spec_tree": None,
            "spec_draft_steps": 0}}
        for i, (n, s) in enumerate(zip(steps, states))]}


def test_fleet_launches_accounts_for_every_replica(smoke):
    """Two routers over 6 layers, one with a dead replica: K2 at C=1 is
    6 a step over every replica's steps, the dead one's included; one
    launch fewer, or the dead replica's steps left out, fails."""
    L = 6
    routers = [_router_stats([40]),
               _router_stats([31, 9], ["healthy", "dead"])]
    want = {1: L * (40 + 31 + 9)}
    assert smoke.fleet_launches(L, routers) == (want, 0)
    assert smoke.check_fleet_launches("t", L, routers, want, 0, True) == \
        [[40], [31, 9]]
    for k2 in ({1: want[1] - 1}, {1: L * (40 + 31)}):
        with pytest.raises(SystemExit):
            smoke.check_fleet_launches("t", L, routers, k2, 0, True)
    assert smoke.check_fleet_launches("t", L, routers, {}, 0, False) == \
        [[40], [31, 9]]


@pytest.mark.parametrize("fault", ["two_failovers", "lost", "failed",
                                   "no_dead", "pool", "tokens", "none"])
def test_check_failover_catches_each_fault(smoke, fault, capsys):
    """The failover leg's gates pass a clean leg and fail each planted
    fault: two failovers, a lost request, a failed one, no dead replica,
    the dead replica's pool holding a block, a token off the unfailed
    run."""
    import types

    from paddle_tpu_torch.serving import KVBlockPool

    pool = KVBlockPool(2, 2, 16, 4, 8, device="cpu")
    if fault == "pool":
        pool.reserve("seq", 1)
        pool.alloc_block("seq")
    dead = [types.SimpleNamespace(
        _workers={"default": types.SimpleNamespace(pool=pool)})]
    st = {"failovers": 1, "requests_submitted": 4,
          "requests_completed": 4, "requests_failed": 0}
    want = [[1, 2], [3, 4], [5], [6, 7]]
    outs = [list(o) for o in want]
    if fault == "two_failovers":
        st["failovers"] = 2
    elif fault == "lost":
        st["requests_completed"] = 3
    elif fault == "failed":
        st.update(requests_completed=3, requests_failed=1)
    elif fault == "no_dead":
        dead = []
    elif fault == "tokens":
        outs[2] = [9]
    if fault == "none":
        smoke.check_failover(st, dead, outs, want)
        return
    with pytest.raises(SystemExit):
        smoke.check_failover(st, dead, outs, want)
    assert "fleet failover" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# phase 6e: training as users configure it (Adam, the schedule, L2 decay,
# the global-norm clip, remat and dropout), its gates on CPU executors
# ---------------------------------------------------------------------------


@pytest.fixture
def user_legs(smoke):
    """Phase 6e's three legs at the small width, batch 2, on the CPU."""
    from paddle_tpu_torch.ops import flash_attention as fa

    return {name: smoke.user_leg(torch, fa, fluid, name, kw, 2,
                                 device="cpu")
            for name, kw, _ in smoke.USER_LEGS}


def test_user_training_gates_pass_on_the_cpu(smoke, user_legs):
    """Each leg passes its gates (the loss falls, every beta1_pow_acc at
    beta1^16, the schedule's closed form at run 15, @step_counter@ at
    15); the CPU route counts no K1 launch; the dropout program's grads
    under remat equal the no-remat build's, bitwise here."""
    L = smoke.TRAIN["n_layers"]
    for name, leg in user_legs.items():
        smoke.check_user_leg(leg, k1_per_step=(0, 0))
        assert leg["runs"] == sum(smoke.USER_STEPS) == 15
        # every parameter: 16 a layer (the fused attention's 8; with
        # dropout the qkv and output fcs' 4), the embedding, the last
        # layer norm's 2 and the head
        per_layer = 12 if name == "dropout" else 16
        assert len(leg["beta1_pow"]) == per_layer * L + 4
    assert smoke.dropout_remat_grads(torch, fluid, devices=("cpu", "cpu"),
                             batch=2) == (0.0, True)


def test_user_training_gates_catch_a_skipped_adam_update(smoke,
                                                         monkeypatch):
    """Adam skipped for one parameter (the embedding, the one weight of
    its shape): its beta1_pow_acc stays behind."""
    opdef = registry.get("adam")
    impl = opdef.impl
    embedding = (smoke.TRAIN["vocab_size"], smoke.TRAIN["d_model"])

    def planted(ctx, ins, attrs):
        if tuple(ins["Param"][0].shape) == embedding:
            return {}
        return impl(ctx, ins, attrs)

    monkeypatch.setattr(opdef, "impl", planted)
    from paddle_tpu_torch.ops import flash_attention as fa

    leg = smoke.user_leg(torch, fa, fluid, "remat", {}, 2, device="cpu")
    with pytest.raises(SystemExit):
        smoke.check_user_leg(leg)


def test_user_training_gates_catch_wrong_k1_counts_and_peaks(smoke,
                                                             user_legs):
    """K1 at 6 + 6 a step (no re-run) fails the remat leg's launch gate,
    and a remat peak not below the no-remat peak fails the memory gate."""
    leg = dict(user_legs["remat"])
    n, L = leg["runs"], smoke.TRAIN["n_layers"]
    zero = {"tc": 0, "fp16": 0, "f32tc": 0}
    want = smoke.user_k1_per_step("remat")
    assert want == (2 * L, L)
    leg["flash_attention_launches"] = (dict(zero, tc=2 * L * n),
                                       dict(zero, tc=L * n), 0)
    smoke.check_user_leg(leg, want)
    leg["flash_attention_launches"] = (dict(zero, tc=L * n),
                                       dict(zero, tc=L * n), 0)
    with pytest.raises(SystemExit):
        smoke.check_user_leg(leg, want)
    smoke.check_remat_memory({"peak_gib": 9.0}, {"peak_gib": 10.0})
    with pytest.raises(SystemExit):
        smoke.check_remat_memory({"peak_gib": 10.0}, {"peak_gib": 10.0})


def _adam_program(smoke):
    return smoke.build_user_lm(fluid, "float32",
                               cfg=dict(smoke.TRAIN, n_layers=2),
                               clip_norm=smoke.USER_CVC_CLIP)


def test_adam_card_vs_cpu_passes_when_the_runs_agree(smoke, capsys):
    smoke.adam_card_vs_cpu_phase(torch, fluid, _adam_program(smoke),
                                 devices=("cpu", "cpu"))
    line = [json.loads(x.split(" ", 1)[1])
            for x in capsys.readouterr().out.splitlines()
            if x.startswith("card_vs_cpu ")][0]
    assert line["optimizer"] == "adam" and line["worst_param_err_over_limit"] \
        == 0.0
    assert max(line["clip_scale_cpu"]) < 0.99   # the clip binds
    assert 2 * line["skipped_update_fails_params"] >= line["params"]


def _no_clip(impl, ctx, ins, attrs):
    """The clip's product left out: a grad times the [1] scale returns
    the grad."""
    x, y = ins["X"][0], ins["Y"][0]
    if y.numel() == 1 and x.numel() > 1:
        return {"Out": [x]}
    return impl(ctx, ins, attrs)


L2 = 1e-4   # chip_smoke.USER["l2"]


def _no_decay(impl, ctx, ins, attrs):
    """The L2 decay's scale by its coefficient returns zeros."""
    if attrs.get("scale") == L2:
        return {"Out": [torch.zeros_like(ins["X"][0])]}
    return impl(ctx, ins, attrs)


@pytest.mark.parametrize("fault", ["no_clip", "no_decay", "skip_adam"])
def test_adam_card_vs_cpu_catches_a_planted_fault(smoke, fault,
                                                  monkeypatch, capsys):
    """The clip left out, the decay left out, or Adam skipped, in the
    first run: the Adam card-vs-CPU check fails."""
    assert smoke.USER["l2"] == L2
    program = _adam_program(smoke)
    op, wrong = {"no_clip": ("elementwise_mul", _no_clip),
                 "no_decay": ("scale", _no_decay),
                 "skip_adam": ("adam", lambda impl, ctx, ins, attrs: {})}[
        fault]
    _plant(monkeypatch, smoke, op, wrong)
    with pytest.raises(SystemExit):
        smoke.adam_card_vs_cpu_phase(torch, fluid, program,
                                     devices=("cpu", "cpu"))
    assert "card vs CPU Adam" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# phase 6f: the stacked flagship, its gates and its card-vs-CPU check on
# CPU executors
# ---------------------------------------------------------------------------


def test_stacked_legs_pass_their_gates_on_the_cpu(smoke):
    """Both legs (build_stacked and build(), the example's recipe) at the
    small width, batch 2: the loss falls, no predicate is read, the CPU
    route counts no K1 launch; the gates fail K1 at 6 + 6 a step (no
    replay), a copied operand and a predicate read."""
    from paddle_tpu_torch.ops import flash_attention as fa

    smoke.STACKED_STEPS = (1, 3)       # the gates read any number of runs
    L = smoke.TRAIN["n_layers"]
    legs = {}
    for stacked in (True, False):
        leg = smoke.stacked_leg(torch, fa, fluid, stacked, batch=2,
                                device="cpu")
        smoke.check_stacked_leg(leg, (0, 0))
        legs[leg["leg"]] = leg
    # the stacked program: 12 stacked weights, the embedding, the last
    # layer norm's 2 and the head
    assert legs["stacked"]["params"] == 16
    assert legs["unrolled"]["params"] == 16 * L + 4
    leg = dict(legs["stacked"])
    n, zero = leg["runs"], {"tc": 0, "fp16": 0, "f32tc": 0}
    leg["flash_attention_launches"] = (dict(zero, tc=2 * L * n),
                                       dict(zero, tc=L * n), 0)
    smoke.check_stacked_leg(leg, (2 * L, L))
    for wrong in ((dict(zero, tc=L * n), dict(zero, tc=L * n), 0),
                  (dict(zero, tc=2 * L * n), dict(zero, tc=L * n), 3)):
        leg["flash_attention_launches"] = wrong
        with pytest.raises(SystemExit):
            smoke.check_stacked_leg(leg, (2 * L, L))
    leg = dict(legs["unrolled"], host_syncs={"cond": 1, "while": 0})
    with pytest.raises(SystemExit):
        smoke.check_stacked_leg(leg)


def test_stacked_card_vs_cpu_passes_when_the_runs_agree(smoke, capsys):
    smoke.stacked_card_vs_cpu_phase(torch, fluid,
                                    smoke.build_stacked_cvc(fluid),
                                    devices=("cpu", "cpu"))
    line = [json.loads(x.split(" ", 1)[1])
            for x in capsys.readouterr().out.splitlines()
            if x.startswith("card_vs_cpu_stacked ")][0]
    assert line["worst_param_err_over_limit"] == 0.0
    assert line["worst_shadow_own_err_over_1e-6"] <= 1
    np.testing.assert_array_equal(np.float32(line["lr_cpu"]),
                                  np.float32([1e-3, 1e-3, 5e-4, 5e-4]))
    assert line["host_syncs"] == {"cond": 12, "while": 0}
    assert 2 * line["skipped_update_fails_params"] >= line["params"]


def _plant_step(monkeypatch, smoke, wrong):
    """Run `wrong(step, args)` in place of the recurrence's step while
    the first executor runs (the phase makes each executor's feed before
    its runs)."""
    from paddle_tpu_torch.ops import controlflow

    feeds = []
    make_feed = smoke.lm_feed

    def lm_feed(torch_, batch, device):
        feeds.append(device)
        return make_feed(torch_, batch, device)

    step = controlflow.recurrent_step

    def planted(*args):
        if len(feeds) == 1:
            return wrong(step, args)
        return step(*args)

    monkeypatch.setattr(smoke, "lm_feed", lm_feed)
    monkeypatch.setattr(controlflow, "recurrent_step", planted)


def _drop_first_layer_grad(step, args):
    """The replay of step 0 with its weight slices cut off the graph:
    no grad reaches layer 0's slice of any stacked weight."""
    block, env, attrs, carry, xs_t, t, seq_len, ctx = args
    if torch.is_grad_enabled() and t == 0:
        xs_t = [x.detach() for x in xs_t]
    return step(block, env, attrs, carry, xs_t, t, seq_len, ctx)


@pytest.mark.parametrize("fault", ["replay_drops_a_step", "switch_wrong_case",
                                   "merge_every_run"])
def test_stacked_card_vs_cpu_catches_a_planted_fault(smoke, fault,
                                                     monkeypatch, capsys):
    """A replay that drops layer 0's stacked-weight grads, a Switch that
    takes the wrong case (its less_than negated) or a merge that updates
    on every run (its counter's remainder always 0), in the first run:
    the stacked card-vs-CPU check fails."""
    program = smoke.build_stacked_cvc(fluid)
    if fault == "replay_drops_a_step":
        _plant_step(monkeypatch, smoke, _drop_first_layer_grad)
    elif fault == "switch_wrong_case":
        _plant(monkeypatch, smoke, "less_than",
               lambda impl, ctx, ins, attrs: {"Out": [
                   ~impl(ctx, ins, attrs)["Out"][0]]})
    else:
        _plant(monkeypatch, smoke, "elementwise_mod",
               lambda impl, ctx, ins, attrs: {"Out": [
                   torch.zeros_like(ins["X"][0])]})
    with pytest.raises(SystemExit):
        smoke.stacked_card_vs_cpu_phase(torch, fluid, program,
                                        devices=("cpu", "cpu"))
    out = capsys.readouterr()
    assert "card vs CPU stacked" in out.err
    line = [json.loads(x.split(" ", 1)[1]) for x in out.out.splitlines()
            if x.startswith("card_vs_cpu_stacked ")][0]
    # the check aimed at the fault sees it too (the loss check fails first)
    if fault == "replay_drops_a_step":
        assert line["worst_grad_err_over_limit"] > 1
        assert line["worst_grad"].startswith("st_") and "[0]" in \
            line["worst_grad"]
    elif fault == "switch_wrong_case":
        assert line["lr_max_rel_err"] > 0.1
    else:
        assert line["moved_on_a_merge_only_run"] > 0


# ---------------------------------------------------------------------------
# phase 9: image classification on CPU executors, and its card-vs-CPU
# check with planted faults
# ---------------------------------------------------------------------------


def test_image_legs_pass_their_gates_on_the_cpu(smoke):
    """The fp32 and amp legs of 9a's recipe on the small ResNet at batch
    4: the loss falls, every moving statistic moves, the test clone
    leaves them; the gates fail a loss that does not fall, a statistic
    left at its start and a clone that moved one."""
    for amp in (False, True):
        leg = smoke.image_leg(torch, fluid, "resnet8_bottleneck", amp, 4,
                              steps=(1, 3), device="cpu")
        smoke.check_image_leg(leg)
        assert leg["batch_norms"] == 13 and leg["params"] == 41
    for wrong in (dict(losses=leg["losses"][::-1]),
                  dict(stats_unmoved=["batch_norm_0.w_1"]),
                  dict(test_clone_moved=["batch_norm_0.w_2"]),
                  dict(test_loss=float("nan"))):
        with pytest.raises(SystemExit):
            smoke.check_image_leg(dict(leg, **wrong))


def test_image_builders_phase_on_the_cpu(smoke):
    rows = smoke.image_builders_phase(
        torch, fluid, builders=(("mnist_mlp", 4), ("mnist_cnn", 4)),
        device="cpu")
    assert [r["builder"] for r in rows] == ["mnist_mlp", "mnist_cnn"]
    assert all(np.isfinite(r["loss"]) for r in rows)


def test_image_card_vs_cpu_passes_when_the_runs_agree(smoke, capsys):
    smoke.image_card_vs_cpu_phase(torch, fluid, smoke.build_image_cvc(fluid),
                                  devices=("cpu", "cpu"))
    line = [json.loads(x.split(" ", 1)[1])
            for x in capsys.readouterr().out.splitlines()
            if x.startswith("card_vs_cpu_image ")][0]
    assert line["moving_stats"] == 26 and line["params"] == 41
    assert 2 * line["skipped_update_fails_params"] >= line["params"]


def _flip_the_closest_relu(impl, ctx, ins, attrs):
    """The relu that puts the element nearest 0 of each call on the other
    side: what fp32 rounding does to a pre-activation within it of 0."""
    x = ins["X"][0]
    keep = (x > 0).flatten()
    i = int(x.detach().abs().flatten().argmin())
    keep[i] = ~keep[i]
    return {"Out": [x * keep.reshape(x.shape).to(x.dtype)]}


def test_image_card_vs_cpu_follows_the_cards_relu_branches(smoke, monkeypatch,
                                                            capsys):
    """The CPU takes each relu branch the card took: a card that puts the
    element nearest 0 of every relu on the other side passes, and the
    phase reads each such element."""
    program = smoke.build_image_cvc(fluid)
    _plant(monkeypatch, smoke, "relu", _flip_the_closest_relu,
           feed="image_feed")
    smoke.image_card_vs_cpu_phase(torch, fluid, program,
                                  devices=("cpu", "cpu"))
    line = [json.loads(x.split(" ", 1)[1])
            for x in capsys.readouterr().out.splitlines()
            if x.startswith("card_vs_cpu_image ")][0]
    assert line["relu_elements_the_cpu_would_cross"] == 10


def _skip_moving_stats(impl, ctx, ins, attrs):
    out = impl(ctx, ins, attrs)
    return dict(out, MeanOut=ins["Mean"], VarianceOut=ins["Variance"])


def _unbiased_moving_variance(impl, ctx, ins, attrs):
    """The moving variance from the unbiased batch variance, as cuDNN's
    running statistic is formed."""
    out = impl(ctx, ins, attrs)
    x, m = ins["X"][0], attrs.get("momentum", 0.9)
    n = x.numel() // x.shape[1]
    var = out["SavedVariance"][0].detach() * (n / (n - 1))
    return dict(out, VarianceOut=[ins["Variance"][0] * m + var * (1 - m)])


def _tf32(t):
    """t rounded to TF32 (10 stored mantissa bits, to nearest), its grad
    passed straight through."""
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach()


def _tf32_conv(impl, ctx, ins, attrs):
    return impl(ctx, dict(ins, Input=[_tf32(ins["Input"][0])],
                          Filter=[_tf32(ins["Filter"][0])]), attrs)


IMAGE_FAULTS = {"skip_moving_stats": ("batch_norm", _skip_moving_stats),
                "unbiased_moving_variance": ("batch_norm",
                                             _unbiased_moving_variance),
                "tf32_conv": ("conv2d", _tf32_conv)}


@pytest.mark.parametrize("fault", sorted(IMAGE_FAULTS))
def test_image_card_vs_cpu_catches_a_planted_fault(smoke, fault,
                                                   monkeypatch, capsys):
    program = smoke.build_image_cvc(fluid)
    _plant(monkeypatch, smoke, *IMAGE_FAULTS[fault], feed="image_feed")
    with pytest.raises(SystemExit):
        smoke.image_card_vs_cpu_phase(torch, fluid, program,
                                      devices=("cpu", "cpu"))
    out = capsys.readouterr()
    assert "card vs CPU image" in out.err
    line = [json.loads(x.split(" ", 1)[1]) for x in out.out.splitlines()
            if x.startswith("card_vs_cpu_image ")][0]
    if fault != "tf32_conv":   # the statistics check sees it
        assert line["worst_stat_err_over_limit"] > 1
    else:
        assert line["loss_rel_err"] > line["loss_limit"]


# ---------------------------------------------------------------------------
# phase 10: the inference predictor on the CPU (the small ResNet at batch
# 4, the mnist cnn at batch 4, the quant predictor bench), with planted
# faults
# ---------------------------------------------------------------------------


def _predictor_checks(out):
    return [json.loads(x.split(" ", 1)[1]) for x in out.splitlines()
            if x.startswith("predictor_checks ")][0]


def test_predictor_phase_on_the_cpu(smoke, capsys):
    """10a on the small ResNet: four legs pass their gates (the passes
    leave no batch_norm, the fold within its limit, the classifier
    bitwise the plain version), then 10b's mnist cnn in full_int8 with
    both convolutions on int8 operands, then 10c's bench keys."""
    smoke.predictor_resnet_phase(torch, fluid, im, name="resnet8_bottleneck",
                                 batch=4, device="cpu")
    checks = _predictor_checks(capsys.readouterr().out)
    assert checks["classifier_bitwise"] == [["fc_0.tmp_0", True]]
    assert checks["fold_max_abs_diff"] <= smoke.PREDICT_FOLD_ATOL
    smoke.predictor_mnist_phase(torch, fluid, im, batch=4,
                                devices=("cpu", "cpu"))
    line = [json.loads(x.split(" ", 1)[1])
            for x in capsys.readouterr().out.splitlines()
            if x.startswith("predictor_mnist ")][0]
    assert line["int8_convolutions"] == 2
    assert line["compiled_ops"]["fused_int8_matmul"] == 1
    smoke.quant_bench_phase(im, place="cpu")
    assert "quant_predictor_bench " in capsys.readouterr().out


def _no_fold(program, scope=None):
    return program


def _fp32_classifier(impl, ctx, ins, attrs):
    """K4 bypassed: the product in fp32 over the dequantized weight."""
    x, w, dq = ins["X"][0], ins["Y"][0], ins["Scale"][0]
    return {"Out": [x.reshape(x.shape[0], -1)
                    @ (w.float() * dq * attrs["act_scale"])]}


PREDICTOR_FAULTS = {"skipped_fold": "batch_norm ops left",
                    "k4_bypassed": "classifier is not bitwise",
                    "act_scale_1pct": "classifier is not bitwise"}


@pytest.mark.parametrize("fault", sorted(PREDICTOR_FAULTS))
def test_predictor_phase_catches_a_planted_fault(smoke, fault, monkeypatch,
                                                 capsys):
    from paddle_tpu_torch import ir

    if fault == "skipped_fold":
        monkeypatch.setattr(ir.get_pass("conv_bn_fold"), "apply", _no_fold)
    else:
        opdef = registry.get("fused_int8_matmul")
        impl = opdef.impl
        wrong = (_fp32_classifier if fault == "k4_bypassed"
                 else _act_scale_one_percent)
        monkeypatch.setattr(opdef, "impl", lambda ctx, ins, attrs: wrong(
            impl, ctx, ins, attrs))
    with pytest.raises(SystemExit):
        smoke.predictor_resnet_phase(torch, fluid, im,
                                     name="resnet8_bottleneck", batch=4,
                                     device="cpu")
    assert PREDICTOR_FAULTS[fault] in capsys.readouterr().err


def test_predictor_mnist_catches_an_act_scale_fault(smoke, monkeypatch,
                                                    capsys):
    opdef = registry.get("fused_int8_matmul")
    impl = opdef.impl
    monkeypatch.setattr(opdef, "impl", lambda ctx, ins, attrs:
                        _act_scale_one_percent(impl, ctx, ins, attrs))
    with pytest.raises(SystemExit):
        smoke.predictor_mnist_phase(torch, fluid, im, batch=4,
                                    devices=("cpu", "cpu"))
    assert "classifier is not bitwise" in capsys.readouterr().err


def test_predictor_gates_count_k4_on_the_card(smoke):
    """On the card the gates want K4 once a run at the classifier's shape
    in full_int8 and never in the other legs: a missing launch, an extra
    one or one in the fp32 leg fails."""
    mkn = (64, 2048, 1000)
    legs = {name: {"finite": True, "ops": {"batch_norm": 1}
                   if name == "fp32_no_ir_optim" else {},
                   "warmup": 3, "runs": 10,
                   "k4_launches": {mkn: 13} if name == "full_int8" else {}}
            for name, _, _ in smoke.PREDICT_LEGS}
    checks = {"fold_max_abs_diff": 0.0, "fold_top1_rows_differing": [],
              "classifier_bitwise": [("fc_0.tmp_0", True)]}
    smoke.check_predictor_legs(legs, checks, True, mkn)
    for leg, launches in (("full_int8", {mkn: 12}), ("full_int8", {}),
                          ("fp32", {mkn: 13})):
        wrong = dict(legs, **{leg: dict(legs[leg], k4_launches=launches)})
        with pytest.raises(SystemExit):
            smoke.check_predictor_legs(wrong, checks, True, mkn)
    for wrong in (dict(fold_max_abs_diff=1e-4),
                  dict(fold_top1_rows_differing=[3])):
        with pytest.raises(SystemExit):
            smoke.check_predictor_legs(legs, dict(checks, **wrong), True,
                                       mkn)
