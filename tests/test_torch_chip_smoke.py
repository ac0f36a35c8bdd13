"""chip_smoke.py's phases that run without the card, here on the CPU at
a small width:

  * the card-vs-CPU step check with two CPU executors (vocab 256,
    d_model 128, 2 heads of 64, 2 layers, d_ff 256, seq 128): it passes
    when the two runs agree, and its fp32 leg fails on each fault
    planted in the first run — an SGD update skipped, an update 1% too
    large, flash attention's dQ 1% too large;
  * the int8 card-vs-CPU check with two CPU executors (the same width,
    fp32, full-int8): it passes when the two runs agree, reads the
    bound for a 1% act-scale fault, and fails on such a fault planted
    in the first run's fused int8 matmuls;
  * the speculative serving phase (vocab 128, d_model 64, 2 heads, 2
    layers, d_ff 128; 6 repetitive prompts, 24 new tokens): its three
    legs run token-identical to ``reference_decode`` with clean pools,
    and a planted wrong verify-window token fails it, printing the
    reference's top-2 logit margin at the differing position."""

import importlib.util
import pathlib

import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops import int8_matmul as im
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import paged_attention_tree as pat
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.serving import GenerationModel

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


def _plant(monkeypatch, smoke, op, wrong):
    """Run `wrong` in place of op `op` while the first executor runs:
    the phases make the first executor's feed before its run and the
    second's after it."""
    feeds = []
    make_feed = smoke.lm_feed

    def lm_feed(torch_, batch, device):
        feeds.append(device)
        return make_feed(torch_, batch, device)

    opdef = registry.get(op)
    impl = opdef.impl

    def planted(ctx, ins, attrs):
        if len(feeds) == 1:
            return wrong(impl, ctx, ins, attrs)
        return impl(ctx, ins, attrs)

    monkeypatch.setattr(smoke, "lm_feed", lm_feed)
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
