"""chip_smoke.py's card-vs-CPU step check, run here with two CPU
executors at a small width (vocab 256, d_model 128, 2 heads of 64, 2
layers, d_ff 256, seq 128): it passes when the two runs agree, and its
fp32 leg fails on each fault planted in the first run — an SGD update
skipped, an update 1% too large, flash attention's dQ 1% too large."""

import importlib.util
import pathlib

import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops import registry

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256,
           seq_len=128)


@pytest.fixture
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.TRAIN = dict(CFG)
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


FAULTS = {"skip_sgd": ("sgd", _skip_sgd),
          "lr_1pct": ("sgd", _lr_one_percent),
          "dq_1pct": ("flash_attention", _dq_one_percent)}


def _plant(monkeypatch, smoke, fault):
    """Run `fault` in place of its op while the first executor steps:
    the phase makes the first executor's feed before its two steps and
    the second's after them."""
    feeds = []
    make_feed = smoke.lm_feed

    def lm_feed(torch_, batch, device):
        feeds.append(device)
        return make_feed(torch_, batch, device)

    op, wrong = FAULTS[fault]
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
    _plant(monkeypatch, smoke, fault)
    with pytest.raises(SystemExit):
        smoke.card_vs_cpu_phase(torch, fluid, program, "float32",
                                devices=("cpu", "cpu"))
    assert "card vs CPU float32" in capsys.readouterr().err
