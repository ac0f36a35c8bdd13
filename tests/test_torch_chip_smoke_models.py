"""chip_smoke.py's phase 11 (the rest of benchmark/fluid's model set)
without the card, here on the CPU:

  * 11a and 11b on CPU executors: deepfm, stacked_dynamic_lstm and
    machine_translation at full width through the port's harness at
    batch 4 (one warm-up and two timed steps), word2vec at its defaults
    and the beam decoder at its defaults pass their gates;
  * the gates fail a loss that does not fall, an AUC outside [0, 1],
    AUC histograms that do not hold batch x runs counts, a sentence
    that is not the backtrack of its steps and a parent outside the
    beam;
  * 11c with two CPU executors passes when the runs agree, for the
    reduced DeepFM and the 2-layer stacked LSTM, and fails each fault
    planted in the first run: the LSTM's gates i and f swapped, the
    LSTM's bias dropped, AUC's bins shifted by half a bin, and Adam's
    update skipped."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops import registry

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_models_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(out, tag):
    return [json.loads(x.split(" ", 1)[1]) for x in out.splitlines()
            if x.startswith(tag + " ")]


def test_bench_models_phase_on_the_cpu(smoke, capsys):
    smoke.bench_models_phase(torch, fluid, device="cpu", steps=(1, 2),
                             argv=["--device", "CPU", "--batch_size", "4"])
    out = capsys.readouterr().out
    legs = {leg["leg"]: leg for leg in _lines(out, "bench_model")}
    assert sorted(legs) == ["deepfm", "machine_translation",
                            "stacked_dynamic_lstm", "word2vec"]
    assert legs["deepfm"]["auc_stats_total"] == 4 * 4
    assert 0 <= legs["deepfm"]["auc"] <= 1
    harness = [json.loads(x) for x in out.splitlines()
               if x.startswith('{"metric"')]
    assert [h["metric"] for h in harness] == [
        m + "_examples_per_sec_per_chip" for m in smoke.BENCH_MODELS]
    assert out.count("examples/sec/chip") == 3
    beam, = _lines(out, "beam_decoder")
    assert beam["steps"] == 8 and len(beam["first_sentence"]) == 8


@pytest.mark.parametrize("wrong", [
    {"losses": [0.7, 0.7]}, {"losses": [0.7, float("nan")]},
    {"auc": 1.5}, {"auc_stats_total": 15.0}])
def test_bench_gates_catch_each_fault(smoke, wrong):
    leg = {"leg": "deepfm", "batch": 4, "losses": [0.7, 0.5], "auc": 0.6,
           "auc_runs": 4, "auc_stats_total": 16.0}
    smoke.check_bench_leg(leg)
    with pytest.raises(SystemExit):
        smoke.check_bench_leg(dict(leg, **wrong))


def test_beam_decode_gate_catches_a_wrong_parent(smoke, capsys):
    leg = smoke.beam_decoder_leg(torch, fluid, device="cpu", batch=3)
    smoke.check_beam_decode(leg)
    parents = leg["parents"].copy()
    parents[3] = 1 - parents[3]           # beam 2: the other lane
    with pytest.raises(SystemExit):
        smoke.check_beam_decode(dict(leg, parents=parents))
    assert "backtrack" in capsys.readouterr().err
    parents = leg["parents"].copy()
    parents[0, 0, 0] = 2
    with pytest.raises(SystemExit):
        smoke.check_beam_decode(dict(leg, parents=parents))
    assert "outside" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["deepfm", "stacked_lstm"])
def test_bench_card_vs_cpu_passes_when_the_runs_agree(smoke, name, capsys):
    report = smoke.bench_card_vs_cpu_phase(torch, fluid, name,
                                           devices=("cpu", "cpu"))
    line, = _lines(capsys.readouterr().out, "card_vs_cpu_bench")
    assert line == report
    assert report["worst_grad_err_over_limit"] <= 1
    assert report["auc_stats_checked"] == (4 if name == "deepfm" else 0)


def _swap_gates_i_f(impl, ctx, ins, attrs):
    """The LSTM with its input and forget gates trading places."""
    def swap(t):
        i, f, c, o = torch.chunk(t, 4, dim=-1)
        return torch.cat([f, i, c, o], dim=-1)

    return impl(ctx, dict(ins, Input=[swap(ins["Input"][0])],
                          Weight=[swap(ins["Weight"][0])],
                          Bias=[swap(ins["Bias"][0])]), attrs)


def _drop_bias(impl, ctx, ins, attrs):
    return impl(ctx, {k: v for k, v in ins.items() if k != "Bias"}, attrs)


def _half_bin(impl, ctx, ins, attrs):
    """AUC's bins as if the score were rounded, not truncated."""
    shift = 0.5 / (ins["StatPos"][0].shape[0] - 1)
    return impl(ctx, dict(ins, Predict=[ins["Predict"][0] + shift]), attrs)


def _skip_adam(impl, ctx, ins, attrs):
    return {"ParamOut": ins["Param"], "Moment1Out": ins["Moment1"],
            "Moment2Out": ins["Moment2"], "Beta1PowOut": ins["Beta1Pow"],
            "Beta2PowOut": ins["Beta2Pow"]}


# fault -> (program, op, planted impl, the report's key that sees it)
FAULTS = {"lstm_gates_swapped": ("stacked_lstm", "lstm", _swap_gates_i_f,
                                 "loss_rel_err"),
          "lstm_bias_dropped": ("stacked_lstm", "lstm", _drop_bias,
                                "worst_grad_err_over_limit"),
          "auc_half_bin": ("deepfm", "auc", _half_bin, "auc_stats_differ"),
          "adam_skipped": ("deepfm", "adam", _skip_adam,
                           "worst_param_err_over_limit")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_bench_card_vs_cpu_catches_a_planted_fault(smoke, fault,
                                                   monkeypatch, capsys):
    """Each fault runs in place of its op in the first executor's first
    run only (the phase makes each run's feed just before it)."""
    name, op, wrong, key = FAULTS[fault]
    feeds = []
    make_feed = smoke.bench_cvc_feed

    def counted(*args):
        feeds.append(args)
        return make_feed(*args)

    opdef = registry.get(op)
    impl = opdef.impl

    def planted(ctx, ins, attrs):
        if len(feeds) == 1:
            return wrong(impl, ctx, ins, attrs)
        return impl(ctx, ins, attrs)

    monkeypatch.setattr(smoke, "bench_cvc_feed", counted)
    monkeypatch.setattr(opdef, "impl", planted)
    with pytest.raises(SystemExit):
        smoke.bench_card_vs_cpu_phase(torch, fluid, name,
                                      devices=("cpu", "cpu"))
    out = capsys.readouterr()
    assert "card vs CPU %s" % name in out.err
    line, = _lines(out.out, "card_vs_cpu_bench")
    if key == "auc_stats_differ":
        assert line[key]
    elif key == "loss_rel_err":
        assert line[key] > line["loss_limit"]
    else:
        assert line[key] > 1


def test_bench_models_phase_from_a_moved_init_counter(smoke, capsys):
    """Each leg pins the port's init counters, so the phase draws the
    weights of a fresh process even after other programs were built (at
    a counter of 123 DeepFM's loss rose before the pin)."""
    from paddle_tpu_torch import initializer, layer_helper

    initializer._global_seed_counter[0] = 123
    layer_helper._op_seed_counter[0] = 1123
    smoke.bench_models_phase(torch, fluid, device="cpu", steps=(1, 2),
                             argv=["--device", "CPU", "--batch_size", "4"])
    legs = {leg["leg"]: leg
            for leg in _lines(capsys.readouterr().out, "bench_model")}
    assert legs["deepfm"]["losses"][-1] < legs["deepfm"]["losses"][0]
    assert initializer._global_seed_counter[0] != 123
