"""chip_smoke.py's phase 12 (the native flagship) without the card, here
on the CPU at reduced depth and batch:

  * 12a: ``native_train_leg`` (``bench.bench_transformer`` with metrics
    on) at full width, 2 layers, batch 2, seq 32 passes its gates — the
    losses falling and the counted step equal to its closed form — and
    the gates fail a loss that does not fall and K1's launches off by one
    either way;
  * 12b: the entry's forward at 2 layers, batch 2, seq 32 gives finite
    fp32 logits of the right shape;
  * 12c with two CPUs at a small config passes in fp32 and bf16, and
    fails each fault planted in the first device's first step of each
    dtype: exact GELU in place of tanh, sqrt(D) taken in fp32 and the
    Adam bias correction dropped."""

import importlib.util
import json
import math
import pathlib

import pytest
import torch
import torch.nn.functional as F

from paddle_tpu_torch import bench as pbench
from paddle_tpu_torch.models import transformer as P
from paddle_tpu_torch.ops import flash_attention as fa

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=64, d_model=32, n_heads=2, d_ff=64, batch=2,
             seq=24)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_native_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def reduced(monkeypatch):
    """bench's native configuration cut to 2 layers (full width)."""
    full = pbench.native_config
    monkeypatch.setattr(pbench, "native_config", lambda *a, **kw: full(
        *a, **dict(kw, n_layers=2)))


def _lines(out, tag):
    return [json.loads(x.split(" ", 1)[1]) for x in out.splitlines()
            if x.startswith(tag + " ")]


def test_native_train_leg_on_the_cpu(smoke, reduced):
    leg = smoke.native_train_leg(torch, fa, device="cpu", batch=2, seq=32,
                                 steps=(1, 2))
    smoke.check_native_leg(leg, on_card=False)
    assert leg["runs"] == 3 and len(leg["losses"]) == 3
    assert leg["step_flops"] == leg["step_flops_closed_form"] > 0
    assert leg["remat"] is False and leg["layers"] == 2
    assert smoke.native_k1_per_step(leg) == (2, 2)
    assert smoke.native_k1_per_step(dict(leg, remat=True)) == (4, 2)


def _card_leg(**kw):
    leg = {"leg": "native_train", "losses": [10.5, 10.2, 9.9],
           "step_flops": 7, "step_flops_closed_form": 7, "layers": 6,
           "remat": True, "runs": 3,
           "k1_fwd": {"tc": 36, "fp16": 0, "f32tc": 0},
           "k1_bwd": {"tc": 18, "fp16": 0, "f32tc": 0}, "k1_copies": 0}
    leg.update(kw)
    return leg


@pytest.mark.parametrize("wrong", [
    {"losses": [10.5, 10.6, 10.5]}, {"losses": [10.5, float("nan"), 9.9]},
    {"step_flops": 8},
    {"k1_fwd": {"tc": 35, "fp16": 0, "f32tc": 0}},
    {"k1_fwd": {"tc": 37, "fp16": 0, "f32tc": 0}},
    {"k1_bwd": {"tc": 19, "fp16": 0, "f32tc": 0}},
    {"k1_fwd": {"tc": 35, "fp16": 0, "f32tc": 1}},
    {"k1_copies": 1}])
def test_native_gates_catch_each_fault(smoke, wrong, capsys):
    smoke.check_native_leg(_card_leg(), on_card=True)
    with pytest.raises(SystemExit):
        smoke.check_native_leg(_card_leg(**wrong), on_card=True)
    assert "native_train" in capsys.readouterr().err


def test_entry_forward_on_the_cpu(smoke, reduced):
    logits, leg = smoke.entry_forward_leg(torch, fa, device="cpu",
                                          shape=(2, 32))
    smoke.check_entry_forward(leg, 32000, on_card=False)
    assert logits.dtype == torch.float32
    assert leg["logits_shape"] == [2, 32, 32000] and leg["finite"]
    with pytest.raises(SystemExit):
        smoke.check_entry_forward(dict(leg, logits_dtype="bfloat16"),
                                  32000, on_card=False)
    with pytest.raises(SystemExit):
        smoke.check_entry_forward(dict(leg, k1_fwd={"tc": 1, "fp16": 0,
                                                    "f32tc": 0}),
                                  32000, on_card=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_native_card_vs_cpu_passes_when_the_runs_agree(smoke, dtype,
                                                       capsys):
    k1 = smoke.native_card_vs_cpu_phase(torch, fa, dtype,
                                        devices=("cpu", "cpu"), **SMALL)
    line, = _lines(capsys.readouterr().out, "card_vs_cpu_native")
    assert line["worst_grad_err_over_limit"] <= 1
    assert line["worst_param_err_over_limit"] <= 1
    assert line["embedding_differs"] == [] and line["steps"] == 2
    assert k1[2] == 0 and not any(k1[0].values())


def _exact_gelu(lp, h_full, dtype):
    a = h_full @ lp["w1"].to(dtype)
    a = F.gelu(a + lp["b1"].to(dtype))
    return a @ lp["w2"].to(dtype)


def _adam_without_bias_correction(params, grads, m, v, t):
    lr, b1, b2, eps = (pbench.NATIVE_ADAM[k]
                       for k in ("lr", "b1", "b2", "eps"))
    with torch.no_grad():
        for p, g, mm, vv in zip(P.tree_leaves(params), grads,
                                P.tree_leaves(m), P.tree_leaves(v)):
            gf = g.float()
            mm.mul_(b1).add_((1 - b1) * gf)
            vv.mul_(b2).add_((1 - b2) * gf * gf)
            p.copy_(p.float() - lr * mm / (torch.sqrt(vv) + eps))
    return t + 1


# fault -> (module, name, planted, the dtypes whose run sees it): exact
# GELU moves the fp32 logits past 1e-5 of their largest; sqrt(D) in fp32
# changes bf16 embeddings only (in fp32 it is the same scalar), seen
# bitwise; the update without bias correction moves the parameters ~3x
# further than Adam's bound
FAULTS = {
    "exact_gelu": (P, "ffn_block", _exact_gelu, ["float32"]),
    "sqrt_d_in_fp32": (P, "weak_scalar", lambda x, value: value,
                       ["bfloat16"]),
    "adam_bias_correction_dropped": (pbench, "native_adam",
                                     _adam_without_bias_correction,
                                     ["float32", "bfloat16"]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_native_card_vs_cpu_catches_a_planted_fault(smoke, fault,
                                                    monkeypatch, capsys):
    """The fault runs in the first device's first step of each dtype's
    run only (``native_device_step`` calls 0, 4, ...)."""
    module, name, wrong, seen_by = FAULTS[fault]
    right = getattr(module, name)
    calls = []
    device_step = smoke.native_device_step

    def counted(*args):
        calls.append(len(calls))
        return device_step(*args)

    def planted(*args, **kw):
        if calls and calls[-1] % 4 == 0:
            return wrong(*args, **kw)
        return right(*args, **kw)

    monkeypatch.setattr(smoke, "native_device_step", counted)
    monkeypatch.setattr(module, name, planted)
    caught = []
    for dtype in ("float32", "bfloat16"):
        try:
            smoke.native_card_vs_cpu_phase(torch, fa, dtype,
                                           devices=("cpu", "cpu"), **SMALL)
        except SystemExit:
            caught.append(dtype)
    assert caught == seen_by
    assert "card vs CPU native" in capsys.readouterr().err


def test_native_step_flops_closed_form_matches_a_count(smoke):
    """``native_step_flops`` (12a's gate) against a counted step, remat
    on and off."""
    from paddle_tpu_torch.observability import cost

    for remat in (False, True):
        cfg = pbench.native_config(2, 16, remat=remat, dtype="float32",
                                   vocab_size=64, d_model=32, n_heads=2,
                                   n_layers=2, d_ff=64)
        state = pbench.native_state(cfg, device="cpu")
        toks = torch.arange(32).view(2, 16) % 64
        with cost.count_flops() as c:
            pbench.native_train_step(*state, toks, toks.roll(-1, 1), cfg)
        assert c.flops == smoke.native_step_flops(cfg, 2, 16)
    assert math.isclose(
        smoke.native_step_flops(pbench.native_config(192), 192, 512),
        2.7e13, rel_tol=0.15)
