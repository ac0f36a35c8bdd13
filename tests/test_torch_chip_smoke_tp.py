"""chip_smoke.py phase 17's rank legs and gates (17b and 17c:
``tp_rank_legs``, ``check_tp_ranks``) on four gloo CPU ranks at a small
width, as ``tests/test_torch_chip_smoke_spmd.py`` runs phase 16's: the
clean run passes every gate, and each planted fault is caught by the
gate named for it — a split that keeps each rank's columns as they lie
(the first loss off Executor.run's), a column-parallel product whose
replicated input enters without its grad's sum (the layer norms'
grads, and so their parameters, differ across the tp ranks), the
vocab-parallel cross-entropy without its MAX all-reduce (the first loss
off), and ZeRO-1's moments left whole (the state not half its
AllReduce bytes). 17a's plan check runs against the pinned table."""

import importlib.util
import pathlib

import pytest

import torch_dp_workers as W
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           seq_len=16)
ARGS = dict(cfg=CFG, batch=8, warmup=1, steps=2, tokens=4)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tp", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()
SPLIT_LEG = [("dropout_2x2", (2, 2), "sgd", False)]


def _run(fault=None, **kw):
    res = W.pool(4).run("torch_tp_workers:smoke_tp", fault=fault,
                        **dict(ARGS, **kw))
    for r in res:
        assert "error" not in r, r["error"]
    return SMOKE.check_tp_ranks(res, on_card=False), res


@pytest.fixture(scope="module")
def clean():
    return _run()


def test_phase17_legs_pass_their_gates(clean):
    bad, res = clean
    assert bad == []
    legs = res[0]["legs"]
    assert sorted(legs) == ["adam_reduce_2x2", "bench_1x4", "bench_2x2"]
    assert legs["bench_1x4"]["local_heads"] == [1, 1]
    assert legs["adam_reduce_2x2"]["zero"]
    assert legs["bench_2x2"]["expected_tp"]["reduce_tp"][0] > 0


def test_dropout_leg_with_its_split_passes():
    bad, res = _run(legs=SPLIT_LEG, dropout=0.1)
    assert bad == []
    seams = [s[0] for s in res[0]["legs"]["dropout_2x2"]["seams"]]
    # each layer's qkv split, then the attention's reshapes of its
    # pieces; none at an op of TP_NO_SEAM
    assert seams.count("split") == 2
    assert not set(seams) & set(SMOKE.TP_NO_SEAM)


@pytest.mark.parametrize("fault,legs,kw,gate", [
    ("local_split", SPLIT_LEG, {"dropout": 0.1}, "off Executor.run's"),
    ("no_enter", None, {}, "differs across the ranks"),
    ("ce_no_max", None, {}, "off Executor.run's"),
    ("whole_moments", None, {}, "not half of AllReduce's")])
def test_planted_faults_are_caught(fault, legs, kw, gate):
    bad, _ = _run(fault=fault, legs=legs, **kw)
    assert any(gate in b for b in bad), bad


def test_phase17a_plan_matches_the_table():
    """17a's check passes after other programs were built in the process
    (as in the whole script, where the name counters have moved on)."""
    import paddle_tpu_torch as fluid

    SMOKE.build_lm(fluid, cfg=dict(CFG, vocab_size=64))
    out = SMOKE.tp_plan_check(fluid)
    assert out["2x2"]["seams"] == [] and out["1x4"]["seams"] == []
    assert out["2x2"]["specs"] == 68
