"""chip_smoke.py phase 19's gates on the CPU: its rank legs
(``chip_smoke.pp_rank_legs``: bench.py's headline program, bf16 under
the legacy AMP decorator, here at a small width, through the Fluid
pipeline on the (dp, pp, tp) mesh) on a gloo group of four ranks
(``torch_pp_workers.smoke_pp`` on ``torch_dp_workers.pool``), and
``check_pp_ranks`` over their results: it passes the port as it is and
fails each planted fault (``chip_smoke.pp_fault``). The plan check of
19a runs on the CPU too (the headline program at full width against
``tests/data/pp_plan_headline.json``)."""

import importlib.util
import pathlib

import pytest

import torch_dp_workers as W
from test_torch_pipeline_program import jax_headline_table
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           seq_len=16)
KW = dict(cfg=CFG, batch=16, warmup=1, steps=1, adam_steps=1)
# the JAX step's splits and wires of the small program at the legs'
# microbatches (16 rows over dp · M = 8, or 4 for the tp leg)
SPLITS = ((4, 1, 2), (2, 1, 2), (2, 2, 2), (2, 1, 4))
_TABLE = []


def _table():
    if not _TABLE:
        _TABLE.append(jax_headline_table(CFG, SPLITS))
    return _TABLE[0]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_pp_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fault=None, legs=None):
    kw = dict(KW, table=_table())
    if legs is not None:
        kw["legs"] = legs
    res = W.pool(4).run("torch_pp_workers:smoke_pp", fault=fault, **kw)
    for r in res:
        assert "error" not in r, r["error"]
    return res


def test_phase19_legs_pass_the_gates():
    """Every leg of PP_LEGS passes check_pp_ranks on the CPU: losses
    equal on the ranks and within the fetch rule's limits of
    Executor.run's, step 1's parameters within their limits, the ranks'
    parameters bitwise equal by tp block, the P2P bytes as predicted."""
    smoke = _smoke()
    res = _run()
    assert smoke.check_pp_ranks(res, on_card=False) == []
    legs = res[0]["legs"]
    assert sorted(legs) == sorted(name for name, *_ in smoke.PP_LEGS)
    for leg in legs.values():
        assert leg["pp_fwd_bytes"] + leg["pp_bwd_bytes"] >= 0
    assert sum(r["legs"]["pp4"]["pp_fwd_bytes"] for r in res) > 0


@pytest.mark.parametrize("fault,gate", [
    ("seed_once", "after step 1"), ("no_cotangent", "after step 1"),
    ("fp32_fetch", "not a bf16 value")])
def test_phase19_gates_catch_planted_faults(fault, gate):
    """Each planted fault fails its own gate: a backward seeded as the
    whole batch and a dropped cotangent (the early stages' grads wrong)
    the parameters after step 1 against Executor.run's step, a bf16 loss
    fetched as its fp32 mean the fetch rule's bf16 value."""
    smoke = _smoke()
    leg = [smoke.PP_LEGS[1]]                   # dp2_pp2
    res = _run(fault, legs=leg)
    bad = smoke.check_pp_ranks(res, on_card=False)
    assert any(gate in b for b in bad), (fault, bad)


def test_phase19a_plan_check_on_the_cpu():
    """19a's plan check: the headline program's splits, crossings, cut
    bytes and schedules against the table (fails the run on a
    difference)."""
    import paddle_tpu_torch as fluid

    smoke = _smoke()
    out = smoke.pp_plan_check(fluid)
    assert out["pp4_v1_r20"]["layers_per_rank"] == [3, 3, 0, 0]
    assert out["pp2_v1_r20"]["layers_per_rank"] == [6, 0]
    assert abs(out["schedule_4_8_1"]["bubble_fraction"] - 6 / 14) < 1e-12
