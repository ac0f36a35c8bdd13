"""chip_smoke.py phase 18's legs and gates (``zero_rank_legs``,
``check_zero_ranks``: 18a at world 1, 18b at world 4 with its fp32 twin)
on gloo CPU ranks of 1 and 4 at a small width (the flagship at 2 layers,
d_model 32, 4 heads, vocab 128, batch 8, seq 16, bf16 compute from fp32
leaves, 3 steps), as ``tests/test_torch_chip_smoke_tp.py`` runs phase
17's: the clean runs pass every gate, and each planted fault is caught
by the gate named for it — a reduce-scatter not divided by the world
(the twin's m and v off the one-rank run's), stage 2 dropping its m
write and offload never copying m/v back (the bucketed rungs no longer
bitwise equal), overlap issued in forward order (no bucket issued with
backward work still to come) and a stage-3 gather-back (a counted extra
collective)."""

import importlib.util
import pathlib

import pytest

import torch_dp_workers as W
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIDTH = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, d_ff=64)
ARGS = dict(width=WIDTH, batch=8, seq=16, warmup=1, steps=2,
            bucket_mb=0.02)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_zero", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def _run(world, fault=None, **kw):
    res = W.pool(world).run("torch_zero_workers:smoke_zero", fault=fault,
                            **dict(ARGS, **kw))
    for r in res:
        assert "error" not in r, r["error"]
    return SMOKE.check_zero_ranks(res, on_card=False), res


@pytest.fixture(scope="module")
def clean():
    return {world: _run(world) for world in (1, 4)}


@pytest.mark.parametrize("world", [1, 4])
def test_phase18_legs_pass_their_gates(clean, world):
    bad, res = clean[world]
    assert bad == []
    legs = res[0]["legs"]
    assert list(legs) == [name for name, _ in SMOKE.ZERO_LEGS]
    assert legs["bucketed"]["buckets"] >= 4
    assert legs["per_leaf"]["buckets"] is None
    assert ("twin" in res[0]) == (world > 1)
    for r in res:
        for leg in r["legs"].values():
            assert world * leg["state_bytes"] == leg["plan_state_bytes"]
    if world == 1:   # every fp32-wire bucketed rung bitwise, plan or not
        digests = {legs[n]["digests"]["params"][0]
                   for n in SMOKE.ZERO_FP32_WIRE}
        assert len(digests) == 1
        assert res[0]["compare"]["per_leaf_excess"][0] <= 0
    else:            # a quarter of world 1's bytes (no pad at this width)
        leg = legs["zero3_overlap"]
        assert 4 * leg["state_bytes"] == leg["world1_state_bytes"]
        assert 4 * leg["param_bytes"] == leg["world1_param_bytes"]
        assert res[0]["twin"]["worst_state_ratio"] < 1e-4


@pytest.mark.parametrize("fault,world,legs,gate", [
    ("no_divide", 4, [], "the twin's m/v"),
    ("drop_m", 1, ["bucketed", "zero2_overlap"], "not bitwise equal"),
    ("no_copy_back", 1, ["bucketed", "offload"], "not bitwise equal"),
    ("forward_order", 1, ["zero2_overlap"], "overlap issued"),
    ("gather_back", 4, ["zero3_overlap"], "ZeRO collectives")])
def test_planted_faults_are_caught(fault, world, legs, gate):
    bad, _ = _run(world, fault=fault, legs=legs)
    assert any(gate in b for b in bad), bad
