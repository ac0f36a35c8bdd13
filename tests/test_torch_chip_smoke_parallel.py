"""chip_smoke.py's phase 14 (data-parallel training) without the card:
its legs on the CPU over a gloo group of 2 ranks (``torch_dp_workers``)
at a small size, and its gates.

  * 14a: the LM (2 layers, d_model 32, seq 16) through ParallelExecutor
    on a global batch of 4: losses finite and falling by more than
    PARALLEL["min_fall"], no K1 launch on
    the CPU, the collective counts a step equal to the plan's
    prediction, gloo;
  * 14a's comparison (ParallelExecutor against Executor.run of the
    global batch from one state) passes in the leg (bf16), and in fp32
    at world 2, where it fails with a reduction whose backward sums the
    cotangents;
  * 14b: fluid_benchmark's ResNet (cifar, batch 4) with
    update_method="nccl2": moving statistics finite and moved, K1-K4
    unlaunched;
  * 14c: the fleet regression: the last loss below half the first;
  * the gates fail a wrong collective count, a rise in the loss, a 14a
    loss that falls by noise only (under PARALLEL["min_fall"]), a K1
    launch on the CPU, a backend that is not the device's, ranks that
    disagree and unmoved statistics."""

import copy
import importlib.util
import pathlib

import pytest

import torch_dp_workers as W
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           seq_len=16)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_parallel_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


@pytest.fixture(scope="module")
def legs():
    pool = W.pool(2)
    return {
        "14a": _ok(pool.run("smoke_leg", leg="parallel_lm_leg", cfg=CFG,
                            batch=4, warmup=1, steps=2)),
        "14b": _ok(pool.run("smoke_leg", leg="parallel_image_leg",
                            model="resnet", data_set="", batch=4, skip=1,
                            iters=2)),
        "14c": _ok(pool.run("smoke_leg", leg="parallel_fleet_leg")),
    }


def test_legs_pass_their_gates_on_the_cpu(smoke, legs):
    assert smoke.check_parallel(legs, on_card=False) == []
    a = legs["14a"][0]
    assert a["world"] == 2 and a["rank_rows"] == 2
    assert a["vs_executor"]["ok"]
    assert a["expected_calls_per_step"] > 0
    b = legs["14b"][0]
    assert b["n_chips"] == 2 and b["stats"] > 0
    assert b["launches_after"] == b["launches_before"]


@pytest.mark.parametrize("fault", [None, "sum_cotangents"])
def test_vs_executor_check(fault):
    res = _ok(W.pool(2).run("smoke_vs_executor", cfg=CFG, batch=4,
                            fault=fault))
    assert res[0]["ok"] is (fault is None), res[0]


@pytest.mark.parametrize("plant", ["calls", "loss", "backend", "ranks",
                                   "stats", "k1", "flat", "vs_executor"])
def test_gates_fail_planted_faults(smoke, legs, plant):
    bad = copy.deepcopy(legs)
    if plant == "calls":
        bad["14a"][0]["collective_calls_per_step"] += 1
    elif plant == "loss":
        bad["14c"][1]["losses"][-1] = bad["14c"][1]["losses"][0] + 1
    elif plant == "backend":
        bad["14a"][1]["backend"] = "nccl"
    elif plant == "ranks":
        bad["14a"][1]["losses"][0] += 1e-6
    elif plant == "stats":
        bad["14b"][0]["stats_unmoved"] = ["batch_norm_0.w_1"]
    elif plant == "k1":
        bad["14a"][0]["k1_fwd"] = {"tc": 1}
    elif plant == "vs_executor":
        bad["14a"][1]["vs_executor"]["ok"] = False
    else:  # a loss that falls by noise only
        for r in bad["14a"]:
            r["losses"] = [10.39009, 10.39008, 10.39008]
    assert smoke.check_parallel(bad, on_card=False)
