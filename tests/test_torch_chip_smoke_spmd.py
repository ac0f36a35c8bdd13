"""chip_smoke.py's phase 16 (the SPMD Transformer trainer) without the
card: its legs on the CPU at a small size — 16a and 16b in this process
(world 1), 16c's rank code over gloo ranks of 2 and 4
(``torch_dp_workers``) — and its gates, with planted faults
(``torch_spmd_workers.plant``), each of which must fail its gate:

  * a grad leaf not summed over pp (the pipeline legs);
  * a reduce_scatter whose backward does not all-gather (the tp legs);
  * an all_to_all backward sent the wrong way (the MoE legs, dp = 2);
  * a pipeline that drops the last microbatch's grad;
  * a rank that creates the mesh's groups in another order, which must
    fail with MeshGroupOrderError within a timeout, not hang;
  * an all_gather forward that concatenates the ranks in reverse order,
    and an all_to_all forward sent the wrong way: the full-width leg's
    own first loss, against the plain reference, must fail.

The full-width legs run at vocab 64, d_model 32, 4 heads, d_ff 64,
batch 8, seq 16 here (their depths and meshes kept); the twins at
chip_smoke's own size."""

import copy
import importlib.util
import pathlib

import pytest

import torch_dp_workers as W
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIDTH = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64)
RANK_KW = dict(batch=8, seq=16, warmup=1, steps=1, width=WIDTH)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_spmd_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


@pytest.fixture(scope="module")
def world1(smoke):
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    small = dict(WIDTH, n_layers=2)
    return {
        "train": smoke.spmd_train_leg(torch, fa, device="cpu", batch=8,
                                      seq=16, warmup=1, steps=2, **small),
        "moe": smoke.spmd_train_leg(torch, fa, device="cpu", batch=8,
                                    seq=16, warmup=0, steps=4, n_experts=4,
                                    **small),
        "cvc": smoke.spmd_card_vs_cpu(torch, fa, devices=("cpu", "cpu"),
                                      batch=2, seq=16),
    }


@pytest.fixture(scope="module")
def multi():
    return {world: _ok(W.pool(world).run(
        "torch_spmd_workers:smoke_spmd_rank", **RANK_KW))
        for world in (2, 4)}


def test_world1_legs_pass_their_gates(smoke, world1):
    for name in ("train", "moe"):
        smoke.check_spmd_train_leg(world1[name], on_card=False)
    leg, moe = world1["train"], world1["moe"]
    assert leg["ref_loss"] is not None and leg["step_flops"] > 0
    assert moe["ref_loss"] is not None
    assert (leg["embed_calls"], leg["head_calls"]) == (3, 3)
    calls = moe["collective_calls_per_step"]
    # one MoE block, remat: 2 exchanges, 2 again in the recompute, 2 back
    assert (calls["all_to_all"], calls["all_to_all_bwd"]) == (4, 2)
    # world 1: each collective the identity, still counted
    assert calls["axis_gather"] == 4 * 2 and calls["psum"] == 5
    assert world1["cvc"]["ok"], world1["cvc"]


@pytest.mark.parametrize("name,key,value", [
    ("train", "losses", [5.0, 5.1, 5.2]),
    ("train", "ref_loss", 4.0),
    ("moe", "ref_loss", 4.0),
    ("train", "head_calls", 2),
    ("moe", "collective_calls_per_step", {"all_to_all": 2,
                                          "all_to_all_bwd": 2}),
])
def test_world1_gates_fail_wrong_legs(smoke, world1, name, key, value):
    leg = dict(copy.deepcopy(world1[name]), **{key: value})
    with pytest.raises(SystemExit):
        smoke.check_spmd_train_leg(leg, on_card=False)


def test_world1_k1_gate_reads_the_schedule(smoke, world1):
    """On the card the gate wants K1's forward 2L and backward L a step
    (remat) by the "tc" route: the CPU's zero launches fail it."""
    with pytest.raises(SystemExit):
        smoke.check_spmd_train_leg(world1["train"], on_card=True)


@pytest.mark.parametrize("world", [2, 4])
def test_rank_legs_pass_their_gates(smoke, multi, world):
    res = multi[world]
    assert smoke.check_spmd_ranks(res, on_card=False) == []
    assert sorted(res[0]["legs"]) == sorted(
        name for name, *_ in smoke.SPMD_LEGS[world])
    for r in res:
        for name, leg in r["legs"].items():
            assert leg["twin"]["loss_rel_err"] <= smoke.SPMD_LOSS_RTOL
            assert leg["twin"]["worst_leaf_ratio"] <= smoke.SPMD_PARAM_RATIO


@pytest.mark.parametrize("fix", ["embed_off_stage", "stash", "losses",
                                 "k1_on_card", "ref_loss", "not_falling"])
def test_rank_gates_fail_wrong_results(smoke, multi, fix):
    res = copy.deepcopy(multi[4])
    pipe = [r["legs"]["pipe_1x4x1"] for r in res]
    on_card = False
    if fix == "embed_off_stage":
        pipe[1]["counts"]["embed"] = 1
    elif fix == "stash":
        pipe[0]["twin"]["counts"]["stash_peak"] = 9
    elif fix == "losses":
        pipe[2]["losses"][0] += 1e-3
    elif fix == "ref_loss":
        for leg in pipe:
            leg["ref_loss"] *= 1.01
    elif fix == "not_falling":
        for leg in pipe:
            leg["losses"][-1] = leg["losses"][0]
    else:
        on_card = True
    assert smoke.check_spmd_ranks(res, on_card=on_card) != []


FAULTS = [("no_pp_sum", 2, "pipe_1x2x1"), ("no_pp_sum", 4, "dense_1x2x2"),
          ("scatter_bwd_local", 2, "dense_1x1x2"),
          ("scatter_bwd_local", 4, "dense_1x2x2"),
          ("a2a_bwd_reversed", 2, "moe_2x1x1"),
          ("a2a_bwd_reversed", 4, "moe_2x1x2"),
          ("drop_last_microbatch", 2, "pipe_1x2x1"),
          ("drop_last_microbatch", 4, "pipe_1x4x1")]


@pytest.mark.parametrize("fault,world,name", FAULTS)
def test_planted_fault_fails_its_gate(smoke, fault, world, name):
    legs = [leg for leg in smoke.SPMD_LEGS[world] if leg[0] == name]
    res = _ok(W.pool(world).run("torch_spmd_workers:smoke_spmd_rank",
                                fault=fault, legs=legs, **RANK_KW))
    bad = smoke.check_spmd_ranks(res, on_card=False)
    assert any("twin" in b for b in bad), bad
    assert all(b.startswith(name) for b in bad), bad


FWD_FAULTS = [("gather_fwd_reversed", 2, "dense_1x1x2"),
              ("gather_fwd_reversed", 4, "dense_1x2x2"),
              ("a2a_fwd_reversed", 4, "moe_2x1x2")]


@pytest.mark.parametrize("fault,world,name", FWD_FAULTS)
def test_planted_forward_fault_fails_the_reference_gate(smoke, fault, world,
                                                        name):
    """A collective wrong in the forward shows in the leg's own first
    loss against the plain reference, which uses no collective."""
    legs = [leg for leg in smoke.SPMD_LEGS[world] if leg[0] == name]
    res = _ok(W.pool(world).run("torch_spmd_workers:smoke_spmd_rank",
                                fault=fault, legs=legs, **RANK_KW))
    bad = smoke.check_spmd_ranks(res, on_card=False)
    assert any("plain reference" in b for b in bad), bad
    assert all(b.startswith(name) for b in bad), bad


@pytest.mark.parametrize("world", [2, 4])
def test_groups_in_another_order_fail_named(world):
    res = W.pool(world).run("torch_spmd_workers:smoke_spmd_rank",
                            fault="group_order", timeout=60, **RANK_KW)
    for r in res:
        assert "MeshGroupOrderError" in r["error"], r
