"""The port's SPMD Transformer trainer (``paddle_tpu_torch.parallel.
transformer``) held against the JAX package's on the CPU: the port on
gloo ranks (``torch_dp_workers.pool``; world 1 in this process), the JAX
``SPMDTrainer`` on the conftest's virtual 8-device mesh, both from the
JAX ``init_params`` tree (carried across as numpy) on the same numpy
batch, at the JAX suite's small config (vocab 64, d_model 32, 4 heads, 4
layers, d_ff 64, seq 16, fp32).

  * (a) `_block_sp` at tp = 2 and `_moe_block` at ep = 2 on each rank's
    shard: the output and the grads of sum(out * cot) against the JAX
    functions' under ``shard_map``; the MoE block picks the same experts
    and drops the same tokens (capacity factor 0.5, so some drop);
  * (b) the trainer at meshes (1, 1, 1), (1, 1, 2), (2, 1, 1), (1, 2, 1)
    at M = 2 and M = 4 and with untied embeddings, (1, 2, 2), and
    (2, 1, 2) with 4 experts: 3 steps, every loss and every parameter
    leaf after them (gathered) against the JAX trainer's at that mesh;
  * (c) cross-mesh parity inside the port, as
    ``test_spmd_transformer.py::test_mesh_parity``;
  * (d) the pipeline's structure from counters: the embedding only on
    stage 0, the vocab head only on the last stage, the stash at most
    2·pp inputs (exactly min(M, 2pp - 1 - 2r) on stage r);
  * (e) the MoE leg trains (its loss falls over 8 steps at (2, 2, 1));
    a shape that breaks a divisibility rule raises naming it; a rank
    that would create the mesh's groups in another order raises
    MeshGroupOrderError on every rank instead of hanging; the trainer's
    mesh builds groups only for the unions of axes it sums over;
  * the trainer's state through ``checkpoint.py``: gathered, saved from
    rank 0 at (2, 1, 2) and restored into fresh trainers at (1, 2, 1)
    and (1, 1, 1), whose next loss is the original trainer's.

Limits (fp32): the port against the JAX trainer at one mesh is one
computation in another summation order (losses measured within 6e-7
relative), so losses are held to LOSS_RTOL = 1e-5; across meshes the
JAX suite's own 2e-3. Parameters after the steps: each leaf's
difference, in the 2-norm, within PARAM_RATIO = 1% of the leaf's whole
move over the steps. Adam moves every element by about lr whatever its
grad's size, so an element whose grad is a near-cancelling sum may land
a fraction of lr off (one element in 36,288 by 4e-4 at lr 1e-2 here);
the norm ratio stays under 2.1e-4, and a grad summed over too few ranks
or microbatches moves whole leaves off (``test_torch_chip_smoke_spmd``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.core.jax_compat import shard_map
from paddle_tpu.models import transformer as JT
from paddle_tpu.parallel import transformer as JP

import torch_dp_workers as W
import torch_spmd_workers as S
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

LR = 1e-2
LOSS_RTOL = 1e-5
CROSS_MESH_RTOL = 2e-3       # tests/test_spmd_transformer.py:41
PARAM_RATIO = 1e-2
STEPS = 3

# name -> (world, mesh, microbatches, config overrides)
CASES = {
    "1x1x1": (1, (1, 1, 1), None, {}),
    "1x1x2": (2, (1, 1, 2), None, {}),
    "2x1x1": (2, (2, 1, 1), None, {}),
    "1x2x1_m2": (2, (1, 2, 1), 2, {}),
    "1x2x1_m4": (2, (1, 2, 1), 4, {}),
    "1x2x1_untied": (2, (1, 2, 1), 2, {"tie_embeddings": False}),
    "1x2x2": (4, (1, 2, 2), None, {}),
    "2x1x2_moe": (4, (2, 1, 2), None, {"n_experts": 4}),
}
DENSE_TIED = [n for n, c in CASES.items()
              if not c[3] and n != "1x1x1"]


def _data(seed=0, batch=8):
    toks = np.random.RandomState(seed).randint(
        0, S.SMALL["vocab_size"], (batch, S.SMALL["max_seq_len"])).astype(
            np.int32)
    return toks, np.roll(toks, -1, axis=1).astype(np.int32)


def _jcfg(**over):
    kw = dict(S.SMALL, **over)
    kw["dtype"] = jnp.float32
    return JT.TransformerConfig(**kw)


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in S.flat(tree).items()}


def _ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def jax_runs(data):
    """Each case's JAX trainer: (initial params, losses, params after)."""
    toks, labs = data
    out = {}
    for name, (world, shape, M, over) in CASES.items():
        tr = JP.SPMDTrainer(_jcfg(**over), mesh_shape=shape,
                            num_microbatches=M, learning_rate=LR,
                            devices=jax.devices()[:world])
        state = tr.init(0)
        start = _np_tree(state[0])
        losses = []
        for _ in range(STEPS):
            state, loss = tr.step(state, toks, labs)
            losses.append(float(loss))
        out[name] = (start, losses, _np_tree(state[0]))
    return out


@pytest.fixture(scope="module")
def port_runs(jax_runs, data):
    """Each case's port trainer from the JAX case's initial tree: the
    first rank's result and every rank's trainer counts and coords."""
    toks, labs = data
    out = {}
    for name, (world, shape, M, over) in CASES.items():
        kw = dict(cfg=over, shape=shape, params=jax_runs[name][0],
                  tokens=toks, labels=labs, steps=STEPS, M=M, lr=LR)
        if world == 1:
            res = [S.train(**kw)]
        else:
            res = _ok(W.pool(world).run("torch_spmd_workers:train", **kw))
        out[name] = res
    return out


def _leaf_ratio(got, ref, start):
    worst = (0.0, "")
    for k in ref:
        move = float(np.linalg.norm(ref[k] - start[k]))
        diff = float(np.linalg.norm(got[k] - ref[k]))
        worst = max(worst, (diff / move if move else diff, k))
    return worst


@pytest.mark.parametrize("name", list(CASES))
def test_trainer_matches_jax_at_the_same_mesh(name, jax_runs, port_runs):
    start, losses, params = jax_runs[name]
    got = port_runs[name][0]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    assert sorted(got["params"]) == sorted(params)
    ratio, leaf = _leaf_ratio(got["params"], params, start)
    assert ratio <= PARAM_RATIO, (leaf, ratio)
    # every rank reports the one global loss
    assert all(r["losses"] == got["losses"] for r in port_runs[name])


@pytest.mark.parametrize("name", DENSE_TIED)
def test_cross_mesh_parity_in_the_port(name, jax_runs, port_runs):
    base = port_runs["1x1x1"][0]
    got = port_runs[name][0]
    np.testing.assert_allclose(got["losses"], base["losses"],
                               rtol=CROSS_MESH_RTOL)
    ratio, leaf = _leaf_ratio(got["params"], base["params"],
                              jax_runs[name][0])
    assert ratio <= PARAM_RATIO, (leaf, ratio)


@pytest.mark.parametrize("name", list(CASES))
def test_stage_structure_from_counters(name, port_runs):
    """The structure pipeline_debug.py reads from the lowering and
    test_pipeline_1f1b.py checks: embedding only on stage 0 (forward and
    backward units: 2M a step), the vocab head only on the last stage (M
    a step), the stash of stage inputs at most 2·pp."""
    world, (dp, pp, tp), M, _ = CASES[name]
    M = M or pp
    for r in port_runs[name]:
        c, stage = r["trainer_counts"], r["coords"][1]
        if pp == 1:
            assert (c["embed"], c["head"], c["stash_peak"]) == (
                STEPS, STEPS, 0), c
            continue
        assert c["embed"] == (2 * M * STEPS if stage == 0 else 0), c
        assert c["head"] == (M * STEPS if stage == pp - 1 else 0), c
        assert c["stash_peak"] == min(M, 2 * pp - 1 - 2 * stage) <= 2 * pp
        # one send/receive batch a tick with a pending exchange
        assert r["counts"]["send_recv"] > 0


def test_stash_stays_o_pp_not_o_m(data):
    """M = 8 microbatches at pp = 2 (test_pipeline_1f1b's
    test_stash_is_opp_not_om): stage 0 holds 3 = 2pp - 1 inputs at once,
    not 8."""
    toks, labs = _data(batch=16)
    params = _np_tree(JT.init_params(jax.random.PRNGKey(0), _jcfg()))
    res = _ok(W.pool(2).run("torch_spmd_workers:train", cfg={},
                            shape=(1, 2, 1), params=params, tokens=toks,
                            labels=labs, steps=1, M=8))
    assert [r["trainer_counts"]["stash_peak"] for r in res] == [3, 1]


# -- (a) the building blocks under shard_map ---------------------------------


def _jax_local(fn, mesh, axis, in_specs, *args):
    """Each rank's (out, param grads, input grad) of sum(fn(p, h) * cot)
    under shard_map over `axis`, stacked on a new leading axis."""
    def local(p, h, cot):
        out, vjp = jax.vjp(fn, p, h)
        gp, gh = vjp(cot)
        add = lambda x: x[None]  # noqa: E731
        return add(out), jax.tree.map(add, gp), add(gh)

    stacked = P(axis)
    out = jax.jit(shard_map(local, mesh=mesh, in_specs=in_specs,
                            out_specs=(stacked, jax.tree.map(
                                lambda _: stacked, in_specs[0],
                                is_leaf=lambda x: isinstance(x, P)),
                                stacked),
                            check_vma=False))(*args)
    return jax.tree.map(np.asarray, out)


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= 1e-5, (what, err)


def test_block_sp_matches_jax_at_tp2():
    cfg = _jcfg()
    layers = JT.init_params(jax.random.PRNGKey(3), cfg)["layers"]
    lp = {k: np.asarray(v[0]) for k, v in layers.items()}
    rng = np.random.RandomState(4)
    h = rng.randn(2, 16, 32).astype(np.float32)
    cot = rng.randn(2, 16, 32).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 1, 2),
                ("dp", "pp", "tp"))
    specs = {k: P(*s[1:]) for k, s in JP.param_specs(cfg)["layers"].items()}
    seq = P(None, "tp", None)
    out, gp, gh = _jax_local(lambda p, x: JP._block_sp(p, x, cfg), mesh,
                             "tp", (specs, seq, seq), lp, h, cot)
    res = _ok(W.pool(2).run("torch_spmd_workers:module", kind="block",
                            cfg={}, params=lp, h=h, cot=cot))
    for r, got in enumerate(res):
        _close(got["out"], out[r], "out@%d" % r)
        _close(got["h_grad"], gh[r], "h_grad@%d" % r)
        assert sorted(got["grads"]) == sorted(gp)
        for k in gp:
            _close(got["grads"][k], gp[k][r], "%s@%d" % (k, r))


def test_moe_block_matches_jax_at_ep2():
    """Same experts picked, same tokens dropped (capacity factor 0.5 on
    each rank's 32 tokens: a capacity of 5 of 8 a expert would take on
    average), same output and grads."""
    over = dict(n_experts=4, expert_capacity_factor=0.5)
    cfg = _jcfg(**over)
    mp = {k: np.asarray(v) for k, v in JT.init_params(
        jax.random.PRNGKey(5), cfg)["moe"].items()}
    rng = np.random.RandomState(6)
    h = rng.randn(4, 16, 32).astype(np.float32)
    cot = rng.randn(4, 16, 32).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1, 1),
                ("dp", "pp", "tp"))
    specs = {"router": P(), "w1": P("dp"), "w2": P("dp")}
    out, gp, gh = _jax_local(lambda p, x: JP._moe_block(p, x, cfg), mesh,
                             "dp", (specs, P("dp"), P("dp")), mp, h, cot)
    res = _ok(W.pool(2).run("torch_spmd_workers:module", kind="moe",
                            cfg=over, params=mp, h=h, cot=cot))
    dropped = 0
    for r, got in enumerate(res):
        # the JAX function's routing lines on this rank's tokens
        x = jnp.asarray(h[2 * r:2 * r + 2].reshape(-1, 32))
        gates = jax.nn.softmax(x @ jnp.asarray(mp["router"]))
        expert = jnp.argmax(gates, axis=-1)
        cap = int(cfg.expert_capacity_factor * x.shape[0] / 4) + 1
        onehot = jax.nn.one_hot(expert, 4, dtype=jnp.int32)
        keep = (jnp.cumsum(onehot, axis=0) * onehot - 1).max(-1) < cap
        assert got["cap"] == cap
        np.testing.assert_array_equal(got["expert"], np.asarray(expert))
        np.testing.assert_array_equal(got["keep"], np.asarray(keep))
        dropped += int((~np.asarray(keep)).sum())
        _close(got["out"], out[r], "out@%d" % r)
        _close(got["h_grad"], gh[r], "h_grad@%d" % r)
        for k in gp:
            _close(got["grads"][k], gp[k][r], "%s@%d" % (k, r))
    assert dropped > 0


# -- (e) faults ---------------------------------------------------------------


def test_moe_expert_parallel_trains(data):
    """test_spmd_transformer.py's MoE leg at world 4: (2, 2, 1), 4
    experts, remat, M = 2, 8 steps; the loss falls."""
    toks, labs = _data(seed=1)
    cfg = _jcfg(n_experts=4, remat=True)
    params = _np_tree(JT.init_params(jax.random.PRNGKey(0), cfg))
    res = _ok(W.pool(4).run("torch_spmd_workers:train",
                            cfg={"n_experts": 4, "remat": True},
                            shape=(2, 2, 1), params=params, tokens=toks,
                            labels=labs, steps=8, M=2, lr=1e-3))
    losses = res[0]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("over,shape,rule", [
    ({}, (1, 3, 1), "pp \\(3\\) must divide n_layers"),
    ({}, (1, 1, 3), "tp \\(3\\) must divide n_heads"),
    ({"max_seq_len": 15}, (1, 1, 2), "tp \\(2\\) must divide max_seq_len"),
    ({"n_experts": 4}, (3, 1, 1), "dp \\(3\\) must divide n_experts"),
])
def test_divisibility_rules_raise(over, shape, rule):
    from paddle_tpu_torch.parallel.transformer import SPMDTrainer

    with pytest.raises(ValueError, match=rule):
        SPMDTrainer(S.config(**over), mesh_shape=shape, device="cpu")


def test_world_size_must_equal_the_mesh():
    res = W.pool(2).run("torch_spmd_workers:mesh_fault", shape=(2, 2, 1),
                        fault=None)
    assert all("world size (2) must equal dp·pp·tp = 4" in r for r in res)


def test_groups_in_another_order_raise_not_hang():
    res = W.pool(2).run("torch_spmd_workers:mesh_fault", shape=(1, 1, 2),
                        fault="group_order", timeout=60)
    assert all(r.startswith("MeshGroupOrderError: ranks [1]") for r in res)
    # the ranks are still in step: a mesh comes up after it
    assert W.pool(2).run("torch_spmd_workers:mesh_fault", shape=(1, 1, 2),
                         fault=None, timeout=60) == [None, None]


@pytest.mark.parametrize("experts,unions", [
    (0, [("dp",), ("pp",), ("tp",), ("dp", "tp"), ("dp", "pp", "tp")]),
    (4, [("dp",), ("pp",), ("tp",), ("dp", "tp"), ("pp", "tp"),
         ("dp", "pp", "tp")]),
])
def test_trainer_mesh_builds_only_the_unions_it_sums_over(experts, unions):
    """The mesh's groups: the single axes, the loss's three, and the
    unions the grad leaves are replicated on; no group over (dp, pp),
    which no leaf is summed over, and asking for one raises."""
    from paddle_tpu_torch.parallel import mesh
    from paddle_tpu_torch.parallel.transformer import SPMDTrainer

    tr = SPMDTrainer(S.config(n_experts=experts), device="cpu")
    assert tr.mesh.unions == unions
    with pytest.raises(ValueError, match="groups over"):
        tr.mesh.group(("pp", "dp"))
    assert tr.mesh.group(("tp", "dp")).ranks == (0,)
    plan = mesh.group_plan((2, 2, 2), unions)
    assert len(plan) == 3 * 4 + 2 + 2 * (experts > 0) + 1
    assert ("dp", "pp") not in {axes for axes, _ in plan}
    with pytest.raises(ValueError, match="distinct names"):
        mesh.mesh_unions([("dp", "xp")])


def test_the_card_is_the_default_device():
    import torch

    from paddle_tpu_torch.parallel.transformer import SPMDTrainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        SPMDTrainer(S.config())


# -- the trainer's state through checkpoint.py --------------------------------


def test_sharded_trainer_state_roundtrip(tmp_path, data):
    """tests/test_checkpoint.py's test_sharded_trainer_state_roundtrip
    across meshes: one step at (2, 1, 2), the state (params, m, v, step)
    gathered and saved from rank 0, the original's next loss; the
    checkpoint restored into fresh trainers at (1, 2, 1) and (1, 1, 1),
    whose next loss equals it within the cross-mesh limit."""
    toks, labs = data
    params = _np_tree(JT.init_params(jax.random.PRNGKey(0), _jcfg()))
    res = _ok(W.pool(4).run("torch_spmd_workers:checkpoint_roundtrip",
                            cfg={}, shape=(2, 1, 2), params=params,
                            tokens=toks, labels=labs,
                            directory=str(tmp_path)))
    want = res[0]["loss"]
    restored = _ok(W.pool(2).run("torch_spmd_workers:restore_step", cfg={},
                                 shape=(1, 2, 1), tokens=toks, labels=labs,
                                 directory=str(tmp_path)))
    restored.append(S.restore_step(cfg={}, shape=(1, 1, 1), tokens=toks,
                                   labels=labs, directory=str(tmp_path)))
    for r in restored:
        assert r["step"] == 2
        np.testing.assert_allclose(r["loss"], want, rtol=CROSS_MESH_RTOL)
