"""Tensor parallelism and ZeRO-1 through the port's
``CompiledProgram.with_data_parallel`` (``tensor_parallel_degree``,
``BuildStrategy.sharding_specs``, ``ParamAttr.shard_spec``,
``ReduceStrategy.Reduce``) over gloo groups of 2 (tp 2) and 4 (dp 2 x tp
2) CPU ranks (``torch_tp_workers`` on ``torch_dp_workers.pool``), held
against the JAX package: its planner (``parallel/planner.py``) on the
same programs built by each package, and its ``CompiledProgram`` on the
8-device CPU mesh (dp 4 x tp 2) from the same numpy init and global
batch.

(a) ``plan_program(...).summary()`` and the row-parallel seams
(``constraints``) equal the JAX planner's, name for name, on every
program of ``tests/test_sharding_planner.py``, the graft entry's and the
LM's, and the headline program's full-width table
(``tests/data/tp_plan_headline.json``, which ``chip_smoke.py`` phase 17a
reads). (b) The steps at the JAX tests' own limits: the MLP, Reduce
mode, the conv chain and the annotated embedding to rtol 1e-4, atol
1e-5 (the losses); the graft entry's program and the LM to rtol 2e-3,
atol 1e-4 (``test_fluid_transformer_tp_dp_mesh``'s). (c) A split on the
sharded axis. (d) The counted collectives equal the plan's prediction
and the ranks' parameters are bitwise equal. (e) The raises.
"""

import json
import pathlib
import warnings

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.parallel.planner import plan_program as jax_plan

import torch_dp_workers as W
import torch_tp_workers as T
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (the autouse fixture)
    pin_jax_init_draw as _pin_jax_init_draw)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TABLE = ROOT / "tests" / "data" / "tp_plan_headline.json"
TP2 = {"tensor_parallel_degree": 2}
TP_KINDS = ("reduce_tp", "gather_tp", "enter_tp_bwd", "zero_gather")


class _Mesh:
    """The JAX planner reads only a mesh's `shape`."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _program(fluid, name, **kw):
    return T.build(fluid, name, **kw)[0]


def _plans(name, mesh, zero=False, strategy=None, **kw):
    """(JAX plan, port plan) of builder `name` over `mesh`."""
    from paddle_tpu_torch.parallel.planner import plan_program
    import paddle_tpu_torch as pfluid

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jax_plan(_program(jfluid, name, **kw), _Mesh(mesh),
                     T.strategy_of(jfluid, strategy), zero_sharding=zero)
        p = plan_program(_program(pfluid, name, **kw), mesh,
                         T.strategy_of(pfluid, strategy),
                         zero_sharding=zero)
    return j, p


def _same(j, p):
    assert p.summary() == j.summary()
    assert sorted(p.constraints) == sorted(j.constraints)
    for n, spec in j.constraints.items():
        assert [repr(d) if d is not None else None for d in p.constraints[n]] \
            == [None if d is None else "UNCONSTRAINED" for d in spec], n


MESHES = [{"dp": 2, "tp": 2}, {"dp": 1, "tp": 4}, {"dp": 4, "tp": 2}]


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4", "4x2"])
@pytest.mark.parametrize("name,kw", [
    ("mlp", {}), ("mlp", {"emb": True}), ("annotated", {}), ("fit", {}),
    ("conv", {}), ("graft", {}), ("lm", {}), ("split", {})],
    ids=["mlp", "mlp_emb", "annotated", "fit", "conv", "graft", "lm",
         "split"])
def test_plan_equals_jax(name, kw, mesh):
    """(a) the Megatron walk, the explicit annotations, _fit's demotion
    and truncation, and the ZeRO-1 state specs, name for name."""
    for zero in (False, True):
        _same(*_plans(name, mesh, zero=zero, **kw))
    if name == "mlp" and not kw:
        j, p = _plans(name, mesh)
        assert p.summary()["tp_w1"] == (None, "tp")
        assert p.summary()["tp_w2"] == ("tp", None)   # row after column
    if name == "fit":
        j, p = _plans(name, mesh)
        assert len(p.summary()["rm_b"]) <= 1 and \
            p.summary()["rm_w"] == (None, "tp")


def test_sharding_specs_override_shard_spec():
    """(a) BuildStrategy.sharding_specs wins over ParamAttr.shard_spec."""
    kw = {"annotate": {"tp_w1": (None, "tp"), "tp_w2": (None, "tp")}}
    strategy = {"sharding_specs": {"tp_w1": ("tp", None)}}
    j, p = _plans("mlp", {"dp": 2, "tp": 2}, strategy=strategy, **kw)
    _same(j, p)
    assert p.summary()["tp_w1"] == ("tp", None)
    assert p.summary()["tp_w2"] == (None, "tp")


def test_annotations_inert_without_a_tp_axis():
    """(a) (None, "tp") on a dp-only mesh: kept with the axis dropped."""
    kw = {"annotate": {"tp_w1": (None, "tp")}}
    j, p = _plans("mlp", {"dp": 4}, **kw)
    _same(j, p)
    assert p.summary() == {"tp_w1": (None, None)}


def test_no_op_tp_degree_warns():
    """(a) a tp degree that shards nothing warns, as the JAX planner's."""
    from paddle_tpu_torch.parallel.planner import plan_program
    import paddle_tpu_torch as pfluid

    for fluid, plan in ((jfluid, lambda p, m: jax_plan(p, _Mesh(m))),
                        (pfluid, plan_program)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = plan(_program(fluid, "noop"), {"dp": 4, "tp": 2})
        assert not got.summary()
        assert any("no tp-sharded parameters" in str(w.message)
                   for w in caught)


def _headline(fluid):
    """bench.py's bench_transformer_fluid program at full width (bf16,
    remat off, the legacy AMP decorator over SGD(0.01))."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tf = __import__(fluid.__name__ + ".models.transformer_fluid",
                        fromlist=["build"])
        _, _, loss = tf.build(seq_len=512, remat=False, dtype="bfloat16")
        fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.SGD(0.01), init_loss_scaling=1.0,
            use_dynamic_loss_scaling=False).minimize(loss)
    return main


def test_headline_table_equals_jax():
    """(a) the full-width table phase 17a holds the port's plan to: the
    JAX planner's summary of the headline program at (2, 2) and (1, 4),
    and the port's equal to it."""
    from paddle_tpu_torch.parallel.planner import plan_program
    import paddle_tpu_torch as pfluid

    table = json.loads(TABLE.read_text())
    jmain, pmain = _headline(jfluid), _headline(pfluid)
    for key, mesh in (("2x2", {"dp": 2, "tp": 2}),
                      ("1x4", {"dp": 1, "tp": 4})):
        want = {n: tuple(s) for n, s in table[key].items()}
        assert jax_plan(jmain, _Mesh(mesh)).summary() == want
        assert plan_program(pmain, mesh).summary() == want
    assert len(table["2x2"]) == 6 * 11 + 2


# ---------------------------------------------------------------------------
# steps against the JAX CompiledProgram
# ---------------------------------------------------------------------------

_JAX_RUNS = {}


def jax_compiled(name, feed, steps, strategy, build_kw=None):
    """The JAX package's CompiledProgram on the 8-device mesh under
    `strategy`: (init, losses, persistables after); each run once a test
    process."""
    key = (name, steps, repr(sorted((strategy or {}).items())),
           repr(sorted((build_kw or {}).items())),
           tuple((k, v.tobytes()) for k, v in sorted(feed.items())))
    if key not in _JAX_RUNS:
        main, startup, loss = T.build(jfluid, name, **(build_kw or {}))
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
        exe.run(startup, scope=scope)
        names = sorted(v.name for v in main.global_block().vars.values()
                       if v.persistable and scope.get(v.name) is not None)
        init = {n: np.array(scope.get(n), copy=True) for n in names}
        prog = jfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name,
            build_strategy=T.strategy_of(jfluid, strategy))
        losses = [np.asarray(exe.run(prog, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]).reshape(-1)
                  for _ in range(steps)]
        after = {n: np.asarray(scope.get(n)).astype(np.float32)
                 for n in names}
        _JAX_RUNS[key] = init, losses, after
    return _JAX_RUNS[key]


def jax_init(name, build_kw=None):
    """The JAX package's startup values of `name`."""
    main, startup, _ = T.build(jfluid, name, **(build_kw or {}))
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    exe.run(startup, scope=scope)
    return {v.name: np.array(scope.get(v.name), copy=True)
            for v in main.global_block().vars.values()
            if v.persistable and scope.get(v.name) is not None}


def ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


def same_on_every_rank(results):
    """Every rank's whole persistables bitwise equal (replicated ones as
    each rank holds them, sharded ones gathered)."""
    first = results[0]["params"]
    for r in results[1:]:
        for n, v in first.items():
            np.testing.assert_array_equal(r["params"][n], v, err_msg=n)


def run_both(world, name, feed, steps, strategy, build_kw=None, **kw):
    init, jl, jafter = jax_compiled(name, feed, steps, strategy, build_kw)
    res = ok(W.pool(world).run("torch_tp_workers:train", name=name,
                               init=W.pack(init), feed=feed, steps=steps,
                               strategy=strategy, build_kw=build_kw, **kw))
    return init, jl, jafter, res


def assert_losses(res, jl, rtol, atol):
    got = [float(v[0]) for v in res[0]["losses"]]
    np.testing.assert_allclose(got, [float(v[0]) for v in jl], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("world", [2, 4])
def test_mlp_matches_jax(world):
    """(b) the auto-planned MLP, 5 Adam steps: losses and parameters to
    rtol 1e-4, atol 1e-5 of the JAX step's; the scope holds w1's column
    shard."""
    feed = T.mlp_feed()
    _, jl, jafter, res = run_both(world, "mlp", feed, 5, TP2)
    same_on_every_rank(res)
    assert_losses(res, jl, 1e-4, 1e-5)
    for n in ("tp_w1", "tp_b1", "tp_w2", "tp_b2", "tp_w3", "tp_b3"):
        np.testing.assert_allclose(res[0]["params"][n], jafter[n],
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    assert res[0]["held_rows"]["tp_w1"] == (16, 16)
    assert res[0]["summary"]["tp_w1"] == (None, "tp")


@pytest.mark.parametrize("world,strategy", [
    (2, {"reduce": True}),
    (4, {"reduce": True, "tensor_parallel_degree": 2})],
    ids=["dp2", "dp2xtp2"])
def test_reduce_mode_matches_jax(world, strategy):
    """(b) ReduceStrategy.Reduce (ZeRO-1): losses to rtol 1e-4, atol
    1e-5; every moment the plan shards over dp held as at most rows/dp
    rows of its (tp) shard, half the bytes of the same run under
    AllReduce."""
    feed = T.mlp_feed()
    _, jl, _, res = run_both(world, "mlp", feed, 5, strategy)
    same_on_every_rank(res)
    assert_losses(res, jl, 1e-4, 1e-5)
    moments = {n: s for n, s in res[0]["summary"].items() if "_moment" in n}
    assert moments and all(s[0] == "dp" for s in moments.values())
    assert sorted(res[0]["zero"]) == sorted(moments)
    plain = dict(strategy, reduce=False)
    base = ok(W.pool(world).run(
        "torch_tp_workers:train", name="mlp",
        init=W.pack(jax_init("mlp")), feed=feed,
        steps=1, strategy=plain))
    for n in moments:
        assert res[0]["held_rows"][n][0] <= base[0]["held_rows"][n][0] // 2
        assert 2 * res[0]["held_bytes"][n] == base[0]["held_bytes"][n], n


def test_conv_chain_matches_jax():
    """(b) the conv chain's channel-wise plan (column conv, bn on the
    rank's channels, row conv with its sum): losses to rtol 1e-4, atol
    1e-5."""
    feed = T.conv_feed()
    _, jl, jafter, res = run_both(2, "conv", feed, 5, TP2)
    same_on_every_rank(res)
    assert_losses(res, jl, 1e-4, 1e-5)
    specs = res[0]["summary"]
    assert ("tp", None, None, None) in specs.values()
    assert (None, "tp", None, None) in specs.values()


def test_annotated_embedding_matches_jax():
    """(b) the vocab-row embedding (auto) and an explicitly annotated
    column fc: losses to rtol 1e-4, atol 1e-5."""
    feed = T.annotated_feed()
    _, jl, _, res = run_both(2, "annotated", feed, 5, TP2)
    same_on_every_rank(res)
    assert_losses(res, jl, 1e-4, 1e-5)
    assert res[0]["summary"]["e_emb"] == ("tp", None)
    assert res[0]["summary"]["e_w1"] == (None, "tp")


def test_padding_idx_and_ignored_labels_match_jax():
    """(b) the vocab-parallel lookup with a padding_idx (its rows look up
    zeros on every rank, its grad nothing) and the vocab-parallel CE
    with ignored labels, 3 SGD steps: losses and parameters to rtol
    1e-4, atol 1e-5."""
    feed = T.edges_feed()
    _, jl, jafter, res = run_both(2, "edges", feed, 3, TP2)
    same_on_every_rank(res)
    assert_losses(res, jl, 1e-4, 1e-5)
    for n in ("pe_emb", "pe_w"):
        np.testing.assert_allclose(res[0]["params"][n], jafter[n],
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    assert res[0]["layout"] == {"pe_emb": 0, "pe_w": 1, "fc_0.b_0": 0}
    assert res[0]["seams"] == []


def test_graft_program_matches_jax():
    """(b) the graft entry's program: tp 2, Reduce and a recompute
    segment, 3 Adam steps at dp 2 x tp 2, losses to rtol 2e-3, atol
    1e-4."""
    feed = T.graft_feed()
    strategy = {"tensor_parallel_degree": 2, "reduce": True}
    _, jl, _, res = run_both(4, "graft", feed, 3, strategy)
    same_on_every_rank(res)
    assert_losses(res, jl, 2e-3, 1e-4)
    assert res[0]["zero"]


def test_lm_matches_jax():
    """(b) transformer_fluid.build(vocab 128, d 32, 4 heads, 2 layers,
    d_ff 64, seq 16, remat) at dp 2 x tp 2, 4 Adam steps: losses to
    rtol 2e-3, atol 1e-4; attention and the CE head gather nothing."""
    feed = T.lm_feed()
    _, jl, _, res = run_both(4, "lm", feed, 4, TP2)
    same_on_every_rank(res)
    assert_losses(res, jl, 2e-3, 1e-4)
    assert res[0]["seams"] == []


def test_split_on_the_sharded_axis_matches_jax():
    """(c) a column-sharded fc split into three pieces on its sharded
    axis, then a product of the pieces: losses to rtol 1e-4, atol 1e-5
    of JAX's, the split listed as a seam; a split that keeps each rank's
    columns as they lie is caught."""
    feed = T.split_feed()
    init, jl, _, res = run_both(2, "split", feed, 3, TP2)
    same_on_every_rank(res)
    assert_losses(res, jl, 1e-4, 1e-5)
    assert [s[0] for s in res[0]["seams"]] == ["split"]
    bad = ok(W.pool(2).run("torch_tp_workers:train", name="split",
                           init=W.pack(init), feed=feed, steps=3,
                           strategy=TP2, fault="local_split"))
    with pytest.raises(AssertionError):
        assert_losses(bad, jl, 1e-4, 1e-5)


@pytest.mark.parametrize("world,strategy,build_kw", [
    (4, TP2, {"remat": False}),
    (4, {"tensor_parallel_degree": 4}, {"remat": False}),
    (4, dict(TP2, reduce=True), {"remat": False}),
    (4, TP2, {"remat": False, "dtype": "bfloat16", "opt": "sgd",
              "amp": True})],
    ids=["lm_2x2", "lm_1x4", "lm_2x2_reduce", "lm_2x2_bf16_amp"])
def test_counted_collectives_equal_the_plan(world, strategy, build_kw):
    """(d) the LM's collectives, counted over 2 steps, equal twice the
    plan's prediction (the data line's all-reduces, the tp line's calls,
    ZeRO-1's gathers), calls and bytes; the ranks' parameters are
    bitwise equal; no seam."""
    feed = T.lm_feed()
    res = ok(W.pool(world).run(
        "torch_tp_workers:train", name="lm",
        init=W.pack(jax_init("lm", build_kw)),
        feed=feed, steps=2, strategy=strategy, build_kw=build_kw))
    same_on_every_rank(res)
    for r in res:
        calls, nbytes = r["expected"]
        assert (r["counts"]["all_reduce"], r["counts"]["all_reduce_bytes"]) \
            == (2 * calls, 2 * nbytes)
        got = {k: (r["counts"][k], r["counts"][k + "_bytes"])
               for k in TP_KINDS if r["counts"][k]}
        want = {k: (2 * c, 2 * b) for k, (c, b) in r["expected_tp"].items()}
        assert got == want
        assert r["seams"] == []
    assert "reduce_tp" in res[0]["expected_tp"]


def test_pipeline_and_sequence_parallel_raise_naming_item_9():
    """(e) sequence_parallel_degree above 1, alone or with
    pipeline_stages (which alone is ported:
    tests/test_torch_pipeline_program.py)."""
    from paddle_tpu_torch.compiler import BuildStrategy, check_build_strategy

    for knobs in ({"sequence_parallel_degree": 2},
                  {"sequence_parallel_degree": 2, "pipeline_stages": 2}):
        bs = BuildStrategy()
        for knob, value in knobs.items():
            setattr(bs, knob, value)
        with pytest.raises(NotImplementedError, match="item 9"):
            check_build_strategy(bs)
    bs = BuildStrategy()
    bs.pipeline_stages = 2
    check_build_strategy(bs)
    bs = BuildStrategy()
    bs.tensor_parallel_degree = 2
    bs.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
    bs.sharding_specs = {"w": (None, "tp")}
    check_build_strategy(bs)


def test_int8_matmul_on_a_shard_raises_at_plan_time():
    """(e) fused_int8_matmul reading a tp-sharded weight raises at plan
    time, naming itself."""
    import paddle_tpu_torch as pfluid
    from paddle_tpu_torch.parallel.planner import (DataParallelError,
                                                   plan_batch)

    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        x = pfluid.layers.data(name="x", shape=[16], dtype="float32")
        blk = main.global_block()
        w = blk.create_var(name="w_int8", shape=(16, 8), dtype="int8",
                           persistable=True)
        s = blk.create_var(name="w_scale", shape=(8,), dtype="float32",
                           persistable=True)
        out = blk.create_var(name="out", shape=(-1, 8), dtype="float32")
        blk.append_op(type="fused_int8_matmul",
                      inputs={"X": [x], "Y": [w], "Scale": [s]},
                      outputs={"Out": [out]}, attrs={"act_scale": 1.0})
    with pytest.raises(DataParallelError, match="fused_int8_matmul"):
        plan_batch(main, ["x"], 1, tp=2, layout={"w_int8": 1}, rows=8)


def test_a_scope_of_shards_refuses_saves_and_plain_runs():
    """(e) io.save_persistables of a scope holding shards raises, naming
    item 9's multi-process save, and a plain Executor.run on it raises
    (it would read the shards as whole tensors); a no-op tp degree warns
    in the step."""
    msgs = W.pool(2).run("torch_tp_workers:raises", name="mlp",
                         feed=T.mlp_feed(), strategy=TP2, then="save")
    for m in msgs:
        assert m is not None and "multi-process checkpoint save" in m \
            and "item 9" in m
    msgs = W.pool(2).run("torch_tp_workers:raises", name="mlp",
                         feed=T.mlp_feed(), strategy=TP2, then="plain")
    for m in msgs:
        assert m is not None and "reads whole" in m
    res = ok(W.pool(2).run("torch_tp_workers:train", name="noop", init={},
                           feed={"nw_x": np.ones((8, 7), np.float32)},
                           steps=1, strategy=TP2))
    assert any("no tp-sharded parameters" in w for w in res[0]["warnings"])
