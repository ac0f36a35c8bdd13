"""Data-parallel training on the port (``compiler.CompiledProgram.
with_data_parallel``, ``ParallelExecutor``) over gloo groups of 2 and 4
CPU ranks (``torch_dp_workers``), held against the JAX package's
``ParallelExecutor`` on the 8-device CPU mesh from the same numpy init
and global batch: with any world size a step gives what one device
gives on the global batch.

Limits: the MLP's losses and parameters to rtol 1e-4, atol 1e-6
(``tests/test_parallel_executor.py``'s own); fp32 steps of the other
programs to ``chip_smoke.STEP_TOL["float32"]`` (losses 1e-5, grads 1e-3
of each tensor's largest) and moving statistics to 1e-5 of their
largest; the bf16 LM to ``STEP_TOL["bfloat16"]``'s loss_rtol and within
2 bf16 ulps plus 2^-7 of the largest update for each parameter (the
bound ``tests/test_torch_train.py`` derives for the single-device
step). The ranks' parameters are bitwise equal to each other.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.scope import Scope as JScope

import torch_dp_workers as W
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (the autouse fixture)
    pin_jax_init_draw as _pin_jax_init_draw)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _step_tol():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tol", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.STEP_TOL


STEP_TOL = _step_tol()


_JAX_RUNS = {}


def jax_pe(name, feed, steps=2, build_kw=None, fetch_grads=(),
           strategy=None):
    """The JAX package's ParallelExecutor on the 8-device mesh: (init,
    losses, grads per step, persistables after); each run once a test
    process (the cases share them)."""
    key = (name, steps, repr(sorted((build_kw or {}).items())),
           tuple(fetch_grads), repr(sorted((strategy or {}).items())),
           tuple((k, v.tobytes()) for k, v in sorted(feed.items())))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _jax_pe(name, feed, steps, build_kw, fetch_grads,
                                 strategy)
    return _JAX_RUNS[key]


def _jax_pe(name, feed, steps, build_kw, fetch_grads, strategy):
    main, startup, loss = W.build(jfluid, name, **(build_kw or {}))
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    exe.run(startup, scope=scope)
    names = sorted(v.name for v in main.global_block().vars.values()
                   if v.persistable and scope.get(v.name) is not None)
    init = {n: np.array(scope.get(n), copy=True) for n in names}
    bs = None
    if strategy:
        bs = jfluid.BuildStrategy()
        for k, v in strategy.items():
            setattr(bs, k, getattr(
                jfluid.BuildStrategy.GradientScaleStrategy, v)
                if k == "gradient_scale_strategy" else v)
    pe = jfluid.ParallelExecutor(loss_name=loss.name, main_program=main,
                                 scope=scope, build_strategy=bs)
    assert pe.device_count == 8
    losses, grads = [], []
    for _ in range(steps):
        out = pe.run([loss.name] + list(fetch_grads), feed=feed)
        losses.append(np.asarray(out[0]).reshape(-1))
        grads.append([np.asarray(g).astype(np.float32) for g in out[1:]])
    after = {n: np.asarray(scope.get(n)).astype(np.float32) for n in names}
    return init, losses, grads, after


def ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


def same_on_every_rank(results):
    first = results[0]["params"]
    for r in results[1:]:
        for n, v in first.items():
            np.testing.assert_array_equal(r["params"][n], v, err_msg=n)


def close_rel(got, want, rtol, what):
    """|got - want| <= rtol * max|want| (each tensor against its
    largest)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    lim = rtol * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= lim, "%s: %g > %g" % (what, err, lim)


@pytest.mark.parametrize("world", [2, 4])
def test_mlp_matches_jax_parallel_executor(world):
    """(a) the MLP, 5 SGD steps at world 2 and 4."""
    feed = W.mlp_feed(0)
    init, jl, _, jafter = jax_pe("mlp", feed, steps=5)
    res = ok(W.pool(world).run("train", name="mlp", init=W.pack(init),
                               feed=feed, steps=5))
    same_on_every_rank(res)
    got = [float(v[0]) for v in res[0]["losses"]]
    np.testing.assert_allclose(got, [float(v[0]) for v in jl], rtol=1e-4,
                               atol=1e-6)
    for n in ("pw1", "pb1", "pw2", "pb2"):
        np.testing.assert_allclose(res[0]["params"][n], jafter[n],
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    # one all-reduce for the mean and one a parameter's grad, as planned
    calls, nbytes = res[0]["expected"]
    assert calls == 5
    assert res[0]["counts"]["all_reduce"] == 5 * calls
    assert res[0]["counts"]["all_reduce_bytes"] == 5 * nbytes


def test_compiled_program_equals_parallel_executor():
    """Executor.run of CompiledProgram.with_data_parallel is the
    ParallelExecutor's step."""
    feed = W.mlp_feed(3)
    init, *_ = jax_pe("mlp", feed, steps=1)
    pe = ok(W.pool(2).run("train", name="mlp", init=W.pack(init),
                          feed=feed, steps=3))
    cp = ok(W.pool(2).run("train", name="mlp", init=W.pack(init),
                          feed=feed, steps=3, runner="compiled"))
    for a, b in zip(pe[0]["losses"], cp[0]["losses"]):
        np.testing.assert_array_equal(a, b)


def test_share_vars_from():
    """(b) a test program's ParallelExecutor built with share_vars_from
    reads the training one's parameters."""
    feed = W.mlp_feed(1)
    init, *_ = jax_pe("mlp", feed, steps=1)
    res = ok(W.pool(2).run("share_vars", init=W.pack(init), feed=feed))
    assert res[0]["device_count"] == 2
    np.testing.assert_allclose(res[0]["pe"], res[0]["exe"], rtol=1e-5)
    assert res[0]["pe"] == res[1]["pe"]


def test_indivisible_batch_is_replicated_with_no_collective():
    """(c) 5 rows over 2 ranks: the feed is used whole on every rank and
    the step runs no collective."""
    feed = W.mlp_feed(2, rows=5)
    init, jl, _, _ = jax_pe("mlp", feed, steps=1)
    res = ok(W.pool(2).run("train", name="mlp", init=W.pack(init),
                           feed=feed, steps=1))
    np.testing.assert_allclose(res[0]["losses"][0], jl[0], rtol=1e-4)
    assert res[0]["counts"]["all_reduce"] == 0
    assert res[0]["expected"] == (0, 0)


@pytest.fixture(scope="module")
def convbn():
    feed = W.convbn_feed(0)
    grads = ("conv2d_0.w_0@GRAD", "fc_0.w_0@GRAD")
    jax = jax_pe("convbn", feed, steps=2, fetch_grads=grads)
    return feed, grads, jax


@pytest.mark.parametrize("world", [2, 4])
def test_batch_norm_classifier_matches_jax(convbn, world):
    """(d) conv + batch_norm + pool + fc under Adam, two steps: loss and
    grads to fp32 STEP_TOL, the moving mean and variance (global
    statistics) to 1e-5 of their largest."""
    feed, grads, (init, jl, jg, jafter) = convbn
    tol = STEP_TOL["float32"]
    res = ok(W.pool(world).run("train", name="convbn", init=W.pack(init),
                               feed=feed, steps=2, fetch_grads=grads))
    same_on_every_rank(res)
    for s in range(2):
        np.testing.assert_allclose(res[0]["losses"][s], jl[s],
                                   rtol=tol["loss_rtol"])
        for g, (got, want) in enumerate(zip(res[0]["grads"][s], jg[s])):
            close_rel(got, want, tol["grad_rtol"], grads[g])
    for n in ("batch_norm_0.w_1", "batch_norm_0.w_2"):
        close_rel(res[0]["params"][n], jafter[n], 1e-5, n)
        assert not np.allclose(jafter[n], init[n])  # they moved
    # the moments' all-reduce and their cotangent's, the mean's, and one
    # a parameter's grad (conv filter, bn scale and bias, fc w and b)
    calls, nbytes = res[0]["expected"]
    assert calls == 2 + 1 + 5
    assert res[0]["counts"]["all_reduce"] == 2 * calls
    assert res[0]["counts"]["all_reduce_bytes"] == 2 * nbytes


@pytest.mark.parametrize("dtype,amp,world", [
    pytest.param("float32", False, 2, id="float32-False"),
    pytest.param("float32", False, 4, id="float32-False-world4"),
    pytest.param("bfloat16", True, 2, id="bfloat16-True")])
def test_lm_matches_jax(dtype, amp, world):
    """(e) the Fluid LM at 2 layers, narrow, two SGD steps: in fp32 at
    world 2 and 4 (two rows a rank), and in bf16 under the headline's
    legacy AMP at world 2 (gloo reduces bf16, so its grads all-reduce
    in bf16). The loss divides by reduce_prod(shape(labels)): (i) the
    global token count."""
    feed = W.lm_feed(0)
    kw = dict(dtype=dtype, amp=amp)
    init, jl, _, jafter = jax_pe("lm", feed, steps=2, build_kw=kw)
    res = ok(W.pool(world).run("train", name="lm", init=W.pack(init),
                               feed=feed, steps=2, build_kw=kw))
    same_on_every_rank(res)
    got = res[0]["params"]
    tol = STEP_TOL[dtype]
    for s in range(2):
        np.testing.assert_allclose(res[0]["losses"][s], jl[s],
                                   rtol=tol["loss_rtol"])
    start = {n: np.asarray(v).astype(np.float32) for n, v in init.items()}
    largest = max(np.abs(jafter[n] - start[n]).max() for n in jafter)
    for n, want in jafter.items():
        if dtype == "float32":
            # each update to 1e-3 of the largest update (grad_rtol)
            close_rel(got[n] - start[n], want - start[n],
                      tol["grad_rtol"] * largest
                      / max(np.abs(want - start[n]).max(), 1e-30), n)
        else:
            mag = np.maximum(np.abs(want), np.abs(start[n]))
            ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126)))
                          - 7)
            assert np.all(np.abs(got[n] - want) <= 2 * ulp + largest / 128), n
    # the plan's collectives, counted
    calls, nbytes = res[0]["expected"]
    assert res[0]["counts"]["all_reduce"] == 2 * calls
    assert res[0]["counts"]["all_reduce_bytes"] == 2 * nbytes


@pytest.mark.parametrize("world", [2, 4])
def test_prod_max_min_over_the_batch_match_jax(world):
    """reduce_prod, reduce_max and reduce_min over the batch axis and
    over all axes, two SGD steps: with a 0 in one rank's rows the
    product's backward stays finite, and a max or min tied on several
    ranks splits its cotangent among all the ties, as one device does.
    The loss, w's grad and w to fp32 STEP_TOL of the JAX
    ParallelExecutor's."""
    feed = W.reduce_feed()
    grads = ("rw@GRAD",)
    init, jl, jg, jafter = jax_pe("reduce", feed, steps=2,
                                  fetch_grads=grads)
    res = ok(W.pool(world).run("train", name="reduce", init=W.pack(init),
                               feed=feed, steps=2, fetch_grads=grads))
    same_on_every_rank(res)
    tol = STEP_TOL["float32"]
    for s in range(2):
        assert np.isfinite(res[0]["grads"][s][0]).all()
        np.testing.assert_allclose(res[0]["losses"][s], jl[s],
                                   rtol=tol["loss_rtol"])
        close_rel(res[0]["grads"][s][0], jg[s][0], tol["grad_rtol"],
                  "rw@GRAD")
    close_rel(res[0]["params"]["rw"], jafter["rw"], 1e-5, "rw")
    # forward: one all-reduce each reduction; backward: each max's and
    # min's tie count, and w's grad; the product's backward all-gathers
    calls, nbytes = res[0]["expected"]
    assert calls == 5 + 4 + 1
    assert res[0]["counts"]["all_reduce"] == 2 * calls
    assert res[0]["counts"]["all_reduce_bytes"] == 2 * nbytes
    assert res[0]["counts"]["all_gather"] == 2


def test_lm_with_dropout_world_2_equals_world_1():
    """(e) dropout on: world 2 draws the global batch's masks, so its
    steps are the single-device port's."""
    feed = W.lm_feed(1)
    kw = dict(dropout=0.1)
    init, *_ = jax_pe("lm", feed, steps=1, build_kw=kw)
    two = ok(W.pool(2).run("train", name="lm", init=W.pack(init),
                           feed=feed, steps=2, build_kw=kw))
    one = ok(W.pool(2).run("train", name="lm", init=W.pack(init),
                           feed=feed, steps=2, build_kw=kw, local=True))
    tol = STEP_TOL["float32"]
    for a, b in zip(two[0]["losses"], one[0]["losses"]):
        np.testing.assert_allclose(a, b, rtol=tol["loss_rtol"])
    for n, v in one[0]["params"].items():
        close_rel(two[0]["params"][n], v, 1e-5, n)


def test_replicated_loss_term_is_not_summed_over_ranks():
    """(f) a reg * reduce_sum(W^2) term, computed on every rank from the
    replicated W, adds its grad once: W's grad equals world 1's."""
    feed = W.mlp_feed(4)
    kw = dict(reg=0.05)
    init, *_ = jax_pe("mlp", feed, steps=1, build_kw=kw)
    args = dict(name="mlp", init=W.pack(init), feed=feed, steps=1,
                build_kw=kw, fetch_grads=("pw1@GRAD",))
    two = ok(W.pool(2).run("train", **args))
    one = ok(W.pool(2).run("train", local=True, **args))
    close_rel(two[0]["grads"][0][0], one[0]["grads"][0][0],
              STEP_TOL["float32"]["grad_rtol"], "pw1@GRAD")


def test_gradient_scale_strategy():
    """(g) One multiplies the grads by the number of replicas;
    Customized raises."""
    feed = W.mlp_feed(5)
    init, *_ = jax_pe("mlp", feed, steps=1)
    args = dict(name="mlp", init=W.pack(init), feed=feed, steps=1,
                fetch_grads=("pw1@GRAD", "pb2@GRAD"))
    one = ok(W.pool(2).run("train", strategy={
        "gradient_scale_strategy": "One"}, **args))
    ref = ok(W.pool(2).run("train", local=True, **args))
    for got, want in zip(one[0]["grads"][0], ref[0]["grads"][0]):
        close_rel(got, 2 * want, 1e-5, "grad")
    msgs = W.pool(2).run("raises", name="mlp", feed=feed, strategy={
        "gradient_scale_strategy": "Customized"})
    assert all("Customized is not supported" in m for m in msgs)


def test_undeclared_op_raises_naming_it():
    """(h) an op with no data-parallel rule on a batch-sharded var raises
    at plan time, naming the op, on every rank."""
    msgs = W.pool(2).run("raises", name="undeclared",
                         feed={"img": np.ones((4, 16), np.float32)})
    for m in msgs:
        assert m is not None and "DataParallelError" in m
        assert "'clip_by_norm'" in m and "no data-parallel rule" in m


@pytest.mark.parametrize("fault,name", [("sum_cotangents", "mlp"),
                                        ("local_shape", "lm"),
                                        ("local_bn", "convbn"),
                                        ("local_ties", "reduce")])
def test_planted_faults_fail(fault, name):
    """A reduction whose backward sums the cotangents (grads x N), a
    local shape (the LM's loss N times too large), local batch-norm
    statistics and a max or min split among each rank's own ties (every
    tied rank takes the cotangent whole) each move the step off JAX's
    beyond the limits above."""
    # the JAX runs and arguments of the cases above, so the runs are
    # theirs with one fault planted
    feed = {"mlp": W.mlp_feed(0), "lm": W.lm_feed(0),
            "convbn": W.convbn_feed(0), "reduce": W.reduce_feed()}[name]
    args = {"mlp": dict(steps=5),
            "lm": dict(steps=2, build_kw=dict(dtype="float32", amp=False)),
            "convbn": dict(steps=2, fetch_grads=("conv2d_0.w_0@GRAD",
                                                 "fc_0.w_0@GRAD")),
            "reduce": dict(steps=2, fetch_grads=("rw@GRAD",))}[name]
    init, jl, jg, jafter = jax_pe(name, feed, **args)
    res = ok(W.pool(2).run("train", name=name, init=W.pack(init),
                           feed=feed, fault=fault, **args))
    got = res[0]
    if fault == "local_shape":
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got["losses"][0], jl[0], rtol=1e-5)
    elif fault == "local_bn":
        with pytest.raises(AssertionError):
            close_rel(got["params"]["batch_norm_0.w_1"],
                      jafter["batch_norm_0.w_1"], 1e-5, "moving mean")
    elif fault == "local_ties":
        with pytest.raises(AssertionError):
            close_rel(got["grads"][0][0], jg[0][0],
                      STEP_TOL["float32"]["grad_rtol"], "rw@GRAD")
    else:
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got["params"]["pw1"], jafter["pw1"],
                                       rtol=1e-4, atol=1e-6)


def test_build_strategy_amp_selects_amp_rewrite():
    """BuildStrategy.amp runs the port's amp_rewrite on the step's
    program (the white-list products in bf16), as JAX's _amp_cfg
    selects its rewrite: the MLP's losses to bf16's loss_rtol of the
    JAX ParallelExecutor's under the same knob."""
    feed = W.mlp_feed(6)
    strategy = {"amp": True}
    init, jl, _, _ = jax_pe("mlp", feed, steps=2, strategy=strategy)
    res = ok(W.pool(2).run("train", name="mlp", init=W.pack(init),
                           feed=feed, steps=2, strategy=strategy))
    assert "cast" in res[0]["op_types"]
    for got, want in zip(res[0]["losses"], jl):
        np.testing.assert_allclose(got, want,
                                   rtol=STEP_TOL["bfloat16"]["loss_rtol"])


def _port_program(fn):
    import paddle_tpu_torch as pfluid

    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.unique_name.guard(), pfluid.program_guard(main, startup):
        fn(pfluid)
    return main


def test_planner_refuses_a_persistable_written_from_rows():
    """A persistable written from batch-sharded rows, not through a
    reduction, raises at plan time (each rank would keep its own
    rows); an undeclared op raises naming it."""
    from paddle_tpu_torch.parallel.planner import (DataParallelError,
                                                   plan_batch)

    def write(fluid):
        x = fluid.layers.data(name="img", shape=[16], dtype="float32")
        block = fluid.default_main_program().global_block()
        keep = block.create_var(name="kept_rows", shape=(4, 16),
                                dtype="float32", persistable=True)
        block.append_op(type="assign",
                        inputs={"X": [fluid.layers.scale(x, scale=2.0)]},
                        outputs={"Out": [keep]})

    with pytest.raises(DataParallelError, match="persistable 'kept_rows'"):
        plan_batch(_port_program(write), ["img"], 2)
    with pytest.raises(DataParallelError, match="'clip_by_norm'"):
        plan_batch(_port_program(W.build_undeclared), ["img"], 2)
    # replicated feeds: nothing is batch-sharded, nothing is refused
    plan = plan_batch(_port_program(write), [], 2)
    assert not plan.ops and not any(plan.marks.values())


def test_planner_refuses_top_k_over_a_1d_batch():
    """top_k works over the last axis: on a 2-D batch it is row-local, on
    a 1-D batch-sharded input its last axis is the batch axis, and the
    plan raises naming it (each rank would take its own rows' top k)."""
    from paddle_tpu_torch.parallel.planner import (DataParallelError,
                                                   plan_batch)

    def top_k(shape):
        def build(fluid):
            x = fluid.layers.data(name="img", shape=shape, dtype="float32",
                                  append_batch_size=False)
            fluid.layers.topk(x, k=2)
        return build

    plan = plan_batch(_port_program(top_k([8, 4])), ["img"], 2)
    assert [p.op.type for p in plan.ops.values()] == ["top_k"]
    with pytest.raises(DataParallelError,
                       match="'top_k'.*last axis is the batch axis"):
        plan_batch(_port_program(top_k([8])), ["img"], 2)


def test_enable_inplace_off_keeps_the_prestep_state():
    """BuildStrategy.enable_inplace (InplaceInfo): on, the update ops
    write the scope's tensors in place; off, they write copies and the
    pre-step tensors keep their values. The step is the same."""
    feed = W.mlp_feed(7)
    init, *_ = jax_pe("mlp", feed, steps=1)
    on = ok(W.pool(2).run("inplace_state", init=W.pack(init), feed=feed,
                          enable_inplace=True))
    off = ok(W.pool(2).run("inplace_state", init=W.pack(init), feed=feed,
                           enable_inplace=False))
    assert on[0]["moved"] and off[0]["moved"]
    assert not on[0]["prestep_kept"] and off[0]["prestep_kept"]
    assert on[0]["loss"] == off[0]["loss"]
