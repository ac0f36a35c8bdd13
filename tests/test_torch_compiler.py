"""The port's ``compiler.py`` and the passes a CompiledProgram schedules,
held against the JAX package on the CPU: ``BuildStrategy`` and
``ExecutionStrategy`` attribute for attribute, the pipeline a strategy
names, the in-place state classification, the dp sharding plan's
summary, ``memory_optimize``'s annotation, ``fuse_elewise_add_act`` with
the ``fused_elemwise_activation`` op, ``conv_bn_fold_baked`` and
``with_inference_optimize`` (each on the same program in both
packages), and the knobs the port does not have yet, which raise."""

import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import compiler as jcompiler
from paddle_tpu import ir as jir
from paddle_tpu import ir_passes as jpasses
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.ops import registry as jreg
from paddle_tpu.parallel import planner as jplanner
from paddle_tpu.parallel.mesh import get_mesh as jget_mesh
from paddle_tpu.transpiler import memory_optimization_transpiler as jmem

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import compiler as pcompiler
from paddle_tpu_torch import ir as pir
from paddle_tpu_torch import ir_passes as ppasses
from paddle_tpu_torch.ops import registry as preg
from paddle_tpu_torch.parallel import planner as pplanner
from paddle_tpu_torch.transpiler import memory_optimization_transpiler as pmem

import torch_dp_workers as W
from torch_parity import assert_programs_equal, carry_scope
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (the autouse fixture)
    pin_jax_init_draw as _pin_jax_init_draw)


def both(fn):
    """fn(fluid) built in each package under a fresh name scope:
    ((jmain, jstartup, jout), (pmain, pstartup, pout))."""
    out = []
    for fluid in (jfluid, pfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            res = fn(fluid)
        out.append((main, startup, res))
    return out


def test_strategies_equal_jax_attribute_for_attribute():
    for cls in ("BuildStrategy", "ExecutionStrategy"):
        j, p = getattr(jcompiler, cls)(), getattr(pcompiler, cls)()
        assert vars(p) == vars(j), cls
    for inner in ("ReduceStrategy", "GradientScaleStrategy"):
        jc = getattr(jcompiler.BuildStrategy, inner)
        pc = getattr(pcompiler.BuildStrategy, inner)
        assert {k: v for k, v in vars(pc).items() if not k.startswith("_")} \
            == {k: v for k, v in vars(jc).items() if not k.startswith("_")}
    assert pfluid.BuildStrategy is pcompiler.BuildStrategy
    assert pfluid.CompiledProgram is pcompiler.CompiledProgram


@pytest.mark.parametrize("knobs", [
    {}, {"memory_optimize": False}, {"fuse_elewise_add_act_ops": True},
    {"enable_inplace": False}, {"amp": True},
    {"amp": True, "amp_dtype": "float16", "amp_level": "O2"}])
def test_pipeline_of_a_build_strategy_equals_jax(knobs):
    """The pass list and the cache key a BuildStrategy selects for a
    training program (amp: BuildStrategy.amp's config)."""
    (jm, _, _), (pm, _, _) = both(lambda f: W.build_mlp(f))
    jbs, pbs = jcompiler.BuildStrategy(), pcompiler.BuildStrategy()
    for k, v in knobs.items():
        setattr(jbs, k, v)
        setattr(pbs, k, v)
    assert ppasses.pipeline_key(pbs, pm) == jpasses.pipeline_key(jbs, jm)
    assert ppasses.pipeline_key(pbs, pm, infer_opt=True) \
        == jpasses.pipeline_key(jbs, jm, infer_opt=True)


@pytest.mark.parametrize("enabled", [True, False])
def test_inplace_classification_equals_jax(enabled):
    """classify_persistable_state under InplaceInfo(enable_inplace) (the
    MLP has no write-before-read persistable for the JAX policy to
    promote, which the port never does)."""
    (jm, js, _), (pm, ps, _) = both(lambda f: W.build_mlp(f))
    jscope = JScope()
    jfluid.Executor(jfluid.CPUPlace()).run(js, scope=jscope)
    jc = jcompiler.classify_persistable_state(
        jm.global_block(), [], jpasses.InplaceInfo(enabled, jscope))
    pc = pcompiler.classify_persistable_state(
        pm.global_block(), [], ppasses.InplaceInfo(enabled))
    assert pc == jc


def test_plan_program_summary_equals_jax():
    """Every persistable replicated; the annotated ones keep their
    shard_spec with the mesh's absent axes dropped."""
    (jm, _, _), (pm, _, _) = both(lambda f: W.build_lm(f))
    jplan = jplanner.plan_program(jm, jget_mesh(("dp",)))
    mesh = types.SimpleNamespace(shape={"dp": 2})
    pplan = pplanner.plan_program(pm, mesh)
    assert pplan.summary() == jplan.summary()
    assert pplan.summary()  # the LM annotates its weights


def test_memory_optimize_annotation_equals_jax():
    """The registered pass and the transpiler's analysis: reuse pairs,
    lifetimes and the early-free plan."""
    (jm, _, _), (pm, _, _) = both(lambda f: W.build_mlp(f))
    jir.apply_passes(jm, ["memory_optimize"])
    pir.apply_passes(pm, ["memory_optimize"])
    assert pm._memory_reuse_plan == jm._memory_reuse_plan
    assert pm._memory_reuse_plan
    jg, pg = jmem.ControlFlowGraph(jm), pmem.ControlFlowGraph(pm)
    assert (pg.first_def, pg.last_use) == (jg.first_def, jg.last_use)
    assert pmem.release_memory(pm) == jmem.release_memory(jm)
    assert pmem.memory_optimize(pm, skip_grads=True) \
        == jmem.memory_optimize(jm, skip_grads=True)


def _fc_relu(fluid):
    x = fluid.layers.data(name="fx", shape=[16], dtype="float32")
    h = fluid.layers.fc(input=x, size=32, act="relu")
    t = fluid.layers.fc(input=h, size=8, act="tanh")
    return fluid.layers.reduce_mean(t)


def test_fuse_elewise_add_act_equals_jax():
    """An inference program: both bias-add + activation pairs fuse into
    fused_elemwise_activation, the programs equal, the outputs too."""
    (jm, js, jout), (pm, ps, pout) = both(_fc_relu)
    for prog, out in ((jm, jout), (pm, pout)):
        prog._opt_fetch_targets = (out.name,)
    jir.apply_passes(jm, ["fuse_elewise_add_act"])
    pir.apply_passes(pm, ["fuse_elewise_add_act"])
    assert_programs_equal(jm, pm, "fused")
    assert [o.type for o in pm.global_block().ops].count(
        "fused_elemwise_activation") == 2
    jscope, pscope = JScope(), pfluid.Scope()
    jexe, pexe = jfluid.Executor(jfluid.CPUPlace()), pfluid.Executor("cpu")
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    carry_scope(jscope, pscope, ["fc_0.w_0", "fc_0.b_0", "fc_1.w_0",
                                 "fc_1.b_0"])
    feed = {"fx": np.random.RandomState(3).randn(8, 16).astype(np.float32)}
    jv, = jexe.run(jm, feed=feed, fetch_list=[jout], scope=jscope)
    pv, = pexe.run(pm, feed=feed, fetch_list=[pout], scope=pscope)
    np.testing.assert_allclose(pv, np.asarray(jv), rtol=1e-6)


def test_fusion_skips_grad_referenced_ops():
    """A training program's add and activation are grad ops' forwards:
    they stay, in both packages."""
    (jm, _, jl), (pm, _, pl) = both(lambda f: W.build_mlp(f))
    for prog, out in ((jm, jl), (pm, pl)):
        prog._opt_fetch_targets = (out.name,)
    jir.apply_passes(jm, ["fuse_elewise_add_act"])
    pir.apply_passes(pm, ["fuse_elewise_add_act"])
    assert "fused_elemwise_activation" not in [
        o.type for o in pm.global_block().ops]
    assert_programs_equal(jm, pm, "unfused")


@pytest.mark.parametrize("functors", [
    ["relu", "elementwise_add"], ["tanh", "elementwise_add"],
    ["sigmoid", "elementwise_mul"], ["elementwise_add", "relu"],
    ["elementwise_mul", "scale"]])
def test_fused_elemwise_activation_op_equals_jax(functors):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 6).astype(np.float32)
    y = rng.randn(6).astype(np.float32)
    attrs = {"functor_list": functors, "scale": 0.5}
    j = jreg.get("fused_elemwise_activation").impl(
        None, {"X": [x], "Y": [y]}, attrs)
    ctx = types.SimpleNamespace(device="cpu")
    p = preg.get("fused_elemwise_activation").impl(
        ctx, {"X": [torch.from_numpy(x)], "Y": [torch.from_numpy(y)]},
        attrs)
    for slot in ("Out", "IntermediateOut"):
        np.testing.assert_allclose(p[slot][0].numpy(),
                                   np.asarray(j[slot][0]), rtol=1e-6,
                                   atol=1e-7, err_msg=slot)


def _conv_bn(fluid):
    img = fluid.layers.data(name="cimg", shape=[3, 8, 8], dtype="float32")
    c = fluid.layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                            bias_attr=False)
    b = fluid.layers.batch_norm(c, act="relu")
    return fluid.layers.reduce_mean(b)


def test_conv_bn_fold_baked_equals_jax():
    """On a test clone: the same folded program (content-addressed names
    included), the same baked weights bitwise, the user's weights left
    as they were, and the folded output the unfolded one's."""
    (jm, js, jout), (pm, ps, pout) = both(_conv_bn)
    jscope, pscope = JScope(), pfluid.Scope()
    jexe, pexe = jfluid.Executor(jfluid.CPUPlace()), pfluid.Executor("cpu")
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    names = sorted(v.name for v in jm.global_block().vars.values()
                   if v.persistable)
    rng = np.random.RandomState(1)
    # moving statistics away from their (0, 1) start
    jscope.set("batch_norm_0.w_1", rng.randn(4).astype(np.float32))
    jscope.set("batch_norm_0.w_2", rng.rand(4).astype(np.float32) + 0.5)
    start = carry_scope(jscope, pscope, names)
    jt, pt = jm.clone(for_test=True), pm.clone(for_test=True)
    feed = {"cimg": rng.randn(2, 3, 8, 8).astype(np.float32)}
    want, = pexe.run(pt, feed=feed, fetch_list=[pout], scope=pscope)
    for prog, out in ((jt, jout), (pt, pout)):
        prog._opt_fetch_targets = (out.name,)
    jir.apply_passes(jt, ["conv_bn_fold_baked"], jscope)
    pir.apply_passes(pt, ["conv_bn_fold_baked"], pscope)
    assert "batch_norm" not in [o.type for o in pt.global_block().ops]
    assert_programs_equal(jt, pt, "folded")
    assert sorted(pt._baked_values) == sorted(jt._baked_values)
    for n, v in jt._baked_values.items():
        np.testing.assert_array_equal(pt._baked_values[n].numpy(),
                                      np.asarray(v), err_msg=n)
    for n in names:
        np.testing.assert_array_equal(pscope.get(n).numpy(), start[n])
    got, = pexe.run(pt, feed=feed, fetch_list=[pout], scope=pscope)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_with_inference_optimize_without_data_parallel():
    """with_inference_optimize on a plain CompiledProgram runs the
    inference pipeline (the bn folded) through Executor.run; ir_optim
    off runs the program as built."""
    (jm, js, jout), (pm, ps, pout) = both(_conv_bn)
    pscope = pfluid.Scope()
    pexe = pfluid.Executor("cpu")
    pexe.run(ps, scope=pscope)
    test = pm.clone(for_test=True)
    feed = {"cimg": np.random.RandomState(2).randn(2, 3, 8, 8).astype(
        np.float32)}
    want, = pexe.run(test, feed=feed, fetch_list=[pout], scope=pscope)
    for ir_optim in (True, False):
        cp = pfluid.CompiledProgram(test).with_inference_optimize(
            types.SimpleNamespace(_ir_optim=ir_optim))
        got, = pexe.run(cp, feed=feed, fetch_list=[pout], scope=pscope)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        ran = list(cp._infer_programs.values())
        if ir_optim:
            assert "batch_norm" not in [o.type
                                        for o in ran[0].global_block().ops]
        else:
            assert not ran


@pytest.mark.parametrize("knob,value", [
    ("tensor_parallel_degree", 2), ("pipeline_stages", 2),
    ("sequence_parallel_degree", 2), ("reduce_strategy", 1),
    ("sharding_specs", {"fc_0.w_0": (None, "tp")})])
def test_unported_knobs_raise_naming_item_9(knob, value):
    """sequence_parallel_degree raises, naming item 9;
    tensor_parallel_degree, ReduceStrategy.Reduce, sharding_specs
    (tests/test_torch_tensor_parallel.py) and pipeline_stages
    (tests/test_torch_pipeline_program.py) are ported and pass the
    check."""
    bs = pcompiler.BuildStrategy()
    setattr(bs, knob, value)
    if knob in ("tensor_parallel_degree", "reduce_strategy",
                "sharding_specs", "pipeline_stages"):
        pcompiler.check_build_strategy(bs)
        return
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        pcompiler.check_build_strategy(bs)


def test_no_cuda_raises_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        pfluid.ParallelExecutor(loss_name="x")
    from paddle_tpu_torch.parallel import mesh

    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        mesh.init_data_group(None)
    assert mesh.data_group() is None  # nothing was brought up


def test_grad_seed_scale_of_equals_jax():
    for gss in (0, 1):
        jbs, pbs = jcompiler.BuildStrategy(), pcompiler.BuildStrategy()
        jbs.gradient_scale_strategy = pbs.gradient_scale_strategy = gss
        assert pcompiler.grad_seed_scale_of(pbs, 4) \
            == jcompiler.grad_seed_scale_of(jbs, 4)
    pbs.gradient_scale_strategy = 2
    jbs.gradient_scale_strategy = 2
    with pytest.raises(NotImplementedError) as pe:
        pcompiler.grad_seed_scale_of(pbs, 4)
    with pytest.raises(NotImplementedError) as je:
        jcompiler.grad_seed_scale_of(jbs, 4)
    assert str(pe.value) == str(je.value)
