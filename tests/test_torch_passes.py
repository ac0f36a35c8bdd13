"""The port's compile-time pass pipeline held against the JAX package's
(``ir_passes.optimize_for_execution``) on the CPU.

On bench.py's program at its TINY widths (bench.py:152-178: the LM, SGD
under each precision scheme of the bench's legs, and the receipt's
foldable constant, CSE pair and fetch-dead branch), on the same model
under ``amp.decorate`` (bf16 and fp16, levels O1 and O2) and on a
full-int8 quantized inference program, both pipelines give the same
optimized program: the same ops in order with the same slots, var names
and attrs (the per-op random seeds, which come from process-wide
counters, aside; a grad op's forward op by its place in the block; array
attrs by dtype, shape and bytes), the same ``compiler/*`` and ``amp/*``
counts and bitwise-equal baked values. Under ``PTPU_NO_PROGRAM_OPT=1``
both return the original program. Each program is built and optimized
under a fresh name counter in each package, so generated names agree.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import ir_passes as j_ir_passes
from paddle_tpu import quant as j_quant
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer_fluid as j_tf
from paddle_tpu.observability import metrics as j_metrics

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import bench as p_bench
from paddle_tpu_torch import ir as p_ir
from paddle_tpu_torch import ir_passes as p_ir_passes
from paddle_tpu_torch import quant as p_quant
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import transformer_fluid as p_tf
from paddle_tpu_torch.observability import metrics as p_metrics

TINY = p_bench.TINY
_COUNTERS = ("compiler/", "amp/")


def j_build(dtype, amp):
    """bench.py:152-178 through the JAX package, as `p_bench.
    build_program` builds it through the port."""
    fluid = jfluid
    prog, sprog = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, sprog):
        _t, _l, loss = j_tf.build(seq_len=TINY["seq"], remat=False,
                                  dtype=dtype, **TINY["model_kwargs"])
        if amp == "legacy":
            opt = fluid.contrib.mixed_precision.decorate(
                fluid.optimizer.SGD(0.01), init_loss_scaling=1.0,
                use_dynamic_loss_scaling=False)
        elif amp:
            opt = fluid.amp.decorate(
                fluid.optimizer.SGD(0.01),
                dtype="float16" if amp == "float16" else "bfloat16")
        else:
            opt = fluid.optimizer.SGD(0.01)
        opt.minimize(loss)
        _c = fluid.layers.scale(
            fluid.layers.fill_constant([1], "float32", 1.5), scale=0.5)
        _d1 = fluid.layers.scale(loss, scale=3.0)
        _d2 = fluid.layers.scale(loss, scale=3.0)
        fluid.layers.elementwise_add(
            fluid.layers.elementwise_add(_d1, _d2), _c)
    return prog, loss


@pytest.fixture
def counts():
    """Both packages' metrics on and zeroed; yields a reader of their
    compiler/* and amp/* counters; turned off afterwards."""
    j_metrics.enable()
    p_metrics.enable()
    j_metrics.reset()
    p_metrics.reset()

    def read():
        return tuple(
            {k: v for k, v in m.registry().to_dict()["counters"].items()
             if k.startswith(_COUNTERS)}
            for m in (j_metrics, p_metrics))

    yield read
    j_metrics.reset()
    p_metrics.reset()
    j_metrics.disable()
    p_metrics.disable()


def _canon(v):
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_canon(x) for x in v)
    return v


def _ops(program):
    ops = program.global_block().ops
    out = []
    for op in ops:
        attrs = {}
        for k, v in op.attrs.items():
            if k == "__op_seed__":
                continue
            if k == "__fwd_op__":
                v = ("op", ops.index(v), v.type)
            attrs[k] = _canon(v)
        out.append((op.type,
                    {s: [v.name for v in vs] for s, vs in op.inputs.items()},
                    {s: [v.name for v in vs]
                     for s, vs in op.outputs.items()},
                    attrs))
    return out


def _vars(program):
    return {v.name: (tuple(v.shape) if v.shape is not None else None,
                     v.dtype, v.persistable)
            for v in program.global_block().vars.values()}


def _baked(program):
    out = {}
    for name, val in (getattr(program, "_baked_values", None)
                      or {}).items():
        if isinstance(val, torch.Tensor):
            val = val.cpu().numpy()
        out[name] = np.asarray(val)
    return out


def assert_same_optimized(j_opt, p_opt):
    j_ops, p_ops = _ops(j_opt), _ops(p_opt)
    assert [o[0] for o in p_ops] == [o[0] for o in j_ops]
    for i, (jo, po) in enumerate(zip(j_ops, p_ops)):
        assert po == jo, "op %d (%s)" % (i, jo[0])
    assert _vars(p_opt) == _vars(j_opt)
    jb, pb = _baked(j_opt), _baked(p_opt)
    assert sorted(pb) == sorted(jb)
    for n in jb:
        assert pb[n].dtype == jb[n].dtype and np.array_equal(
            pb[n].view(np.uint8), jb[n].view(np.uint8)), n


def optimize_both(dtype, amp, scopes=(None, None)):
    with j_unique.guard():
        jp, jl = j_build(dtype, amp)
        j_opt = j_ir_passes.optimize_for_execution(
            jp, [jl.name], scopes[0] or JScope())
    with p_unique.guard():
        pp, _, pl, _ = p_bench.build_program(TINY["seq"], dtype, amp,
                                             TINY["model_kwargs"])
        p_opt = p_ir_passes.optimize_for_execution(
            pp, [pl.name], scopes[1] or pfluid.Scope(), "cpu")
    return (jp, j_opt), (pp, p_opt)


# the receipt's counts on each leg's program (bench.py's training legs
# and the port's amp_fp16 leg), pinned: constant_fold folds the fill ->
# scale chain (the scale becomes one assign_value, the fill is folded),
# cse removes the second scale(loss, 3.0), fetch_dce the fetch-dead
# branch (the fill, the assign_value, the first scale, both adds) and
# nothing else; amp_rewrite rewrites the 7 white-list ops of the TINY
# model (a fused attention op and two fc muls a layer, the head's mul)
# with 35 casts
RECEIPT = {"compiler/ops_folded": 1, "compiler/ops_removed": 6,
           "compiler/programs_optimized": 1}
AMP_REWRITE = {"amp/casts_inserted": 35, "amp/ops_rewritten": 7}


@pytest.mark.parametrize("dtype,amp", [("bfloat16", "legacy"),
                                       ("float32", False),
                                       ("float32", True),
                                       ("float32", "float16")])
def test_receipt_program_optimizes_as_in_jax(counts, dtype, amp):
    (jp, j_opt), (pp, p_opt) = optimize_both(dtype, amp)
    assert j_opt is not jp and p_opt is not pp
    assert_same_optimized(j_opt, p_opt)
    j_counts, p_counts = counts()
    assert p_counts == j_counts
    want = dict(RECEIPT, **(AMP_REWRITE if amp in (True, "float16")
                            else {}))
    assert p_counts == want
    types = [op.type for op in p_opt.global_block().ops]
    assert types.count("assign_value") == 0  # swept with the dead branch
    assert len(types) == len(pp.global_block().ops) - 6 + (
        35 if amp in (True, "float16") else 0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_decorated_program_optimizes_as_in_jax(counts, monkeypatch,
                                                   dtype, level):
    """``amp.decorate(amp_level=level, dtype=dtype)`` on the fp32 model
    (no receipt: the amp_rewrite pass alone is what differs)."""
    def build(fluid, tf, unique_name):
        with unique_name.guard():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                _, _, loss = tf.build(seq_len=TINY["seq"], remat=False,
                                      dtype="float32",
                                      **TINY["model_kwargs"])
                fluid.amp.decorate(fluid.optimizer.SGD(0.01),
                                   amp_level=level,
                                   dtype=dtype).minimize(loss)
            return main, loss

    jm, jl = build(jfluid, j_tf, j_unique)
    pm, pl = build(pfluid, p_tf, p_unique)
    with j_unique.guard():
        j_opt = j_ir_passes.optimize_for_execution(jm, [jl.name], JScope())
    with p_unique.guard():
        p_opt = p_ir_passes.optimize_for_execution(pm, [pl.name],
                                                   pfluid.Scope(), "cpu")
    assert_same_optimized(j_opt, p_opt)
    j_counts, p_counts = counts()
    assert p_counts == j_counts and p_counts["amp/ops_rewritten"] == 7
    assert p_ir_passes.pipeline_key(None, pm)[-1] == (
        "amp:" + jm._amp_config.cache_key())
    assert pm._amp_config.cache_key() == jm._amp_config.cache_key()


def test_full_int8_program_optimizes_as_in_jax(counts, monkeypatch):
    """A full-int8 inference clone of the fp32 LM, calibrated by the JAX
    package and decorated alike in both: quant_rewrite, then the default
    passes; the baked int8 weights and scales bitwise equal."""
    def build(fluid, tf, unique_name):
        with unique_name.guard():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                _, _, loss = tf.build(seq_len=TINY["seq"], remat=False,
                                      dtype="float32",
                                      **TINY["model_kwargs"])
            return main, startup, loss

    monkeypatch.setenv("PTPU_KERNELS", "1")
    jm, js, jl = build(jfluid, j_tf, j_unique)
    pm, ps, pl = build(pfluid, p_tf, p_unique)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    pexe, pscope = pfluid.Executor("cpu"), pfluid.Scope()
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    scope_from_numpy(pscope, {v.name: np.array(jscope.get(v.name))
                              for v in pm.global_block().vars.values()
                              if v.persistable})
    rng = np.random.RandomState(0)
    vocab = TINY["model_kwargs"]["vocab_size"]
    feeds = []
    for _ in range(2):
        toks = rng.randint(0, vocab, (2, TINY["seq"])).astype(np.int32)
        feeds.append({"tokens": toks, "labels": np.roll(toks, -1, 1)})
    table = j_quant.calibrate(jm, feeds, scope=jscope)
    ji, pi = jm.clone(for_test=True), pm.clone(for_test=True)
    j_metrics.reset()  # the counts of the startup and calibration runs
    p_metrics.reset()
    j_quant.decorate(ji, "full_int8", table)
    p_quant.decorate(pi, "full_int8",
                     p_quant.CalibrationTable.from_dict(table.to_dict()))
    with j_unique.guard():
        j_opt = j_ir_passes.optimize_for_execution(ji, [jl.name], jscope)
    with p_unique.guard():
        p_opt = p_ir_passes.optimize_for_execution(pi, [pl.name], pscope,
                                                   "cpu")
    assert_same_optimized(j_opt, p_opt)
    assert [op.type for op in p_opt.global_block().ops].count(
        "fused_int8_matmul") == 5
    j_counts, p_counts = counts()
    assert p_counts == j_counts


@pytest.mark.parametrize("dtype,amp", [("bfloat16", "legacy"),
                                       ("float32", True)])
def test_no_program_opt_returns_the_original(counts, monkeypatch, dtype,
                                             amp):
    monkeypatch.setenv("PTPU_NO_PROGRAM_OPT", "1")
    (jp, j_opt), (pp, p_opt) = optimize_both(dtype, amp)
    assert j_opt is jp and p_opt is pp
    assert p_ir_passes.pipeline_key(None, pp) == ("noopt",) \
        == j_ir_passes.pipeline_key(None, jp)
    assert counts() == ({}, {})


def test_executor_runs_the_optimized_clone_and_keys_the_pipeline(
        monkeypatch):
    """The executor's cache miss runs the pipeline: the step runs the
    optimized clone (the dead branch gone); PTPU_NO_PROGRAM_OPT=1 is
    another cache entry, which runs the program itself."""
    with p_unique.guard():
        pp, ps, pl, _ = p_bench.build_program(TINY["seq"], "float32",
                                              False, TINY["model_kwargs"])
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(ps, scope=scope)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 512, (2, TINY["seq"])).astype(np.int32)
    feed = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    opt_loss, = exe.run(pp, feed=feed, fetch_list=[pl], scope=scope)
    monkeypatch.setenv("PTPU_NO_PROGRAM_OPT", "1")
    noopt_loss, = exe.run(pp, feed=feed, fetch_list=[pl], scope=scope)
    steps = [s for k, s in exe._cache.items() if k[0] == id(pp)]
    assert len(steps) == 2
    assert steps[0].program is not pp and steps[1].program is pp
    assert len(steps[0].program.global_block().ops) == \
        len(pp.global_block().ops) - 6
    assert np.isfinite(opt_loss).all() and np.isfinite(noopt_loss).all()


def test_passes_the_port_lacks_raise_naming_them():
    """A pipeline that names a pass that is not registered (here the
    inference optimization's and a BuildStrategy's, taken out for the
    test) raises, naming it: no pass is skipped silently. Registered,
    the same pipelines run."""
    from paddle_tpu_torch import ir as p_ir

    with p_unique.guard():
        pp, _, pl, _ = p_bench.build_program(TINY["seq"], "float32", False,
                                             TINY["model_kwargs"])

    class Strategy:
        fuse_elewise_add_act_ops = True
        memory_optimize = True

    names = ("conv_bn_fold_baked", "fuse_elewise_add_act", "memory_optimize")
    saved = {n: p_ir.get_pass(n) for n in names}
    try:
        for n in names:
            p_ir.unregister_pass(n)
        with pytest.raises(NotImplementedError, match="conv_bn_fold_baked"):
            p_ir_passes.optimize_for_execution(pp, [pl.name], pfluid.Scope(),
                                               "cpu", infer_opt=True)
        with pytest.raises(NotImplementedError,
                           match="fuse_elewise_add_act.*memory_optimize"):
            p_ir_passes.optimize_for_execution(
                pp, [pl.name], pfluid.Scope(), "cpu",
                build_strategy=Strategy())
    finally:
        p_ir._REGISTRY.update(saved)
    opt = p_ir_passes.optimize_for_execution(pp, [pl.name], pfluid.Scope(),
                                             "cpu", build_strategy=Strategy())
    assert opt is not pp and opt._memory_reuse_plan
    assert p_ir_passes.build_pipeline(Strategy(), infer_opt=True) == \
        j_ir_passes.build_pipeline(Strategy(), infer_opt=True)


def test_ir_registry_and_match_chain():
    """register / unregister / apply_passes, and match_chain over the
    fc layers' mul -> elementwise_add links (each mul's output is also
    read by its add's grad op, so not single-consumer), as in the JAX
    package."""
    from paddle_tpu import ir as j_ir

    assert {"dropout_remove", "constant_fold", "cse", "fetch_dce",
            "amp_rewrite", "quant_rewrite"} <= set(p_ir.registered_passes())
    seen = []

    @p_ir.register_pass("_probe")
    def _probe(program, scope=None):
        seen.append(program)
        return program

    try:
        with pytest.raises(ValueError, match="already registered"):
            p_ir.register_pass("_probe")(_probe)
        with p_unique.guard():
            pp, _, _, _ = p_bench.build_program(
                TINY["seq"], "float32", False, TINY["model_kwargs"])
        with j_unique.guard():
            jp, _ = j_build("float32", False)
        p_ir.apply_passes(pp, ["_probe"], pfluid.Scope())
        assert seen == [pp]
    finally:
        p_ir.unregister_pass("_probe")
    assert "_probe" not in p_ir.registered_passes()

    def chains(ir, program):
        return [[(op.type, op.output_names()) for op in chain]
                for chain in ir.match_chain(program.global_block(),
                                            ("mul", "elementwise_add"),
                                            single_consumer=False)]

    got = chains(p_ir, pp)
    assert got == chains(j_ir, jp) and len(got) == 4  # the 4 FFN fcs


def test_dropout_remove_on_an_inference_program():
    """The pipeline schedules dropout_remove for an inference clone; the
    port has no dropout op, so it changes nothing there, and on a program
    that holds one it rewrites as the JAX pass does."""
    from paddle_tpu import ir as j_ir
    from paddle_tpu_torch.framework import Operator

    with p_unique.guard():
        pp, _, pl, _ = p_bench.build_program(TINY["seq"], "float32", False,
                                             TINY["model_kwargs"])
    infer = pp.clone(for_test=True)
    assert p_ir_passes.program_is_inference(infer)
    assert not p_ir_passes.program_is_inference(pp)
    assert p_ir_passes.build_pipeline(is_test=True)[0] == "dropout_remove"
    v0 = infer.version
    p_ir.get_pass("dropout_remove").apply(infer)
    assert infer.version == v0
    # a hand-made dropout pair in each package
    progs = []
    for fluid, ir in ((jfluid, j_ir), (pfluid, p_ir)):
        prog = fluid.Program()
        blk = prog.global_block()
        x = blk.create_var(name="x", shape=(2, 3))
        y = blk.create_var(name="y", shape=(2, 3))
        z = blk.create_var(name="z", shape=(2, 3))
        op_cls = Operator if fluid is pfluid else type(
            blk.append_op("scale", inputs={"X": [x]},
                          outputs={"Out": [y]}))
        blk.ops = [
            op_cls(blk, "dropout", inputs={"X": [x]}, outputs={"Out": [y]},
                   attrs={"dropout_prob": 0.25, "is_test": True}),
            op_cls(blk, "scale", inputs={"X": [y]}, outputs={"Out": [z]},
                   attrs={"scale": 2.0})]
        prog._opt_fetch_targets = ("z",)
        ir.get_pass("dropout_remove").apply(prog)
        progs.append(prog)
    assert _ops(progs[1]) == _ops(progs[0])
    assert _ops(progs[1])[0][0] == "scale"
