"""``layers.recompute`` in the port, held against the JAX package and
against the port's own no-remat build on the CPU, at vocab 256, d_model
64, 1 head of 64 (the flash kernel qualifies in JAX at seq 128), 2
layers (one two-layer segment), d_ff 128, batch 2.

* ``transformer_fluid.build()`` (remat=True) under Adam on the phase-6e
  schedule (a linear warmup over an exponential decay), a global-norm
  clip of 0.25 (it binds at this size: the init grads' norm is about
  1.2) and L2 decay appends JAX's ops, the segment's included, and
  trains 3 steps as JAX does: losses to rtol 1e-5, the learning rate to
  rtol 1e-6, the grads Adam reads to 1e-4 of each tensor's largest plus
  1e-7 of the largest of all, and every persistable as
  ``tests/test_torch_train.py`` holds fp32 parameters (each update to
  rtol 1e-4 plus the larger of 3e-8 and 2 ulps) plus what the observed
  grad differences let Adam move it (``chip_smoke.adam_param_limit``:
  Adam turns a grad that is rounding noise, such as the attention key
  bias's, into a step of up to the learning rate); the moments to what
  those grad differences move them plus 3 ulps and 2^-20 of their terms'
  magnitude (the first moment's terms may cancel); the beta powers
  bitwise.
* Remat against no-remat in the port, from the same weights: losses
  equal, grads to rtol 1e-6 (the test records whether they are bitwise;
  on the CPU they are), with dropout too under one set of op seeds (the
  re-run redraws the forward's masks; other seeds give other grads).
* The recompute forward keeps only its inputs, and no graph.
* The passes leave the segment alone, with JAX's ``compiler/*`` counts.
* JAX's errors and routing, ``clone(for_test=True)`` into the segment,
  the AMP marks inside it, fp32 moments beside bf16 parameters, and the
  executor's liveness across the segment and its grad op.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import ir_passes as j_ir_passes
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer_fluid as j_tf
from paddle_tpu.observability import metrics as j_metrics

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import ir_passes as p_ir_passes
from paddle_tpu_torch import layer_helper as p_layer_helper
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.executor import _Step
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import transformer_fluid as p_tf
from paddle_tpu_torch.observability import metrics as p_metrics
from torch_parity import (  # noqa: F401 (the autouse fixture)
    pin_jax_init_draw as _pin_jax_init_draw)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=256, d_model=64, n_heads=1, n_layers=2, d_ff=128,
           seq_len=128)
BETA1, BETA2 = 0.9, 0.98


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_recompute",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fp32_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 23)


def feed(seed=0, batch=2):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, CFG["vocab_size"],
                       (batch, CFG["seq_len"])).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def build_adam(fluid, tf, unique_name, remat=True, dtype="float32",
               amp=False):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = tf.build(remat=remat, dtype=dtype, **CFG)
        L = fluid.layers
        lr = L.linear_lr_warmup(L.exponential_decay(1e-3, 1000, 0.9),
                                warmup_steps=4, start_lr=0.0, end_lr=1e-3)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(0.25))
        opt = fluid.optimizer.Adam(
            learning_rate=lr, beta1=BETA1, beta2=BETA2, epsilon=1e-9,
            regularization=fluid.regularizer.L2Decay(1e-4))
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss, lr


def _canon(v, ops):
    if isinstance(v, (jfluid.framework.Block, pfluid.framework.Block)):
        return ("block", v.idx, v.parent_idx)
    if isinstance(v, (jfluid.framework.Operator,
                      pfluid.framework.Operator)):
        return ("op", ops.index(v), v.type)
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape, v.tobytes())
    return v


def _desc(program):
    out = []
    for blk in program.blocks:
        ops = blk.ops
        out.append((blk.idx, blk.parent_idx, [
            (op.type,
             {s: [v.name for v in vs] for s, vs in op.inputs.items()},
             {s: [v.name for v in vs] for s, vs in op.outputs.items()},
             {k: _canon(v, ops) for k, v in op.attrs.items()
              if k != "__op_seed__"})
            for op in ops]))
    return out


def _adam_grads(main):
    return {op.inputs["Param"][0].name: op.inputs["Grad"][0].name
            for op in main.global_block().ops if op.type == "adam"}


def test_remat_adam_clip_l2_matches_jax_for_three_steps():
    jm, js, jl, jlr = build_adam(jfluid, j_tf, j_unique)
    pm, ps, pl, plr = build_adam(pfluid, p_tf, p_unique)
    assert _desc(pm) == _desc(jm)
    assert [op.type for op in pm.global_block().ops].count("recompute") == 1
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    pexe, pscope = pfluid.Executor("cpu"), pfluid.Scope()
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    names = sorted(v.name for v in jm.global_block().vars.values()
                   if v.persistable)
    assert set(names) == set(pscope.local_var_names()) - {
        "__step_counter__"}
    start = {n: np.array(jscope.get(n), copy=True) for n in names}
    # the JAX scope holds the int64 counter as int32 (x64 is off)
    scope_from_numpy(pscope, {n: a.astype(np.int64)
                              if n == "@step_counter@" else a
                              for n, a in start.items()})
    grads = _adam_grads(pm)
    params = sorted(grads)
    fetch = [pl.name, plr.name] + [grads[p] for p in params]
    g_ref, g_err = {p: [] for p in params}, {p: [] for p in params}
    lrs = []
    batch = feed()
    for step in range(3):
        jo = [np.asarray(v) for v in jexe.run(jm, feed=batch,
                                               fetch_list=fetch,
                                               scope=jscope)]
        po = pexe.run(pm, feed=batch, fetch_list=fetch, scope=pscope)
        np.testing.assert_allclose(po[0], jo[0], rtol=1e-5,
                                   err_msg="loss of step %d" % step)
        np.testing.assert_allclose(po[1], jo[1], rtol=1e-6)
        lrs.append(float(jo[1][0]))
        top = max(float(np.abs(g).max()) for g in jo[2:])
        for p, jg, pg in zip(params, jo[2:], po[2:]):
            err = np.abs(pg - jg)
            assert err.max() <= 1e-4 * np.abs(jg).max() + 1e-7 * top, p
            g_ref[p].append(jg)
            g_err[p].append(err)
    assert lrs == pytest.approx([2.5e-4, 5e-4, 7.5e-4], rel=1e-6)
    limit = _smoke().adam_param_limit
    updated = 0
    for n in names:
        want = np.asarray(jscope.get(n)).astype(np.float64)
        got = pscope.get(n).double().numpy()
        assert got.shape == want.shape, n
        s = start[n].astype(np.float64)
        if n == "@step_counter@" or "_pow_acc_" in n:
            assert np.array_equal(got, want), n
            continue
        p = n.rsplit("_moment", 1)[0]
        if n in grads:
            d_want, d_got = want - s, got - s
            bound = 1e-4 * np.abs(d_want) + np.maximum(
                2 * fp32_ulp(want), 3e-8) + limit(
                    g_ref[n], g_err[n], lrs, BETA1, BETA2)
            err = np.abs(d_got - d_want)
            updated += int(not np.array_equal(want, s))
        elif "_moment" in n:
            # m = sum of (1 - b1) b1^k g and v of (1 - b2) b2^k g^2: each
            # step's grad error carried through, and a few roundings of
            # the terms (they may cancel in m)
            first = "_moment1_" in n
            b = BETA1 if first else BETA2
            # the terms as large as either package's grads make them
            terms = [(1 - b) * b ** (2 - i) * (np.abs(g) + e) ** (1 if first
                                                                 else 2)
                     for i, (g, e) in enumerate(zip(g_ref[p], g_err[p]))]
            carried = [(1 - b) * b ** (2 - i) * (e if first else
                                                 (2 * np.abs(g) + e) * e)
                       for i, (g, e) in enumerate(zip(g_ref[p], g_err[p]))]
            bound = 3 * fp32_ulp(want) + 2.0 ** -20 * sum(terms) + sum(
                carried)
            err = np.abs(got - want)
        else:                    # the schedule's and the model's others
            bound = 2 * fp32_ulp(want)
            err = np.abs(got - want)
        i = int(np.argmax(err - bound))
        assert err.flat[i] <= bound.flat[i], (
            "%s: %r vs %r (start %r) at %d, bound %r"
            % (n, got.flat[i], want.flat[i], s.flat[i], i, bound.flat[i]))
    assert updated == len(params)


def _same_weights_run(build, fetch_grads=True, seeds=(1000, 1000)):
    """Build twice (op seeds from `seeds`), run one step of each from
    the first build's weights: [(loss, {param: grad}), ...]."""
    runs, start = [], None
    for (remat, kw), seed in zip(build, seeds):
        p_layer_helper._op_seed_counter[0] = seed
        main, startup = pfluid.Program(), pfluid.Program()
        with p_unique.guard(), pfluid.program_guard(main, startup):
            _, _, loss = p_tf.build(remat=remat, **dict(CFG, **kw))
            pg = pfluid.optimizer.SGD(0.0).backward(loss)
        exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
        exe.run(startup, scope=scope)
        if start is None:
            start = {n: scope.get(n).clone()
                     for n in scope.local_var_names()
                     if n != "__step_counter__"}
        else:
            for n, t in start.items():
                scope.set(n, t.clone())
        out = exe.run(main, feed=feed(), fetch_list=[loss] + [
            g for _, g in pg], scope=scope)
        runs.append((out[0], {p.name: g for (p, _), g in zip(pg, out[1:])}))
    return runs


def _compare(runs, record_property):
    (la, ga), (lb, gb) = runs
    assert sorted(ga) == sorted(gb)
    np.testing.assert_array_equal(la, lb)
    for p in ga:
        np.testing.assert_allclose(ga[p], gb[p], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(gb[p]).max()),
                                   err_msg=p)
    bitwise = all(np.array_equal(ga[p], gb[p]) for p in ga)
    record_property("grads_bitwise", bitwise)
    return bitwise


def test_remat_equals_no_remat(record_property):
    runs = _same_weights_run([(True, {}), (False, {})])
    assert _compare(runs, record_property)  # bitwise on the CPU


def test_remat_equals_no_remat_with_dropout(record_property):
    """The dropout masks of the segment's re-run are the forward's: the
    grads equal the no-remat build's under the same op seeds (and other
    seeds, other masks, give other grads)."""
    kw = dict(dropout_rate=0.1)
    runs = _same_weights_run([(True, kw), (False, kw)])
    assert _compare(runs, record_property)
    other = _same_weights_run([(True, kw), (False, kw)], seeds=(1000, 2000))
    assert not np.array_equal(other[0][0], other[1][0])


def test_recompute_forward_keeps_only_its_inputs(monkeypatch):
    """The segment's forward records its input tensors themselves and
    nothing else; its outputs carry no graph; its inner ops record
    nothing; the grad op re-runs the segment under autograd."""
    main, startup, loss, _ = build_adam(pfluid, p_tf, p_unique)
    seg = [op for op in main.global_block().ops if op.type == "recompute"]
    assert len(seg) == 1
    forward, replay = lowering._SPECIAL["recompute"]
    seen = {}

    def spy_forward(op, env, ctx):
        before = set(ctx.fwd)
        forward(op, env, ctx)
        kept = ctx.fwd[id(op)]
        xs = [env[v.name] for v in op.inputs["X"]]
        assert len(kept) == len(xs) and all(
            a is b for a, b in zip(kept, xs))
        assert set(ctx.fwd) - before == {id(op)}
        for v in op.outputs["Out"]:
            assert env[v.name].grad_fn is None
            assert not env[v.name].requires_grad
        seen["forward"] = True

    def spy_replay(op, fwd, xs, ctx):
        leaves, outs = replay(op, fwd, xs, ctx)
        assert all(t.grad_fn is not None for t in outs["Out"])
        seen["replay"] = True
        return leaves, outs

    monkeypatch.setitem(lowering._SPECIAL, "recompute",
                        (spy_forward, spy_replay))
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    assert seen == {"forward": True, "replay": True}


@pytest.fixture
def counts():
    j_metrics.enable()
    p_metrics.enable()
    j_metrics.reset()
    p_metrics.reset()

    def read():
        return tuple(
            {k: v for k, v in m.registry().to_dict()["counters"].items()
             if k.startswith("compiler/")}
            for m in (j_metrics, p_metrics))

    yield read
    j_metrics.reset()
    p_metrics.reset()
    j_metrics.disable()
    p_metrics.disable()


def test_passes_leave_the_segment_alone(counts):
    """constant_fold, cse and fetch_dce on the remat Adam program: the
    recompute op, its inputs and its sub-block come through unchanged,
    the optimized programs are alike and the compiler/* counts equal
    JAX's on the same program."""
    with j_unique.guard():
        jm, _, jl, _ = build_adam(jfluid, j_tf, j_unique)
        j_opt = j_ir_passes.optimize_for_execution(jm, [jl.name], JScope())
    with p_unique.guard():
        pm, _, pl, _ = build_adam(pfluid, p_tf, p_unique)
        p_opt = p_ir_passes.optimize_for_execution(pm, [pl.name],
                                                   pfluid.Scope(), "cpu")
    assert p_opt is not pm
    j_counts, p_counts = counts()
    assert p_counts == j_counts
    # the schedule fills the warmup length twice and casts the step
    # counter twice: cse removes one of each; the three fill_constants
    # left (the decay rate, the warmup length, the clip norm) inline as
    # assign_value, and nothing else folds (the rest reads the counter)
    assert p_counts == {"compiler/ops_folded": 0, "compiler/ops_removed": 2,
                        "compiler/programs_optimized": 1}
    types = [op.type for op in p_opt.global_block().ops]
    assert types.count("assign_value") == 3
    assert "fill_constant" not in types
    assert types.count("cast") == [
        op.type for op in pm.global_block().ops].count("cast") - 1
    assert _desc(p_opt) == _desc(j_opt)
    before = [op for op in pm.global_block().ops if op.type == "recompute"]
    after = [op for op in p_opt.global_block().ops if op.type == "recompute"]
    assert len(before) == len(after) == 1
    b, a = before[0], after[0]
    assert a.input_names("X") == b.input_names("X") == b.attrs["x_names"]
    assert a.output_names("Out") == b.output_names("Out")
    assert a.attrs["sub_block"] is p_opt.blocks[1]
    assert _desc(p_opt)[1] == _desc(pm)[1]


def test_recompute_rejects_an_inplace_outer_write():
    with pfluid.program_guard(pfluid.Program(), pfluid.Program()):
        x = pfluid.layers.data(name="x", shape=[4], dtype="float32")
        side = pfluid.layers.fc(x, 4)

        def seg(h):
            pfluid.layers.assign(h, side)
            return pfluid.layers.fc(h, 4)

        with pytest.raises(ValueError, match="in place"):
            pfluid.layers.recompute(seg, x)


def test_recompute_routes_a_passthrough_output_around_the_op():
    main = pfluid.Program()
    with pfluid.program_guard(main, pfluid.Program()):
        x = pfluid.layers.data(name="x", shape=[4], dtype="float32")
        same, new = pfluid.layers.recompute(
            lambda h: (h, pfluid.layers.fc(h, 3)), x)
    assert same is x
    op, = [o for o in main.global_block().ops if o.type == "recompute"]
    assert op.output_names("Out") == [new.name]
    assert main.num_blocks == 2 and main.block(1).parent_idx == 0
    assert main.current_block_idx == 0


def test_for_test_clone_reaches_a_dropout_inside_a_segment():
    p_layer_helper._op_seed_counter[0] = 1000
    main, startup = pfluid.Program(), pfluid.Program()
    with p_unique.guard(), pfluid.program_guard(main, startup):
        _, _, loss = p_tf.build(dropout_rate=0.1, **CFG)
        pfluid.optimizer.SGD(0.01).minimize(loss)
    test = main.clone(for_test=True)
    assert [b.parent_idx for b in test.blocks] == [-1, 0]
    seg, = [op for op in test.global_block().ops if op.type == "recompute"]
    assert seg.attrs["sub_block"] is test.blocks[1]
    drops = [op for op in test.blocks[1].ops if op.type == "dropout"]
    assert len(drops) == 3 * CFG["n_layers"]
    assert all(op.attrs["is_test"] for op in drops)
    assert not any(op.attrs["is_test"] for op in main.blocks[1].ops
                   if op.type == "dropout")
    assert not any("__fwd_op__" in op.attrs
                   for op in test.global_block().ops)
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    a, = exe.run(test, feed=feed(), fetch_list=[loss], scope=scope)
    b, = exe.run(test, feed=feed(), fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(a, b)  # no mask drawn at test


def test_amp_marks_ops_inside_the_segment_and_keeps_fp32_moments():
    """contrib decorate marks the white-list ops of the sub-block as
    JAX's does; decorate(Adam) keeps its moments fp32 beside bf16
    parameters, through a step."""
    jm, *_ = build_adam(jfluid, j_tf, j_unique, dtype="bfloat16", amp=True)
    pm, ps, pl, _ = build_adam(pfluid, p_tf, p_unique, dtype="bfloat16",
                               amp=True)

    def marked(program):
        return [(op.type, bool(op.attrs.get("__amp_bf16__")))
                for op in program.blocks[1].ops]

    assert marked(pm) == marked(jm)
    assert ("fused_multihead_attention", True) in marked(pm)
    assert ("mul", True) in marked(pm)
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(ps, scope=scope)
    exe.run(pm, feed=feed(), fetch_list=[pl], scope=scope)
    gb = pm.global_block()
    moments = [v for v in gb.vars.values() if "_moment" in v.name]
    assert moments
    for v in moments:
        param = gb.var(v.name.rsplit("_moment", 1)[0])
        assert (param.dtype, v.dtype) == ("bfloat16", "float32")
        assert scope.get(v.name).dtype == torch.float32
        assert scope.get(param.name).dtype == torch.bfloat16


def test_segment_inputs_live_until_the_grad_op():
    """The executor drops no var a segment reads before the recompute op
    and its grad op have both run."""
    main, *_ = build_adam(pfluid, p_tf, p_unique)
    step = _Step(main, ["tokens", "labels"], [])
    ops = main.global_block().ops
    fwd = next(i for i, op in enumerate(ops) if op.type == "recompute")
    grad = next(i for i, op in enumerate(ops)
                if op.attrs.get("__fwd_op__") is ops[fwd])
    freed = {n: i for i, names in step.free_after.items() for n in names}
    for n in ops[fwd].attrs["x_names"]:
        assert freed.get(n, len(ops)) >= grad, n
