"""``transformer_fluid.build_stacked`` (the flagship's layer stack as one
``StaticRNN(remat=True)`` over stacked ``[n_layers, ...]`` weights) and
the rematerialized recurrence of ``core/lowering.py``, held against the
JAX package and against the port's own recorded recurrence on the CPU,
at vocab 256, d_model 64, 1 head of 64 (the flash kernel qualifies in
JAX at seq 128), 2 layers, d_ff 128, batch 2.

* fp32 Adam for 3 steps against JAX: losses to rtol 1e-5, the grads
  Adam reads to 1e-4 of each tensor's largest plus 1e-7 of the largest
  of all (every layer's slice of every stacked grad among them: a
  replay that writes a step's grad into the wrong slice fails), every
  parameter as ``tests/test_torch_recompute.py`` holds them (each
  update to rtol 1e-4 plus the larger of 3e-8 and 2 ulps, plus what the
  observed grad differences let Adam move it,
  ``chip_smoke.adam_param_limit``), the moments to what those grad
  differences move them plus 3 ulps and 2^-20 of their terms, the beta
  powers bitwise.
* Two bf16 steps under the legacy decorator (static loss scale 1.0, the
  example's recipe) against JAX within ``STEP_TOL["bfloat16"]``: the
  losses to its loss_rtol, each step's grads to grad_rtol of each
  tensor's largest plus floor_rel of the largest of all.
* ``remat=True`` against the recorded loop (``remat`` off on the same
  program) in the port, from the same weights: losses equal, grads to
  rtol 1e-6 (the test records whether they are bitwise; on the CPU they
  are), with a dropout in the step body too (the replay redraws step
  t's mask from the op's seed: the same grads; another seed, another
  loss).
* The remat forward keeps the op's inputs and each step's incoming carry
  (one [B, T, D] tensor a layer) and no graph; the replay runs the body
  once more a step, backwards through the steps, one step's graph at a
  time (the flash_attention op runs 2 L times a step: L in the scan, L
  in the replay).
* A recompute segment nested in a recurrent body and a recurrence
  nested in a recompute segment give JAX's grads.
* The contrib decorator marks the white-list ops of the recurrent
  sub-block as JAX's does, ``clone(for_test=True)`` reaches into it, and
  the executor keeps the op's inputs alive until its grad op.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer_fluid as j_tf

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import layer_helper as p_layer_helper
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.executor import _Step
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import transformer_fluid as p_tf
from paddle_tpu_torch.ops import registry as p_registry
from torch_parity import carry_scope
from torch_parity import (  # noqa: F401 (the autouse fixture)
    pin_jax_init_draw as _pin_jax_init_draw)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=256, d_model=64, n_heads=1, n_layers=2, d_ff=128,
           seq_len=128)
BETA1, BETA2 = 0.9, 0.999


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_stacked",
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


def build(fluid, tf, unique_name, dtype="float32", amp=False):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = tf.build_stacked(dtype=dtype, **CFG)
        opt = fluid.optimizer.Adam(learning_rate=1e-3 if not amp else 3e-4,
                                   beta1=BETA1, beta2=BETA2)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        opt.minimize(loss)
    return main, startup, loss


def _pair(dtype="float32", amp=False):
    """Both packages' programs, the port's scope holding JAX's start."""
    jm, js, jl = build(jfluid, j_tf, j_unique, dtype, amp)
    pm, ps, pl = build(pfluid, p_tf, p_unique, dtype, amp)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    pexe, pscope = pfluid.Executor("cpu"), pfluid.Scope()
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    names = sorted(v.name for v in jm.global_block().vars.values()
                   if v.persistable)
    start = carry_scope(jscope, pscope, names)
    return (jm, jl, jexe, jscope), (pm, pl, pexe, pscope), names, start


def _adam_grads(main):
    return {op.inputs["Param"][0].name: op.inputs["Grad"][0].name
            for op in main.global_block().ops if op.type == "adam"}


def _recurrent(main):
    ops = [op for op in main.global_block().ops if op.type == "recurrent"]
    assert len(ops) == 1
    return ops[0]


def test_stacked_program_is_jax_s():
    (jm, *_), (pm, *_), _, _ = _pair()
    for jb, pb in zip(jm.blocks, pm.blocks):
        assert [op.type for op in pb.ops] == [op.type for op in jb.ops]
        for jo, po in zip(jb.ops, pb.ops):
            assert ({s: [v.name for v in vs] for s, vs in po.inputs.items()}
                    == {s: [v.name for v in vs]
                        for s, vs in jo.inputs.items()}), po.type
            assert ({s: [v.name for v in vs]
                     for s, vs in po.outputs.items()}
                    == {s: [v.name for v in vs]
                        for s, vs in jo.outputs.items()}), po.type
    assert len(pm.blocks) == 2
    op = _recurrent(pm)
    assert op.attrs["remat"] and len(op.inputs["StepInputs"]) == 12
    assert [op.type for op in pm.blocks[1].ops].count("flash_attention") == 1


def test_stacked_adam_matches_jax_for_three_steps():
    (jm, jl, jexe, jscope), (pm, pl, pexe, pscope), names, start = _pair()
    grads = _adam_grads(pm)
    params = sorted(grads)
    assert {p for p in params if p.startswith("st_")} == {
        "st_wqkv", "st_bqkv", "st_wproj", "st_bproj", "st_ln1_s", "st_ln1_b",
        "st_ln2_s", "st_ln2_b", "st_wff1", "st_bff1", "st_wff2", "st_bff2"}
    fetch = [pl.name] + [grads[p] for p in params]
    g_ref, g_err = {p: [] for p in params}, {p: [] for p in params}
    batch = feed()
    for step in range(3):
        jo = [np.asarray(v) for v in jexe.run(jm, feed=batch,
                                               fetch_list=fetch,
                                               scope=jscope)]
        po = pexe.run(pm, feed=batch, fetch_list=fetch, scope=pscope)
        np.testing.assert_allclose(po[0], jo[0], rtol=1e-5,
                                   err_msg="loss of step %d" % step)
        top = max(float(np.abs(g).max()) for g in jo[1:])
        for p, jg, pg in zip(params, jo[1:], po[1:]):
            err = np.abs(pg - jg)
            # every layer's slice of a stacked grad on its own
            for k, (e, j) in enumerate(zip(err, jg) if p.startswith("st_")
                                       else [(err, jg)]):
                assert e.max() <= 1e-4 * np.abs(j).max() + 1e-7 * top, (
                    p, k, step)
            g_ref[p].append(jg)
            g_err[p].append(err)
    limit = _smoke().adam_param_limit
    lrs = [1e-3] * 3
    for n in names:
        want = np.asarray(jscope.get(n)).astype(np.float64)
        got = pscope.get(n).double().numpy()
        s = start[n].astype(np.float64)
        if "_pow_acc_" in n:
            assert np.array_equal(got, want), n
            continue
        if n in grads:
            bound = 1e-4 * np.abs(want - s) + np.maximum(
                2 * fp32_ulp(want), 3e-8) + limit(
                    g_ref[n], g_err[n], lrs, BETA1, BETA2)
            err = np.abs((got - s) - (want - s))
        elif "_moment" not in n:          # the learning rate
            bound, err = 2 * fp32_ulp(want), np.abs(got - want)
        else:
            p = n.rsplit("_moment", 1)[0]
            first = "_moment1_" in n
            b = BETA1 if first else BETA2
            terms = [(1 - b) * b ** (2 - i) * (np.abs(g) + e) ** (
                1 if first else 2)
                for i, (g, e) in enumerate(zip(g_ref[p], g_err[p]))]
            carried = [(1 - b) * b ** (2 - i) * (
                e if first else (2 * np.abs(g) + e) * e)
                for i, (g, e) in enumerate(zip(g_ref[p], g_err[p]))]
            bound = 3 * fp32_ulp(want) + 2.0 ** -20 * sum(terms) + sum(
                carried)
            err = np.abs(got - want)
        i = int(np.argmax(err - bound))
        assert err.flat[i] <= bound.flat[i], (n, got.flat[i], want.flat[i])


def test_stacked_bf16_legacy_two_steps_within_step_tol():
    tol = _smoke().STEP_TOL["bfloat16"]
    (jm, jl, jexe, jscope), (pm, pl, pexe, pscope), _, _ = _pair(
        "bfloat16", amp=True)
    assert pscope.get("st_wqkv").dtype == torch.bfloat16
    params = sorted(pm.param_grad_map)
    fetch = [pl.name] + [pm.param_grad_map[p] for p in params]
    batch = feed()
    for step in range(2):
        jo = [np.asarray(v).astype(np.float32)
              for v in jexe.run(jm, feed=batch, fetch_list=fetch,
                                scope=jscope)]
        po = pexe.run(pm, feed=batch, fetch_list=fetch, scope=pscope)
        np.testing.assert_allclose(po[0], jo[0], rtol=tol["loss_rtol"])
        floor = tol["floor_rel"] * max(float(np.abs(g).max())
                                       for g in jo[1:])
        for p, jg, pg in zip(params, jo[1:], po[1:]):
            lim = tol["grad_rtol"] * float(np.abs(jg).max()) + floor
            assert float(np.abs(pg - jg).max()) <= lim, (p, step)


def _set_remat(main, remat):
    _recurrent(main).attrs["remat"] = remat
    main._bump_version()


def _one_step(main, startup, loss, start=None, seed=0):
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    if start is None:
        start = {n: scope.get(n).clone() for n in scope.local_var_names()
                 if n != "__step_counter__"}
    for n, t in start.items():
        scope.set(n, t.clone())
    params = sorted(main.param_grad_map)
    out = exe.run(main, feed=feed(seed), fetch_list=[loss] + [
        main.param_grad_map[p] for p in params], scope=scope)
    return out[0], dict(zip(params, out[1:])), start


def _compare(a, b, record_property):
    (la, ga), (lb, gb) = a, b
    assert sorted(ga) == sorted(gb)
    np.testing.assert_array_equal(la, lb)
    for p in ga:
        np.testing.assert_allclose(ga[p], gb[p], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(gb[p]).max()),
                                   err_msg=p)
    bitwise = all(np.array_equal(ga[p], gb[p]) for p in ga)
    record_property("grads_bitwise", bitwise)
    return bitwise


def test_remat_equals_the_recorded_loop(record_property):
    main, startup = pfluid.Program(), pfluid.Program()
    with p_unique.guard(), pfluid.program_guard(main, startup):
        _, _, loss = p_tf.build_stacked(dtype="float32", **CFG)
        pfluid.optimizer.SGD(0.0).backward(loss)
    la, ga, start = _one_step(main, startup, loss)
    _set_remat(main, False)
    lb, gb, _ = _one_step(main, startup, loss, start)
    assert _compare((la, ga), (lb, gb), record_property)


def _dropout_rnn(seed, remat):
    """A stacked two-step recurrence with a dropout in its body."""
    p_layer_helper._op_seed_counter[0] = seed
    main, startup = pfluid.Program(), pfluid.Program()
    with p_unique.guard(), pfluid.program_guard(main, startup):
        L = pfluid.layers
        x = L.data(name="tokens", shape=[CFG["seq_len"]], dtype="int32")
        L.data(name="labels", shape=[CFG["seq_len"]], dtype="int32")
        h = L.embedding(x, size=[CFG["vocab_size"], 16])
        w = L.create_parameter(shape=[3, 16, 16], dtype="float32",
                               name="st_w")
        rnn = L.StaticRNN(remat=remat)
        with rnn.step():
            w_t = rnn.step_input(w)
            m = rnn.memory(init=h)
            y = L.dropout(L.tanh(L.matmul(m, w_t)), dropout_prob=0.3)
            rnn.update_memory(m, L.elementwise_add(m, y))
        rnn()
        loss = L.mean(L.square(rnn.final_memories[0]))
        pfluid.optimizer.SGD(0.0).backward(loss)
    return main, startup, loss


def test_remat_equals_the_recorded_loop_with_dropout(record_property):
    """The replay redraws step t's mask: the grads equal the recorded
    loop's under the same op seeds; another seed draws other masks."""
    ma, sa, la_ = _dropout_rnn(1000, True)
    mb, sb, lb_ = _dropout_rnn(1000, False)
    la, ga, start = _one_step(ma, sa, la_)
    lb, gb, _ = _one_step(mb, sb, lb_, start)
    assert _compare((la, ga), (lb, gb), record_property)
    mc, sc, lc_ = _dropout_rnn(2000, True)
    lc, _, _ = _one_step(mc, sc, lc_, start)
    assert not np.array_equal(lc, la)


def test_remat_forward_keeps_only_the_carries(monkeypatch):
    """The forward records the op's inputs and one incoming carry a
    step (no graph on either, nor on its outputs); the inner ops record
    nothing; the grad op replays each step once, last step first."""
    main, startup = pfluid.Program(), pfluid.Program()
    with p_unique.guard(), pfluid.program_guard(main, startup):
        _, _, loss = p_tf.build_stacked(dtype="float32", **CFG)
        pfluid.optimizer.SGD(0.01).minimize(loss)
    op = _recurrent(main)
    forward = lowering._scan_forward
    seen = {"steps": []}

    def spy_forward(op_, env, ctx):
        before = set(ctx.fwd)
        forward(op_, env, ctx)
        assert set(ctx.fwd) - before == {id(op_)}
        ins, carries = ctx.fwd[id(op_)]
        assert len(carries) == CFG["n_layers"]
        for carry in carries:
            h, = carry
            assert tuple(h.shape) == (2, CFG["seq_len"], CFG["d_model"])
            assert h.grad_fn is None and not h.requires_grad
        for v in op_.outputs["FinalMemories"]:
            assert env[v.name].grad_fn is None
        xs = [env[v.name] for v in op_.inputs["StepInputs"]]
        assert all(a is b for a, b in zip(ins["StepInputs"], xs))
        seen["forward"] = True

    import paddle_tpu_torch.ops.controlflow as cf

    step = cf.recurrent_step

    def spy_step(block, env, attrs, carry, xs_t, t, seq_len, ctx):
        seen["steps"].append((t, torch.is_grad_enabled()))
        return step(block, env, attrs, carry, xs_t, t, seq_len, ctx)

    monkeypatch.setattr(lowering, "_scan_forward", spy_forward)
    monkeypatch.setattr(cf, "recurrent_step", spy_step)
    flash = p_registry.get("flash_attention")
    impl, calls = flash.impl, []

    def counted(ctx, ins, attrs):
        calls.append(torch.is_grad_enabled())
        return impl(ctx, ins, attrs)

    monkeypatch.setattr(flash, "impl", counted)
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    assert seen["forward"] and op.attrs["remat"]
    L = CFG["n_layers"]
    # the scan under no_grad, then the replay under autograd, reversed
    assert seen["steps"] == [(t, False) for t in range(L)] + [
        (t, True) for t in reversed(range(L))]
    assert calls == [False] * L + [True] * L


def _nested(fluid, inner):
    """A two-step recurrence with a recompute segment in its body
    (`inner`), or a recompute segment around a recurrence."""
    L = fluid.layers
    x = L.data(name="x", shape=[3, 8], dtype="float32")
    w = L.create_parameter(
        shape=[2, 8, 8], dtype="float32", name="st_nw",
        default_initializer=fluid.initializer.Normal(0.0, 0.5))

    def rnn_over(h):
        rnn = L.StaticRNN(remat=True)
        with rnn.step():
            w_t = rnn.step_input(w)
            m = rnn.memory(init=h)

            def body(a):
                return L.tanh(L.matmul(a, w_t))

            y = L.recompute(body, m) if inner else body(m)
            rnn.update_memory(m, L.elementwise_add(m, y))
        rnn()
        return rnn.final_memories[0]

    out = rnn_over(x) if inner else L.recompute(rnn_over, x)
    loss = L.mean(L.square(out))
    (_, g), = fluid.append_backward(loss, parameter_list=[w])
    return loss, g


@pytest.mark.parametrize("inner", [True, False],
                         ids=["recompute_in_rnn", "rnn_in_recompute"])
def test_nested_recompute_and_recurrence_match_jax(inner):
    progs = []
    for fluid, un in ((jfluid, j_unique), (pfluid, p_unique)):
        main, startup = fluid.Program(), fluid.Program()
        with un.guard(), fluid.program_guard(main, startup):
            loss, g = _nested(fluid, inner)
        progs.append((main, startup, loss, g))
    (jm, js, jl, jg), (pm, ps, pl, pg) = progs
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    pexe, pscope = pfluid.Executor("cpu"), pfluid.Scope()
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    scope_from_numpy(pscope, {"st_nw": np.asarray(jscope.get("st_nw"))})
    xd = np.random.RandomState(2).randn(4, 3, 8).astype(np.float32)
    jo = [np.asarray(v) for v in jexe.run(jm, feed={"x": xd},
                                           fetch_list=[jl, jg],
                                           scope=jscope)]
    po = pexe.run(pm, feed={"x": xd}, fetch_list=[pl, pg], scope=pscope)
    np.testing.assert_allclose(po[0], jo[0], rtol=1e-6)
    np.testing.assert_allclose(po[1], jo[1], rtol=1e-5,
                               atol=1e-6 * float(np.abs(jo[1]).max()))
    assert float(np.abs(po[1]).max()) > 0


def test_amp_marks_and_test_clone_reach_the_step_body():
    jm, *_ = build(jfluid, j_tf, j_unique, "bfloat16", amp=True)
    pm, ps, pl = build(pfluid, p_tf, p_unique, "bfloat16", amp=True)

    def marked(program):
        return [(op.type, bool(op.attrs.get("__amp_bf16__")))
                for op in program.blocks[1].ops]

    assert marked(pm) == marked(jm)
    assert ("matmul", True) in marked(pm)
    assert ("flash_attention", True) in marked(pm)
    test = pm.clone(for_test=True)
    op = _recurrent(test)
    assert op.attrs["sub_block"] is test.blocks[1]
    assert [o.type for o in test.blocks[1].ops] == [
        o.type for o in pm.blocks[1].ops]
    assert not any("__fwd_op__" in o.attrs for o in test.global_block().ops)
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(ps, scope=scope)
    a, = exe.run(test, feed=feed(), fetch_list=[pl], scope=scope)
    b, = exe.run(pm, feed=feed(), fetch_list=[pl], scope=scope)
    assert a == b     # the test clone's loss is the train step's forward


def test_recurrent_inputs_live_until_the_grad_op():
    pm, _, _ = build(pfluid, p_tf, p_unique)
    step = _Step(pm, ["tokens", "labels"], [])
    ops = pm.global_block().ops
    fwd = next(i for i, op in enumerate(ops) if op.type == "recurrent")
    grad = next(i for i, op in enumerate(ops)
                if op.attrs.get("__fwd_op__") is ops[fwd])
    freed = {n: i for i, names in step.free_after.items() for n in names}
    for n in ops[fwd].input_names():
        assert freed.get(n, len(ops)) >= grad, n
