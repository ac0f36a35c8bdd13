"""The port's optimizer family held against the JAX package's on the CPU.

* Each update op (``ops/optimizer_ops.py``) on the same seeded inputs:
  the fp32 state within 2 fp32 ulps of the JAX op's, a bf16 ParamOut
  within 1 bf16 ulp (both round once, on the write-back, from fp32 math
  done in the same order). The ulps are those of the largest of the
  result, the state it updates and the step between them: a result
  that is the difference of two larger terms rounds at their ulps. Two
  ops add what the math itself amplifies: lamb and lars_momentum a
  worst-case reduction error (n fp32 roundings a norm, relative to
  the step), and ftrl the propagation of 2 ulps of each square root or
  power through the differences it takes (XLA's CPU sqrt is not
  correctly rounded: it differs from torch's by an ulp on about 6
  values in 1000, and ftrl's sigma subtracts two roots).
* Each optimizer appends the JAX package's ops: types, slots, var names
  and attrs; its accumulators' names, shapes and dtypes, and the startup
  fills.
* Each optimizer's 6-step trajectory on ``tests/test_optimizer_torch_
  parity.py``'s objective (an fc without bias under a mean squared
  error, the same weights and data) stays within rtol 1e-5 of JAX's.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.ops import registry as j_registry

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.ops import registry as p_registry

W0 = np.random.RandomState(3).randn(4, 3).astype(np.float32) * 0.5
X = np.random.RandomState(4).rand(8, 4).astype(np.float32)
TGT = np.random.RandomState(5).rand(8, 3).astype(np.float32)


def ulp(x, mantissa_bits):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - mantissa_bits).astype(np.float64)


# op -> (state slots: (in slot, out slot, kind)), attrs). kind "pos": a
# non-negative accumulator ("big": one above 0.02); "pow1"/"pow2": a
# beta power [1]; "any": signed ("small": within a few 0.005)
_STATE = {
    "sgd": ((), {}),
    "momentum": ((("Velocity", "VelocityOut", "any"),), {"mu": 0.9}),
    "momentum_nesterov": ((("Velocity", "VelocityOut", "any"),),
                          {"mu": 0.9, "use_nesterov": True}),
    "lars_momentum": ((("Velocity", "VelocityOut", "any"),),
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
    "adam": ((("Moment1", "Moment1Out", "any"),
              ("Moment2", "Moment2Out", "pos"),
              ("Beta1Pow", "Beta1PowOut", "pow1"),
              ("Beta2Pow", "Beta2PowOut", "pow2")),
             {"beta1": 0.9, "beta2": 0.98, "epsilon": 1e-9}),
    "adamax": ((("Moment", "MomentOut", "any"),
                ("InfNorm", "InfNormOut", "pos"),
                ("Beta1Pow", None, "pow1")),
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adagrad": ((("Moment", "MomentOut", "pos"),), {"epsilon": 1e-6}),
    "decayed_adagrad": ((("Moment", "MomentOut", "pos"),),
                        {"decay": 0.95, "epsilon": 1e-6}),
    "adadelta": ((("AvgSquaredGrad", "AvgSquaredGradOut", "pos"),
                  ("AvgSquaredUpdate", "AvgSquaredUpdateOut", "pos")),
                 {"rho": 0.95, "epsilon": 1e-6}),
    "rmsprop": ((("MeanSquare", "MeanSquareOut", "pos"),
                 ("Moment", "MomentOut", "any")),
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.9}),
    "rmsprop_centered": ((("MeanSquare", "MeanSquareOut", "big"),
                          ("MeanGrad", "MeanGradOut", "small"),
                          ("Moment", "MomentOut", "any")),
                         {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.9,
                          "centered": True}),
    "ftrl": ((("SquaredAccumulator", "SquaredAccumOut", "pos"),
              ("LinearAccumulator", "LinearAccumOut", "any")),
             {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
    "ftrl_power": ((("SquaredAccumulator", "SquaredAccumOut", "pos"),
                    ("LinearAccumulator", "LinearAccumOut", "any")),
                   {"l1": 0.01, "l2": 0.02, "lr_power": -0.6}),
    "lamb": ((("Moment1", "Moment1Out", "any"),
              ("Moment2", "Moment2Out", "pos"),
              ("Beta1Pow", "Beta1PowOut", "pow1"),
              ("Beta2Pow", "Beta2PowOut", "pow2")),
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}),
    "proximal_gd": ((), {"l1": 0.001, "l2": 0.01}),
    "proximal_adagrad": ((("Moment", "MomentOut", "pos"),),
                         {"l1": 0.001, "l2": 0.01}),
}


def _op_inputs(case, param_dtype, seed=0):
    rng = np.random.RandomState(seed)
    shape = (16, 8)
    ins = {"Param": rng.randn(*shape).astype(np.float32),
           "Grad": (rng.randn(*shape) * 0.1).astype(np.float32),
           "LearningRate": np.array([0.01], np.float32)}
    for slot, _, kind in _STATE[case][0]:
        if kind == "pow1":
            ins[slot] = np.array([0.9 ** 3], np.float32)
        elif kind == "pow2":
            ins[slot] = np.array([_STATE[case][1].get("beta2") ** 3],
                                 np.float32)
        elif kind == "pos":
            ins[slot] = (rng.rand(*shape) * 0.05 + 1e-3).astype(np.float32)
        elif kind == "big":  # a mean square above any mean grad squared
            ins[slot] = (rng.rand(*shape) * 0.05 + 0.02).astype(np.float32)
        elif kind == "small":
            ins[slot] = (rng.randn(*shape) * 0.005).astype(np.float32)
        else:
            ins[slot] = (rng.randn(*shape) * 0.05).astype(np.float32)
    if param_dtype == "bfloat16":
        for slot in ("Param", "Grad"):
            ins[slot] = ins[slot].astype(ml_dtypes.bfloat16)
    return ins


def _extra_limits(op, ins, attrs, want):
    """{out slot: what the op's own math adds to the ulp limit}."""
    f = {k: np.asarray(v, np.float64) for k, v in ins.items()}
    if op in ("lamb", "lars_momentum"):
        n = f["Param"].size
        step = np.abs(want["ParamOut"] - f["Param"])
        return {"ParamOut": 2 * n * 2.0 ** -24 * step}
    if op != "ftrl":
        return {}
    p, g, lr = f["Param"], f["Grad"], f["LearningRate"][0]
    sq, lin = f["SquaredAccumulator"], f["LinearAccumulator"]
    power = attrs.get("lr_power", -0.5)
    root = (np.sqrt if power == -0.5 else lambda v: v ** (-power))
    new_sq = sq + g * g
    d_sigma = 2 * (ulp(root(new_sq), 23) + ulp(root(sq), 23)) / lr
    sigma = (root(new_sq) - root(sq)) / lr
    d_lin = 2 * ulp(np.maximum(np.abs(lin) + np.abs(g),
                               np.abs(sigma * p)), 23) + d_sigma * np.abs(p)
    lin_out = want["LinearAccumOut"]
    y = root(new_sq) / lr + 2 * attrs.get("l2", 0.0)
    d_y = 2 * ulp(root(new_sq), 23) / lr
    x = attrs.get("l1", 0.0) * np.sign(lin_out) - lin_out
    d_p = (d_lin + 2 * ulp(np.abs(x) + np.abs(lin_out), 23)) / y \
        + np.abs(x) * d_y / y ** 2
    return {"LinearAccumOut": d_lin, "ParamOut": d_p}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_STATE))
def test_update_op_matches_jax(case, param_dtype):
    op = case.split("_nesterov")[0].split("_centered")[0].split("_power")[0]
    state, attrs = _STATE[case]
    ins = _op_inputs(case, param_dtype)
    j_outs = j_registry.get(op).impl(
        None, {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs)
    p_ins = {k: [_torch(v)] for k, v in ins.items()}
    p_outs = p_registry.get(op).impl(None, p_ins, attrs)
    # the port writes in place into the tensors it was given
    assert p_outs["ParamOut"][0] is p_ins["Param"][0]
    pairs = [("Param", "ParamOut")] + [(i, o) for i, o, _ in state if o]
    wants = {o: np.asarray(j_outs[o][0]).astype(np.float64).reshape(
        ins[i].shape) for i, o in pairs}
    extra = _extra_limits(op, ins, attrs, wants)
    for slot_in, slot_out in pairs:
        want = wants[slot_out]
        got = p_ins[slot_in][0].double().numpy()
        assert got.shape == ins[slot_in].shape
        bits = 7 if (slot_in == "Param" and param_dtype == "bfloat16") \
            else 23
        start = np.asarray(ins[slot_in], np.float64)
        mag = np.maximum(np.maximum(np.abs(want), np.abs(start)),
                         np.abs(want - start))
        lim = (1 if bits == 7 else 2) * ulp(mag, bits) \
            + extra.get(slot_out, 0.0)
        err = np.abs(got - want)
        i = int(np.argmax(err - lim))
        assert err.flat[i] <= lim.flat[i], (
            "%s %s: %r vs %r at %d" % (case, slot_out, got.flat[i],
                                       want.flat[i], i))
    assert p_ins["Param"][0].dtype == _torch(ins["Param"]).dtype


# (name, constructor kwargs) of every ported optimizer
OPTIMIZERS = [
    ("SGD", dict(learning_rate=0.1)),
    ("Momentum", dict(learning_rate=0.05, momentum=0.9)),
    ("Momentum", dict(learning_rate=0.05, momentum=0.9, use_nesterov=True)),
    ("LarsMomentum", dict(learning_rate=0.05, momentum=0.9)),
    ("Adagrad", dict(learning_rate=0.05, epsilon=1e-10,
                     initial_accumulator_value=0.1)),
    ("Adam", dict(learning_rate=0.01, beta1=0.9, beta2=0.98,
                  epsilon=1e-9)),
    ("Adamax", dict(learning_rate=0.01)),
    ("DecayedAdagrad", dict(learning_rate=0.05)),
    ("Adadelta", dict(learning_rate=1.0, epsilon=1e-6, rho=0.95)),
    ("RMSProp", dict(learning_rate=0.01, rho=0.9, momentum=0.5)),
    ("RMSProp", dict(learning_rate=0.01, rho=0.9, centered=True)),
    ("Ftrl", dict(learning_rate=0.05, l1=0.01, l2=0.01)),
    ("Lamb", dict(learning_rate=0.01)),
]
OPT_IDS = ["%s-%d" % (n, i) for i, (n, _) in enumerate(OPTIMIZERS)]


def _objective(fluid, unique_name, name, kw):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        t = fluid.layers.data(name="t", shape=[3], dtype="float32")
        y = fluid.layers.fc(x, 3, param_attr=fluid.ParamAttr(name="tw"),
                            bias_attr=False)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(y, t))
        opt = getattr(fluid.optimizer, name)(**kw)
        opt.minimize(loss)
    return main, startup, loss, opt


def _desc(program):
    ops = program.global_block().ops
    out = []
    for op in ops:
        attrs = {k: (("op", ops.index(v), v.type) if k == "__fwd_op__"
                     else v) for k, v in op.attrs.items()
                 if k != "__op_seed__"}
        out.append((op.type,
                    {s: [v.name for v in vs] for s, vs in op.inputs.items()},
                    {s: [v.name for v in vs] for s, vs in op.outputs.items()},
                    attrs))
    vs = {v.name: (tuple(v.shape) if v.shape is not None else None,
                   v.dtype, v.persistable)
          for v in program.global_block().vars.values()}
    return out, vs


@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=OPT_IDS)
def test_optimizer_appends_the_jax_ops(name, kw):
    jm, js, _, jopt = _objective(jfluid, j_unique, name, kw)
    pm, ps, _, popt = _objective(pfluid, p_unique, name, kw)
    (j_ops, j_vars), (p_ops, p_vars) = _desc(jm), _desc(pm)
    assert [o[0] for o in p_ops] == [o[0] for o in j_ops]
    for i, (jo, po) in enumerate(zip(j_ops, p_ops)):
        assert po == jo, "op %d (%s)" % (i, jo[0])
    assert p_vars == j_vars
    # the startup program fills each accumulator as the JAX one does
    assert _desc(ps) == _desc(js)
    assert popt.get_opti_var_name_list() == jopt.get_opti_var_name_list()
    assert popt.get_opti_var_name_list()  # the learning rate at least


def _trajectory(fluid, unique_name, exe, scope, name, kw, steps=6):
    main, startup, loss, _ = _objective(fluid, unique_name, name, kw)
    exe.run(startup, scope=scope)
    scope.set("tw", W0.copy() if fluid is jfluid else torch.tensor(W0))
    ws = []
    for _ in range(steps):
        exe.run(main, feed={"x": X, "t": TGT}, fetch_list=[loss],
                scope=scope)
        w = scope.get("tw")
        ws.append(np.array(w if fluid is jfluid else w.numpy(), copy=True))
    return ws


@pytest.mark.parametrize("name,kw", OPTIMIZERS, ids=OPT_IDS)
def test_six_step_trajectory_matches_jax(name, kw):
    want = _trajectory(jfluid, j_unique, jfluid.Executor(jfluid.CPUPlace()),
                       JScope(), name, kw)
    got = _trajectory(pfluid, p_unique, pfluid.Executor("cpu"),
                      pfluid.Scope(), name, kw)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0,
                                   err_msg="step %d" % i)
    assert not np.array_equal(want[-1], W0)  # it trained


# ---------------------------------------------------------------------------
# the wrappers: GradientMergeOptimizer, ExponentialMovingAverage and
# ModelAverage (with average_accumulates), held against JAX's on the
# same objective
# ---------------------------------------------------------------------------


def _wrapped(fluid, unique_name, wrap):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        t = fluid.layers.data(name="t", shape=[3], dtype="float32")
        y = fluid.layers.fc(x, 3, param_attr=fluid.ParamAttr(name="tw"),
                            bias_attr=False)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(y, t))
        extra = wrap(fluid, loss)
    return main, startup, loss, extra


def _run_wrapped(wrap, steps, fetch=()):
    """Both packages from W0 for `steps` runs: per run the loss, tw and
    the fetched names; returns (jax side, port side) and the pieces."""
    from paddle_tpu_torch.ops import controlflow as p_cf

    sides = []
    for fluid, un in ((jfluid, j_unique), (pfluid, p_unique)):
        main, startup, loss, extra = _wrapped(fluid, un, wrap)
        exe = (jfluid.Executor(jfluid.CPUPlace()) if fluid is jfluid
               else pfluid.Executor("cpu"))
        scope = JScope() if fluid is jfluid else pfluid.Scope()
        exe.run(startup, scope=scope)
        scope.set("tw", W0.copy() if fluid is jfluid else torch.tensor(W0))
        runs, syncs = [], []
        for _ in range(steps):
            p_cf.reset_counts()
            out = exe.run(main, feed={"x": X, "t": TGT},
                          fetch_list=[loss, "tw"] + list(fetch), scope=scope)
            syncs.append(dict(p_cf.host_syncs))
            runs.append([np.array(o, copy=True) for o in out])
        sides.append(dict(main=main, exe=exe, scope=scope, extra=extra,
                          runs=runs, syncs=syncs))
    return sides


def _types(program):
    return [[op.type for op in b.ops] for b in program.blocks]


@pytest.mark.parametrize("inner", ["SGD", "Adam"])
def test_gradient_merge_matches_jax(inner):
    """k_steps=2: the inner update runs under a cond on even runs only
    (one predicate read a run), on the mean of the two runs' grads; tw
    follows JAX's to rtol 1e-5 over 6 runs. Adam's moments and beta
    powers are written in the branch but are not the cond op's outputs,
    so in both packages they keep their start values."""
    def wrap(fluid, loss):
        opt = getattr(fluid.optimizer, inner)(learning_rate=0.05)
        fluid.optimizer.GradientMergeOptimizer(opt, k_steps=2).minimize(loss)

    j, p = _run_wrapped(wrap, 6)
    assert _types(p["main"]) == _types(j["main"])
    cond, = [op for op in p["main"].global_block().ops if op.type == "cond"]
    assert [v.name for v in cond.outputs["Out"]] == ["tw", "tw_grad_merge_0"]
    for i, (jr, pr) in enumerate(zip(j["runs"], p["runs"])):
        np.testing.assert_allclose(pr[0], jr[0], rtol=1e-5)
        np.testing.assert_allclose(pr[1], jr[1], rtol=1e-5, atol=0,
                                   err_msg="run %d" % (i + 1))
    moved = [not np.array_equal(a[1], b[1])
             for a, b in zip(p["runs"], p["runs"][1:])]
    assert moved == [True, False, True, False, True]   # runs 2, 4, 6
    np.testing.assert_array_equal(p["runs"][0][1], W0)  # run 1 merges only
    assert p["syncs"] == [{"cond": 1, "while": 0}] * 6
    for n in p["scope"].local_var_names():
        if "moment" in n or "_pow_acc_" in n:
            want = np.asarray(j["scope"].get(n))
            np.testing.assert_array_equal(p["scope"].get(n).numpy(), want)


def test_exponential_moving_average_matches_jax():
    """Adam then EMA(0.9).update(): over 4 runs the shadow equals the EMA
    recurrence over the port's own parameters to rtol 1e-6 and JAX's
    shadow to the parameters' rtol 1e-5 (Adam's updates differ by
    ~1e-6 between the packages); apply() swaps it into tw (its guard and
    restore() put the trained value back)."""
    def wrap(fluid, loss):
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
        ema = fluid.optimizer.ExponentialMovingAverage(0.9)
        ema.update()
        return ema

    j, p = _run_wrapped(wrap, 4, fetch=["tw.ema"])
    shadow = np.zeros_like(W0)
    for jr, pr in zip(j["runs"], p["runs"]):
        np.testing.assert_allclose(pr[1], jr[1], rtol=1e-5)
        np.testing.assert_allclose(pr[2], jr[2], rtol=1e-5)
        shadow = np.float32(0.9) * shadow + np.float32(0.1) * pr[1]
        np.testing.assert_allclose(pr[2], shadow, rtol=1e-6)
    trained = p["scope"].get("tw").clone()
    with p["extra"].apply(scope=p["scope"]):
        np.testing.assert_array_equal(p["scope"].get("tw").numpy(),
                                      p["runs"][-1][2])
    np.testing.assert_array_equal(p["scope"].get("tw").numpy(),
                                  trained.numpy())
    from paddle_tpu.core.scope import scope_guard

    with scope_guard(j["scope"]):
        j["extra"].apply()
        np.testing.assert_allclose(p["runs"][-1][2],
                                   np.asarray(j["scope"].get("tw")),
                                   rtol=1e-5)
        j["extra"].restore()


def test_model_average_matches_jax():
    """SGD with ModelAverage(0.15, min 2, max 3): the window sums and
    counters of average_accumulates follow JAX's over 7 runs (both
    shifts taken), apply() swaps in the same average, restore() the
    trained parameter."""
    from paddle_tpu.core.scope import scope_guard

    def wrap(fluid, loss):
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
        return fluid.optimizer.ModelAverage(0.15, min_average_window=2,
                                            max_average_window=3)

    names = ["tw_sum_1_0", "tw_sum_2_0", "tw_sum_3_0",
             "tw_num_accumulates_0", "tw_old_num_accumulates_0",
             "tw_num_updates_0"]
    j, p = _run_wrapped(wrap, 7, fetch=names)
    assert _types(p["main"]) == _types(j["main"])
    shifted = set()
    for jr, pr in zip(j["runs"], p["runs"]):
        for n, a, b in zip(names, pr[2:], jr[2:]):
            if "num_" in n:
                np.testing.assert_array_equal(a, b.astype(a.dtype))
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6)
                shifted.add((n, bool(np.any(a))))
    assert ("tw_sum_3_0", True) in shifted
    trained = p["scope"].get("tw").clone()
    p["extra"].apply(p["exe"], scope=p["scope"])
    with scope_guard(j["scope"]):
        j["extra"].apply(j["exe"])
        np.testing.assert_allclose(p["scope"].get("tw").numpy(),
                                   np.asarray(j["scope"].get("tw")),
                                   rtol=1e-6)
        j["extra"].restore(j["exe"])
    p["extra"].restore(p["exe"], scope=p["scope"])
    np.testing.assert_array_equal(p["scope"].get("tw").numpy(),
                                  trained.numpy())


def test_a_fetched_parameter_keeps_its_value():
    """A parameter fetched on the CPU is a copy of the scope's tensor:
    the next run's in-place update leaves the array the caller holds at
    that run's value."""
    main, startup, loss, _ = _objective(pfluid, p_unique, "SGD",
                                        dict(learning_rate=0.1))
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    first, = exe.run(main, feed={"x": X, "t": TGT}, fetch_list=["tw"],
                     scope=scope)
    kept = first.copy()
    second, = exe.run(main, feed={"x": X, "t": TGT}, fetch_list=["tw"],
                      scope=scope)
    np.testing.assert_array_equal(first, kept)
    assert not np.array_equal(first, second)
