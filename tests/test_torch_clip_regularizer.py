"""The port's gradient clips and weight-decay regularizers held against
the JAX package's on the CPU: a two-layer fc regression (4 -> 8 -> 3,
fp32) built in both packages with each clip (by value, by norm, by
global norm, and global-norm groups set per parameter), L1 and L2 decay
(the optimizer's, and a parameter's own overriding it), and a clip with
a decay together. Both packages append the same ops in the same order
(the clip ahead of the decay, as JAX's ``apply_gradients`` runs them);
three SGD steps from the same weights give parameters within rtol 1e-5
(atol 1e-7) of JAX's, and the step moved every parameter."""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as p_unique

RNG = np.random.RandomState(11)
WEIGHTS = {"w1": (RNG.randn(4, 8) * 0.5).astype(np.float32),
           "b1": (RNG.randn(8) * 0.1).astype(np.float32),
           "w2": (RNG.randn(8, 3) * 0.5).astype(np.float32)}
FEED = {"x": RNG.rand(16, 4).astype(np.float32),
        "t": RNG.rand(16, 3).astype(np.float32)}


def _clip(fluid, kind):
    c = fluid.clip
    return {"value": lambda: c.GradientClipByValue(0.05),
            "norm": lambda: c.GradientClipByNorm(0.1),
            "global": lambda: c.GradientClipByGlobalNorm(0.1)}[kind]()


def _build(fluid, unique_name, clip=None, decay=None, own_decay=False,
           groups=False):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data(name="x", shape=[4], dtype="float32")
        t = L.data(name="t", shape=[3], dtype="float32")
        w1_attr = fluid.ParamAttr(
            name="w1", regularizer=(fluid.regularizer.L1Decay(0.02)
                                    if own_decay else None))
        h = L.fc(x, 8, act="relu", param_attr=w1_attr,
                 bias_attr=fluid.ParamAttr(name="b1"))
        y = L.fc(h, 3, param_attr=fluid.ParamAttr(name="w2"),
                 bias_attr=False)
        loss = L.mean(L.square_error_cost(y, t))
        if clip is not None:
            fluid.clip.set_gradient_clip(_clip(fluid, clip))
        if groups:
            gn = fluid.clip.GradientClipByGlobalNorm
            fluid.clip.set_gradient_clip(gn(0.05, group_name="a"),
                                         param_list=["w1", "b1"])
            fluid.clip.set_gradient_clip(gn(1.0, group_name="b"),
                                         param_list=["w2"])
        reg = None
        if decay is not None:
            reg = {"l1": fluid.regularizer.L1Decay,
                   "l2": fluid.regularizer.L2Decay}[decay](0.01)
        fluid.optimizer.SGD(0.1, regularization=reg).minimize(loss)
    return main, startup, loss


def _ops(program):
    ops = program.global_block().ops
    return [(op.type,
             {s: [v.name for v in vs] for s, vs in op.inputs.items()},
             {s: [v.name for v in vs] for s, vs in op.outputs.items()},
             {k: (ops.index(v) if k == "__fwd_op__" else v)
              for k, v in op.attrs.items()})
            for op in ops]


CASES = {
    "clip_value": dict(clip="value"),
    "clip_norm": dict(clip="norm"),
    "clip_global_norm": dict(clip="global"),
    "clip_global_norm_groups": dict(groups=True),
    "l1": dict(decay="l1"),
    "l2": dict(decay="l2"),
    "l2_with_a_param_own_l1": dict(decay="l2", own_decay=True),
    "global_norm_and_l2": dict(clip="global", decay="l2"),
    "value_and_l1": dict(clip="value", decay="l1"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_clip_and_decay_match_jax(case):
    kw = CASES[case]
    jm, js, jl = _build(jfluid, j_unique, **kw)
    pm, ps, pl = _build(pfluid, p_unique, **kw)
    assert _ops(pm) == _ops(jm)
    types = [op.type for op in pm.global_block().ops]
    if kw.get("clip") == "global" or kw.get("groups"):
        assert types.count("sqrt") == (2 if kw.get("groups") else 1)
    if kw.get("decay"):  # the decay comes after every clip op
        first_decay = min(i for i, op in enumerate(pm.global_block().ops)
                          if op.type in ("sign", "scale")
                          and op.inputs["X"][0].name in WEIGHTS)
        clip_ops = [i for i, t in enumerate(types)
                    if t in ("clip", "clip_by_norm", "elementwise_max")]
        assert all(i < first_decay for i in clip_ops)

    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    pexe, pscope = pfluid.Executor("cpu"), pfluid.Scope()
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    for n, w in WEIGHTS.items():
        jscope.set(n, w.copy())
        pscope.set(n, torch.from_numpy(w.copy()))
    for step in range(3):
        jv, = jexe.run(jm, feed=FEED, fetch_list=[jl], scope=jscope)
        pv, = pexe.run(pm, feed=FEED, fetch_list=[pl], scope=pscope)
        np.testing.assert_allclose(pv, np.asarray(jv), rtol=1e-5,
                                   err_msg="loss of step %d" % step)
    for n, w in WEIGHTS.items():
        want = np.asarray(jscope.get(n))
        got = pscope.get(n).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=n)
        assert not np.array_equal(want, w), n


def test_set_gradient_clip_is_scoped_to_its_program():
    """A clip set on one program adds no op to another."""
    clipped, _, _ = _build(pfluid, p_unique, clip="global")
    plain, _, _ = _build(pfluid, p_unique)
    assert "sqrt" in [op.type for op in clipped.global_block().ops]
    assert "sqrt" not in [op.type for op in plain.global_block().ops]
    assert getattr(plain, "_gradient_clip_attr", None) is None
