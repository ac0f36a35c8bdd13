"""Mixed precision in the port held against the JAX package on the CPU:
the `update_loss_scaling` state machine and `check_finite_and_unscale`
op for op; two (or three) SGD steps of the LM under ``amp.decorate``
(bf16; fp16 with dynamic loss scaling and an overflowing step) and under
the contrib decorator's defaults (dynamic loss scaling), from the same
weights, at the train parity test's size (vocab 256, d_model 128, 2
heads of 64, 2 layers, d_ff 256, seq 128, batch 2)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer_fluid as j_tf
from paddle_tpu.ops import registry as j_registry

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import transformer_fluid as p_tf
from paddle_tpu_torch.ops import registry as p_registry

from test_torch_train import CFG, bf16_ulp, feed
from torch_parity import carry_scope
from torch_parity import (  # noqa: F401 (the autouse fixture)
    pin_jax_init_draw as _pin_jax_init_draw)


def test_update_loss_scaling_is_bitwise_the_jax_op():
    """A found-inf sequence that grows the scale (3 finite steps in a
    row), shrinks it (2 overflows in a row), resets each counter on the
    other kind of step and clamps the scale at 1: every output of every
    step bitwise equal to the JAX op's, fed back as the next step's
    state."""
    attrs = {"incr_every_n_steps": 3, "decr_every_n_nan_or_inf": 2,
             "incr_ratio": 2.0, "decr_ratio": 0.5}
    seq = [0, 0, 0, 0, 1, 0, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
           1, 1, 1, 1, 1, 1, 0, 0, 0]
    j_op = j_registry.get("update_loss_scaling").impl
    p_op = p_registry.get("update_loss_scaling").impl
    state = (np.array([8.0], np.float32), np.array([0], np.int32),
             np.array([0], np.int32))
    scales = []
    for inf in seq:
        found = np.array([bool(inf)])
        j_out = j_op(None, {"PrevLossScaling": [jnp.asarray(state[0])],
                            "InGoodSteps": [jnp.asarray(state[1])],
                            "InBadSteps": [jnp.asarray(state[2])],
                            "FoundInfinite": [jnp.asarray(found)]}, attrs)
        p_out = p_op(None, {"PrevLossScaling": [torch.from_numpy(state[0])],
                            "InGoodSteps": [torch.from_numpy(state[1])],
                            "InBadSteps": [torch.from_numpy(state[2])],
                            "FoundInfinite": [torch.from_numpy(found)]},
                     attrs)
        state = []
        for slot in ("LossScaling", "OutGoodSteps", "OutBadSteps"):
            want = np.asarray(j_out[slot][0])
            got = p_out[slot][0].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
            state.append(got)
        scales.append(float(state[0][0]))
    assert max(scales) > 8.0 and min(scales) == 1.0   # grew; clamped
    assert len(set(scales)) > 4


def test_check_finite_and_unscale_zeroes_grads_on_overflow():
    """The op as the JAX op: finite grads divided by the scale (bf16
    promoted to fp32), every grad zero once any holds an inf or a nan."""
    j_op = j_registry.get("check_finite_and_unscale").impl
    p_op = p_registry.get("check_finite_and_unscale").impl
    rng = np.random.RandomState(3)
    a = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    scale = np.array([1024.0], np.float32)
    for bad in (None, np.inf, np.nan):
        bb = b.copy()
        if bad is not None:
            bb[3] = bad
        j_out = j_op(None, {"X": [jnp.asarray(a), jnp.asarray(
            bb, jnp.bfloat16)], "Scale": [jnp.asarray(scale)]}, {})
        p_out = p_op(None, {"X": [torch.from_numpy(a), torch.from_numpy(
            bb).to(torch.bfloat16)], "Scale": [torch.from_numpy(scale)]}, {})
        for want, got in zip(j_out["Out"], p_out["Out"]):
            want = np.asarray(want)
            assert got.dtype == torch.float32 and want.dtype == np.float32
            assert np.array_equal(got.numpy(), want)
        assert bool(p_out["FoundInfinite"][0][0]) == (bad is not None) \
            == bool(np.asarray(j_out["FoundInfinite"][0])[0])
        if bad is not None:
            assert all(not g.any() for g in p_out["Out"])


def _build(fluid, tf, unique_name, dtype, make_opt):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = tf.build(remat=False, dtype=dtype, **CFG)
        opt = make_opt(fluid)
        opt.minimize(loss)
    return main, startup, loss, opt


def sgd_steps_match_jax(dtype, make_opt, steps=2, low="bfloat16",
                        before_step=None):
    """`steps` SGD steps in both packages from the JAX startup program's
    weights; per-step losses, then every persistable. Bounds as the
    train parity test's (``two_sgd_steps_match_jax``) for the compute
    dtype `low`: losses to rtol 1e-3; every element of every parameter
    within 2 ulps of `low` at the larger of its start and its JAX result
    plus 2^-7 of the largest update (fp32-stored params compute in `low`,
    so their grads carry its precision); the loss-scaling state exactly.
    `before_step(step, jscope, pscope)` may change both scopes alike.
    Returns (JAX scope, port scope, names, start values)."""
    jm, js, jl, jopt = _build(jfluid, j_tf, j_unique, dtype, make_opt)
    pm, ps, pl, popt = _build(pfluid, p_tf, p_unique, dtype, make_opt)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    pexe, pscope = pfluid.Executor("cpu"), pfluid.Scope()
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    names = sorted(v.name for v in jm.global_block().vars.values()
                   if v.persistable)
    assert names == sorted(v.name for v in pm.global_block().vars.values()
                           if v.persistable)
    start = carry_scope(jscope, pscope, names)
    batch = feed()
    for step in range(steps):
        if before_step is not None:
            before_step(step, jscope, pscope)
        jv, = jexe.run(jm, feed=batch, fetch_list=[jl], scope=jscope)
        pv, = pexe.run(pm, feed=batch, fetch_list=[pl], scope=pscope)
        np.testing.assert_allclose(pv, np.asarray(jv), rtol=1e-3,
                                   err_msg="loss of step %d" % step)
    start = {n: a.astype(np.float32) for n, a in start.items()}
    wants = {n: np.asarray(jscope.get(n)).astype(np.float32)
             for n in names}
    largest = max(np.abs(wants[n] - start[n]).max() for n in names
                  if jm.global_block().var(n).dtype in ("float32",
                                                        "bfloat16",
                                                        "float16"))
    ulp = bf16_ulp if low == "bfloat16" else (
        lambda x: bf16_ulp(x) / 8)   # fp16: 3 more significant bits
    for n in names:
        want, got = wants[n], pscope.get(n).float().numpy()
        assert got.shape == want.shape, n
        if jm.global_block().var(n).dtype in ("int32", "bool") \
                or "loss_scaling" in n:
            assert np.array_equal(got, want), (n, got, want)
            continue
        bound = (2 * ulp(np.maximum(np.abs(want), np.abs(start[n])))
                 + largest / 128)
        err = np.abs(got - want)
        i = int(np.argmax(err - bound))
        assert err.flat[i] <= bound.flat[i], (
            "%s: %r vs %r (start %r) at flat index %d, bound %r"
            % (n, got.flat[i], want.flat[i], start[n].flat[i], i,
               bound.flat[i]))
    return jscope, pscope, names, start


def _scaling(scope, names):
    return {n.rsplit("_", 1)[0]: float(np.asarray(scope.get(n)).ravel()[0])
            for n in names if "loss_scaling" in n or "_steps" in n}


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_decorate_bf16_two_steps_match_jax(level):
    """``amp.decorate`` (bf16) on the fp32-stored LM: no loss scaling by
    default (no scaling state at all), the fp32 params their own
    masters."""
    jscope, pscope, names, start = sgd_steps_match_jax(
        "float32", lambda f: f.amp.decorate(f.optimizer.SGD(0.01),
                                            amp_level=level))
    assert not any("loss_scaling" in n for n in names)
    moved = [n for n in names
             if not np.array_equal(pscope.get(n).numpy(), start[n])]
    assert len(moved) >= 4 * CFG["n_layers"]


def test_amp_decorate_fp16_dynamic_scaling_with_an_overflow_matches_jax():
    """``amp.decorate(dtype="float16")``: dynamic loss scaling from 2**15
    (here growing 2x after every finite step and shrinking 2^-25x after
    one overflow). Step 1 is finite: the scale doubles. Before step 2
    both scopes' scale is set to 2**40, so the fp16 grads overflow (an
    injected inf): every grad is zeroed, no param moves, the scale
    shrinks to 2**15 and the bad-step counter resets; step 3 trains
    again and doubles it. Params, losses, the scale and the
    good/bad/overflow counters match the JAX package's."""
    snaps = {}

    def before(step, jscope, pscope):
        if step == 1:
            name = [n for n in pscope.local_var_names()
                    if n.startswith("loss_scaling")][0]
            jscope.set(name, jnp.asarray(np.array([2.0 ** 40], np.float32)))
            scope_from_numpy(pscope, {name: np.array([2.0 ** 40],
                                                     np.float32)})
        snap = {n: pscope.get(n).clone() for n in pscope.local_var_names()
                if isinstance(pscope.get(n), torch.Tensor)}
        snaps["after_overflow" if step == 2 else step] = snap

    jscope, pscope, names, start = sgd_steps_match_jax(
        "float32", lambda f: f.amp.decorate(
            f.optimizer.SGD(0.01), dtype="float16", incr_every_n_steps=1,
            decr_every_n_nan_or_inf=1, decr_ratio=2.0 ** -25),
        steps=3, low="float16", before_step=before)
    got = _scaling(pscope, names)
    assert got == _scaling(jscope, names)
    assert got == {"loss_scaling": 2.0 ** 16, "amp_good_steps": 0.0,
                   "amp_bad_steps": 0.0, "amp_overflow_steps": 1.0}
    # the overflowed step moved no parameter
    for n in names:
        if n.endswith((".w_0", ".b_0", "_w")) or "fused_multihead" in n:
            assert torch.equal(snaps[1][n], snaps["after_overflow"][n]), n


def test_contrib_decorator_dynamic_default_matches_jax():
    """``contrib.mixed_precision.decorate`` at its defaults (dynamic
    loss scaling from 2**15, the headline bf16-stored model): two steps,
    the scale and the good/bad counters as the JAX package's."""
    jscope, pscope, names, _ = sgd_steps_match_jax(
        "bfloat16", lambda f: f.contrib.mixed_precision.decorate(
            f.optimizer.SGD(0.01)))
    got = _scaling(pscope, names)
    assert got == _scaling(jscope, names)
    assert got == {"loss_scaling": 2.0 ** 15, "good_steps": 2.0,
                   "bad_steps": 0.0}


def test_amp_decorate_keeps_masters_for_low_precision_params():
    """A bf16-stored model under ``amp.decorate``: an fp32 master per
    param (startup casts it from the param; sgd updates the master; a
    trailing cast re-derives the param), as in the JAX package; and
    `record_metrics` reads the scaling state."""
    def ops(fluid, tf, unique_name):
        main, startup, _, opt = _build(
            fluid, tf, unique_name, "bfloat16",
            lambda f: f.amp.decorate(f.optimizer.SGD(0.01),
                                     dtype="float16"))
        return ([(op.type, op.input_names(), op.output_names())
                 for op in main.global_block().ops
                 if op.type in ("sgd", "cast") and op.attrs.get(
                     "__amp_state__", op.type == "sgd")],
                [(op.type, op.input_names(), op.output_names())
                 for op in startup.global_block().ops
                 if op.type == "cast"], opt, startup, main)

    p_upd, p_init, popt, ps, pm = ops(pfluid, p_tf, p_unique)
    j_upd, j_init, _, _, _ = ops(jfluid, j_tf, j_unique)
    assert (p_upd, p_init) == (j_upd, j_init)
    assert any(o[1][0].endswith(".master") for o in p_upd if o[0] == "sgd")
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(ps, scope=scope)
    assert popt.record_metrics(scope) == {"loss_scale": 2.0 ** 15,
                                          "overflow_steps": 0}


def test_chip_smoke_loss_scaling_gate_follows_the_op():
    """chip_smoke.py's bench phase holds the amp_fp16 leg's final loss
    scale to `loss_scaling_after` over the overflow flags it saw: that
    replay equals the port's update_loss_scaling op run step by step."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_scaling",
        pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    op = p_registry.get("update_loss_scaling").impl
    rng = np.random.RandomState(5)
    for params in (smoke.AMP_FP16_SCALING, (8.0, 3, 2, 2.0, 0.5)):
        init, incr, decr, up, down = params
        flags = list(rng.rand(60) < 0.3)
        scale = torch.tensor([init], dtype=torch.float32)
        good = torch.zeros(1, dtype=torch.int32)
        bad = torch.zeros(1, dtype=torch.int32)
        for inf in flags:
            out = op(None, {"PrevLossScaling": [scale],
                            "InGoodSteps": [good], "InBadSteps": [bad],
                            "FoundInfinite": [torch.tensor([bool(inf)])]},
                     {"incr_every_n_steps": incr,
                      "decr_every_n_nan_or_inf": decr,
                      "incr_ratio": up, "decr_ratio": down})
            scale, good, bad = (out["LossScaling"][0],
                                out["OutGoodSteps"][0],
                                out["OutBadSteps"][0])
        assert smoke.loss_scaling_after(flags, *params) == (
            float(scale[0]), float(good[0]), float(bad[0]))
