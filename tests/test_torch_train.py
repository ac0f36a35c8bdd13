"""The Fluid-API training step of the Transformer LM, the PyTorch port
held against the JAX package end to end on the CPU, at a size where the
flash kernel qualifies in JAX (vocab 256, d_model 128, 2 heads of 64, 2
layers, d_ff 256, seq 128, batch 2).

Both packages build the program, the JAX startup program makes the
weights, ``paddle_tpu_torch.io.scope_from_numpy`` carries them (and the
learning rate and the loss scale) into the port's scope by name, and
both run two SGD steps on the same seeded tokens. The JAX side runs its
Pallas flash kernel in interpret mode, as its own tests run it.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer_fluid as j_tf

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import transformer_fluid as p_tf

CFG = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256,
           seq_len=128)
# the JAX decorator always makes dynamic loss scaling's step counters;
# the port scales statically only and makes none
_JAX_ONLY = ("good_steps", "bad_steps")


def build(fluid, tf, unique_name, dtype, amp):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = tf.build(remat=False, dtype=dtype, **CFG)
        opt = fluid.optimizer.SGD(0.01)
        if amp is not None:  # "static": the headline (legacy AMP) setting
            opt = fluid.contrib.mixed_precision.decorate(
                opt, init_loss_scaling={"static": 1.0, "scaled": 1024.0}[amp],
                use_dynamic_loss_scaling=False)
        opt.minimize(loss)
    return main, startup, loss


def feed(seed=0, batch=2):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, CFG["vocab_size"],
                       (batch, CFG["seq_len"])).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("dtype,amp", [("float32", None),
                                       ("bfloat16", "static"),
                                       ("bfloat16", "scaled")])
def test_two_sgd_steps_match_jax(dtype, amp):
    """Per-step loss and every persistable after step 2.

    fp32: losses to rtol 1e-5, and each parameter's update (after minus
    before) to rtol 1e-4 plus 3e-8 (4 fp32 ulps at the weights' 0.125
    scale: the two packages sum in different orders).
    bf16 (legacy AMP at a static loss scale of 1, and of 1024, which
    runs check_finite_and_unscale): losses to rtol 1e-3; every element
    of every parameter within 2 bf16 ulps of its own magnitude (bf16
    rounds at other places in the two packages, so a sub-ulp update may
    round the other way, once a step) plus 2^-8 of the step's largest
    update (a bf16 grad carries 8 significant bits of the terms it sums;
    near-zero biases show it)."""
    jm, js, jl = build(jfluid, j_tf, j_unique, dtype, amp)
    pm, ps, pl = build(pfluid, p_tf, p_unique, dtype, amp)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    pexe, pscope = pfluid.Executor("cpu"), pfluid.Scope()
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    names = sorted(v.name for v in jm.global_block().vars.values()
                   if v.persistable and not v.name.startswith(_JAX_ONLY))
    assert names == sorted(v.name for v in pm.global_block().vars.values()
                           if v.persistable)
    assert set(names) == set(pscope.local_var_names()) - {
        "__step_counter__"}
    # copies: JAX donates (reuses) its state buffers on the next step
    start = {n: np.array(jscope.get(n), copy=True) for n in names}
    scope_from_numpy(pscope, start)
    start = {n: a.astype(np.float32) for n, a in start.items()}

    batch = feed()
    for step in range(2):
        jv, = jexe.run(jm, feed=batch, fetch_list=[jl], scope=jscope)
        pv, = pexe.run(pm, feed=batch, fetch_list=[pl], scope=pscope)
        assert pv.dtype == np.float32 and pv.shape == (1,)
        np.testing.assert_allclose(
            pv, np.asarray(jv), rtol=1e-5 if dtype == "float32" else 1e-3,
            err_msg="loss of step %d" % step)
    wants = {n: np.asarray(jscope.get(n)).astype(np.float32)
             for n in names}
    largest = max(np.abs(wants[n] - start[n]).max() for n in names)
    updated = 0
    for n in names:
        want, got = wants[n], pscope.get(n).float().numpy()
        assert got.shape == want.shape, n
        if dtype == "float32":
            np.testing.assert_allclose(got - start[n], want - start[n],
                                       rtol=1e-4, atol=3e-8, err_msg=n)
        else:
            bound = 2 * bf16_ulp(want) + largest / 256
            assert (np.abs(got - want) <= bound).all(), n
        updated += int(not np.array_equal(want, start[n]))
    assert updated >= 4 * CFG["n_layers"]  # the step moved the weights


def test_loss_falls_on_the_port():
    """The headline configuration trains: five steps on one batch lower
    the loss monotonically."""
    main, startup, loss = build(pfluid, p_tf, p_unique, "bfloat16",
                                "static")
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed(), fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(5)]
    assert all(np.isfinite(losses))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_uninitialized_persistable_and_missing_feed_raise():
    main, startup, loss = build(pfluid, p_tf, p_unique, "float32", None)
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    with pytest.raises(RuntimeError, match="not initialized.*startup"):
        exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    exe.run(startup, scope=scope)
    with pytest.raises(KeyError, match="feed 'labels' is missing"):
        exe.run(main, feed={"tokens": feed()["tokens"]}, fetch_list=[loss],
                scope=scope)
    # int64 ids within range are narrowed to the declared int32
    batch = {k: v.astype(np.int64) for k, v in feed().items()}
    out, = exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
    assert np.isfinite(out).all()
    batch["tokens"][0, 0] = 2 ** 40
    with pytest.raises(ValueError, match="int32 range"):
        exe.run(main, feed=batch, fetch_list=[loss], scope=scope)


def test_dynamic_loss_scaling_is_refused():
    """Dynamic loss scaling (the decorator's default) is not ported: the
    decorator says so instead of scaling statically."""
    with pytest.raises(NotImplementedError, match="dynamic loss scaling"):
        pfluid.contrib.mixed_precision.decorate(pfluid.optimizer.SGD(0.01))
    opt = pfluid.contrib.mixed_precision.decorate(
        pfluid.optimizer.SGD(0.01), init_loss_scaling=8.0,
        use_dynamic_loss_scaling=False)
    assert opt.get_loss_scaling() is None  # made by minimize


def test_scope_from_numpy_checks_and_keeps_bf16_bits():
    import ml_dtypes

    scope = pfluid.Scope()
    scope.set("w", torch.zeros(2, 3, dtype=torch.bfloat16))
    bits = np.arange(6, dtype=np.uint16).reshape(2, 3) + 0x3F80
    scope_from_numpy(scope, {"w": bits.view(ml_dtypes.bfloat16)})
    assert (scope.get("w").view(torch.int16).numpy().view(np.uint16)
            == bits).all()
    with pytest.raises(ValueError, match="'w'"):
        scope_from_numpy(scope, {"w": np.zeros((2, 3), np.float32)})
    with pytest.raises(KeyError, match="'v'"):
        scope_from_numpy(scope, {"v": np.zeros(1, np.float32)})
