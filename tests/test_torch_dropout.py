"""The port's dropout held against the JAX package's on the CPU.

At test time (``is_test``, as ``clone(for_test=True)`` sets it) both
implementations equal the JAX op bitwise, in fp32 and bf16: X * (1 - p)
for downgrade_in_infer, X for upscale_in_train, and a mask of ones. In
training the two packages draw from different generators, so the port
is held to the op's definition: Out equals X * Mask bitwise
(downgrade_in_infer), or X / (1 - p) where Mask is 1 and 0 elsewhere
(upscale_in_train; 1 - p rounded to X's dtype first, as jnp rounds a
Python scalar); the mask's keep fraction over 2^17 elements lies
within 5 sigma of 1 - p; the same (program seed, step, op seed) redraws
the same mask and the next step draws another."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.lowering import LoweringContext as JContext
from paddle_tpu.ops import registry as j_registry

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.core.lowering import LoweringContext
from paddle_tpu_torch.ops import registry as p_registry

IMPLS = ["downgrade_in_infer", "upscale_in_train"]


def _x(dtype, shape=(64, 32), seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_is_test_equals_jax_bitwise(impl, dtype):
    x = _x(dtype)
    attrs = {"dropout_prob": 0.3, "is_test": True,
             "dropout_implementation": impl, "__op_seed__": 7}
    j = j_registry.get("dropout").impl(
        JContext(jax.random.PRNGKey(0)), {"X": [jax.numpy.asarray(x)]},
        attrs)
    p = p_registry.get("dropout").impl(
        LoweringContext("cpu"), {"X": [_torch(x)]}, attrs)
    for slot in ("Out", "Mask"):
        want = np.asarray(j[slot][0])
        got = p[slot][0]
        assert str(got.dtype).endswith(str(want.dtype)), slot
        want = want.view(np.int16) if dtype == "bfloat16" else want
        assert np.array_equal(_bits(got), want), (impl, slot)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_training_out_is_x_times_the_mask(impl, dtype):
    p = 0.3
    x = _torch(_x(dtype, shape=(256, 512), seed=1))
    attrs = {"dropout_prob": p, "is_test": False,
             "dropout_implementation": impl, "__op_seed__": 7}
    ctx = LoweringContext("cpu", seed=5, step=3)
    outs = p_registry.get("dropout").impl(ctx, {"X": [x]}, attrs)
    out, mask = outs["Out"][0], outs["Mask"][0]
    assert out.dtype == mask.dtype == x.dtype
    assert set(np.unique(mask.float().numpy())) <= {0.0, 1.0}
    if impl == "downgrade_in_infer":
        want = x * mask
    else:
        # 1 - p in x's dtype, as jnp takes a Python scalar
        keep_p = torch.tensor(1.0 - p, dtype=x.dtype)
        want = torch.where(mask == 1, x / keep_p, torch.zeros_like(x))
    assert np.array_equal(_bits(out), _bits(want))
    n = mask.numel()
    keep = float(mask.float().sum()) / n
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(keep - (1 - p)) <= 5 * sigma, keep
    # the same (seed, step, op seed) redraws the mask; the next step not
    again = p_registry.get("dropout").impl(
        LoweringContext("cpu", seed=5, step=3), {"X": [x]}, attrs)["Mask"][0]
    assert torch.equal(again, mask)
    other = p_registry.get("dropout").impl(
        LoweringContext("cpu", seed=5, step=4), {"X": [x]}, attrs)["Mask"][0]
    assert not torch.equal(other, mask)


def _program(fluid, unique_name, impl):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[32], dtype="float32")
        y = fluid.layers.dropout(x, dropout_prob=0.25,
                                 dropout_implementation=impl)
        out = fluid.layers.scale(y, scale=2.0)
    return main, startup, out


@pytest.mark.parametrize("impl", IMPLS)
def test_for_test_clone_equals_jax_bitwise(impl):
    """A program's dropout behind clone(for_test=True) runs in test mode
    in both packages, with the same result."""
    x = _x("float32")
    outs = []
    for fluid, unique_name, exe in (
            (jfluid, j_unique, jfluid.Executor(jfluid.CPUPlace())),
            (pfluid, p_unique, pfluid.Executor("cpu"))):
        main, startup, out = _program(fluid, unique_name, impl)
        test = main.clone(for_test=True)
        op = [o for o in test.global_block().ops if o.type == "dropout"]
        assert op and op[0].attrs["is_test"] is True
        v, = exe.run(test, feed={"x": x}, fetch_list=[out])
        outs.append(np.asarray(v))
    assert np.array_equal(outs[0], outs[1])
