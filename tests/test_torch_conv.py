"""The image classifiers' ops in the port held against the JAX package's
kernels on the same seeded numpy inputs and attrs, forward and vjp
(torch autograd against ``jax.vjp`` for a seeded cotangent), in fp32 and
as the AMP bf16 pair: conv2d over strides, padding, dilation, groups 1,
2 and C (depthwise_conv2d), with and without the FoldedBias input;
pool2d max and avg x exclusive x padding, global pooling, padding past
half a window and a max pool over tied values; batch_norm in training
(Y and the four statistics), is_test, use_global_stats and NHWC;
cross_entropy with hard labels, soft labels and ignore_index, and
cross_entropy2; top_k with ties and accuracy.

Tolerances: fp32 outputs to rtol 1e-5 (plus 1e-6 of the tensor's
largest value: sums in another order), grads to 1e-4 of each tensor's
largest value; bf16 to one bf16 ulp of the larger of the two values
(each package accumulates in fp32 and rounds once) plus 2^-12 of the
tensor's largest value for grads (a grad through the bf16 cast sums
bf16 products in another order). That an fp32 convolution on the card
does not depend on ``torch.backends.cudnn.allow_tf32`` is a card leg of
``tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.lowering import LoweringContext as JCtx
from paddle_tpu.ops import registry as j_registry
from paddle_tpu_torch.core.lowering import LoweringContext
from paddle_tpu_torch.ops import registry as p_registry


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x)


def _close(got, want, tol, grad=False, label=""):
    """`tol` "float32" or "bfloat16" (a bf16 result, or an fp32 one formed
    from a bf16 product: then plus 2^-8 of the largest value)."""
    promoted = isinstance(got, torch.Tensor) and got.dtype != torch.bfloat16
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, label
    top = float(np.abs(want).max()) if want.size else 0.0
    if tol == "bfloat16":
        lim = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        if grad:
            lim = lim + 2.0 ** -12 * top
        elif promoted:
            lim = lim + 2.0 ** -8 * top
    elif grad:
        lim = 1e-4 * top
    else:
        lim = 1e-5 * np.abs(want) + 1e-6 * top
    err = np.abs(got.astype(np.float64) - want)
    i = int(np.argmax(err - lim)) if err.size else 0
    assert err.size == 0 or err.flat[i] <= np.asarray(lim).flat[
        i if np.ndim(lim) else 0], (label, got.flat[i], want.flat[i])


def bf16_round(a):
    """fp32 values rounded to bf16 (exact in both dtypes)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _same_dtype(p, j):
    # JAX without x64 holds Fluid's int64 as int32
    p = str(p.dtype).split(".")[-1]
    return p == str(j.dtype) or (p, str(j.dtype)) == ("int64", "int32")


def run_both(op, ins, attrs, diff=(), dtype="float32", seed=1):
    """The op's outputs in both packages and, when `diff` names input
    slots, their grads for one seeded cotangent (bf16 values) on the
    first output slot of `op`'s JAX outputs that is floating (its order
    in the JAX dict)."""
    def jx(a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if dtype == "bfloat16" and \
            a.dtype == jnp.float32 else a

    def tx(a):
        t = torch.from_numpy(np.array(a))
        return t.to(torch.bfloat16) if dtype == "bfloat16" and \
            t.dtype == torch.float32 else t

    j_impl = j_registry.get(op).impl
    jctx = JCtx(base_key=jax.random.PRNGKey(0))
    j_const = {s: [jx(a) for a in v] for s, v in ins.items() if s not in diff}
    j_diff = {s: [jx(a) for a in v] for s, v in ins.items() if s in diff}
    j_outs = j_impl(jctx, {**j_const, **j_diff}, attrs)
    p_ins = {s: [tx(a).requires_grad_(s in diff) for a in v]
             for s, v in ins.items()}
    p_outs = p_registry.get(op).impl(LoweringContext(torch.device("cpu")),
                                     p_ins, attrs)
    for slot, js in j_outs.items():
        for j, p in zip(js, p_outs[slot]):
            assert _same_dtype(p, j), slot
    if not diff:
        return j_outs, p_outs, None, None
    slot = next(s for s, v in j_outs.items()
                if jnp.issubdtype(v[0].dtype, jnp.floating))

    def j_fn(d):
        return j_impl(jctx, {**j_const, **d}, attrs)[slot][0]

    j_out, vjp = jax.vjp(j_fn, j_diff)
    cot = bf16_round(np.random.RandomState(seed).standard_normal(
        j_out.shape).astype(np.float32))
    (jg,) = vjp(jnp.asarray(cot).astype(j_out.dtype))
    leaves = [t for s in diff for t in p_ins[s]]
    p_out = p_outs[slot][0]
    pg = torch.autograd.grad(p_out, leaves,
                             torch.from_numpy(cot).to(p_out.dtype))
    for leaf, g in zip(leaves, pg):
        assert g.dtype == leaf.dtype
    return j_outs, p_outs, [g for s in diff for g in jg[s]], list(pg)


def check_both(op, ins, attrs, diff=(), dtype="float32", outs=None,
               tol=None):
    """run_both, then every output (or those of `outs`) and grad held to
    `tol` (default: the inputs' dtype)."""
    tol = tol or dtype
    j_outs, p_outs, jg, pg = run_both(op, ins, attrs, diff, dtype)
    for slot in outs or j_outs:
        for j, p in zip(j_outs[slot], p_outs[slot]):
            _close(p, j, tol, label=slot)
    for i, (p, j) in enumerate(zip(pg or (), jg or ())):
        _close(p, j, tol, grad=True, label="grad %d" % i)
    return j_outs, p_outs


# ---------------------------------------------------------------------------
# conv2d and depthwise_conv2d
# ---------------------------------------------------------------------------

# (op, C_in, C_out, kernel, strides, paddings, dilations, groups)
CONVS = {
    "3x3": ("conv2d", 4, 6, 3, [1, 1], [1, 1], [1, 1], 1),
    "strided": ("conv2d", 4, 6, 3, [2, 1], [0, 2], [1, 1], 1),
    "dilated": ("conv2d", 4, 6, 3, [1, 2], [2, 1], [2, 2], 1),
    "1x1_s2": ("conv2d", 4, 8, 1, [2, 2], [0, 0], [1, 1], 1),
    "7x7_s2": ("conv2d", 3, 4, 7, [2, 2], [3, 3], [1, 1], 1),
    "groups2": ("conv2d", 4, 6, 3, [1, 1], [1, 1], [1, 1], 2),
    "depthwise": ("depthwise_conv2d", 4, 8, 3, [2, 2], [1, 1], [1, 1], 4),
}


@pytest.mark.parametrize("bias", [False, True], ids=["", "folded_bias"])
@pytest.mark.parametrize("amp", ["fp32", "amp", "bf16"])
@pytest.mark.parametrize("case", sorted(CONVS))
def test_conv_matches_jax(case, amp, bias):
    op, cin, cout, k, strides, pads, dils, groups = CONVS[case]
    rng = np.random.RandomState(0)
    ins = {"Input": [_randn(rng, 2, cin, 11, 10)],
           "Filter": [_randn(rng, cout, cin // groups, k, k) * 0.3]}
    if bias:
        ins["FoldedBias"] = [_randn(rng, cout)]
    attrs = {"strides": strides, "paddings": pads, "dilations": dils,
             "groups": groups}
    if amp != "fp32":
        attrs["__amp_bf16__"] = True
    # a bf16 FoldedBias's grad is a bf16 sum, which JAX's vjp accumulates
    # in bf16 (many ulps off the exact sum): its forward add is checked
    diff = ("Input", "Filter") if amp == "bf16" else tuple(ins)
    j_outs, p_outs = check_both(
        op, ins, attrs, diff, "bfloat16" if amp == "bf16"
        else "float32", tol="float32" if amp == "fp32" else "bfloat16")
    want = jnp.bfloat16 if amp != "fp32" and not bias else None
    if want is not None:
        assert j_outs["Output"][0].dtype == want
        assert p_outs["Output"][0].dtype == torch.bfloat16


def test_conv_int8_operands_are_exact():
    """quant_rewrite's int8 operands: an exact int32 convolution."""
    rng = np.random.RandomState(3)
    x = rng.randint(-127, 128, (2, 8, 9, 9)).astype(np.int8)
    w = rng.randint(-127, 128, (4, 8, 3, 3)).astype(np.int8)
    attrs = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1, "__quant_int8__": True}
    j_outs, p_outs, _, _ = run_both("conv2d", {"Input": [x], "Filter": [w]},
                                    attrs)
    np.testing.assert_array_equal(_np(p_outs["Output"][0]),
                                  _np(j_outs["Output"][0]))


# ---------------------------------------------------------------------------
# pool2d
# ---------------------------------------------------------------------------

# (pooling_type, ksize, strides, paddings, exclusive, global_pooling)
POOLS = {
    "max_3s2p1": ("max", [3, 3], [2, 2], [1, 1], True, False),
    "max_2s2": ("max", [2, 2], [2, 2], [0, 0], True, False),
    "max_wide_pad": ("max", [3, 3], [1, 1], [2, 2], True, False),
    "avg_3s1p1_exclusive": ("avg", [3, 3], [1, 1], [1, 1], True, False),
    "avg_3s1p1_inclusive": ("avg", [3, 3], [1, 1], [1, 1], False, False),
    "avg_2s2": ("avg", [2, 2], [2, 2], [0, 0], True, False),
    "avg_wide_pad_exclusive": ("avg", [3, 2], [2, 1], [2, 1], True, False),
    "avg_wide_pad_inclusive": ("avg", [3, 2], [2, 1], [2, 1], False, False),
    "avg_global": ("avg", [7, 7], [1, 1], [0, 0], True, True),
    "max_global": ("max", [2, 2], [1, 1], [1, 1], True, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(POOLS))
def test_pool2d_matches_jax(case, dtype):
    """Forward and vjp. A bf16 average pool is held to one bf16 ulp (plus
    2^-12 of the largest grad) of the JAX op over the same bf16 values in
    fp32: JAX's CPU reduce_window sums bf16 in bf16, several ulps off
    the exact sum, while torch sums in fp32 and rounds once."""
    ptype, k, s, p, exclusive, glob = POOLS[case]
    x = bf16_round(_randn(np.random.RandomState(1), 2, 3, 9, 8))
    attrs = {"pooling_type": ptype, "ksize": k, "strides": s,
             "paddings": p, "exclusive": exclusive, "global_pooling": glob,
             "ceil_mode": False}
    if dtype == "float32" or ptype == "max":
        check_both("pool2d", {"X": [x]}, attrs, ("X",), dtype)
        return
    j_outs, _, jg, _ = run_both("pool2d", {"X": [x]}, attrs, ("X",))
    _, p_outs, _, pg = run_both("pool2d", {"X": [x]}, attrs, ("X",), dtype)
    _close(p_outs["Out"][0], j_outs["Out"][0], "bfloat16", label="Out")
    _close(pg[0], jg[0], "bfloat16", grad=True, label="grad")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_routes_tied_grads_as_jax(dtype):
    """A max pool over tied values (ReLU zeros and repeated integers, in
    overlapping 3x3 windows at stride 2): each window's grad goes to the
    same element in both packages, its first maximum."""
    rng = np.random.RandomState(2)
    x = np.maximum(rng.randint(-2, 3, (2, 3, 9, 9)), 0).astype(np.float32)
    assert (x == 0).mean() > 0.4
    attrs = {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1], "global_pooling": False}
    j_outs, p_outs, jg, pg = run_both("pool2d", {"X": [x]}, attrs, ("X",),
                                      dtype)
    np.testing.assert_array_equal(_np(p_outs["Out"][0]),
                                  _np(j_outs["Out"][0]))
    np.testing.assert_array_equal(_np(pg[0]), _np(jg[0]))


# ---------------------------------------------------------------------------
# batch_norm
# ---------------------------------------------------------------------------

BN_OUTS = ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance")


def _bn_ins(layout, c=5, seed=4):
    rng = np.random.RandomState(seed)
    shape = (3, c, 6, 4) if layout == "NCHW" else (3, 6, 4, c)
    return {"X": [_randn(rng, *shape) * 2 + 0.5],
            "Scale": [_randn(rng, c)], "Bias": [_randn(rng, c)],
            "Mean": [_randn(rng, c) * 0.1],
            "Variance": [np.abs(_randn(rng, c)) + 0.5]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "is_test", "use_global_stats",
                                  "train_nhwc"])
def test_batch_norm_matches_jax(mode, dtype):
    layout = "NHWC" if mode.endswith("nhwc") else "NCHW"
    ins = _bn_ins(layout)
    if dtype == "bfloat16":  # the AMP case: X bf16, the rest fp32
        ins["X"] = [np.asarray(jnp.asarray(ins["X"][0]).astype(
            jnp.bfloat16).astype(jnp.float32))]
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "data_layout": layout,
             "is_test": mode == "is_test",
             "use_global_stats": mode == "use_global_stats"}
    j_outs, p_outs, jg, pg = run_both("batch_norm", ins, attrs,
                                      ("X", "Scale", "Bias"), "float32")
    if dtype == "bfloat16":
        # X alone in bf16: the op computes in fp32 and returns Y in bf16
        xb = {"X": ins["X"]}
        j2 = j_registry.get("batch_norm").impl(
            JCtx(base_key=jax.random.PRNGKey(0)),
            {**{k: [jnp.asarray(v[0])] for k, v in ins.items()},
             "X": [jnp.asarray(xb["X"][0]).astype(jnp.bfloat16)]}, attrs)
        p2 = p_registry.get("batch_norm").impl(
            LoweringContext(torch.device("cpu")),
            {**{k: [torch.from_numpy(v[0])] for k, v in ins.items()},
             "X": [torch.from_numpy(xb["X"][0]).to(torch.bfloat16)]}, attrs)
        assert p2["Y"][0].dtype == torch.bfloat16
        _close(p2["Y"][0], j2["Y"][0], "bfloat16", label="Y bf16")
        for slot in BN_OUTS[1:]:
            assert p2[slot][0].dtype == torch.float32
            _close(p2[slot][0], j2[slot][0], "float32", label=slot)
        return
    for slot in BN_OUTS:
        _close(p_outs[slot][0], j_outs[slot][0], "float32", label=slot)
    for i, (p, j) in enumerate(zip(pg, jg)):
        _close(p, j, "float32", grad=True, label="grad %d" % i)
    if mode != "train" and mode != "train_nhwc":
        # the moving statistics pass through unmoved, bitwise
        assert torch.equal(p_outs["MeanOut"][0],
                           torch.from_numpy(ins["Mean"][0]))
        assert torch.equal(p_outs["VarianceOut"][0],
                           torch.from_numpy(ins["Variance"][0]))


def test_batch_norm_moving_statistics_are_off_the_graph():
    """The moving statistics are written outside autograd: MeanOut and
    VarianceOut carry no graph, while Y's grad reaches X through the
    batch statistics."""
    ins = _bn_ins("NCHW")
    p_ins = {k: [torch.from_numpy(v[0]).requires_grad_(k != "Variance")]
             for k, v in ins.items()}
    out = p_registry.get("batch_norm").impl(
        LoweringContext(torch.device("cpu")), p_ins,
        {"momentum": 0.9, "epsilon": 1e-5})
    assert not out["MeanOut"][0].requires_grad
    assert not out["VarianceOut"][0].requires_grad
    assert out["Y"][0].requires_grad


# ---------------------------------------------------------------------------
# cross_entropy, top_k, accuracy
# ---------------------------------------------------------------------------


def _probs(rng, n, c):
    z = _randn(rng, n, c) * 2
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["hard", "soft", "ignore_index",
                                  "cross_entropy2"])
def test_cross_entropy_matches_jax(case, dtype):
    rng = np.random.RandomState(5)
    x = _probs(rng, 6, 7)
    x[0, 3] = 0.0                  # a zero probability: the 1e-12 floor
    label = rng.randint(0, 7, (6, 1)).astype(np.int64)
    label[0] = 3
    attrs = {}
    if case == "soft":
        label = _probs(rng, 6, 7)
        attrs["soft_label"] = True
    if case == "ignore_index":
        label[[1, 4]] = -100
        attrs["ignore_index"] = -100
    op = "cross_entropy2" if case == "cross_entropy2" else "cross_entropy"
    diff = ("X", "Label") if case == "soft" else ("X",)
    j_outs, p_outs = check_both(op, {"X": [x], "Label": [label]}, attrs,
                                diff, dtype,
                                outs=("Y", "MatchX") if op.endswith("2")
                                else ("Y",))
    if case == "ignore_index":
        assert float(_np(p_outs["Y"][0])[[1, 4]].max()) == 0.0


def test_top_k_and_accuracy_match_jax():
    """top_k with ties (equal values in index order, as lax.top_k gives
    them), then accuracy at k 1 and 3."""
    rng = np.random.RandomState(6)
    x = np.round(_probs(rng, 16, 10) * 8) / 8      # many ties
    label = rng.randint(0, 10, (16, 1)).astype(np.int64)
    for k in (1, 3):
        j_outs, p_outs, _, _ = run_both("top_k", {"X": [x]}, {"k": k})
        for slot in ("Out", "Indices"):
            np.testing.assert_array_equal(_np(p_outs[slot][0]),
                                          _np(j_outs[slot][0]))
        ins = {"Out": [x], "Indices": [_np(p_outs["Indices"][0])],
               "Label": [label]}
        j_acc, p_acc, _, _ = run_both("accuracy", ins, {})
        for slot in ("Accuracy", "Correct", "Total"):
            np.testing.assert_array_equal(_np(p_acc[slot][0]),
                                          _np(j_acc[slot][0]))
        assert int(_np(p_acc["Correct"][0])[0]) > 0
