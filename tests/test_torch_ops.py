"""Each op kernel of the port's LM path held against the JAX package's
kernel of the same op, on the same seeded numpy inputs and attrs: the
outputs, and for differentiable ops the input grads (torch autograd
against ``jax.vjp``) for a seeded cotangent. Also every op of the
activation family (36 unary ops and prelu), the binary,
compare and logical families, matmul, softmax, transpose2, split, sign,
clip, clip_by_norm, squared_l2_norm, assign, mean and increment, the
reductions (reduce_mean, reduce_max, reduce_min), concat, select_rowwise,
is_empty and print, and mixed-dtype operands promoted as jnp promotes
them.

Tolerances: fp32 atol/rtol 1e-5 (other summation orders; the layer
norm's statistics come from a fused kernel on the torch side); bf16
atol/rtol 1e-2 (one bf16 rounding of values of magnitude ~1, 2^-8
relative, placed differently by the two packages)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import registry as j_registry
from paddle_tpu_torch.core.lowering import LoweringContext
from paddle_tpu_torch.ops import registry as p_registry

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-2, rtol=1e-2)
R = np.random.RandomState(0)


def _randn(*shape):
    return R.standard_normal(shape).astype(np.float32)


def _ids(high, *shape):
    return R.randint(0, high, shape).astype(np.int32)


# (op, inputs {slot: [array]}, attrs, output slot, slots differentiated,
#  dtype of the float inputs, tolerance)
CASES = {
    "mul": ("mul", {"X": [_randn(2, 8, 16)], "Y": [_randn(16, 12)]},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}, "Out", ("X", "Y"),
            "float32", F32),
    "mul_amp": ("mul", {"X": [_randn(2, 8, 16)], "Y": [_randn(16, 12)]},
                {"x_num_col_dims": 2, "__amp_bf16__": True}, "Out",
                ("X", "Y"), "float32", BF16),
    "mul_bf16": ("mul", {"X": [_randn(16, 32)], "Y": [_randn(32, 8)]},
                 {"__amp_bf16__": True}, "Out", ("X", "Y"), "bfloat16",
                 BF16),
    "scale": ("scale", {"X": [_randn(4, 6)]},
              {"scale": 22.627416997969522, "bias": 0.5,
               "bias_after_scale": True}, "Out", ("X",), "float32", F32),
    "scale_bf16": ("scale", {"X": [_randn(4, 6)]},
                   {"scale": 22.627416997969522, "bias": 0.0}, "Out",
                   ("X",), "bfloat16", BF16),
    "sum": ("sum", {"X": [_randn(3, 5), _randn(3, 5), _randn(3, 5)]}, {},
            "Out", ("X",), "float32", F32),
    "cast": ("cast", {"X": [_randn(3, 5)]},
             {"in_dtype": "float32", "out_dtype": "bfloat16"}, "Out",
             ("X",), "float32", BF16),
    "add_axis": ("elementwise_add", {"X": [_randn(2, 3, 8)],
                                     "Y": [_randn(8)]}, {"axis": 2},
                 "Out", ("X", "Y"), "float32", F32),
    "add_bf16": ("elementwise_add", {"X": [_randn(2, 3, 8)],
                                     "Y": [_randn(2, 3, 8)]}, {"axis": -1},
                 "Out", ("X", "Y"), "bfloat16", BF16),
    "mul_scalar": ("elementwise_mul", {"X": [_randn(1)], "Y": [_randn(1)]},
                   {"axis": -1}, "Out", ("X", "Y"), "float32", F32),
    "div": ("elementwise_div", {"X": [_randn(1)],
                                "Y": [np.array([256.0], np.float32)]},
            {"axis": -1}, "Out", ("X",), "float32", F32),
    "gelu": ("gelu", {"X": [_randn(4, 32)]}, {}, "Out", ("X",), "float32",
             F32),
    "gelu_bf16": ("gelu", {"X": [_randn(4, 32)]}, {}, "Out", ("X",),
                  "bfloat16", BF16),
    "reduce_sum_all": ("reduce_sum", {"X": [_randn(2, 3, 1)]},
                       {"dim": [0], "keep_dim": False, "reduce_all": True},
                       "Out", ("X",), "float32", F32),
    "reduce_sum_dims": ("reduce_sum", {"X": [_randn(2, 3, 4)]},
                        {"dim": [0, -1], "keep_dim": True,
                         "reduce_all": False}, "Out", ("X",), "float32",
                        F32),
    "reduce_prod_int": ("reduce_prod",
                        {"X": [np.array([2, 128], np.int32)]},
                        {"dim": [0], "keep_dim": False, "reduce_all": True},
                        "Out", (), "int32", F32),
    "reshape2": ("reshape2", {"X": [_ids(50, 2, 6)]}, {"shape": [0, 0, 1]},
                 "Out", (), "int32", F32),
    "slice": ("slice", {"Input": [_randn(2, 8, 4)]},
              {"axes": [1], "starts": [2], "ends": [6]}, "Out", ("Input",),
              "float32", F32),
    "lookup_table": ("lookup_table", {"W": [_randn(50, 8)],
                                      "Ids": [_ids(50, 2, 6)]},
                     {"padding_idx": -1}, "Out", ("W",), "float32", F32),
    "lookup_table_pad": ("lookup_table", {"W": [_randn(50, 8)],
                                          "Ids": [_ids(50, 2, 6, 1)]},
                         {"padding_idx": 3}, "Out", ("W",), "bfloat16",
                         BF16),
    "layer_norm": ("layer_norm", {"X": [_randn(2, 5, 16)],
                                  "Scale": [_randn(16)],
                                  "Bias": [_randn(16)]},
                   {"begin_norm_axis": 2, "epsilon": 1e-5}, "Y",
                   ("X", "Scale", "Bias"), "float32", F32),
    "layer_norm_bf16": ("layer_norm", {"X": [_randn(2, 5, 16)],
                                       "Scale": [_randn(16)],
                                       "Bias": [_randn(16)]},
                        {"begin_norm_axis": 2}, "Y",
                        ("X", "Scale", "Bias"), "bfloat16", BF16),
    "position_encoding": ("add_position_encoding", {"X": [_randn(2, 7, 16)]},
                          {"alpha": 1.0, "beta": 1.0}, "Out", ("X",),
                          "float32", F32),
    "position_encoding_bf16": ("add_position_encoding",
                               {"X": [_randn(2, 7, 16)]},
                               {"alpha": 0.5, "beta": 2.0}, "Out", ("X",),
                               "bfloat16", BF16),
    "softmax_ce": ("softmax_with_cross_entropy",
                   {"Logits": [_randn(2, 6, 40)],
                    "Label": [_ids(40, 2, 6, 1)]},
                   {"ignore_index": -100, "axis": -1,
                    "__need_softmax__": False}, "Loss", ("Logits",),
                   "float32", F32),
    "softmax_ce_bf16": ("softmax_with_cross_entropy",
                        {"Logits": [_randn(2, 6, 40)],
                         "Label": [_ids(40, 2, 6, 1)]},
                        {"ignore_index": 7, "__need_softmax__": False},
                        "Loss", ("Logits",), "bfloat16", BF16),
    "softmax_ce_softmax": ("softmax_with_cross_entropy",
                           {"Logits": [_randn(3, 10)],
                            "Label": [_ids(10, 3, 1)]},
                           {"__need_softmax__": True}, "Softmax", (),
                           "float32", F32),
}


def _pos(*shape):
    return (R.rand(*shape) * 2 + 0.1).astype(np.float32)


def _unit(*shape):
    return (R.rand(*shape) * 1.8 - 0.9).astype(np.float32)


# the activation family (ops/activations.py): each unary op on inputs in
# its domain, grads where it has them; a few in bf16 too
_UNARY = {
    "abs": _randn, "acos": _unit, "asin": _unit, "atan": _randn,
    "ceil": _randn, "floor": _randn, "round": _randn, "cos": _randn,
    "sin": _randn, "exp": _randn, "log": _pos, "sqrt": _pos, "rsqrt": _pos,
    "square": _randn, "reciprocal": _pos, "sigmoid": _randn,
    "logsigmoid": _randn, "tanh": _randn, "tanh_shrink": _randn,
    "relu": _randn, "relu6": _randn, "softplus": _randn,
    "softsign": _randn, "softshrink": _randn, "hard_shrink": _randn,
    "hard_sigmoid": _randn, "brelu": _randn, "leaky_relu": _randn,
    "elu": _randn, "selu": _randn, "stanh": _randn, "soft_relu": _randn,
    "swish": _randn, "thresholded_relu": _randn, "pow": _pos,
}
_NO_GRAD = ("ceil", "floor", "round")
_UNARY_ATTRS = {"relu6": {"threshold": 4.0}, "leaky_relu": {"alpha": 0.1},
                "brelu": {"t_min": -1.0, "t_max": 1.5}, "pow": {"factor": 1.5},
                "softshrink": {"lambda": 0.3}, "swish": {"beta": 2.0}}
for _op, _make in _UNARY.items():
    CASES["unary_" + _op] = (
        _op, {"X": [_make(4, 16) * (3 if _op == "relu6" else 1)]},
        _UNARY_ATTRS.get(_op, {}), "Out", () if _op in _NO_GRAD else ("X",),
        "float32", F32)
for _op in ("exp", "tanh", "sqrt", "square", "sigmoid"):
    CASES["unary_%s_bf16" % _op] = (_op, {"X": [_UNARY[_op](4, 16)]}, {},
                                    "Out", ("X",), "bfloat16", BF16)
# the binary, compare and logical families (ops/elementwise.py)
for _op, _x, _y in (("elementwise_sub", _randn, _randn),
                    ("elementwise_max", _randn, _randn),
                    ("elementwise_min", _randn, _randn),
                    ("elementwise_pow", _pos, _randn)):
    CASES[_op] = (_op, {"X": [_x(3, 8)], "Y": [_y(8)]}, {"axis": -1}, "Out",
                  ("X", "Y"), "float32", F32)
for _op in ("elementwise_mod", "elementwise_floordiv"):
    CASES[_op] = (_op, {"X": [_randn(3, 8) * 5], "Y": [_pos(3, 8)]},
                  {"axis": -1}, "Out", (), "float32", F32)
for _op in ("equal", "not_equal", "less_than", "less_equal", "greater_than",
            "greater_equal"):
    _a = np.round(_randn(3, 8))
    CASES[_op] = (_op, {"X": [_a], "Y": [np.round(_randn(3, 8))]}, {},
                  "Out", (), "float32", F32)
for _op in ("logical_and", "logical_or", "logical_xor", "logical_not"):
    CASES[_op] = (_op, {"X": [_randn(3, 8) > 0], "Y": [_randn(3, 8) > 0]},
                  {}, "Out", (), "bool", F32)
CASES.update({
    "prelu_channel": ("prelu", {"X": [_randn(2, 3, 4, 4)],
                                "Alpha": [_pos(1, 3, 1, 1)]},
                      {"mode": "channel"}, "Out", ("X", "Alpha"), "float32",
                      F32),
    "matmul": ("matmul", {"X": [_randn(2, 3, 5, 8)],
                          "Y": [_randn(2, 3, 6, 8)]},
               {"transpose_Y": True, "alpha": 0.5}, "Out", ("X", "Y"),
               "float32", F32),
    "matmul_amp": ("matmul", {"X": [_randn(2, 4, 8)], "Y": [_randn(2, 8, 3)]},
                   {"__amp_bf16__": True}, "Out", ("X", "Y"), "float32",
                   BF16),
    "softmax": ("softmax", {"X": [_randn(2, 3, 10)]}, {"axis": -1}, "Out",
                ("X",), "float32", F32),
    "softmax_bf16": ("softmax", {"X": [_randn(2, 10)]}, {}, "Out", ("X",),
                     "bfloat16", BF16),
    "transpose2": ("transpose2", {"X": [_randn(2, 3, 4, 5)]},
                   {"axis": [0, 2, 1, 3]}, "Out", ("X",), "float32", F32),
    "split_num": ("split", {"X": [_randn(2, 12)]},
                  {"num": 3, "sections": [], "axis": 1}, "Out", ("X",),
                  "float32", F32),
    "split_sections": ("split", {"X": [_randn(7, 2)]},
                       {"num": 0, "sections": [2, 5], "axis": 0}, "Out",
                       ("X",), "float32", F32),
    "sign": ("sign", {"X": [_randn(3, 4)]}, {}, "Out", ("X",), "float32",
             F32),
    "clip": ("clip", {"X": [_randn(3, 4)]}, {"min": -0.5, "max": 0.7},
             "Out", ("X",), "float32", F32),
    "clip_by_norm": ("clip_by_norm", {"X": [_randn(3, 4)]},
                     {"max_norm": 1.0}, "Out", ("X",), "float32", F32),
    "clip_by_norm_under": ("clip_by_norm", {"X": [_randn(3, 4)]},
                           {"max_norm": 100.0}, "Out", ("X",), "float32",
                           F32),
    "squared_l2_norm": ("squared_l2_norm", {"X": [_randn(3, 4)]}, {},
                        "Out", ("X",), "float32", F32),
    "assign": ("assign", {"X": [_randn(3, 4)]}, {}, "Out", ("X",),
               "float32", F32),
    "mean": ("mean", {"X": [_randn(3, 4)]}, {}, "Out", ("X",), "float32",
             F32),
    "increment_int": ("increment", {"X": [np.array([7], np.int32)]},
                      {"step": 1.0}, "Out", (), "int32", F32),
    "increment": ("increment", {"X": [_randn(1)]}, {"step": 0.5}, "Out",
                  ("X",), "float32", F32),
    # the control-flow slice's ops and the layers build_stacked needs
    "reduce_mean_last": ("reduce_mean", {"X": [_randn(2, 5, 16)]},
                         {"dim": [-1], "keep_dim": True, "reduce_all": False},
                         "Out", ("X",), "float32", F32),
    "reduce_mean_dims": ("reduce_mean", {"X": [_randn(2, 3, 4)]},
                         {"dim": [0, 2], "keep_dim": False,
                          "reduce_all": False}, "Out", ("X",), "float32",
                         F32),
    "reduce_mean_all": ("reduce_mean", {"X": [_randn(3, 4)]},
                        {"dim": [0], "keep_dim": False, "reduce_all": True},
                        "Out", ("X",), "float32", F32),
    "reduce_mean_bf16": ("reduce_mean", {"X": [_randn(4, 32)]},
                         {"dim": [1], "keep_dim": True, "reduce_all": False},
                         "Out", ("X",), "bfloat16", BF16),
    "reduce_max": ("reduce_max", {"X": [_randn(3, 4, 5)]},
                   {"dim": [1], "keep_dim": False, "reduce_all": False},
                   "Out", ("X",), "float32", F32),
    "reduce_min_all": ("reduce_min", {"X": [_randn(3, 4)]},
                       {"dim": [0], "keep_dim": True, "reduce_all": True},
                       "Out", ("X",), "float32", F32),
    "concat": ("concat", {"X": [_randn(2, 3), _randn(2, 5), _randn(2, 1)]},
               {"axis": 1}, "Out", ("X",), "float32", F32),
    "concat_axis0": ("concat", {"X": [_randn(1, 4), _randn(3, 4)]},
                     {"axis": 0}, "Out", ("X",), "bfloat16", BF16),
    "select_rowwise": ("select_rowwise", {"Cond": [_randn(4, 1) > 0],
                                          "X": [_randn(4, 3)],
                                          "Y": [_randn(4, 3)]}, {}, "Out",
                       ("X", "Y"), "float32", F32),
    "is_empty": ("is_empty", {"X": [_randn(2, 3)]}, {}, "Out", (),
                 "float32", F32),
    "is_empty_yes": ("is_empty", {"X": [_randn(0, 3)]}, {}, "Out", (),
                     "float32", F32),
    "print": ("print", {"In": [_randn(2, 2)]}, {"message": "x"}, "Out", (),
              "float32", F32),
})


def _jax(arr, dtype):
    a = jnp.asarray(arr)
    return a.astype(jnp.bfloat16) if dtype == "bfloat16" and \
        arr.dtype == np.float32 else a


def _torch(arr, dtype):
    t = torch.from_numpy(np.array(arr))
    return t.to(torch.bfloat16) if dtype == "bfloat16" and \
        arr.dtype == np.float32 else t


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    op, ins, attrs, out_slot, diff, dtype, tol = CASES[case]
    j_impl = j_registry.get(op).impl
    p_impl = p_registry.get(op).impl

    j_const = {s: [_jax(a, dtype) for a in v] for s, v in ins.items()
               if s not in diff}
    j_diff = {s: [_jax(a, dtype) for a in v] for s, v in ins.items()
              if s in diff}

    def j_fn(d):
        return j_impl(None, {**j_const, **d}, attrs)[out_slot][0]

    j_out, vjp = jax.vjp(j_fn, j_diff)

    ctx = LoweringContext(torch.device("cpu"))
    p_ins = {s: [_torch(a, dtype).requires_grad_(s in diff) for a in v]
             for s, v in ins.items()}
    p_out = p_impl(ctx, p_ins, attrs)[out_slot][0]

    assert tuple(p_out.shape) == tuple(j_out.shape)
    assert str(p_out.dtype).split(".")[-1] == str(j_out.dtype)
    np.testing.assert_allclose(_np(p_out), _np(j_out), err_msg="out", **tol)
    if not diff:
        return
    cot = R.standard_normal(j_out.shape).astype(np.float32)
    (j_grads,) = vjp(jnp.asarray(cot).astype(j_out.dtype))
    leaves = [t for s in diff for t in p_ins[s]]
    p_grads = torch.autograd.grad(p_out, leaves,
                                  torch.from_numpy(cot).to(p_out.dtype))
    want = [g for s in diff for g in j_grads[s]]
    for i, (pg, jg) in enumerate(zip(p_grads, want)):
        assert pg.dtype == leaves[i].dtype
        np.testing.assert_allclose(_np(pg), _np(jg), err_msg="grad %d" % i,
                                   **tol)


def test_creation_ops_match_jax():
    ctx = LoweringContext(torch.device("cpu"))
    attrs = {"shape": [2, 3], "dtype": "bfloat16", "value": 0.25}
    got = p_registry.get("fill_constant").impl(ctx, {}, attrs)["Out"][0]
    want = j_registry.get("fill_constant").impl(None, {}, attrs)["Out"][0]
    np.testing.assert_array_equal(_np(got), _np(want))
    assert got.dtype == torch.bfloat16
    x = _randn(3, 2)
    got = p_registry.get("fill_any_like").impl(
        ctx, {"X": [torch.from_numpy(x)]}, {"value": 1.0})["Out"][0]
    np.testing.assert_array_equal(got.numpy(), np.ones_like(x))
    got = p_registry.get("shape").impl(
        ctx, {"X": [torch.zeros(4, 128, 2)]}, {})["Out"][0]
    want = j_registry.get("shape").impl(
        None, {"X": [jnp.zeros((4, 128, 2))]}, {})["Out"][0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("op", ["uniform_random", "gaussian_random"])
def test_random_init_ops(op):
    """The port draws from torch generators (JAX's bits differ): the
    right shape, dtype and distribution; the same (program seed, step,
    op seed) repeats, another op seed differs."""
    attrs = {"shape": [256, 128], "dtype": "bfloat16", "min": -0.5,
             "max": 0.5, "mean": 0.0, "std": 0.5, "__op_seed__": 7}
    impl = p_registry.get(op).impl
    ctx = LoweringContext(torch.device("cpu"), seed=0, step=0)
    a = impl(ctx, {}, attrs)["Out"][0]
    b = impl(ctx, {}, attrs)["Out"][0]
    c = impl(ctx, {}, dict(attrs, __op_seed__=8))["Out"][0]
    assert a.shape == (256, 128) and a.dtype == torch.bfloat16
    assert torch.equal(a, b) and not torch.equal(a, c)
    af = a.float()
    assert abs(float(af.mean())) < 0.02
    if op == "uniform_random":
        assert float(af.min()) >= -0.5 and float(af.max()) <= 0.5
        assert abs(float(af.std()) - 1 / 12 ** 0.5) < 0.02
    else:
        assert abs(float(af.std()) - 0.5) < 0.02


def test_update_ops_match_jax():
    """sgd (fp32 math, bf16 write-back, in place in the port) and
    check_finite_and_unscale."""
    ctx = LoweringContext(torch.device("cpu"))
    p, g = _randn(8, 4), _randn(8, 4)
    lr = np.array([0.01], np.float32)
    for dtype in ("float32", "bfloat16"):
        pt = _torch(p, dtype)
        out = p_registry.get("sgd").impl(ctx, {
            "Param": [pt], "Grad": [_torch(g, dtype)],
            "LearningRate": [torch.from_numpy(lr)]}, {})["ParamOut"][0]
        want = j_registry.get("sgd").impl(None, {
            "Param": [_jax(p, dtype)], "Grad": [_jax(g, dtype)],
            "LearningRate": [jnp.asarray(lr)]}, {})["ParamOut"][0]
        assert out is pt  # updated in place
        np.testing.assert_array_equal(_np(out), _np(want))

    grads = [_randn(3, 2), _randn(5)]
    scale = np.array([4.0], np.float32)
    for bad in (False, True):
        if bad:
            grads[1][2] = np.inf
        got = p_registry.get("check_finite_and_unscale").impl(ctx, {
            "X": [_torch(x, "bfloat16") for x in grads],
            "Scale": [torch.from_numpy(scale)]}, {})
        want = j_registry.get("check_finite_and_unscale").impl(None, {
            "X": [_jax(x, "bfloat16") for x in grads],
            "Scale": [jnp.asarray(scale)]}, {})
        for a, b in zip(got["Out"], want["Out"]):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            np.testing.assert_array_equal(_np(a), _np(b))
        assert bool(got["FoundInfinite"][0][0]) == bad
        assert bool(np.asarray(want["FoundInfinite"][0])[0]) == bad


@pytest.mark.parametrize("op", ["elementwise_add", "elementwise_mul",
                                "elementwise_div", "elementwise_max",
                                "less_than"])
@pytest.mark.parametrize("y_shape", [(1,), ()])
def test_mixed_dtypes_promote_as_jax(op, y_shape):
    """A bf16 X with an fp32 Y of shape [1] or 0-d: the result's dtype and
    values are jnp's (torch alone would keep bf16 for the 0-d Y)."""
    x = _randn(4, 5)
    y = np.array(0.37, np.float32).reshape(y_shape)
    got = p_registry.get(op).impl(None, {
        "X": [_torch(x, "bfloat16")], "Y": [torch.from_numpy(y)]},
        {"axis": -1})["Out"][0]
    want = j_registry.get(op).impl(None, {
        "X": [_jax(x, "bfloat16")], "Y": [jnp.asarray(y)]},
        {"axis": -1})["Out"][0]
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_rounds_its_scalar_as_jax(dtype):
    """scale by a Python float: jnp takes the scalar in x's dtype (a bf16
    x is multiplied by bf16(scale)), so the port's op equals the JAX
    op's bitwise; the LM's embedding scale sqrt(512) is 22.627... in
    fp32 and 22.625 in bf16."""
    ctx = LoweringContext(torch.device("cpu"))
    x = _randn(64, 32)
    for attrs in ({"scale": 512 ** 0.5}, {"scale": 1e-4},
                  {"scale": 0.3, "bias": 0.1},
                  {"scale": 0.3, "bias": 0.1, "bias_after_scale": False}):
        got = p_registry.get("scale").impl(
            ctx, {"X": [_torch(x, dtype)]}, attrs)["Out"][0]
        want = j_registry.get("scale").impl(
            None, {"X": [_jax(x, dtype)]}, attrs)["Out"][0]
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype,amp", [("float32", False),
                                       ("bfloat16", False),
                                       ("float32", True)])
def test_fused_multihead_attention_matches_jax(dtype, amp):
    """The fused sublayer (projections + flash attention + output
    projection) at T 128, 2 heads of 64: output and every input grad.
    The JAX side runs its Pallas kernel in interpret mode."""
    B, T, D, H = 2, 128, 128, 2
    ins = {"X": [_randn(B, T, D)], "WQ": [0.1 * _randn(D, H, 64)],
           "WK": [0.1 * _randn(D, H, 64)], "WV": [0.1 * _randn(D, H, 64)],
           "WO": [0.1 * _randn(H, 64, D)], "BQ": [_randn(H, 64)],
           "BK": [_randn(H, 64)], "BV": [_randn(H, 64)], "BO": [_randn(D)]}
    attrs = {"causal": True, "sm_scale": 0.125, "__amp_bf16__": amp}
    tol = F32 if dtype == "float32" and not amp else BF16
    j_impl = j_registry.get("fused_multihead_attention").impl
    j_ins = {s: [_jax(a, dtype) for a in v] for s, v in ins.items()}
    j_out, vjp = jax.vjp(
        lambda d: j_impl(None, d, attrs)["Out"][0], j_ins)
    ctx = LoweringContext(torch.device("cpu"))
    p_ins = {s: [_torch(a, dtype).requires_grad_() for a in v]
             for s, v in ins.items()}
    p_out = p_registry.get("fused_multihead_attention").impl(
        ctx, p_ins, attrs)["Out"][0]
    assert str(p_out.dtype).split(".")[-1] == str(j_out.dtype)
    np.testing.assert_allclose(_np(p_out), _np(j_out), **tol)
    cot = R.standard_normal(j_out.shape).astype(np.float32)
    (j_grads,) = vjp(jnp.asarray(cot).astype(j_out.dtype))
    slots = sorted(ins)
    p_grads = torch.autograd.grad(
        p_out, [p_ins[s][0] for s in slots],
        torch.from_numpy(cot).to(p_out.dtype))
    # the grads sum B*T terms and reach ~1e2: atol scales with the
    # largest of them (the key bias's grad is zero in exact arithmetic,
    # so both sides return rounding noise of those terms)
    scale = max(1.0, max(float(np.abs(_np(j_grads[s][0])).max())
                         for s in slots))
    for s, pg in zip(slots, p_grads):
        np.testing.assert_allclose(_np(pg), _np(j_grads[s][0]), err_msg=s,
                                   atol=tol["atol"] * scale,
                                   rtol=tol["rtol"])
