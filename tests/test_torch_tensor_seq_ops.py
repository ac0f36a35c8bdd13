"""The tensor, loss, metric, recurrent, sequence and beam-search ops the
benchmark models run (``paddle_tpu_torch/ops/tensor_ops.py``,
``loss_ops.py``, ``metric_ops.py``, ``rnn_ops.py``, ``sequence_ops.py``,
``misc_ops.py`` and ``math.py``'s fill_zeros_like), each held against the
JAX package's op of the same name on the same seeded numpy inputs and
attrs: every output slot, and for a differentiable op the input grads
(torch autograd against ``jax.vjp``) for a seeded cotangent of each
float output.

Tolerances: fp32 atol/rtol 1e-5 (other summation orders; the
recurrences here run 5 steps); integer outputs, one-hot rows, masks,
selected ids, parents and AUC's StatPos / StatNeg histograms exactly.
The three random ops draw from the port's own generator, so their values
are not JAX's: both packages' draws are held by shape, dtype, range and
moments over 20000 values a row."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.ops import registry as j_registry

import paddle_tpu_torch as pfluid
from paddle_tpu_torch.core.lowering import LoweringContext
from paddle_tpu_torch.ops import registry as p_registry

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(atol=1e-5, rtol=1e-5)
R = np.random.RandomState(0)


def _randn(*shape):
    return R.standard_normal(shape).astype(np.float32)


def _ints(lo, hi, *shape):
    return R.randint(lo, hi, shape).astype(np.int64)


def _probs(*shape):
    p = R.rand(*shape).astype(np.float32) + 0.05
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


D = 4   # recurrent hidden width
LENS = np.array([[5], [3]], np.int64)   # a full row and a short one


def _ties(*shape):
    """Values on a grid of 0.5, so that a row's maximum repeats."""
    return (R.randint(-2, 3, shape) * 0.5).astype(np.float32)


# name -> (op, inputs {slot: [array]}, attrs, slots differentiated)
CASES = {
    # the shape ops
    "reshape": ("reshape", {"X": [_randn(2, 3, 4)]}, {"shape": [0, -1]},
                ("X",)),
    "squeeze2": ("squeeze2", {"X": [_randn(2, 1, 3, 1)]}, {"axes": [1, -1]},
                 ("X",)),
    "squeeze2_all": ("squeeze2", {"X": [_randn(1, 3, 1)]}, {}, ("X",)),
    "squeeze": ("squeeze", {"X": [_randn(2, 1, 3)]}, {"axes": [-2]},
                ("X",)),
    "unsqueeze2": ("unsqueeze2", {"X": [_randn(2, 3)]}, {"axes": [2, 0]},
                   ("X",)),
    "unsqueeze": ("unsqueeze", {"X": [_randn(2, 3)]}, {"axes": [1]},
                  ("X",)),
    "flatten2": ("flatten2", {"X": [_randn(2, 3, 4)]}, {"axis": 2}, ("X",)),
    "flatten": ("flatten", {"X": [_randn(2, 3, 4)]}, {"axis": 0}, ("X",)),
    "transpose": ("transpose", {"X": [_randn(2, 3, 4)]},
                  {"axis": [2, 0, 1]}, ("X",)),
    "stack": ("stack", {"X": [_randn(2, 4), _randn(2, 4), _randn(2, 4)]},
              {"axis": 1}, ("X",)),
    "unstack": ("unstack", {"X": [_randn(3, 2, 4)]}, {"axis": 1, "num": 2},
                ("X",)),
    "expand": ("expand", {"X": [_randn(2, 1, 3)]},
               {"expand_times": [1, 4, 2]}, ("X",)),
    "strided_slice": ("strided_slice", {"Input": [_randn(6, 8)]},
                      {"axes": [0, 1], "starts": [1, 7], "ends": [5, 0],
                       "strides": [2, -2]}, ("Input",)),
    "pad": ("pad", {"X": [_randn(2, 3)]},
            {"paddings": [1, 0, 2, 1], "pad_value": 0.5}, ("X",)),
    "pad2d_constant": ("pad2d", {"X": [_randn(1, 2, 3, 4)]},
                       {"paddings": [1, 2, 0, 1], "mode": "constant",
                        "pad_value": -1.0}, ("X",)),
    "pad2d_reflect": ("pad2d", {"X": [_randn(1, 2, 3, 4)]},
                      {"paddings": [1, 2, 2, 1], "mode": "reflect"}, ("X",)),
    "pad2d_edge_nhwc": ("pad2d", {"X": [_randn(1, 3, 4, 2)]},
                        {"paddings": [2, 0, 1, 1], "mode": "edge",
                         "data_format": "NHWC"}, ("X",)),
    "pad_constant_like": ("pad_constant_like",
                          {"X": [_randn(4, 5)], "Y": [_randn(2, 3)]},
                          {"pad_value": 0.25}, ("Y",)),
    # the index ops
    "gather": ("gather", {"X": [_randn(6, 3)],
                          "Index": [np.array([4, 0, 4, 2], np.int64)]},
               {}, ("X",)),
    "gather_nd": ("gather_nd", {"X": [_randn(4, 5, 3)],
                                "Index": [_ints(0, 4, 2, 3, 2)]}, {},
                  ("X",)),
    "scatter": ("scatter", {"X": [_randn(6, 3)],
                            "Ids": [np.array([5, 1, 3], np.int64)],
                            "Updates": [_randn(3, 3)]},
                {"overwrite": True}, ("X", "Updates")),
    "scatter_add": ("scatter", {"X": [_randn(6, 3)],
                                "Ids": [np.array([2, 0, 2, 5], np.int64)],
                                "Updates": [_randn(4, 3)]},
                    {"overwrite": False}, ("X", "Updates")),
    "one_hot": ("one_hot", {"X": [np.array([[0], [3], [5], [2]],
                                           np.int64)]},
                {"depth": 5}, ()),
    "multiplex": ("multiplex", {"X": [_randn(4, 5), _randn(4, 5),
                                      _randn(4, 5)],
                                "Ids": [np.array([[2], [0], [1], [2]],
                                                 np.int64)]}, {}, ("X",)),
    "reverse": ("reverse", {"X": [_randn(3, 4, 2)]}, {"axis": [0, 2]},
                ("X",)),
    "where": ("where", {"Condition": [_randn(3, 4) > 0]}, {}, ()),
    "where_op_select": ("where_op_select",
                        {"Condition": [_randn(3, 4) > 0],
                         "X": [_randn(3, 4)], "Y": [_randn(3, 4)]}, {},
                        ("X", "Y")),
    "label_smooth": ("label_smooth", {"X": [_probs(4, 6)]},
                     {"epsilon": 0.1}, ("X",)),
    "label_smooth_prior": ("label_smooth", {"X": [_probs(4, 6)],
                                            "PriorDist": [_probs(1, 6)]},
                           {"epsilon": 0.2}, ("X", "PriorDist")),
    "shard_index": ("shard_index", {"X": [_ints(0, 20, 8, 1)]},
                    {"index_num": 20, "nshards": 3, "shard_id": 1,
                     "ignore_value": -1}, ()),
    "fill_zeros_like": ("fill_zeros_like", {"X": [_randn(3, 2)]}, {}, ()),
    # the losses
    "sigmoid_ce": ("sigmoid_cross_entropy_with_logits",
                   {"X": [np.concatenate([_randn(3, 4) * 3,
                                          np.zeros((1, 4), np.float32)])],
                    "Label": [np.where(R.rand(4, 4) < 0.2, -100.0,
                                       R.rand(4, 4)).astype(np.float32)]},
                   {"ignore_index": -100}, ("X",)),
    "sigmoid_ce_normalize": ("sigmoid_cross_entropy_with_logits",
                             {"X": [_randn(4, 3)],
                              "Label": [np.where(
                                  R.rand(4, 3) < 0.3, -1.0,
                                  R.randint(0, 2, (4, 3))).astype(
                                      np.float32)]},
                             {"ignore_index": -1, "normalize": True},
                             ("X",)),
    "log_loss": ("log_loss", {"Predicted": [R.rand(6, 1).astype(np.float32)],
                              "Labels": [_ints(0, 2, 6, 1).astype(
                                  np.float32)]},
                 {"epsilon": 1e-4}, ("Predicted",)),
    # the recurrences
    "gru_unit": ("gru_unit", {"Input": [_randn(3, 3 * D)],
                              "HiddenPrev": [_randn(3, D)],
                              "Weight": [_randn(D, 3 * D) * 0.5],
                              "Bias": [_randn(1, 3 * D)]},
                 {}, ("Input", "HiddenPrev", "Weight", "Bias")),
    "gru_unit_origin_relu": ("gru_unit", {"Input": [_randn(3, 3 * D)],
                                          "HiddenPrev": [_randn(3, D)],
                                          "Weight": [_randn(D, 3 * D)]},
                             {"origin_mode": True, "activation": "relu"},
                             ("Input", "HiddenPrev", "Weight")),
    "lstm_unit": ("lstm_unit", {"X": [_randn(3, 4 * D)],
                                "C_prev": [_randn(3, D)]},
                  {"forget_bias": 0.5}, ("X", "C_prev")),
    "gru": ("gru", {"Input": [_randn(2, 5, 3 * D)],
                    "Weight": [_randn(D, 3 * D) * 0.5],
                    "Bias": [_randn(1, 3 * D)]},
            {"is_reverse": False, "gate_activation": "sigmoid",
             "activation": "tanh", "origin_mode": False},
            ("Input", "Weight", "Bias")),
    "gru_reverse_origin_h0": ("gru", {"Input": [_randn(2, 5, 3 * D)],
                                      "Weight": [_randn(D, 3 * D) * 0.5],
                                      "H0": [_randn(2, D)]},
                              {"is_reverse": True, "origin_mode": True,
                               "gate_activation": "sigmoid",
                               "activation": "identity"},
                              ("Input", "Weight", "H0")),
    "lstm": ("lstm", {"Input": [_randn(2, 5, 4 * D)],
                      "Weight": [_randn(D, 4 * D) * 0.5],
                      "Bias": [_randn(1, 4 * D)]},
             {"is_reverse": False}, ("Input", "Weight", "Bias")),
    "lstm_reverse_peepholes_h0_c0": (
        "lstm", {"Input": [_randn(2, 5, 4 * D)],
                 "Weight": [_randn(D, 4 * D) * 0.5],
                 "Bias": [_randn(1, 7 * D)], "H0": [_randn(2, D)],
                 "C0": [_randn(2, D)]},
        {"is_reverse": True}, ("Input", "Weight", "Bias", "H0", "C0")),
    # the sequence ops
    "sequence_conv": ("sequence_conv", {"X": [_randn(2, 5, 3)],
                                        "Filter": [_randn(9, 4)]},
                      {"contextLength": 3, "contextStart": -1},
                      ("X", "Filter")),
    "sequence_conv_ahead": ("sequence_conv", {"X": [_randn(2, 5, 3)],
                                              "Filter": [_randn(6, 2)]},
                            {"contextLength": 2, "contextStart": 1},
                            ("X", "Filter")),
    "sequence_softmax": ("sequence_softmax", {"X": [_randn(2, 5)],
                                              "Length": [LENS]}, {}, ("X",)),
    "sequence_softmax_3d": ("sequence_softmax", {"X": [_randn(2, 5, 1)]},
                            {}, ("X",)),
    "sequence_expand": ("sequence_expand", {"X": [_randn(2, 3)],
                                            "Y": [_randn(2, 4, 3)]}, {},
                        ("X",)),
    "sequence_expand_as": ("sequence_expand_as", {"X": [_randn(2, 3)],
                                                  "Y": [_randn(2, 4, 3)]},
                           {}, ("X",)),
    "sequence_reshape": ("sequence_reshape", {"X": [_randn(2, 4, 6)]},
                         {"new_dim": 3}, ("X",)),
    "sequence_reverse": ("sequence_reverse", {"X": [_randn(2, 5, 3)],
                                              "Length": [LENS]}, {}, ("X",)),
    "sequence_reverse_2d": ("sequence_reverse", {"X": [_randn(2, 5)],
                                                 "Length": [LENS]}, {},
                            ("X",)),
    "sequence_reverse_full": ("sequence_reverse", {"X": [_randn(2, 5, 3)]},
                              {}, ("X",)),
    "sequence_concat": ("sequence_concat", {"X": [_randn(2, 3, 2),
                                                  _randn(2, 4, 2)]}, {},
                        ("X",)),
    "sequence_slice": ("sequence_slice", {"X": [_randn(2, 5, 3)]},
                       {"offset_val": 1, "length_val": 3}, ("X",)),
    "sequence_pad": ("sequence_pad", {"X": [_randn(2, 5, 3)],
                                      "PadValue": [np.zeros(1, np.float32)],
                                      "Length": [LENS]}, {}, ("X",)),
    "sequence_unpad": ("sequence_unpad", {"X": [_randn(2, 5, 3)],
                                          "Length": [LENS]}, {}, ("X",)),
    "sequence_mask": ("sequence_mask", {"X": [np.array([[4], [0], [6]],
                                                       np.int64)]},
                      {"maxlen": 6, "out_dtype": "float32"}, ()),
    "sequence_mask_int": ("sequence_mask", {"X": [np.array([2, 5],
                                                           np.int64)]},
                          {"maxlen": 4, "out_dtype": "int64"}, ()),
    "sequence_enumerate": ("sequence_enumerate", {"X": [_ints(1, 9, 2, 5)]},
                           {"win_size": 3, "pad_value": 0}, ()),
    "sequence_erase": ("sequence_erase", {"X": [_ints(0, 6, 2, 7)]},
                       {"tokens": [2, 5]}, ()),
    "sequence_scatter": ("sequence_scatter",
                         {"X": [_randn(2, 6)],
                          "Ids": [np.array([[0, 3, 3], [5, 1, 2]],
                                           np.int64)],
                          "Updates": [_randn(2, 3)]}, {},
                         ("X", "Updates")),
    "similarity_focus": ("similarity_focus", {"X": [_randn(2, 3, 4, 4)]},
                         {"axis": 1, "indexes": [0, 2]}, ()),
}
for _p in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
    CASES["sequence_pool_" + _p.lower()] = (
        "sequence_pool", {"X": [_ties(2, 5, 3)], "Length": [LENS]},
        {"pooltype": _p}, ("X",))
CASES["sequence_pool_max_full"] = ("sequence_pool", {"X": [_ties(3, 4, 2)]},
                                   {"pooltype": "MAX"}, ("X",))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.double() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) \
        else x


def _compare(got, want, name):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, err_msg=name, **F32)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=name)


def run_both(op, ins, attrs, diff):
    """Both packages' op on `ins`: (JAX outs, port outs, JAX grads, port
    grads), the grads for one seeded cotangent of every float output."""
    j_impl, p_impl = j_registry.get(op).impl, p_registry.get(op).impl
    j_const = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()
               if s not in diff}
    j_diff = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()
              if s in diff}
    j_outs = j_impl(None, {**j_const, **j_diff}, attrs)
    ctx = LoweringContext(torch.device("cpu"))
    p_ins = {s: [torch.from_numpy(np.array(a)).requires_grad_(s in diff)
                 for a in v] for s, v in ins.items()}
    p_outs = p_impl(ctx, p_ins, attrs)
    if not diff:
        return j_outs, p_outs, None, None
    cot_rng = np.random.RandomState(1)
    keys = [(s, i) for s in sorted(j_outs) for i, o in enumerate(j_outs[s])
            if jnp.issubdtype(o.dtype, jnp.floating) and o.size]
    cots = {k: cot_rng.standard_normal(j_outs[k[0]][k[1]].shape).astype(
        np.float32) for k in keys}

    def j_fn(d):
        outs = j_impl(None, {**j_const, **d}, attrs)
        return sum(jnp.sum(outs[s][i] * cots[(s, i)]) for s, i in keys)

    j_grads = jax.grad(j_fn)(j_diff)
    total = sum((p_outs[s][i] * torch.from_numpy(cots[(s, i)])).sum()
                for s, i in keys)
    leaves = [t for s in diff for t in p_ins[s]]
    p_grads = torch.autograd.grad(total, leaves, allow_unused=True)
    p_grads = [torch.zeros_like(t) if g is None else g
               for t, g in zip(leaves, p_grads)]
    return j_outs, p_outs, [g for s in diff for g in j_grads[s]], p_grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    op, ins, attrs, diff = CASES[case]
    assert p_registry.get(op).differentiable == bool(
        j_registry.get(op).differentiable)
    j_outs, p_outs, j_grads, p_grads = run_both(op, ins, attrs, diff)
    assert sorted(p_outs) == sorted(j_outs), case
    for slot in j_outs:
        assert len(p_outs[slot]) == len(j_outs[slot]), (case, slot)
        for i, (g, w) in enumerate(zip(p_outs[slot], j_outs[slot])):
            _compare(g, w, "%s %s[%d]" % (case, slot, i))
    for i, (g, w) in enumerate(zip(p_grads or (), j_grads or ())):
        _compare(g, w, "%s grad %d" % (case, i))


def test_sequence_pool_max_splits_tied_grads_evenly():
    """Equal maxima share the grad, as jnp.max's do (torch.max(dim) would
    give it all to one of them)."""
    x = np.array([[[1.0], [3.0], [3.0], [3.0]]], np.float32)
    _, p_outs, j_grads, p_grads = run_both(
        "sequence_pool", {"X": [x]}, {"pooltype": "MAX"}, ("X",))
    cot = np.random.RandomState(1).standard_normal((1, 1))
    np.testing.assert_allclose(_np(p_grads[0])[0, 1:, 0],
                               np.full(3, cot[0, 0] / 3), rtol=1e-6)
    _compare(p_grads[0], j_grads[0], "tied max grad")


@pytest.mark.parametrize("width", [1, 2])
def test_auc_histograms_bitwise_over_runs(width):
    """Three runs of the auc op carrying StatPos / StatNeg: the
    histograms bitwise equal to JAX's after each (scores on and beside
    the bin edges k / num_thresholds), the AUC within 1e-6 (the
    trapezoid's sum may take another order)."""
    n, nt = 64, 1023
    j_impl, p_impl = j_registry.get("auc").impl, p_registry.get("auc").impl
    rng = np.random.RandomState(3)
    j_stats = [jnp.zeros(nt + 1, jnp.float32)] * 2
    p_stats = [torch.zeros(nt + 1)] * 2
    for run in range(3):
        score = rng.rand(n).astype(np.float32)
        score[:16] = (rng.randint(0, nt + 1, 16) / np.float32(nt)).astype(
            np.float32)
        score[16:20] = [0.0, 1.0, np.nextafter(np.float32(1), 0), 0.5]
        pred = score[:, None] if width == 1 else np.stack(
            [1 - score, score], 1).astype(np.float32)
        label = rng.randint(0, 2, (n, 1)).astype(np.int64)
        jo = j_impl(None, {"Predict": [jnp.asarray(pred)],
                           "Label": [jnp.asarray(label)],
                           "StatPos": [j_stats[0]],
                           "StatNeg": [j_stats[1]]}, {"num_thresholds": nt})
        po = p_impl(None, {"Predict": [torch.from_numpy(pred)],
                           "Label": [torch.from_numpy(label)],
                           "StatPos": [p_stats[0]],
                           "StatNeg": [p_stats[1]]}, {"num_thresholds": nt})
        j_stats = [jo["StatPosOut"][0], jo["StatNegOut"][0]]
        p_stats = [po["StatPosOut"][0], po["StatNegOut"][0]]
        for j, p in zip(j_stats, p_stats):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        assert float(p_stats[0].sum() + p_stats[1].sum()) == n * (run + 1)
        np.testing.assert_allclose(_np(po["AUC"][0]), _np(jo["AUC"][0]),
                                   atol=1e-6, rtol=0)


def test_beam_search_breaks_ties_in_index_order():
    """Finished lanes carry -1e30 in every candidate but their first, so
    the top-k over beam * K candidates sees many equal scores: the port
    takes them in index order, as lax.top_k does, and the selected ids,
    scores and parents equal JAX's."""
    W, K = 3, 3
    pre_ids = np.array([[1, 1, 4], [1, 1, 1]], np.int64)   # end_id 1
    pre_scores = np.array([[-0.5, -0.5, -0.7], [-1.0, -1.0, -2.0]],
                          np.float32)
    ids = np.array(R.randint(2, 9, (2, W, K)), np.int64)
    scores = np.full((2, W, K), 0.25, np.float32)
    ins = {"pre_ids": [pre_ids], "pre_scores": [pre_scores], "ids": [ids],
           "scores": [scores]}
    attrs = {"beam_size": W, "end_id": 1}
    j_outs, p_outs, _, _ = run_both("beam_search", ins, attrs, ())
    for slot in j_outs:
        _compare(p_outs[slot][0], j_outs[slot][0], slot)
    np.testing.assert_array_equal(_np(p_outs["parent_idx"][0]),
                                  [[0, 1, 2], [0, 1, 2]])


def test_beam_search_decode_backtracks_like_jax():
    T, B, W = 5, 2, 3
    ins = {"Ids": [_ints(0, 9, T, B, W)], "Scores": [_randn(T, B, W)],
           "Parents": [_ints(0, W, T, B, W)]}
    j_outs, p_outs, _, _ = run_both("beam_search_decode", ins, {}, ())
    for slot in j_outs:
        _compare(p_outs[slot][0], j_outs[slot][0], slot)


def _random_layer(fluid, kind):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    if kind == "uniform":
        return fluid.layers.uniform_random_batch_size_like(
            x, [-1, 20000], min=-2.0, max=3.0, seed=5)
    if kind == "gaussian":
        return fluid.layers.gaussian_random_batch_size_like(
            x, [-1, 20000], mean=1.0, std=2.0, seed=5)
    probs = fluid.layers.expand(fluid.layers.reshape(
        fluid.layers.softmax(x), [-1, 1, 4]), [1, 20000, 1])
    return fluid.layers.sampling_id(
        fluid.layers.reshape(probs, [-1, 4]), seed=5)


@pytest.mark.parametrize("kind", ["uniform", "gaussian", "sampling"])
def test_random_ops_match_by_shape_dtype_range_and_moments(kind):
    """Each package's draw through its own layer and executor: the same
    shape and dtype; uniform draws inside [min, max) with mean and
    variance within 0.03 and 0.06 of (max + min) / 2 and (max - min)^2 /
    12; gaussian ones with mean and std within 0.05 of 1 and 2; sampled
    ids in [0, 4) with each id's share within 0.015 of its
    probability."""
    xs = np.array([[0.0, 1.0, 2.0, -1.0], [0.5, 0.5, 0.5, 0.5]], np.float32)
    probs = np.exp(xs) / np.exp(xs).sum(1, keepdims=True)
    outs = []
    for fluid, place in ((jfluid, jfluid.CPUPlace()), (pfluid, "cpu")):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            out = _random_layer(fluid, kind)
        exe = fluid.Executor(place)
        exe.run(startup)
        got, = exe.run(main, feed={"x": xs}, fetch_list=[out])
        outs.append(np.asarray(got))
    j, p = outs
    assert p.shape == j.shape and p.dtype.kind == j.dtype.kind, (
        p.shape, j.shape, p.dtype, j.dtype)
    for draw in outs:
        if kind == "uniform":
            assert draw.shape == (2, 20000)
            assert draw.min() >= -2.0 and draw.max() < 3.0
            assert abs(draw.mean() - 0.5) < 0.03
            assert abs(draw.var() - 25 / 12) < 0.06
        elif kind == "gaussian":
            assert abs(draw.mean() - 1.0) < 0.05
            assert abs(draw.std() - 2.0) < 0.05
        else:
            ids = draw.reshape(2, 20000)
            assert ids.min() >= 0 and ids.max() < 4
            share = np.stack([(ids == k).mean(1) for k in range(4)], 1)
            np.testing.assert_allclose(share, probs, atol=0.015)
