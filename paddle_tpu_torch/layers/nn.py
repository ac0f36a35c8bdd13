"""NN layers (parity: the JAX package's ``layers/nn.py``): the layers the
Fluid-API Transformer LM, its dropout path, the gradient clips, the
learning-rate schedules, the image classifiers (conv2d, pool2d,
batch_norm, cross_entropy) and the benchmark models (the tensor layers,
topk, the sigmoid and log losses) are built from. Each appends ops to the
current block through LayerHelper, exactly as the JAX package's layers
do."""

import numpy as np

from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

_ACTIVATIONS = (
    "relu", "relu6", "sigmoid", "logsigmoid", "tanh", "tanh_shrink",
    "softplus", "softsign", "softshrink", "hard_shrink", "hard_sigmoid",
    "elu", "selu", "leaky_relu", "brelu", "soft_relu", "swish",
    "thresholded_relu", "stanh", "exp", "log", "sqrt", "rsqrt", "square",
    "reciprocal", "abs", "ceil", "floor", "round", "cos", "sin", "acos",
    "asin", "atan", "gelu")
_ELEMENTWISE = ("elementwise_add", "elementwise_sub", "elementwise_mul",
                "elementwise_div", "elementwise_max", "elementwise_min",
                "elementwise_pow", "elementwise_mod", "elementwise_floordiv")
_COMPARE = ("equal", "not_equal", "less_than", "less_equal",
            "greater_than", "greater_equal")
_LOGICAL = ("logical_and", "logical_or", "logical_xor", "logical_not")

__all__ = [
    "fc", "embedding", "scale", "layer_norm", "reshape", "slice",
    "softmax_with_cross_entropy", "add_position_encoding", "shape",
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
    "matmul", "mul", "softmax", "dropout",
    "transpose", "split", "clip", "clip_by_norm", "pow", "sign",
    "mean", "square_error_cost", "conv2d", "pool2d", "batch_norm",
    "cross_entropy", "one_hot", "topk", "squeeze", "unsqueeze", "flatten",
    "stack", "unstack", "expand", "gather", "gather_nd", "scatter", "pad",
    "pad2d", "pad_constant_like", "label_smooth",
    "sigmoid_cross_entropy_with_logits", "log_loss", "where", "multiplex",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "sampling_id",
] + list(_ACTIVATIONS + _ELEMENTWISE + _COMPARE + _LOGICAL)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully connected: one `mul` per input (summed when several), then
    bias and activation."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = helper.multiple_param_attr(len(inputs))
    mul_results = []
    for inp, p_attr in zip(inputs, param_attrs):
        in_shape = inp.shape
        fan_in = int(np.prod(in_shape[num_flatten_dims:]))
        w = helper.create_parameter(attr=p_attr, shape=[fan_in, size],
                                    dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul", inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        tmp.shape = tuple(in_shape[:num_flatten_dims]) + (size,)
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
        pre_bias.shape = mul_results[0].shape
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    padding_idx = (-1 if padding_idx is None
                   else padding_idx if padding_idx >= 0
                   else size[0] + padding_idx)
    helper.append_op(
        type="lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": padding_idx})
    ish = input.shape
    if ish is not None:
        base = ish[:-1] if (ish and ish[-1] == 1) else ish
        out.shape = tuple(base) + (size[1],)
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale})
    out.shape = x.shape
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = input.dtype
    feat = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            attr=helper.param_attr, shape=feat, dtype=dtype,
            default_initializer=Constant(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=feat, dtype=dtype, is_bias=True)]
    out = helper.create_variable_for_type_inference(dtype)
    mean_out = helper.create_variable_for_type_inference(dtype,
                                                         stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype,
                                                        stop_gradient=True)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    out.shape = input.shape
    return helper.append_activation(out)


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper("reshape2", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    if x.shape is not None:
        s = list(shape)
        for i, d in enumerate(s):
            if d == 0:
                s[i] = x.shape[i]
        known = int(np.prod([d for d in s if d > 0]))
        total = (int(np.prod(x.shape)) if all(d != -1 for d in x.shape)
                 else None)
        if -1 in s and total is not None:
            s[s.index(-1)] = total // known
        out.shape = tuple(s)
    return helper.append_activation(out)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="slice", inputs={"Input": [input]}, outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts),
               "ends": list(ends)})
    if input.shape is not None:
        s = list(input.shape)
        for ax, st, en in zip(axes, starts, ends):
            d = s[ax]
            if d == -1:
                continue
            st2 = max(st + d, 0) if st < 0 else min(st, d)
            en2 = max(en + d, 0) if en < 0 else min(en, d)
            s[ax] = max(en2 - st2, 0)
        out.shape = tuple(s)
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy", **locals())
    softmax_out = helper.create_variable_for_type_inference(
        dtype=logits.dtype)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "axis": axis,
               # the op skips the discarded softmax side output
               "__need_softmax__": bool(return_softmax)})
    if logits.shape is not None:
        s = list(logits.shape)
        s[axis % len(s)] = 1
        loss.shape = tuple(s)
        softmax_out.shape = logits.shape
    if return_softmax:
        return loss, softmax_out
    return loss


def add_position_encoding(input, alpha, beta, name=None):
    helper = LayerHelper("add_position_encoding", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="add_position_encoding", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"alpha": alpha, "beta": beta})
    out.shape = input.shape
    return out


def shape(input):
    helper = LayerHelper("shape", **locals())
    out = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(type="shape", inputs={"X": [input]},
                     outputs={"Out": [out]})
    out.shape = (len(input.shape),)
    out.stop_gradient = True
    return out


# ---------------------------------------------------------------------------
# elementwise and reductions
# ---------------------------------------------------------------------------


def _broadcast_dims(xs, ys):
    """Numpy-broadcast two shapes with None = unknown; raises ValueError
    when two known dims, neither 1, differ."""
    n = max(len(xs), len(ys))
    xs = (None,) * (n - len(xs)) + tuple(xs)
    ys = (None,) * (n - len(ys)) + tuple(ys)
    out = []
    for a, b in zip(xs, ys):
        if a is None or b is None:
            known = a if a is not None else b
            out.append(known if known is not None and known != 1 else None)
        elif a == b or b == 1:
            out.append(a)
        elif a == 1:
            out.append(b)
        else:
            raise ValueError("dims %r and %r do not broadcast" % (a, b))
    return tuple(out)


def _elementwise_out_shape(xs, ys, axis):
    """Declared Out shape of an elementwise op: Fluid axis alignment of
    Y into X, then numpy broadcasting (-1 = unknown), as the JAX
    package's layers declare it."""
    if xs is None or ys is None:
        return xs
    unk = lambda s: tuple(None if d == -1 else d for d in s)  # noqa: E731
    xs_u, ys_u = unk(xs), unk(ys)
    if axis not in (-1, None):
        if axis + len(ys_u) > len(xs_u):
            return tuple(xs)
        ys_u = (1,) * axis + ys_u + (1,) * (len(xs_u) - axis - len(ys_u))
    try:
        merged = _broadcast_dims(xs_u, ys_u)
    except ValueError:
        return tuple(xs)  # statically incompatible: the op will raise
    return tuple(-1 if d is None else d for d in merged)


def _elementwise(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, **locals())
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        out.shape = _elementwise_out_shape(x.shape,
                                           getattr(y, "shape", None), axis)
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise("elementwise_add")
elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")
elementwise_max = _elementwise("elementwise_max")
elementwise_min = _elementwise("elementwise_min")
elementwise_pow = _elementwise("elementwise_pow")
elementwise_mod = _elementwise("elementwise_mod")
elementwise_floordiv = _elementwise("elementwise_floordiv")


def _compare(op_type):
    def layer(x, y, cond=None):
        helper = LayerHelper(op_type, **locals())
        if cond is None:
            cond = helper.create_variable_for_type_inference(dtype="bool")
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [cond]})
        cond.shape = x.shape
        cond.stop_gradient = True
        return cond

    layer.__name__ = op_type
    return layer


equal = _compare("equal")
not_equal = _compare("not_equal")
less_than = _compare("less_than")
less_equal = _compare("less_equal")
greater_than = _compare("greater_than")
greater_equal = _compare("greater_equal")


def _logical(op_type, unary=False):
    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, **locals())
        if out is None:
            out = helper.create_variable_for_type_inference(dtype="bool")
        inputs = {"X": [x]} if unary else {"X": [x], "Y": [y]}
        helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]})
        out.shape = x.shape
        out.stop_gradient = True
        return out

    layer.__name__ = op_type
    return layer


logical_and = _logical("logical_and")
logical_or = _logical("logical_or")
logical_xor = _logical("logical_xor")
logical_not = _logical("logical_not", unary=True)


def _reduce(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, **locals())
        out = helper.create_variable_for_type_inference(dtype=input.dtype)
        if dim is None:
            attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
        else:
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            attrs = {"dim": list(dims), "keep_dim": keep_dim,
                     "reduce_all": False}
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        if input.shape is not None:
            if dim is None:
                out.shape = ((1,) * len(input.shape)) if keep_dim else (1,)
            else:
                dims = [d % len(input.shape) for d in attrs["dim"]]
                if keep_dim:
                    out.shape = tuple(1 if i in dims else d
                                      for i, d in enumerate(input.shape))
                else:
                    out.shape = tuple(d for i, d in enumerate(input.shape)
                                      if i not in dims) or (1,)
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
reduce_prod = _reduce("reduce_prod")


def mean(x, name=None):
    helper = LayerHelper("mean", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    out.shape = (1,)
    return out


# ---------------------------------------------------------------------------
# activations and the single-input math layers
# ---------------------------------------------------------------------------


def _activation(op_type):
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, **locals())
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        attrs = {k: v for k, v in kwargs.items() if v is not None}
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        out.shape = x.shape
        return out

    layer.__name__ = op_type
    return layer


for _name in _ACTIVATIONS:
    globals()[_name] = _activation(_name)
del _name


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": float(factor)})
    out.shape = x.shape
    return out


def sign(x):
    helper = LayerHelper("sign", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="sign", inputs={"X": [x]}, outputs={"Out": [out]})
    out.shape = x.shape
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    out.shape = x.shape
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    out.shape = x.shape
    return out


def square_error_cost(input, label):
    """(input - label)^2, an elementwise_sub and a square."""
    helper = LayerHelper("square_error_cost", **locals())
    minus_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="elementwise_sub",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [minus_out]})
    minus_out.shape = input.shape
    sq = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="square", inputs={"X": [minus_out]},
                     outputs={"Out": [sq]})
    sq.shape = input.shape
    return sq


# ---------------------------------------------------------------------------
# attention's layers: matmul, softmax, dropout, transpose, split
# ---------------------------------------------------------------------------


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)})
    if x.shape is not None and y.shape is not None:
        xs, ys = list(x.shape), list(y.shape)
        if transpose_x and len(xs) > 1:
            xs[-1], xs[-2] = xs[-2], xs[-1]
        if transpose_y and len(ys) > 1:
            ys[-1], ys[-2] = ys[-2], ys[-1]
        out.shape = (tuple(xs[:-1] + [ys[-1]])
                     if len(xs) > 1 and len(ys) > 1 else (1,))
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """Fluid's mul: x flattened to 2-D at x_num_col_dims times y at
    y_num_col_dims."""
    helper = LayerHelper("mul", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    if x.shape is not None and y.shape is not None:
        out.shape = (tuple(x.shape[:x_num_col_dims])
                     + tuple(y.shape[y_num_col_dims:]))
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    out.shape = input.shape
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed or 0,
               "dropout_implementation": dropout_implementation})
    out.shape = x.shape
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    if x.shape is not None:
        out.shape = tuple(x.shape[p] for p in perm)
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", **locals())
    dim = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
        sizes = ([input.shape[dim] // num] * num if input.shape[dim] > 0
                 else [-1] * num)
    else:
        num, sections = 0, list(num_or_sections)
        sizes = sections
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in sizes]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"num": num, "sections": sections, "axis": dim})
    for o, sz in zip(outs, sizes):
        s = list(input.shape)
        s[dim] = sz
        o.shape = tuple(s)
    return outs


# ---------------------------------------------------------------------------
# the image classifiers' layers: conv2d, pool2d, batch_norm, cross_entropy
# ---------------------------------------------------------------------------


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def _conv_out_dim(d, k, pad, stride, dilation=1):
    if d == -1:
        return -1
    ke = dilation * (k - 1) + 1
    return (d + 2 * pad - ke) // stride + 1


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """NCHW convolution, filter [num_filters, C_in / groups, kh, kw] drawn
    from Normal(0, sqrt(2 / (kh kw C_in))), then bias and activation."""
    helper = LayerHelper("conv2d", **locals())
    dtype = input.dtype
    groups = groups or 1
    c_in = input.shape[1]
    fsize = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    filter_shape = [num_filters, c_in // groups] + fsize
    std = (2.0 / (fsize[0] * fsize[1] * c_in)) ** 0.5
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=Normal(0.0, std))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups})
    if input.shape is not None:
        n, _, h, wd = input.shape
        out.shape = (
            n, num_filters,
            _conv_out_dim(h, fsize[0], padding[0], stride[0], dilation[0]),
            _conv_out_dim(wd, fsize[1], padding[1], stride[1], dilation[1]))
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    """Max or average pool over NCHW. The declared shape honours
    `ceil_mode`; the op does not read it (the JAX op's semantics)."""
    helper = LayerHelper("pool2d", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    pool_size = _pair(pool_size)
    pool_stride = _pair(pool_stride)
    pool_padding = _pair(pool_padding)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "strides": pool_stride, "paddings": pool_padding,
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive})
    if input.shape is not None:
        n, c, h, w = input.shape
        if global_pooling:
            out.shape = (n, c, 1, 1)
        else:
            def od(d, k, p, s):
                if d == -1:
                    return -1
                if ceil_mode:
                    return (d - k + 2 * p + s - 1) // s + 1
                return (d - k + 2 * p) // s + 1

            out.shape = (n, c,
                         od(h, pool_size[0], pool_padding[0], pool_stride[0]),
                         od(w, pool_size[1], pool_padding[1], pool_stride[1]))
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=False,
               fuse_with_relu=False, use_global_stats=False):
    """Batch norm with a scale, a shift and the moving mean and variance
    (persistable, not trainable), which the op reads as Mean / Variance
    and writes back as MeanOut / VarianceOut: one variable each."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = input.dtype
    ch = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(attr=helper.param_attr, shape=[ch],
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[ch],
                                   dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, initializer=Constant(0.0),
                       trainable=False),
        shape=[ch], dtype=dtype)
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, initializer=Constant(1.0),
                       trainable=False),
        shape=[ch], dtype=dtype)
    mean.stop_gradient = True
    variance.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype)
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    out.shape = input.shape
    return helper.append_activation(out)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """-log of the label's probability, [..., 1]."""
    helper = LayerHelper("cross_entropy", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="cross_entropy", inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    if input.shape is not None:
        out.shape = tuple(input.shape[:-1]) + (1,)
    return out


# ---------------------------------------------------------------------------
# the tensor layers over ops/tensor_ops.py, top-k and the sigmoid and log
# losses (the JAX package's layers/nn.py one_hot :381 to label_smooth
# :657, sigmoid_cross_entropy_with_logits :974, log_loss :1005, where
# :1539 to sampling_id :1614)
# ---------------------------------------------------------------------------


def one_hot(input, depth):
    helper = LayerHelper("one_hot", **locals())
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    if input.shape is not None:
        base = input.shape[:-1] if input.shape[-1] == 1 else input.shape
        out.shape = tuple(base) + (depth,)
    out.stop_gradient = True
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", **locals())
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    if input.shape is not None:
        values.shape = tuple(input.shape[:-1]) + (k,)
        indices.shape = values.shape
    indices.stop_gradient = True
    return values, indices


def _with_xshape(layer, op_type, x, attrs, name):
    """Append an op of the ``*2`` form (Out and a stop-gradient XShape)."""
    helper = LayerHelper(layer, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs=attrs)
    return out


def squeeze(input, axes, name=None):
    out = _with_xshape("squeeze", "squeeze2", input, {"axes": axes},
                       name)
    if input.shape is not None:
        drop = [a % len(input.shape) for a in axes]
        out.shape = tuple(d for i, d in enumerate(input.shape)
                          if i not in drop)
    return out


def unsqueeze(input, axes, name=None):
    out = _with_xshape("unsqueeze", "unsqueeze2", input, {"axes": axes},
                       name)
    if input.shape is not None:
        s = list(input.shape)
        for a in sorted(axes):
            s.insert(a, 1)
        out.shape = tuple(s)
    return out


def flatten(x, axis=1, name=None):
    out = _with_xshape("flatten", "flatten2", x, {"axis": axis}, name)
    if x.shape is not None:
        lead = int(np.prod(x.shape[:axis])) if axis > 0 else 1
        rest = int(np.prod(x.shape[axis:]))
        if any(d == -1 for d in x.shape[:axis]):
            lead = -1
        out.shape = (lead, rest)
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack", **locals())
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    if x[0].shape is not None:
        s = list(x[0].shape)
        s.insert(axis % (len(s) + 1), len(x))
        out.shape = tuple(s)
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack", **locals())
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    s = list(x.shape)
    del s[axis % len(s)]
    for o in outs:
        o.shape = tuple(s)
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    if x.shape is not None:
        out.shape = tuple(d * t if d != -1 else -1
                          for d, t in zip(x.shape, expand_times))
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    if input.shape is not None and index.shape is not None:
        out.shape = (index.shape[0],) + tuple(input.shape[1:])
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="gather_nd",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    if input.shape is not None and index.shape is not None:
        out.shape = tuple(index.shape[:-1]) + tuple(
            input.shape[index.shape[-1]:])
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    out.shape = input.shape
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    if x.shape is not None:
        out.shape = tuple(d + paddings[2 * i] + paddings[2 * i + 1]
                          if d != -1 else -1 for i, d in enumerate(x.shape))
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="pad2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"paddings": list(paddings), "mode": mode,
               "pad_value": float(pad_value), "data_format": data_format})
    if input.shape is not None:
        s = list(input.shape)
        h = 2 if data_format == "NCHW" else 1
        s[h] += paddings[0] + paddings[1]
        s[h + 1] += paddings[2] + paddings[3]
        out.shape = tuple(s)
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    helper = LayerHelper("pad_constant_like", **locals())
    out = helper.create_variable_for_type_inference(dtype=y.dtype)
    helper.append_op(type="pad_constant_like", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"pad_value": float(pad_value)})
    out.shape = x.shape
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", **locals())
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    out.shape = label.shape
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]}, outputs={"Out": [out]},
        attrs={"ignore_index": ignore_index, "normalize": normalize})
    out.shape = x.shape
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", **locals())
    loss = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="log_loss",
                     inputs={"Predicted": [input], "Labels": [label]},
                     outputs={"Loss": [loss]}, attrs={"epsilon": epsilon})
    loss.shape = input.shape
    return loss


def where(condition):
    helper = LayerHelper("where", **locals())
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="where", inputs={"Condition": [condition]},
                     outputs={"Out": [out]})
    out.stop_gradient = True
    return out


def multiplex(inputs, index):
    helper = LayerHelper("multiplex", **locals())
    out = helper.create_variable_for_type_inference(dtype=inputs[0].dtype)
    helper.append_op(type="multiplex", inputs={"X": inputs, "Ids": [index]},
                     outputs={"Out": [out]})
    out.shape = inputs[0].shape
    return out


def _random_batch_size_like(op_type, input, attrs):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(attrs["dtype"])
    helper.append_op(type=op_type, inputs={"Input": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    out.stop_gradient = True
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _random_batch_size_like(
        "uniform_random_batch_size_like", input,
        {"shape": list(shape), "dtype": dtype,
         "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx,
         "min": min, "max": max, "seed": seed})


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    return _random_batch_size_like(
        "gaussian_random_batch_size_like", input,
        {"shape": list(shape), "dtype": dtype,
         "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx,
         "mean": mean, "std": std, "seed": seed})


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id", **locals())
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="sampling_id", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"seed": seed})
    out.shape = (x.shape[0],)
    out.stop_gradient = True
    return out
