"""NN layers (parity: python/paddle/fluid/layers/nn.py): the layers the
Fluid-API Transformer LM is built from. Each appends ops to the current
block through LayerHelper, exactly as the JAX package's layers do."""

import numpy as np

from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "scale", "layer_norm", "reshape", "slice",
    "softmax_with_cross_entropy", "add_position_encoding", "shape",
    "elementwise_add", "elementwise_mul", "elementwise_div",
    "reduce_sum", "reduce_prod",
]


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
    from ..initializer import Constant

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
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")


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
reduce_prod = _reduce("reduce_prod")
