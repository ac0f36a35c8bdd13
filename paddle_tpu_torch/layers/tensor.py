"""Tensor layers (parity: python/paddle/fluid/layers/tensor.py)."""

import numpy as np

from ..framework import Variable, convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["create_parameter", "cast", "concat", "sums", "assign",
           "fill_constant", "ones", "zeros", "zeros_like", "reverse"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter", **locals())
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def cast(x, dtype):
    helper = LayerHelper("cast", **locals())
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    out.shape = x.shape
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", **locals())
    out = helper.create_variable_for_type_inference(
        dtype=helper.input_dtype())
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    shapes = [v.shape for v in input]
    if all(s is not None for s in shapes):
        ax = axis % len(shapes[0])
        dim = -1 if any(s[ax] == -1 for s in shapes) else sum(
            s[ax] for s in shapes)
        out.shape = tuple(dim if i == ax else d
                          for i, d in enumerate(shapes[0]))
    return out


def sums(input, out=None):
    helper = LayerHelper("sum", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=helper.input_dtype())
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    out.shape = input[0].shape
    return out


def assign(input, output=None):
    """Copy a Variable (an `assign` op) or a numpy value (an
    `assign_value` op holding it) into `output`."""
    helper = LayerHelper("assign", **locals())
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
        output.shape = input.shape
        return output
    arr = np.asarray(input)
    if output is None:
        output = helper.create_variable_for_type_inference(str(arr.dtype))
    helper.append_op(type="assign_value", outputs={"Out": [output]},
                     attrs={"shape": list(arr.shape), "dtype": str(arr.dtype),
                            "values": arr.tolist()})
    output.shape = tuple(arr.shape)
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    dtype = convert_dtype(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    out.shape = tuple(shape)
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    out.shape = x.shape
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse", **locals())
    if isinstance(axis, int):
        axis = [axis]
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    out.shape = x.shape
    return out
