"""Sequence layers (parity: the JAX package's ``layers/sequence.py``,
the whole file: the sequence_* layers, dynamic_gru :230, dynamic_lstm
:264, dynamic_lstmp, gru_unit, lstm and lstm_unit).

Padded-dense semantics: inputs are [B, T, ...]; pass `sequence_length`
(a Variable [B]) where raggedness matters (the reference's LoD offsets).
``sequence_mask`` needs a static Python-int `maxlen`, as the JAX layer
does: the port's Program carries the same attrs.
"""

import numpy as np

from ..framework import Variable, convert_dtype
from ..layer_helper import LayerHelper

__all__ = [
    "sequence_conv", "sequence_pool", "sequence_softmax", "sequence_concat",
    "sequence_first_step", "sequence_last_step", "sequence_expand",
    "sequence_expand_as", "sequence_reshape", "sequence_reverse",
    "sequence_slice", "sequence_pad", "sequence_unpad", "sequence_mask",
    "sequence_enumerate", "sequence_erase", "sequence_scatter",
    "dynamic_gru", "dynamic_lstm", "dynamic_lstmp", "gru_unit", "lstm",
    "lstm_unit",
]


def _seq_inputs(input, sequence_length):
    ins = {"X": [input]}
    if sequence_length is not None:
        ins["Length"] = [sequence_length]
    return ins


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None, sequence_length=None):
    helper = LayerHelper("sequence_conv", **locals())
    dtype = input.dtype
    d = input.shape[-1]
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[filter_size * d, num_filters],
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    ins = _seq_inputs(input, sequence_length)
    ins["Filter"] = [w]
    helper.append_op(
        type="sequence_conv", inputs=ins, outputs={"Out": [out]},
        attrs={"contextLength": filter_size, "contextStride": filter_stride,
               "contextStart": -(filter_size // 2)},
    )
    out.shape = tuple(input.shape[:-1]) + (num_filters,)
    pre_act = helper.append_bias_op(out, dim_start=len(out.shape) - 1)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type, is_test=False, sequence_length=None):
    helper = LayerHelper("sequence_pool", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    max_index = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(
        type="sequence_pool", inputs=_seq_inputs(input, sequence_length),
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper(), "is_test": is_test},
    )
    if input.shape is not None:
        out.shape = (input.shape[0],) + tuple(input.shape[2:])
    return out


def sequence_first_step(input, sequence_length=None):
    return sequence_pool(input, "first", sequence_length=sequence_length)


def sequence_last_step(input, sequence_length=None):
    return sequence_pool(input, "last", sequence_length=sequence_length)


def sequence_softmax(input, use_cudnn=False, name=None, sequence_length=None):
    helper = LayerHelper("sequence_softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_softmax", inputs=_seq_inputs(input, sequence_length),
        outputs={"Out": [out]},
    )
    out.shape = input.shape
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", **locals())
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sequence_concat", inputs={"X": input},
                     outputs={"Out": [out]})
    if all(v.shape is not None for v in input):
        t = sum(v.shape[1] for v in input)
        out.shape = (input[0].shape[0], t) + tuple(input[0].shape[2:])
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"ref_level": ref_level})
    if x.shape is not None and y.shape is not None:
        out.shape = (x.shape[0], y.shape[1]) + tuple(x.shape[1:])
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand_as", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    out.shape = y.shape
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"new_dim": new_dim})
    if input.shape is not None:
        b, t, d = input.shape
        out.shape = (b, t * d // new_dim if t != -1 else -1, new_dim)
    return out


def sequence_reverse(x, name=None, sequence_length=None):
    helper = LayerHelper("sequence_reverse", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_reverse",
                     inputs=_seq_inputs(x, sequence_length),
                     outputs={"Y": [out]})
    out.shape = x.shape
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    off_val = offset if not isinstance(offset, Variable) else 0
    len_val = length if not isinstance(length, Variable) else input.shape[1]
    helper.append_op(
        type="sequence_slice", inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"offset_val": off_val, "length_val": len_val},
    )
    if input.shape is not None:
        out.shape = (input.shape[0], len_val) + tuple(input.shape[2:])
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None, sequence_length=None):
    helper = LayerHelper("sequence_pad", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int64", True)
    ins = _seq_inputs(x, sequence_length)
    ins["PadValue"] = [pad_value]
    helper.append_op(type="sequence_pad", inputs=ins,
                     outputs={"Out": [out], "Length": [length]})
    out.shape = x.shape
    length.shape = (x.shape[0],) if x.shape else None
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out]})
    out.shape = x.shape
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", **locals())
    out = helper.create_variable_for_type_inference(convert_dtype(dtype))
    attrs = {"out_dtype": convert_dtype(dtype)}
    if maxlen is None:
        raise ValueError(
            "sequence_mask needs a static maxlen (the program's shapes "
            "are static); pass maxlen explicitly")
    attrs["maxlen"] = maxlen if not isinstance(maxlen, Variable) else -1
    if isinstance(maxlen, Variable):
        raise ValueError("maxlen must be a python int for static shapes")
    helper.append_op(type="sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]}, attrs=attrs)
    n = int(np.prod(x.shape)) if x.shape and all(
        d != -1 for d in x.shape) else -1
    out.shape = (n, maxlen)
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_enumerate", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    if input.shape is not None:
        out.shape = tuple(input.shape[:2]) + (win_size,)
    return out


def sequence_erase(input, tokens, name=None):
    helper = LayerHelper("sequence_erase", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_erase", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"tokens": list(tokens)})
    out.shape = input.shape
    return out


def sequence_scatter(input, index, updates, name=None):
    helper = LayerHelper("sequence_scatter", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]})
    out.shape = input.shape
    return out


# -- recurrent layers -------------------------------------------------------


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False):
    """GRU over a padded [B, T, 3*size] pre-projected input (parity:
    layers/nn.py dynamic_gru / gru_op.cc)."""
    helper = LayerHelper("gru", **locals())
    dtype = input.dtype
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    bg = helper.create_variable_for_type_inference(dtype, True)
    brhp = helper.create_variable_for_type_inference(dtype, True)
    bh = helper.create_variable_for_type_inference(dtype, True)
    ins = {"Input": [input], "Weight": [w]}
    if bias is not None:
        ins["Bias"] = [bias]
    if h_0 is not None:
        ins["H0"] = [h_0]
    helper.append_op(
        type="gru", inputs=ins,
        outputs={"Hidden": [hidden], "BatchGate": [bg],
                 "BatchResetHiddenPrev": [brhp], "BatchHidden": [bh]},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "activation": candidate_activation,
               "origin_mode": origin_mode},
    )
    if input.shape is not None:
        hidden.shape = tuple(input.shape[:2]) + (size,)
    return hidden


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """LSTM over padded [B, T, 4*hidden] input (layers/nn.py dynamic_lstm)."""
    helper = LayerHelper("lstm", **locals())
    hidden_size = size // 4
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[hidden_size, 4 * hidden_size],
                                dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[1, 4 * hidden_size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    bg = helper.create_variable_for_type_inference(dtype, True)
    bc = helper.create_variable_for_type_inference(dtype, True)
    ins = {"Input": [input], "Weight": [w], "Bias": [bias]}
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    helper.append_op(
        type="lstm", inputs=ins,
        outputs={"Hidden": [hidden], "Cell": [cell], "BatchGate": [bg],
                 "BatchCellPreAct": [bc]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation},
    )
    if input.shape is not None:
        hidden.shape = tuple(input.shape[:2]) + (hidden_size,)
        cell.shape = hidden.shape
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, **kwargs):
    hidden, cell = dynamic_lstm(input, size, **kwargs)
    from . import nn

    proj = nn.fc(input=hidden, size=proj_size, num_flatten_dims=2,
                 bias_attr=False)
    return proj, cell


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    helper = LayerHelper("gru_unit", **locals())
    dtype = input.dtype
    hidden_size = size // 3
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[hidden_size, 3 * hidden_size],
                                dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[1, 3 * hidden_size], dtype=dtype,
                                   is_bias=True)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden_prev = helper.create_variable_for_type_inference(dtype)
    updated_hidden = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if bias is not None:
        ins["Bias"] = [bias]
    helper.append_op(
        type="gru_unit", inputs=ins,
        outputs={"Hidden": [updated_hidden], "Gate": [gate],
                 "ResetHiddenPrev": [reset_hidden_prev]},
        attrs={"activation": activation, "gate_activation": gate_activation,
               "origin_mode": origin_mode},
    )
    updated_hidden.shape = hidden.shape
    return updated_hidden, reset_hidden_prev, gate


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """cudnn_lstm parity: multi-layer LSTM; composed from dynamic_lstm."""
    from . import nn

    x = input
    last_h, last_c = None, None
    for i in range(num_layers):
        proj = nn.fc(input=x, size=4 * hidden_size, num_flatten_dims=2,
                     bias_attr=False)
        x, c = dynamic_lstm(proj, 4 * hidden_size)
        last_h, last_c = x, c
        if dropout_prob:
            x = nn.dropout(x, dropout_prob)
    return x, last_h, last_c


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    from . import nn

    helper = LayerHelper("lstm_unit", **locals())
    size = cell_t_prev.shape[-1]
    concat = nn.fc(input=[x_t, hidden_t_prev], size=4 * size,
                   param_attr=param_attr, bias_attr=bias_attr)
    cell = helper.create_variable_for_type_inference(x_t.dtype)
    hidden = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(
        type="lstm_unit", inputs={"X": [concat], "C_prev": [cell_t_prev]},
        outputs={"C": [cell], "H": [hidden]},
        attrs={"forget_bias": forget_bias},
    )
    cell.shape = cell_t_prev.shape
    hidden.shape = hidden_t_prev.shape
    return hidden, cell
