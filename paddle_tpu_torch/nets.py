"""Composite layers (parity: the JAX package's ``nets.py``): the fused
self-attention sublayer of the Fluid-API Transformer LM,
`scaled_dot_product_attention` :74-131, and the image classifiers'
`simple_img_conv_pool` :12 and `img_conv_group` :28."""

import copy

import numpy as np

from . import layers
from .layer_helper import LayerHelper
from .param_attr import ParamAttr

__all__ = ["fused_multihead_attention", "scaled_dot_product_attention",
           "simple_img_conv_pool", "img_conv_group"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    """A conv2d, then a pool2d."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """A stack of conv2d (each optionally followed by batch_norm and
    dropout), then a pool2d; per-conv arguments are a value or a list."""
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("img_conv_group: conv_num_filter must be a list "
                        "of filter counts, one a conv2d")
    tmp = input

    def _expand(v):
        return v if isinstance(v, (list, tuple)) else [v] * len(conv_num_filter)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0, causal=False):
    """Multi-head scaled dot-product attention over [B, T, D] inputs.
    Without dropout: one `flash_attention` op (the kernel K1) reading the
    heads of [B, T, H, Dh] views ("bthd"). With dropout: the explicit
    score tensor (scale, matmul, an additive causal mask, softmax,
    dropout on the weights, matmul), as in the JAX package."""
    if queries.shape[-1] % num_heads != 0:
        raise ValueError("num_heads must divide the hidden size")
    d = queries.shape[-1]
    dk = d // num_heads

    def _split4(x):
        return layers.reshape(x, shape=[0, 0, num_heads,
                                        x.shape[-1] // num_heads])

    if not dropout_rate:
        q, k, v = _split4(queries), _split4(keys), _split4(values)
        helper = LayerHelper("flash_attention")
        ctx = helper.create_variable_for_type_inference(queries.dtype)
        helper.append_op(type="flash_attention",
                         inputs={"Q": [q], "K": [k], "V": [v]},
                         outputs={"Out": [ctx]},
                         attrs={"causal": bool(causal),
                                "sm_scale": dk ** -0.5, "layout": "bthd"})
        ctx.shape = q.shape
        return layers.reshape(ctx, shape=[0, 0, d])

    def _split_heads(x):
        return layers.transpose(_split4(x), perm=[0, 2, 1, 3])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    product = layers.matmul(layers.scale(q, scale=dk ** -0.5), k,
                            transpose_y=True)
    if causal:
        t = product.shape[-1]
        mask = layers.assign(np.triu(np.full((t, t), -1e9, "float32"), k=1))
        product = layers.elementwise_add(product, mask)
    weights = layers.dropout(layers.softmax(product),
                             dropout_prob=dropout_rate)
    ctx = layers.transpose(layers.matmul(weights, v), perm=[0, 2, 1, 3])
    return layers.reshape(ctx, shape=[0, 0, d])


def fused_multihead_attention(input, num_heads, causal=False,
                              param_attr=None, bias_attr=None,
                              out_param_attr=None, out_bias_attr=None,
                              name=None):
    """The whole self-attention sublayer (q/k/v/out projections and flash
    attention) as ONE graph op. Per-head projection weights [D, H, Dh]
    keep heads as real dimensions, so q/k/v come out as [B, T, H, Dh] and
    the attention kernel reads them through strides.

    input [B, T, D] -> [B, T, D]."""
    d = input.shape[-1]
    if d % num_heads:
        raise ValueError("num_heads %d must divide the hidden size %d"
                         % (num_heads, d))
    dh = d // num_heads
    helper = LayerHelper("fused_multihead_attention", **locals())
    base = name or helper.name

    def _p(suffix, shape, template, shard_spec, is_bias=False):
        """A user-given name becomes a prefix: the four weights cannot
        share one name."""
        if template is False:
            if not is_bias:
                raise ValueError(
                    "fused_multihead_attention projection weights cannot "
                    "be disabled (param_attr/out_param_attr=False); use "
                    "bias_attr/out_bias_attr=False to drop the biases")
            return None
        attr = copy.deepcopy(ParamAttr._to_attr(template))
        attr.name = ("%s_%s" % (attr.name, suffix) if attr.name
                     else "%s_%s" % (base, suffix))
        if attr.shard_spec is None:
            attr.shard_spec = shard_spec
        return helper.create_parameter(attr=attr, shape=shape,
                                       dtype=input.dtype, is_bias=is_bias)

    inputs = {"X": [input]}
    for nm in ("q", "k", "v"):
        inputs["W" + nm.upper()] = [_p("w" + nm, [d, num_heads, dh],
                                       param_attr, (None, "tp", None))]
        b = _p("b" + nm, [num_heads, dh], bias_attr, ("tp", None),
               is_bias=True)
        if b is not None:
            inputs["B" + nm.upper()] = [b]
    inputs["WO"] = [_p("wo", [num_heads, dh, d], out_param_attr,
                       ("tp", None, None))]
    bo = _p("bo", [d], out_bias_attr, (None,), is_bias=True)
    if bo is not None:
        inputs["BO"] = [bo]

    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="fused_multihead_attention", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"causal": bool(causal), "sm_scale": dh ** -0.5})
    out.shape = input.shape
    return out
