"""Weight-decay regularizers (parity: the JAX package's ``regularizer.py``:
L1Decay, L2Decay and `append_regularization_ops`; a parameter's own
`regularizer` wins over the optimizer's)."""

from .layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """decay = coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = LayerHelper("l2_decay").create_variable_for_type_inference(
            param.dtype)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        decay.shape = param.shape
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    """decay = coeff * sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        sign.shape = param.shape
        decay = helper.create_variable_for_type_inference(param.dtype)
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        decay.shape = param.shape
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """[(param, grad + decay)] for every param with a regularizer."""
    helper = LayerHelper("regularization")
    out = []
    for param, grad in parameters_and_grads:
        regular = getattr(param, "regularizer", None) or regularization
        if grad is None or regular is None:
            out.append((param, grad))
            continue
        block = grad.block
        decay = regular(param, grad, block)
        new_grad = helper.create_variable_for_type_inference(grad.dtype)
        block.append_op(type="elementwise_add",
                        inputs={"X": [grad], "Y": [decay]},
                        outputs={"Out": [new_grad]})
        new_grad.shape = grad.shape
        out.append((param, new_grad))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
