"""Optimizers (parity: the JAX package's ``optimizer.py``: the base
`Optimizer` with `minimize` :156, and `SGDOptimizer` :272). Each
optimizer appends per-parameter update ops to the main program; the
learning rate is a persistable var filled by the startup program.

Not ported: the other optimizers, gradient clipping, regularization and
the dygraph paths.
"""

from . import framework, unique_name
from .backward import append_backward
from .framework import default_main_program, default_startup_program
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ["Optimizer", "SGD", "SGDOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        if regularization is not None:
            raise NotImplementedError(
                "regularization is not ported to the PyTorch port yet")
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map = {}

    def _create_global_learning_rate(self, prog):
        if self._learning_rate_map.get(prog) is not None:
            return
        lr_name = unique_name.generate("learning_rate")
        lr_var = prog.global_block().create_var(
            name=lr_name, shape=(1,), dtype="float32", persistable=True,
            stop_gradient=True)
        sb = default_startup_program().global_block()
        sv = sb.create_var(name=lr_name, shape=(1,), dtype="float32",
                           persistable=True)
        Constant(float(self._learning_rate))(sv, sb)
        self._learning_rate_map[prog] = lr_var

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        base = self._learning_rate_map[param.block.program]
        mult = (param.optimize_attr or {}).get("learning_rate", 1.0)
        if mult == 1.0:
            return base
        helper = LayerHelper("param_lr")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="scale", inputs={"X": [base]},
                         outputs={"Out": [out]},
                         attrs={"scale": float(mult)})
        out.shape = (1,)
        return out

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        # the ops land in the program that owns the params
        prog = (params_grads[0][0].block.program if params_grads
                else default_main_program())
        block = prog.global_block()
        with framework.program_guard(prog):
            self._create_global_learning_rate(prog)
            for p, _ in params_grads:
                if p.regularizer is not None or p.gradient_clip_attr:
                    raise NotImplementedError(
                        "parameter %r asks for regularization or gradient "
                        "clipping, which the PyTorch port does not have "
                        "yet" % p.name)
            start = len(block.ops)
            for pg in params_grads:
                self._append_optimize_op(block, pg)
            return list(block.ops[start:])

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p]})


SGD = SGDOptimizer
