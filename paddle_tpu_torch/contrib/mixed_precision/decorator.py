"""Mixed-precision training decorator (parity: the JAX package's
``contrib/mixed_precision/decorator.py``: `decorate` :162,
`OptimizerWithMixedPrecision`, `AutoMixedPrecisionLists`).

The low-precision compute dtype is bfloat16, chosen per op by a white
list (`__amp_bf16__` marks the op; its kernel casts fp32 operands to
bf16) and a black list (kept in fp32); ``use_bf16=False`` marks nothing,
so every op computes in its inputs' dtype (an fp16-built model in fp16).
The loss is scaled by a persistable `loss_scaling` var. By default the
scale is dynamic: ``check_finite_and_unscale`` zeroes every grad of a
step that overflowed, and ``update_loss_scaling`` grows the scale after
`incr_every_n_steps` finite steps and shrinks it after
`decr_every_n_nan_or_inf` overflows, on the device. A static scale of 1
skips both, as in the JAX package.
"""

from ... import framework, unique_name
from ...framework import default_startup_program
from ...initializer import Constant

__all__ = ["decorate", "OptimizerWithMixedPrecision",
           "AutoMixedPrecisionLists"]


class AutoMixedPrecisionLists:
    """White list runs in bf16, black list stays fp32."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = {"matmul", "mul", "conv2d", "conv3d",
                           "depthwise_conv2d", "flash_attention",
                           "fused_multihead_attention"} \
            | set(custom_white_list or ())
        self.black_list = {"softmax", "softmax_with_cross_entropy",
                           "cross_entropy", "cross_entropy2", "mean",
                           "layer_norm", "batch_norm", "exp", "log",
                           "sum"} | set(custom_black_list or ())
        self.white_list -= self.black_list


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                 use_bf16=True):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._use_bf16 = use_bf16
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def _create_state(self, prog, startup):
        def mk(name, value, dtype="float32"):
            v = prog.global_block().create_var(
                name=name, shape=(1,), dtype=dtype, persistable=True)
            sb = startup.global_block()
            if not sb.has_var(name):
                sv = sb.create_var(name=name, shape=(1,), dtype=dtype,
                                   persistable=True)
                Constant(value)(sv, sb)
            return v

        # unique per decorated optimizer: two AMP optimizers in one
        # program never share scaling state
        self._loss_scaling = mk(unique_name.generate("loss_scaling"),
                                self._init_loss_scaling)
        self._good_steps = mk(unique_name.generate("good_steps"), 0.0,
                              "int32")
        self._bad_steps = mk(unique_name.generate("bad_steps"), 0.0,
                             "int32")

    def _rewrite_bf16(self, prog):
        """Mark the white-list ops to run in bf16."""
        if not self._use_bf16:
            return
        for block in prog.blocks:
            for op in block.ops:
                if op.type in self._amp_lists.white_list:
                    op.attrs["__amp_bf16__"] = True
        prog._bump_version()

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        prog = loss.block.program
        startup = startup_program or default_startup_program()
        self._create_state(prog, startup)
        self._rewrite_bf16(prog)
        with framework.program_guard(prog, startup):
            from ...layers import nn as nn_layers

            scaled_loss = nn_layers.elementwise_mul(loss,
                                                    self._loss_scaling)
        self._scaled_loss = scaled_loss
        return self._optimizer.backward(scaled_loss, startup_program,
                                        parameter_list, no_grad_set,
                                        callbacks)

    def apply_gradients(self, params_grads):
        if not self._use_dynamic and self._init_loss_scaling == 1.0:
            # a static scale of 1: unscaling is the identity
            return self._optimizer.apply_gradients(params_grads)
        block = params_grads[0][0].block.program.global_block()
        grads = [g for _, g in params_grads]
        found_inf = block.create_var(
            name=unique_name.generate("find_infinite_scale"),
            dtype="bool", shape=(1,))
        unscaled = [block.create_var(name=g.name + "@UNSCALED",
                                     dtype=g.dtype, shape=g.shape)
                    for g in grads]
        block.append_op(
            type="check_finite_and_unscale",
            inputs={"X": grads, "Scale": [self._loss_scaling]},
            outputs={"Out": unscaled, "FoundInfinite": [found_inf]})
        if self._use_dynamic:
            block.append_op(
                type="update_loss_scaling",
                inputs={"PrevLossScaling": [self._loss_scaling],
                        "InGoodSteps": [self._good_steps],
                        "InBadSteps": [self._bad_steps],
                        "FoundInfinite": [found_inf]},
                outputs={"LossScaling": [self._loss_scaling],
                         "OutGoodSteps": [self._good_steps],
                         "OutBadSteps": [self._bad_steps]},
                attrs={"incr_every_n_steps": self._incr_every_n_steps,
                       "decr_every_n_nan_or_inf":
                           self._decr_every_n_nan_or_inf,
                       "incr_ratio": self._incr_ratio,
                       "decr_ratio": self._decr_ratio})
        new_pg = [(p, ug) for (p, _), ug in zip(params_grads, unscaled)]
        return self._optimizer.apply_gradients(new_pg)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=2 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, use_bf16=True):
    """Wrap `optimizer` for mixed precision: bf16 compute on the white
    list (none with use_bf16=False) and a loss scale, dynamic by
    default. The JAX package's signature and defaults."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        use_bf16=use_bf16)
