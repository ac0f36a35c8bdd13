"""Optimizers (parity: the JAX package's ``optimizer.py``: the base
`Optimizer` :29 with its accumulators :82-108 and `apply_gradients`
:131, and the family :272-643). Each optimizer appends per-parameter
update ops to the main program: first the gradient clip
(``clip.append_gradient_clip_ops``), then the weight decay
(``regularizer.append_regularization_ops``), then the updates. The
learning rate is a persistable var filled by the startup program, or a
Variable the caller passes (a schedule of
``layers.learning_rate_scheduler``). Accumulators are persistable vars
with the JAX package's names, shapes, dtypes and fills.

`ModelAverage` (:644), `ExponentialMovingAverage` (:734) and
`GradientMergeOptimizer` (:807) wrap the family: the first two append
their accumulating ops to the train program and swap averaged values
into a scope with `apply` / `restore`; the last accumulates the grads in
persistables and runs the inner optimizer's update under a `cond` every
k-th run. Not ported: DGCMomentum and the dygraph paths.
"""

from . import framework, unique_name
from .backward import append_backward
from .framework import Variable, default_main_program, default_startup_program
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
    "Adadelta", "RMSProp", "Ftrl", "Lamb", "LarsMomentum",
    "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer", "AdamOptimizer",
    "AdamaxOptimizer", "DecayedAdagradOptimizer", "AdadeltaOptimizer",
    "RMSPropOptimizer", "FtrlOptimizer", "LambOptimizer",
    "LarsMomentumOptimizer", "ModelAverage", "ExponentialMovingAverage",
    "GradientMergeOptimizer",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = {}  # {acc name: {param name: var}}
        self.helper = None

    # -- learning rate -------------------------------------------------------
    def _create_global_learning_rate(self, prog):
        if self._learning_rate_map.get(prog) is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[prog] = self._learning_rate
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

    def _global_learning_rate(self, program=None):
        return self._learning_rate_map.get(program or default_main_program())

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        base = self._global_learning_rate(param.block.program)
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

    # -- accumulators --------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        accs = self._accumulators.setdefault(name, {})
        if param.name in accs:
            return accs[param.name]
        acc_name = unique_name.generate("%s_%s" % (param.name, name))
        shape = tuple(shape if shape is not None else param.shape)
        dtype = dtype or "float32"
        acc = default_main_program().global_block().create_var(
            name=acc_name, shape=shape, dtype=dtype, persistable=True,
            stop_gradient=True)
        sb = default_startup_program().global_block()
        sv = sb.create_var(name=acc_name, shape=shape, dtype=dtype,
                           persistable=True)
        Constant(float(fill_value))(sv, sb)
        accs[param.name] = acc
        return acc

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- hooks ---------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    # -- API -----------------------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        from .clip import append_gradient_clip_ops
        from .regularizer import append_regularization_ops

        # the ops land in the program that owns the params
        prog = (params_grads[0][0].block.program if params_grads
                else default_main_program())
        block = prog.global_block()
        self.helper = LayerHelper(self.__class__.__name__)
        with framework.program_guard(prog):
            self._create_global_learning_rate(prog)
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
            self._create_accumulators(block, [p for p, _ in params_grads])
            start = len(block.ops)
            for pg in params_grads:
                self._append_optimize_op(block, pg)
            self._finish_update(block, params_grads)
            return list(block.ops[start:])

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def get_opti_var_name_list(self):
        """The optimizer's vars: accumulators, then the learning rates."""
        names = [v.name for accs in self._accumulators.values()
                 for v in accs.values()]
        names.extend(v.name for v in self._learning_rate_map.values())
        return names

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_optimize(loss, startup_program,
                                           params_grads)
        return optimize_ops, params_grads

    def _update_op(self, block, param_and_grad, inputs, outputs, attrs=None):
        """Append `self.type`'s op: Param, Grad, LearningRate and the
        accumulators named by slot (`inputs`: slot -> accumulator name;
        `outputs`: out slot -> accumulator name, ParamOut added)."""
        p, g = param_and_grad
        ins = {"Param": [p], "Grad": [g]}
        ins.update({s: [self._get_accumulator(a, p)]
                    for s, a in inputs.items()})
        if self._uses_lr:
            ins["LearningRate"] = [self._create_param_lr(param_and_grad)]
        outs = {"ParamOut": [p]}
        outs.update({s: [self._get_accumulator(a, p)]
                     for s, a in outputs.items()})
        return block.append_op(type=self.type, inputs=ins, outputs=outs,
                               attrs=attrs or {})

    _uses_lr = True


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return self._update_op(block, param_and_grad, {}, {})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        return self._update_op(
            block, param_and_grad, {"Velocity": "velocity"},
            {"VelocityOut": "velocity"},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov})


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        return self._update_op(
            block, param_and_grad, {"Velocity": "velocity"},
            {"VelocityOut": "velocity"},
            {"mu": self._momentum, "lars_coeff": self._lars_coeff,
             "lars_weight_decay": self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, regularization, name)
        self.type = "adagrad"
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        return self._update_op(block, param_and_grad, {"Moment": "moment"},
                               {"MomentOut": "moment"},
                               {"epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False):
        super().__init__(learning_rate, regularization, name)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    _SLOTS = ({"Moment1": "moment1", "Moment2": "moment2",
               "Beta1Pow": "beta1_pow_acc", "Beta2Pow": "beta2_pow_acc"},
              {"Moment1Out": "moment1", "Moment2Out": "moment2",
               "Beta1PowOut": "beta1_pow_acc",
               "Beta2PowOut": "beta2_pow_acc"})

    def _append_optimize_op(self, block, param_and_grad):
        return self._update_op(block, param_and_grad, *self._SLOTS,
                               {"beta1": self._beta1, "beta2": self._beta2,
                                "epsilon": self._epsilon})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        return self._update_op(
            block, param_and_grad,
            {"Moment": "moment", "InfNorm": "inf_norm",
             "Beta1Pow": "beta1_pow_acc"},
            {"MomentOut": "moment", "InfNormOut": "inf_norm"},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})

    def _finish_update(self, block, parameters_and_grads):
        # the op reads beta1^t; one scale op a parameter advances it
        for p, _ in parameters_and_grads:
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op(type="scale", inputs={"X": [b1p]},
                            outputs={"Out": [b1p]},
                            attrs={"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "decayed_adagrad"
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        return self._update_op(block, param_and_grad, {"Moment": "moment"},
                               {"MomentOut": "moment"},
                               {"decay": self._decay,
                                "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    _uses_lr = False   # the JAX op takes no learning rate

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "adadelta"
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("_avg_squared_grad", p)
            self._add_accumulator("_avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        return self._update_op(
            block, param_and_grad,
            {"AvgSquaredGrad": "_avg_squared_grad",
             "AvgSquaredUpdate": "_avg_squared_update"},
            {"AvgSquaredGradOut": "_avg_squared_grad",
             "AvgSquaredUpdateOut": "_avg_squared_update"},
            {"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "rmsprop"
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        return self._update_op(
            block, param_and_grad,
            {"Moment": "momentum", "MeanSquare": "mean_square",
             "MeanGrad": "mean_grad"},
            {"MomentOut": "momentum", "MeanSquareOut": "mean_square",
             "MeanGradOut": "mean_grad"},
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        return self._update_op(
            block, param_and_grad,
            {"SquaredAccumulator": "squared", "LinearAccumulator": "linear"},
            {"SquaredAccumOut": "squared", "LinearAccumOut": "linear"},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


class LambOptimizer(AdamOptimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, regularization=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         regularization, name)
        self.type = "lamb"
        self._weight_decay = lamb_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        return self._update_op(block, param_and_grad, *self._SLOTS,
                               {"beta1": self._beta1, "beta2": self._beta2,
                                "epsilon": self._epsilon,
                                "weight_decay": self._weight_decay})


def _scope(scope):
    from .core.scope import global_scope

    return scope if scope is not None else global_scope()


class ModelAverage(Optimizer):
    """Parameter averaging over a sliding window: one
    `average_accumulates` op a trainable parameter, appended to the
    current main program when constructed (after minimize). `apply`
    swaps (sum_1 + sum_2 + sum_3) / (num_accumulates +
    old_num_accumulates) into each parameter of the scope (the global
    scope by default), `restore` swaps the parameters back."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization, name)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        block = default_main_program().global_block()
        self.params_grads = [(p, None) for p in block.all_parameters()
                             if p.trainable]
        self.helper = LayerHelper("model_average")
        self._create_accumulators(block, [p for p, _ in self.params_grads])
        for pg in self.params_grads:
            self._append_optimize_op(block, pg)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            for acc in ("sum_1", "sum_2", "sum_3"):
                self._add_accumulator(acc, p)
            for acc in ("num_accumulates", "old_num_accumulates",
                        "num_updates"):
                self._add_accumulator(acc, p, dtype="int64", fill_value=0,
                                      shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, _ = param_and_grad
        accs = ("sum_1", "sum_2", "sum_3", "num_accumulates",
                "old_num_accumulates", "num_updates")
        ins = {"param": [p]}
        ins.update({"in_" + a: [self._get_accumulator(a, p)] for a in accs})
        block.append_op(
            type="average_accumulates", inputs=ins,
            outputs={"out_" + a: [self._get_accumulator(a, p)]
                     for a in accs},
            attrs={"average_window": self.average_window,
                   "min_average_window": self.min_average_window,
                   "max_average_window": self.max_average_window})

    def _param_backup_name(self, p):
        return p.name + "@MODEL_AVG_BACKUP"

    def apply(self, executor=None, need_restore=True, scope=None):
        scope = _scope(scope)
        for p, _ in self.params_grads:
            def acc(name):
                return scope.get(self._get_accumulator(name, p).name)

            total = max(int(acc("num_accumulates").reshape(()))
                        + int(acc("old_num_accumulates").reshape(())), 1)
            param = scope.get(p.name)
            if need_restore:
                scope.set(self._param_backup_name(p), param.clone())
            avg = (acc("sum_1") + acc("sum_2") + acc("sum_3")) / total
            scope.set(p.name, avg.to(param.dtype))

    def restore(self, executor=None, scope=None):
        scope = _scope(scope)
        for p, _ in self.params_grads:
            backup = scope.get(self._param_backup_name(p))
            if backup is not None:
                scope.set(p.name, backup)


class ExponentialMovingAverage:
    """An EMA shadow of each trainable parameter, a persistable
    ``<param>.ema`` filled with 0 by the startup program; `update()`
    appends shadow = decay * shadow + (1 - decay) * param to the train
    program (three ops a parameter); `apply` swaps the shadows into the
    scope's parameters (returning a guard that restores them on exit),
    `restore` swaps the parameters back."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or ""
        self._shadows = {}
        self._helper = LayerHelper("ema")
        block = default_main_program().global_block()
        sb = default_startup_program().global_block()
        for p in block.all_parameters():
            if p.trainable:
                shadow_name = p.name + ".ema"
                shadow = block.create_var(name=shadow_name, shape=p.shape,
                                          dtype=p.dtype, persistable=True,
                                          stop_gradient=True)
                sv = sb.create_var(name=shadow_name, shape=p.shape,
                                   dtype=p.dtype, persistable=True)
                Constant(0.0)(sv, sb)
                self._shadows[p.name] = shadow

    def update(self):
        block = default_main_program().global_block()
        for pname, shadow in self._shadows.items():
            p = block.var(pname)
            tmp = self._helper.create_variable_for_type_inference(p.dtype)
            block.append_op(type="scale", inputs={"X": [shadow]},
                            outputs={"Out": [tmp]},
                            attrs={"scale": self._decay})
            tmp2 = self._helper.create_variable_for_type_inference(p.dtype)
            block.append_op(type="scale", inputs={"X": [p]},
                            outputs={"Out": [tmp2]},
                            attrs={"scale": 1.0 - self._decay})
            block.append_op(type="elementwise_add",
                            inputs={"X": [tmp], "Y": [tmp2]},
                            outputs={"Out": [shadow]})

    def apply(self, executor=None, need_restore=True, scope=None):
        scope = self._scope = _scope(scope)
        self._backups = {}
        for pname, shadow in self._shadows.items():
            if need_restore:
                self._backups[pname] = scope.get(pname).clone()
            sval = scope.get(shadow.name)
            if sval is not None:
                scope.set(pname, sval.clone())
        return _EMAGuard(self)

    def restore(self, executor=None):
        scope = getattr(self, "_scope", None) or _scope(None)
        for pname, val in getattr(self, "_backups", {}).items():
            scope.set(pname, val)


class _EMAGuard:
    def __init__(self, ema):
        self._ema = ema

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self._ema.restore()


class GradientMergeOptimizer:
    """Gradient accumulation over k runs: each run adds its grads into
    persistable fp32 buffers, and every k-th run (the `@gradient_merge_
    step@` counter divisible by k) a `cond` op runs the inner optimizer's
    update on the buffers (their mean with `avg`) and zeroes them. The
    cond op lists the parameters and the buffers as its outputs; as in
    the JAX package, the inner optimizer's own accumulators (Adam's
    moments and beta powers) are not among them, so their writes stay in
    the branch."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers import control_flow, learning_rate_scheduler, nn, tensor

        params_grads = self.inner.backward(loss, startup_program,
                                           parameter_list, no_grad_set)
        if self.k_steps <= 1:
            return self.inner.apply_gradients(params_grads), params_grads

        prog = params_grads[0][0].block.program
        block = prog.global_block()
        with framework.program_guard(prog):
            self.inner.helper = LayerHelper("gradient_merge")
            self.inner._create_global_learning_rate(prog)
            self.inner._create_accumulators(block,
                                            [p for p, _ in params_grads])
            merged = []
            sb = default_startup_program().global_block()
            for p, g in params_grads:
                acc = block.create_var(
                    name=unique_name.generate(p.name + "_grad_merge"),
                    shape=p.shape, dtype="float32", persistable=True,
                    stop_gradient=True)
                sv = sb.create_var(name=acc.name, shape=p.shape,
                                   dtype="float32", persistable=True)
                Constant(0.0)(sv, sb)
                block.append_op(type="elementwise_add",
                                inputs={"X": [acc], "Y": [g]},
                                outputs={"Out": [acc]}, attrs={"axis": -1})
                merged.append((p, acc))

            counter = learning_rate_scheduler.autoincreased_step_counter(
                counter_name="@gradient_merge_step@")
            kvar = tensor.fill_constant([1], "int64", self.k_steps)
            zero = tensor.fill_constant([1], "int64", 0)
            pred = nn.equal(nn.elementwise_mod(counter, kvar), zero)

            with control_flow._sub_block() as update_blk:
                for p, acc in merged:
                    g_eff = nn.scale(
                        acc, scale=1.0 / self.k_steps) if self.avg else acc
                    self.inner._append_optimize_op(update_blk, (p, g_eff))
                    # the buffer starts over after the update
                    zg = tensor.fill_constant(p.shape, "float32", 0.0)
                    update_blk.append_op(type="assign", inputs={"X": [zg]},
                                         outputs={"Out": [acc]})
                if merged:
                    self.inner._finish_update(update_blk, merged)
            control_flow._append_cond_op(
                block, pred, update_blk, None,
                [p.name for p, _ in merged] + [a.name for _, a in merged])
        return [], params_grads


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
