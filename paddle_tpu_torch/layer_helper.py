"""LayerHelper (parity: python/paddle/fluid/layer_helper.py:42) — the
funnel through which every layer creates parameters (with their init ops
in the startup program) and appends ops to the current main-program
block."""

from . import framework, unique_name
from .framework import Variable, default_main_program, default_startup_program
from .initializer import Constant, Xavier
from .param_attr import ParamAttr

_op_seed_counter = [1000]


def next_op_seed():
    _op_seed_counter[0] += 1
    return _op_seed_counter[0]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = unique_name.generate(layer_type) if name is None else name

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    # -- params -------------------------------------------------------------
    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        attr = self.kwargs.get("bias_attr")
        if attr is False:
            return None
        return ParamAttr._to_attr(attr)

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr] + [
                ParamAttr(**{k: getattr(attr, k) for k in (
                    "initializer", "learning_rate", "regularizer",
                    "trainable", "gradient_clip", "do_model_average")})
                for _ in range(length - 1)
            ]
        if len(attr) != length:
            raise ValueError("param_attr length mismatch")
        return attr

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        suffix = "b" if is_bias else "w"
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, suffix]))
        init = attr.initializer or default_initializer
        if init is None:
            init = Constant(0.0) if is_bias else Xavier()
        startup_gb = self.startup_program.global_block()
        main_gb = self.main_program.global_block()
        if main_gb.has_var(attr.name):
            return main_gb.var(attr.name)
        param = main_gb.create_parameter(shape=shape, dtype=dtype,
                                         **attr._to_kwargs())
        # the parameter lives in the main program; its init op in startup
        sp = framework.Parameter(startup_gb, shape=shape, dtype=dtype,
                                 name=attr.name, trainable=attr.trainable)
        startup_gb.vars[sp.name] = sp
        init(sp, startup_gb)
        return param

    # -- vars ---------------------------------------------------------------
    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_global_variable(self, persistable=False, **kwargs):
        """A var of the main program's global block (a persistable one
        for state that a run carries to the next, such as AUC's
        histogram)."""
        name = kwargs.pop("name", None) or unique_name.generate(
            ".".join([self.name, "tmp"]))
        return self.main_program.global_block().create_var(
            name=name, persistable=persistable, **kwargs)

    def set_variable_initializer(self, var, initializer):
        """`var`'s init op, `initializer`, in the startup program."""
        sgb = self.startup_program.global_block()
        sv = sgb.var(var.name) if sgb.has_var(var.name) else sgb.create_var(
            name=var.name, shape=var.shape, dtype=var.dtype,
            persistable=True)
        initializer(sv, sgb)
        return var

    # -- ops ----------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        from .ops import registry as _reg

        attrs = dict(attrs or {})
        if _reg.has(type) and _reg.get(type).stateful:
            attrs.setdefault("__op_seed__", next_op_seed())
        return self.block.append_op(type=type, inputs=inputs,
                                    outputs=outputs, attrs=attrs)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [tmp]}, attrs={"axis": dim_start})
        tmp.shape = input_var.shape
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        tmp.shape = input_var.shape
        return tmp

    def input_dtype(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name)
        if isinstance(inputs, Variable):
            return inputs.dtype
        return inputs[0].dtype
