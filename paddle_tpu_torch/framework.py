"""Program IR: Program / Block / Operator / Variable / Parameter.

Parity target: the JAX package's ``framework.py`` (itself after Fluid's
framework.py: Program :2704, Block :1369, Operator :924, Variable :366,
Parameter :3476). Ops carry named input/output slots and attrs exactly
like Fluid's OpDesc, so ``fluid.layers``, ``append_backward`` and the
optimizers build the same programs as the JAX package. The executor
(``executor.py``) runs a block op by op in eager PyTorch
(``core/lowering.py``); gradients come from each op's own autograd graph.
"""

import contextlib
import copy

import numpy as np
import torch

from . import unique_name

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter",
    "default_startup_program", "default_main_program", "program_guard",
    "grad_var_name", "convert_dtype", "torch_dtype",
]

GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(var_name):
    return var_name + GRAD_VAR_SUFFIX


# ---------------------------------------------------------------------------
# dtypes: canonical string names ("float32", "bfloat16", ...) in the IR,
# mapped to torch dtypes where tensors are made
# ---------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float16": "float16", "fp16": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "float32": "float32", "fp32": "float32",
    "float64": "float64", "fp64": "float64",
    "int8": "int8", "uint8": "uint8", "int16": "int16", "int32": "int32",
    "int64": "int64", "bool": "bool",
}

_TORCH_DTYPES = {
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_TORCH_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def convert_dtype(dtype):
    """Normalize a dtype (string alias, numpy dtype, torch dtype) to its
    canonical string name."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        if dtype in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[dtype]
        return np.dtype(dtype).name
    if isinstance(dtype, torch.dtype):
        return _TORCH_NAMES[dtype]
    name = np.dtype(dtype).name  # ml_dtypes' bfloat16 names itself too
    return _DTYPE_ALIASES.get(name, name)


def torch_dtype(dtype):
    """The torch dtype of a canonical (or alias) dtype name."""
    return _TORCH_DTYPES[convert_dtype(dtype)]


# ---------------------------------------------------------------------------
# Variable / Parameter
# ---------------------------------------------------------------------------


class Variable:
    """A named symbolic value in a Block. `shape` may hold -1 for a
    dimension bound at run time from the feed (the batch)."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 is_data=False, type=None):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type or "LOD_TENSOR"

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, self.dtype,
            ", persistable" if self.persistable else "")

    __str__ = __repr__


class Parameter(Variable):
    """A persistable, trainable Variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        self.shard_spec = kwargs.pop("shard_spec", None)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


# ---------------------------------------------------------------------------
# Operator / Block / Program
# ---------------------------------------------------------------------------


def _as_var_list(v):
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]


class Operator:
    """One op: inputs/outputs map slot name -> list of Variable; attrs is
    a plain dict (grad ops also hold their forward Operator)."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: _as_var_list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: _as_var_list(v)
                        for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input_names(self, slot=None):
        if slot is not None:
            return [v.name for v in self.inputs.get(slot, [])]
        return [v.name for vs in self.inputs.values() for v in vs]

    def output_names(self, slot=None):
        if slot is not None:
            return [v.name for v in self.outputs.get(slot, [])]
        return [v.name for vs in self.outputs.values() for v in vs]

    def __repr__(self):
        return "Operator(type=%s, inputs=%s, outputs=%s)" % (
            self.type,
            {k: [v.name for v in vs] for k, vs in self.inputs.items()},
            {k: [v.name for v in vs] for k, vs in self.outputs.items()})


class Block:
    """An ordered op list and a var map. The port's programs have one
    block: control-flow sub-blocks are not ported."""

    def __init__(self, program, idx):
        self.program = program
        self.idx = idx
        self.vars = {}
        self.ops = []

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("Variable %r not found in block %d"
                             % (name, self.idx))
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        return self.vars.get(name)

    def create_var(self, *args, **kwargs):
        v = Variable(self, *args, **kwargs)
        self.vars[v.name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, *args, **kwargs):
        p = Parameter(self, *args, **kwargs)
        gb = self.program.global_block()  # parameters live in block 0
        gb.vars[p.name] = p
        p.block = gb
        self.program._bump_version()
        return p

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        return op


class Program:
    """A whole computation: a list of Blocks, block 0 global."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0  # bumped on every mutation; keys the step cache
        self.random_seed = 0
        self.param_grad_map = {}  # filled by append_backward
        self._appending_grad_times = 0

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _bump_version(self):
        self._version += 1

    @property
    def version(self):
        return self._version

    def all_parameters(self):
        return self.global_block().all_parameters()

    @staticmethod
    def _is_train_only_op(op):
        """Backward and optimizer ops, pruned by clone(for_test=True)."""
        if "__fwd_op__" in op.attrs or op.type.endswith("_grad"):
            return True
        if op.type in _OPTIMIZER_OP_TYPES or op.type in _AMP_STATE_OP_TYPES:
            return True
        if op.attrs.get("__amp_state__"):
            return True
        # the loss-grad seed: a fill op writing only @GRAD outputs
        outs = op.output_names()
        return bool(outs) and all(n.endswith(GRAD_VAR_SUFFIX) for n in outs)

    def clone(self, for_test=False):
        """Copy the program. With for_test=True, switch train-only op
        behavior to inference mode and prune the backward and optimizer
        ops. A quantization decoration (``quant.decorate``) travels with
        the copy."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = [Block(p, blk.idx) for blk in self.blocks]
        for blk, nb in zip(self.blocks, p.blocks):
            for name, v in blk.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                if isinstance(v, Parameter):
                    nv.optimize_attr = dict(v.optimize_attr)
                nb.vars[name] = nv
        op_map = {}  # id(original op) -> cloned op
        for blk, nb in zip(self.blocks, p.blocks):
            for op in blk.ops:
                if for_test and self._is_train_only_op(op):
                    continue
                attrs = dict(op.attrs)
                if for_test and "is_test" in _TEST_MODE_OPS.get(op.type, ()):
                    attrs["is_test"] = True
                op_map[id(op)] = nb.append_op(
                    op.type,
                    inputs={k: [nb.var(v.name) for v in vs]
                            for k, vs in op.inputs.items()},
                    outputs={k: [nb.var(v.name) for v in vs]
                             for k, vs in op.outputs.items()},
                    attrs=attrs)
        # grad ops hold their forward op: point them at the cloned one
        for nb in p.blocks:
            for op in nb.ops:
                for k, v in op.attrs.items():
                    if isinstance(v, Operator) and id(v) in op_map:
                        op.attrs[k] = op_map[id(v)]
        p.param_grad_map = dict(self.param_grad_map)
        if getattr(self, "_quant_config", None) is not None:
            p._quant_config = self._quant_config
        return p

    def __repr__(self):
        lines = []
        for blk in self.blocks:
            lines.append("-- block %d --" % blk.idx)
            lines.extend("  " + repr(op) for op in blk.ops)
        return "\n".join(lines)


# ops whose attrs hold an `is_test` switch that clone(for_test=True) sets
_TEST_MODE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
    "layer_norm": (),
}

# parameter-update op types
_OPTIMIZER_OP_TYPES = frozenset([
    "sgd", "momentum", "lars_momentum", "adagrad", "adam", "adamax",
    "adadelta", "decayed_adagrad", "rmsprop", "ftrl", "lamb",
    "dgc_momentum", "proximal_gd", "proximal_adagrad",
])

# AMP loss-scaling ops: they read @GRAD vars and update the scaling state,
# so they are train-only and pruned with the backward ops
_AMP_STATE_OP_TYPES = frozenset([
    "check_finite_and_unscale", "update_loss_scaling",
])


# ---------------------------------------------------------------------------
# default programs and guards
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()


def default_startup_program():
    return _startup_program_


def default_main_program():
    return _main_program_


def switch_main_program(program):
    global _main_program_
    prev = _main_program_
    _main_program_ = program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev = _startup_program_
    _startup_program_ = program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
