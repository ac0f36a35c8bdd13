"""Initializers (parity: python/paddle/fluid/initializer.py — Constant,
Uniform, Normal, Xavier).

An initializer appends one init op for a parameter to the *startup*
program; running the startup program fills the scope.
"""

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "Xavier", "Initializer",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "XavierInitializer"]

_global_seed_counter = [0]


def _next_seed(seed):
    if seed:
        return seed
    _global_seed_counter[0] += 1
    return _global_seed_counter[0]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": self.low, "max": self.high,
                   "__op_seed__": _next_seed(self.seed)},
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            type="gaussian_random",
            outputs={"Out": [var]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self.loc, "std": self.scale,
                   "__op_seed__": _next_seed(self.seed)},
        )


def _fan_in_out(var):
    shape = var.shape
    if not shape:
        return 1, 1
    if len(shape) < 2:
        return int(shape[0]), int(shape[0])
    if len(shape) == 2:
        return int(shape[0]), int(shape[1])
    # [c_out, c_in, *k]: receptive = prod(k)
    receptive = int(np.prod(shape[2:]))
    return int(shape[1]) * receptive, int(shape[0]) * receptive


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / (fi + fo)))
            NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
