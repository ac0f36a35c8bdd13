"""Learning-rate schedules (parity: the JAX package's
``layers/learning_rate_scheduler.py``).

Each schedule appends ops computing the rate from the persistable int64
`@step_counter@`, which an `increment` op advances once a run (from
`begin`: the first run reads 1); the returned Variable goes to an
optimizer as its `learning_rate`. The counter is the program's own
state, not the executor's host step count. `piecewise_decay` writes a
persistable rate var from a `Switch` of `less_than` cases on the
counter.
"""

import math

from .. import unique_name
from ..framework import Variable, default_main_program, default_startup_program
from ..initializer import Constant
from . import nn, tensor
from .control_flow import Switch, increment

__all__ = [
    "exponential_decay", "natural_exp_decay", "inverse_time_decay",
    "polynomial_decay", "piecewise_decay", "noam_decay", "cosine_decay",
    "linear_lr_warmup", "autoincreased_step_counter",
]


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """The persistable int64 counter, += step a run; the startup program
    sets it to begin - step."""
    name = counter_name or "@step_counter@"
    gb = default_main_program().global_block()
    if gb.has_var(name):
        return gb.var(name)
    counter = gb.create_var(name=name, shape=(1,), dtype="int64",
                            persistable=True, stop_gradient=True)
    sb = default_startup_program().global_block()
    sv = sb.create_var(name=name, shape=(1,), dtype="int64",
                       persistable=True)
    Constant(float(begin - step))(sv, sb)
    increment(counter, value=step, in_place=True)
    return counter


def _float_step():
    return tensor.cast(autoincreased_step_counter(), "float32")


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""
    step = _float_step()
    a = nn.pow(step, factor=-0.5)
    b = nn.scale(step, scale=float(warmup_steps) ** -1.5)
    return nn.scale(nn.elementwise_min(a, b), scale=float(d_model) ** -0.5)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """learning_rate * decay_rate^(step / decay_steps)."""
    step = _float_step()
    div = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = nn.floor(div)
    return nn.scale(nn.elementwise_pow(
        tensor.fill_constant([1], "float32", decay_rate), div),
        scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """learning_rate * exp(-decay_rate * step / decay_steps)."""
    step = _float_step()
    div = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = nn.floor(div)
    return nn.scale(nn.exp(nn.scale(div, scale=-decay_rate)),
                    scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """learning_rate / (1 + decay_rate * step / decay_steps)."""
    step = _float_step()
    div = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = nn.floor(div)
    denom = nn.scale(div, scale=decay_rate, bias=1.0)
    return nn.elementwise_div(
        tensor.fill_constant([1], "float32", float(learning_rate)), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(learning_rate - end) * (1 - step / decay_steps)^power + end, the
    step capped at decay_steps, or with `cycle` decay_steps stretched to
    the next multiple past the step."""
    step = _float_step()
    if cycle:
        div = nn.ceil(nn.scale(step, scale=1.0 / decay_steps))
        # ceil(0) = 0 at a step of 0: count it as one cycle
        one = tensor.fill_constant([1], "float32", 1.0)
        div = nn.elementwise_max(div, one)
        frac = nn.elementwise_div(step,
                                  nn.scale(div, scale=float(decay_steps)))
    else:
        capped = nn.elementwise_min(
            step, tensor.fill_constant([1], "float32", float(decay_steps)))
        frac = nn.scale(capped, scale=1.0 / decay_steps)
    base = nn.scale(frac, scale=-1.0, bias=1.0)
    poly = nn.elementwise_pow(
        base, tensor.fill_constant([1], "float32", float(power)))
    return nn.scale(poly, scale=float(learning_rate) - end_learning_rate,
                    bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """values[i] while the step is below boundaries[i] (the first such
    i), values[-1] past the last: a persistable rate var, filled with
    values[0] by the startup program and written by a Switch each run."""
    assert len(values) == len(boundaries) + 1
    gb = default_main_program().global_block()
    lr = gb.create_var(name=unique_name.generate("piecewise_lr"),
                       shape=(1,), dtype="float32", persistable=True,
                       stop_gradient=True)
    sb = default_startup_program().global_block()
    sv = sb.create_var(name=lr.name, shape=(1,), dtype="float32",
                       persistable=True)
    Constant(float(values[0]))(sv, sb)

    step = autoincreased_step_counter()
    switch = Switch()
    for i, bound in enumerate(boundaries):
        bvar = tensor.fill_constant([1], "int64", int(bound))
        with switch.case(nn.less_than(step, bvar)):
            tensor.assign(
                tensor.fill_constant([1], "float32", float(values[i])), lr)
    with switch.default():
        tensor.assign(
            tensor.fill_constant([1], "float32", float(values[-1])), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """0.5 * learning_rate * (cos(pi * epoch / epochs) + 1)."""
    step = _float_step()
    epoch = nn.floor(nn.scale(step, scale=1.0 / step_each_epoch))
    inner = nn.scale(epoch, scale=math.pi / epochs)
    return nn.scale(nn.cos(inner), scale=0.5 * float(learning_rate),
                    bias=0.5 * float(learning_rate))


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """start_lr -> end_lr linearly over warmup_steps, then
    `learning_rate` (a float or a schedule)."""
    step = _float_step()
    if not isinstance(learning_rate, Variable):
        learning_rate = tensor.fill_constant([1], "float32",
                                             float(learning_rate))
    frac = nn.scale(
        nn.elementwise_min(
            step, tensor.fill_constant([1], "float32", float(warmup_steps))),
        scale=1.0 / warmup_steps)
    warm = nn.scale(frac, scale=float(end_lr) - float(start_lr),
                    bias=float(start_lr))
    in_warmup = tensor.cast(
        nn.less_than(step, tensor.fill_constant([1], "float32",
                                                float(warmup_steps))),
        "float32")
    a = nn.elementwise_mul(in_warmup, warm)
    b = nn.elementwise_mul(nn.scale(in_warmup, scale=-1.0, bias=1.0),
                           learning_rate)
    return nn.elementwise_add(a, b)
