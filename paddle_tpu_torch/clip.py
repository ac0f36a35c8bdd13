"""Gradient clipping (parity: the JAX package's ``clip.py``:
ErrorClipByValue, GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm with its groups, `set_gradient_clip` scoped to
the program, and `append_gradient_clip_ops`, which the optimizers run
ahead of the weight decay)."""

from . import framework, layers

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops"]


class BaseErrorClipAttr:
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _create_operators(self, param, grad):
        return param, layers.clip(x=grad, min=self.min, max=self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _create_operators(self, param, grad):
        return param, layers.clip_by_norm(x=grad, max_norm=self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale every grad of the group by clip_norm / max(clip_norm, the
    group's global L2 norm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        sq = layers.reduce_sum(layers.square(grad))
        context[self.group_name].append(sq)
        self.context = context

    def _create_operators(self, param, grad):
        group_scale_name = self.group_name + "_scale"
        if group_scale_name not in self.context:
            group_norm = layers.sqrt(
                layers.sums(self.context[self.group_name]))
            clip_var = layers.fill_constant(
                shape=[1], dtype=grad.dtype,
                value=self.context[self.group_name + "_clip_value"])
            scale = layers.elementwise_div(
                x=clip_var, y=layers.elementwise_max(x=clip_var, y=group_norm))
            self.context[group_scale_name] = scale
        return param, layers.elementwise_mul(
            x=grad, y=self.context[group_scale_name])


def set_gradient_clip(clip, param_list=None, program=None):
    """Attach `clip` to the params of `param_list`, or make it the
    program's default (never process-wide: one program's clip cannot
    reach another)."""
    program = program or framework.default_main_program()
    if param_list is None:
        program._gradient_clip_attr = clip
        return
    for p in param_list:
        name = p if isinstance(p, str) else p.name
        program.global_block().var(name).gradient_clip_attr = clip


def _clip_attr_for(p):
    attr = getattr(p, "gradient_clip_attr", None)
    if attr is not None:
        return attr
    return getattr(p.block.program, "_gradient_clip_attr", None)


def append_gradient_clip_ops(param_grads):
    """[(param, clipped grad)]: every clip's context first (a global-norm
    group sums all its grads' squares), then its ops."""
    context = {}
    any_clip = False
    for p, g in param_grads:
        clip_attr = _clip_attr_for(p) if g is not None else None
        if clip_attr is not None:
            any_clip = True
            clip_attr._process_context(context, p, g)
    if not any_clip:
        return param_grads
    out = []
    for p, g in param_grads:
        clip_attr = _clip_attr_for(p) if g is not None else None
        out.append((p, g) if clip_attr is None
                   else clip_attr._create_operators(p, g))
    return out
