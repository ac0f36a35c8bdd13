"""Program-pass infrastructure (parity: the JAX package's ``ir.py``
`Pass`, `register_pass`, `get_pass`, `registered_passes` :34-95).

A pass rewrites a program in place (bumping its version when it changes
ops) and returns it; ``scope`` carries the materialized values for
passes that read or bake weights. The port registers one pass so far,
``quant_rewrite`` (``quant.py``).
"""

__all__ = ["Pass", "register_pass", "get_pass", "registered_passes"]


class Pass:
    """One program transform: subclass and implement `apply`."""

    name = None

    def apply(self, program, scope=None):
        raise NotImplementedError

    def __call__(self, program, scope=None):
        return self.apply(program, scope)


_REGISTRY = {}


def register_pass(name):
    """Decorator registering a Pass subclass (or a plain
    ``fn(program, scope)``) under `name`; a duplicate name raises."""
    def deco(obj):
        if name in _REGISTRY:
            raise ValueError("pass %r already registered" % name)
        if isinstance(obj, type) and issubclass(obj, Pass):
            inst = obj()
        else:
            fn = obj

            class _FnPass(Pass):
                def apply(self, program, scope=None):
                    return fn(program, scope)

            inst = _FnPass()
        inst.name = name
        _REGISTRY[name] = inst
        return obj

    return deco


def get_pass(name):
    if name not in _REGISTRY:
        raise KeyError("no pass registered under %r (have: %s)"
                       % (name, sorted(_REGISTRY)))
    return _REGISTRY[name]


def registered_passes():
    return sorted(_REGISTRY)
