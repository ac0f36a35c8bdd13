"""Scope: a name -> value store. The executor keeps a program's
persistable tensors (parameters, learning rate, loss-scaling state) in
a scope between steps; the serving engine keeps each model's weights in
a scope of its own."""

__all__ = ["Scope", "global_scope"]


class Scope:
    def __init__(self):
        self._vars = {}

    def get(self, name, default=None):
        return self._vars.get(name, default)

    def set(self, name, value):
        self._vars[name] = value

    def local_var_names(self):
        return list(self._vars)


_global_scope = Scope()


def global_scope():
    """The scope `Executor.run` uses when the caller names none."""
    return _global_scope
