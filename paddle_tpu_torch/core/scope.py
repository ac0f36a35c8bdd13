"""Scope: a name -> value store. The executor keeps a program's
persistable tensors (parameters, learning rate, loss-scaling state) in
a scope between steps; the serving engine keeps each model's weights in
a scope of its own, and so does each inference predictor.
`scope_guard(scope)` makes `scope` the one `global_scope()` returns
while it is open (parity: the JAX package's ``core/scope.py``)."""

__all__ = ["Scope", "global_scope", "scope_guard"]


class Scope:
    def __init__(self):
        self._vars = {}

    def get(self, name, default=None):
        return self._vars.get(name, default)

    def set(self, name, value):
        self._vars[name] = value

    def erase(self, name):
        """Drop the binding of `name` if there is one."""
        self._vars.pop(name, None)

    def local_var_names(self):
        return list(self._vars)

    def items(self):
        """This scope's (name, value) bindings: the state
        ``resilience.snapshot_scope`` copies to the host."""
        return list(self._vars.items())


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope():
    """The scope `Executor.run` and the io functions use when the caller
    names none: the innermost open `scope_guard`'s, else the process's
    global scope."""
    return _scope_stack[-1]


class scope_guard:
    def __init__(self, scope):
        self._scope = scope

    def __enter__(self):
        _scope_stack.append(self._scope)
        return self._scope

    def __exit__(self, *a):
        _scope_stack.pop()
