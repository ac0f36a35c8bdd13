"""The memory-optimization transpiler (parity: the JAX package's
``transpiler/memory_optimization_transpiler.py``, after Fluid's).

The port's step frees each intermediate after the last op that names it
(``executor._Step``'s memory plan), and PyTorch's caching allocator
reuses the freed blocks, so the reference's var-renaming rewrite is not
needed. What this module provides is the same analysis as the JAX
package's: variable lifetimes over the op list, the reusable pairs
annotated on the program (``memory_optimize``, also the registered
``memory_optimize`` pass) and the early-free plan
(``release_memory``).
"""

__all__ = ["memory_optimize", "release_memory", "ControlFlowGraph"]


class ControlFlowGraph:
    """Forward-order lifetime analysis of the global block."""

    def __init__(self, program):
        self._program = program
        block = program.global_block()
        self.ops = list(block.ops)
        self.first_def = {}
        self.last_use = {}
        for i, op in enumerate(self.ops):
            for name in op.output_names():
                self.first_def.setdefault(name, i)
                self.last_use[name] = i
            for name in op.input_names():
                self.last_use[name] = i

    def lifetime(self, varname):
        return self.first_def.get(varname), self.last_use.get(varname)

    def reusable_pairs(self, skip=()):
        """(dead_var, new_var) pairs: dead_var's last use precedes
        new_var's definition, and their shapes and dtypes match."""
        block = self._program.global_block()
        pairs = []
        names = [n for n in self.first_def
                 if n not in skip and block.has_var(n)
                 and not getattr(block.var(n), "persistable", False)
                 and not getattr(block.var(n), "is_data", False)]
        for dead in names:
            for new in names:
                if dead == new:
                    continue
                dv, nv = block.var(dead), block.var(new)
                if dv.shape != nv.shape or dv.dtype != nv.dtype:
                    continue
                if self.last_use[dead] < self.first_def[new]:
                    pairs.append((dead, new))
        return pairs


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=False):
    """Annotate the reuse plan on the program (``_memory_reuse_plan``)
    and return it."""
    skip = set(skip_opt_set or ())
    cfg = ControlFlowGraph(input_program)
    if skip_grads:
        skip |= {n for n in cfg.first_def if n.endswith("@GRAD")}
    pairs = cfg.reusable_pairs(skip)
    input_program._memory_reuse_plan = pairs
    if print_log:
        for dead, new in pairs:
            print("memory_optimize: %s -> %s" % (dead, new))
    return pairs


def release_memory(input_program, skip_opt_set=None):
    """Mark each non-persistable var freeable right after its last use
    (``_eager_deletion_plan``: name -> op index)."""
    skip = set(skip_opt_set or ())
    cfg = ControlFlowGraph(input_program)
    block = input_program.global_block()
    plan = {}
    for name, last in cfg.last_use.items():
        if name in skip or not block.has_var(name):
            continue
        v = block.var(name)
        if getattr(v, "persistable", False) or getattr(v, "is_data", False):
            continue
        plan[name] = last
    input_program._eager_deletion_plan = plan
    return plan
