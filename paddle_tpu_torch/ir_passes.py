"""The compile-time pass pipeline of the port (parity: the JAX package's
``ir_passes.py`` `pipeline_key` :200, `optimize_for_execution` :244 and
the shared analyses :314-397).

The port's pipeline has one slot so far: ``quant_rewrite``
(``quant.py``), scheduled when a quantization config is in effect for
the program (``quant.decorate`` or ``PTPU_QUANT=1``). With none in
effect the executor runs the user's program itself and its cache key
gains nothing.
"""

from . import quant

__all__ = ["bake_value", "optimize_for_execution", "pipeline_key",
           "state_fallback"]


def pipeline_key(program):
    """The compile-cache key component of the pipeline: the quant
    config's key, so that a step compiled under one quantization policy
    (or none) never serves another. ``decorate`` does not change the
    program's version, so the executor's key needs this."""
    cfg = quant.active_config(program)
    return () if cfg is None else ("quant:" + cfg.cache_key(),)


def optimize_for_execution(program, fetch_names, scope=None, device=None):
    """Run the pipeline on a CLONE of `program` and return it, or the
    original, untouched, when no pass is scheduled or none changed
    anything. Called on every compile-cache miss. Values a pass bakes
    are tensors on `device` (the executor's)."""
    cfg = quant.active_config(program)
    if cfg is None:
        return program
    from .ir import get_pass

    clone = program.clone()
    clone._opt_fetch_targets = tuple(fetch_names)
    clone._opt_device = device
    clone._quant_config = cfg
    baked = getattr(program, "_baked_values", None)
    if baked:
        clone._baked_values = dict(baked)
    v0 = clone.version
    get_pass("quant_rewrite").apply(clone, scope)
    return clone if clone.version != v0 else program


# ---------------------------------------------------------------------------
# shared analyses
# ---------------------------------------------------------------------------


def _fetch_targets(program):
    """Fetch-target names the pipeline pinned on the clone; None means
    unknown, and makes the fetch-driven passes no-ops."""
    return getattr(program, "_opt_fetch_targets", None)


def bake_value(program, name, value):
    """Record a compile-time value (a baked constant) on the optimized
    program: `state_fallback` re-seeds any scope that lacks the entry,
    so a cached step stays valid across scopes."""
    baked = getattr(program, "_baked_values", None)
    if baked is None:
        baked = program._baked_values = {}
    baked[name] = value


def state_fallback(program, name):
    """The baked value of a persistable step input missing from the run
    scope, or None (genuinely uninitialized)."""
    baked = getattr(program, "_baked_values", None)
    if baked and name in baked:
        return baked[name]
    return None


def _grad_referenced_ids(program):
    """ids of ops referenced (transitively) through `__fwd_op__` attrs:
    their grad ops read what they record, so no pass rewrites them."""
    from .framework import Operator

    refed = set()
    for blk in program.blocks:
        for op in blk.ops:
            fwd = op.attrs.get("__fwd_op__")
            while isinstance(fwd, Operator) and id(fwd) not in refed:
                refed.add(id(fwd))
                fwd = fwd.attrs.get("__fwd_op__")
    return refed


def _write_indices(block):
    """{name: [op index, ...]} for every output name in `block`."""
    writes = {}
    for i, op in enumerate(block.ops):
        for n in op.output_names():
            writes.setdefault(n, []).append(i)
    return writes
