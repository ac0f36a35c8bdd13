"""The compile-time pass pipeline of the port (parity: the JAX package's
``ir_passes.py``: `pipeline_enabled` :93, `program_is_inference` :100,
`build_pipeline` :158, `pipeline_key` :200, `optimize_for_execution`
:244, the shared analyses :314-440 and the passes `fetch_dce` :500,
`cse` :566 and `constant_fold` :664).

On every compile-cache miss the executor runs the pipeline on a CLONE of
the program; the user's program never changes. The default pipeline is
``constant_fold``, ``cse`` and ``fetch_dce``; ahead of them come
``dropout_remove`` for an inference-shaped program (``ir.py``),
``amp_rewrite`` when an AMP config is in effect (``amp.py``:
``amp.decorate`` or ``PTPU_AMP=1``) and ``quant_rewrite`` when a
quantization config is (``quant.py``: ``quant.decorate`` or
``PTPU_QUANT=1``). ``PTPU_NO_PROGRAM_OPT=1`` turns the pipeline off and
the executor runs the user's program itself. The cache key carries
`pipeline_key`, so a step compiled under one pass list or policy never
serves another.

A ``compiler.CompiledProgram`` passes its ``BuildStrategy``: its
``memory_optimize`` (on by default; registered in ``ir.py``),
``fuse_elewise_add_act_ops`` (`fuse_elewise_add_act`, into the
``fused_elemwise_activation`` op) and ``amp`` knobs choose passes, and
``with_inference_optimize`` adds ``conv_bn_fold_baked`` and
``conv_elementwise_add_fuse`` (``ir.py``). `InplaceInfo` is
``enable_inplace``'s state classification. A pipeline naming a pass
that is not registered raises, naming it.

Soundness, as in the JAX package: ops referenced through a grad op's
`__fwd_op__` are never deleted or rewired (their grad ops read what they
record); names read or written by sub-blocks are never rewired; CSE and
folding treat a var as value-stable only when a single definition
reaches every read.
"""

import hashlib
import time

import numpy as np

from . import flags as _flags
from .observability import metrics as _metrics
from .observability import tracing as _tracing

__all__ = ["InplaceInfo", "bake_value", "build_pipeline",
           "optimize_for_execution", "pipeline_enabled", "pipeline_key",
           "program_is_inference", "state_fallback"]

# constant folding refuses to bake results larger than this
_MAX_FOLD_BYTES = 1 << 24

# folded values up to this many elements stay inline (one assign_value
# op); larger ones bake as initialized persistables
_INLINE_FOLD_ELEMS = 1 << 16

# pure but context-sensitive kernels never fold
_CTX_SENSITIVE_TYPES = frozenset({"flash_attention"})

# the activations fuse_elewise_add_act folds into the add before them
_FUSABLE_ACTS = ("relu", "tanh", "sigmoid")


def pipeline_enabled():
    """False under PTPU_NO_PROGRAM_OPT=1: every compile-time transform
    gates on this, so the opt-out runs the program exactly as built."""
    return not _flags.env("PTPU_NO_PROGRAM_OPT")


def program_is_inference(program):
    """True when the program holds no backward or optimizer op and every
    train/eval-switchable op is pinned to test mode: a
    clone(for_test=True)-shaped program. Cached per program version."""
    from .framework import _TEST_MODE_OPS, Program

    cached = getattr(program, "_is_test_cache", None)
    if cached is not None and cached[0] == program.version:
        return cached[1]
    result = True
    for blk in program.blocks:
        for op in blk.ops:
            if Program._is_train_only_op(op) or (
                    "is_test" in _TEST_MODE_OPS.get(op.type, ())
                    and not op.attrs.get("is_test", False)):
                result = False
                break
        if not result:
            break
    program._is_test_cache = (program.version, result)
    return result


def _amp_cfg(program, build_strategy=None):
    """The AMP config in effect for one compile, or None. Importing amp
    registers the amp_rewrite pass."""
    from . import amp

    return amp.active_config(program, build_strategy)


def _quant_cfg(program):
    from . import quant

    return quant.active_config(program)


def build_pipeline(build_strategy=None, is_test=False, infer_opt=False,
                   single_block=True, amp=False, quant=False):
    """Ordered pass-name list for one compile, the JAX package's (its
    embedding-prefetch slot aside: the port has no embedding pipeline).
    `amp` and `quant` (an active config) schedule their rewrite ahead of
    constant_fold and cse, so the casts and quantize ops they insert
    fold and dedup."""
    names = []
    if (is_test or infer_opt) and single_block:
        names.append("dropout_remove")
    if infer_opt:
        names.append("conv_bn_fold_baked")
        names.append("conv_elementwise_add_fuse")
    if amp:
        names.append("amp_rewrite")
    if quant:
        names.append("quant_rewrite")
    names.append("constant_fold")
    names.append("cse")
    if infer_opt or (build_strategy is not None
                     and getattr(build_strategy,
                                 "fuse_elewise_add_act_ops", False)):
        names.append("fuse_elewise_add_act")
    names.append("fetch_dce")
    if build_strategy is not None and getattr(build_strategy,
                                              "memory_optimize", False):
        names.append("memory_optimize")
    return names


def _pipeline_names(program, build_strategy=None, infer_opt=False):
    amp_cfg = _amp_cfg(program, build_strategy)
    quant_cfg = _quant_cfg(program)
    names = build_pipeline(build_strategy, program_is_inference(program),
                           infer_opt, len(program.blocks) == 1,
                           amp=amp_cfg is not None,
                           quant=quant_cfg is not None)
    return names, amp_cfg, quant_cfg


def pipeline_key(build_strategy=None, program=None, infer_opt=False):
    """The compile-cache key component of the pipeline: the pass list,
    then the AMP and quantization configs' keys (a step compiled under
    one policy never serves another); ``("noopt",)`` under
    PTPU_NO_PROGRAM_OPT=1."""
    if not pipeline_enabled():
        return ("noopt",)
    names, amp_cfg, quant_cfg = _pipeline_names(program, build_strategy,
                                                infer_opt)
    key = tuple(names)
    if amp_cfg is not None:
        key += ("amp:" + amp_cfg.cache_key(),)
    if quant_cfg is not None:
        key += ("quant:" + quant_cfg.cache_key(),)
    if build_strategy is not None:
        # enable_inplace selects the step's state classification
        key += ("inplace:%d" % int(getattr(build_strategy,
                                           "enable_inplace", True)),)
    return key


def optimize_for_execution(program, fetch_names, scope=None, device=None,
                           build_strategy=None, infer_opt=False):
    """Run the pipeline on a CLONE of `program` and return it, or the
    original, untouched, when the pipeline is off or no pass changed
    anything. Called on every compile-cache miss. Values a pass folds or
    bakes are tensors on `device` (the executor's). Records
    ``compiler/pass_time`` for each pass and ``compiler/programs_optimized``
    once a program changed, when metrics are on; each pass runs in a
    ``pass:<name>`` span."""
    if not pipeline_enabled():
        return program
    names, amp_cfg, quant_cfg = _pipeline_names(program, build_strategy,
                                                infer_opt)
    from .ir import get_pass, registered_passes

    missing = [n for n in names if n not in registered_passes()]
    if missing:
        raise NotImplementedError(
            "the pass pipeline names %s, not ported to paddle_tpu_torch "
            "(the JAX package runs it for an inference optimization or a "
            "BuildStrategy)" % ", ".join(repr(n) for n in missing))
    clone = program.clone()
    clone._opt_fetch_targets = tuple(fetch_names)
    clone._opt_device = device
    if amp_cfg is not None:
        clone._amp_config = amp_cfg
    if quant_cfg is not None:
        clone._quant_config = quant_cfg
    baked = getattr(program, "_baked_values", None)
    if baked:
        clone._baked_values = dict(baked)
    rec = _metrics.enabled()
    changed_any = False
    for name in names:
        v0 = clone.version
        t0 = time.perf_counter()
        with _tracing.span("pass:" + name):
            get_pass(name).apply(clone, scope)
        if rec:
            _metrics.histogram("compiler/pass_time").observe(
                time.perf_counter() - t0)
        changed_any = changed_any or clone.version != v0
    if not changed_any:
        return program
    if rec:
        _metrics.counter("compiler/programs_optimized").inc()
    return clone


# ---------------------------------------------------------------------------
# shared analyses
# ---------------------------------------------------------------------------


def _fetch_targets(program):
    """Fetch-target names the pipeline pinned on the clone; None means
    unknown, and makes the fetch-driven passes no-ops."""
    return getattr(program, "_opt_fetch_targets", None)


def _outside_reads(program):
    """Var names read by any op outside the global block."""
    gb = program.global_block()
    reads = set()
    for blk in program.blocks:
        if blk is not gb:
            for op in blk.ops:
                reads.update(op.input_names())
    return reads


def _outside_writes(program):
    """Var names written by any op outside the global block: their write
    order relative to the global block's ops is unknown."""
    gb = program.global_block()
    writes = set()
    for blk in program.blocks:
        if blk is not gb:
            for op in blk.ops:
                writes.update(op.output_names())
    return writes


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


class InplaceInfo:
    """The state plan's in-place policy (``BuildStrategy.enable_inplace``;
    the JAX package's `InplaceInfo` :443, handed to
    ``compiler.classify_persistable_state``). `enabled=False` moves every
    read-and-written persistable to the read-only set (`const`), so the
    step gives the update ops copies and the scope's pre-step tensors
    keep their values. `enabled=True` keeps the classification.

    The JAX policy also promotes large write-before-read persistables
    into the donated inputs, so that XLA can reuse their buffers. The
    port's step hands no buffer to a compiler: it writes each new value
    into the scope after the step, so it promotes nothing."""

    def __init__(self, enabled=True):
        self.enabled = enabled

    def adjust(self, mut, const):
        if not self.enabled:
            return [], const + mut
        return mut, const


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


def _is_pure(op):
    """A registered, stateless kernel with no structural role, no
    sub-block or operator attrs and no grad machinery: safe to evaluate,
    dedup or delete on the usual liveness grounds."""
    from .core.lowering import _SPECIAL, _STRUCTURAL
    from .framework import Block, Operator
    from .ops import registry

    if op.type in _STRUCTURAL or op.type in _SPECIAL:
        return False
    if "__fwd_op__" in op.attrs:
        return False
    if not registry.has(op.type) or registry.get(op.type).stateful:
        return False
    return not any(isinstance(v, (Block, Operator))
                   for v in op.attrs.values())


def _attr_fingerprint(attrs):
    """Hashable canonical form of an op's attrs (ndarrays by content,
    containers recursively)."""
    def canon(v):
        if isinstance(v, np.ndarray):
            return ("__ndarray__", v.shape, str(v.dtype), v.tobytes())
        if isinstance(v, (list, tuple)):
            return tuple(canon(x) for x in v)
        if isinstance(v, dict):
            return tuple(sorted((kk, canon(vv)) for kk, vv in v.items()))
        try:
            hash(v)
        except TypeError:
            return repr(v)
        return v

    return tuple((k, canon(attrs[k])) for k in sorted(attrs))


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------


def _register_builtin_passes():
    from .ir import Pass, register_pass

    @register_pass("fetch_dce")
    class FetchDeadOpEliminationPass(Pass):
        """Remove global-block ops whose outputs cannot reach a fetch
        target, a persistable write, a structural op, a sub-block read
        or a surviving grad op's forward reference
        (``compiler/ops_removed``)."""

        def apply(self, program, scope=None):
            from .core.lowering import _SPECIAL, _STRUCTURAL
            from .framework import Block, Operator

            targets = _fetch_targets(program)
            if targets is None:
                return program
            block = program.global_block()
            ops = block.ops
            idx_of = {id(op): i for i, op in enumerate(ops)}
            writers = _write_indices(block)

            live = set()
            live_names = set(targets) | _outside_reads(program)
            for i, op in enumerate(ops):
                anchor = (op.type in _STRUCTURAL or op.type in _SPECIAL
                          or not op.output_names()
                          or any(isinstance(v, Block)
                                 for v in op.attrs.values()))
                if not anchor:
                    for n in op.output_names():
                        v = block._find_var_recursive(n)
                        if v is not None and v.persistable:
                            anchor = True
                            break
                if anchor:
                    live.add(i)

            changed = True
            while changed:
                changed = False
                for n in list(live_names):
                    for i in writers.get(n, ()):
                        if i not in live:
                            live.add(i)
                            changed = True
                for i in list(live):
                    op = ops[i]
                    new = set(op.input_names()) - live_names
                    if new:
                        live_names |= new
                        changed = True
                    fwd = op.attrs.get("__fwd_op__")
                    while isinstance(fwd, Operator):
                        j = idx_of.get(id(fwd))
                        if j is not None and j not in live:
                            live.add(j)
                            changed = True
                        fwd = fwd.attrs.get("__fwd_op__")

            if len(live) == len(ops):
                return program
            removed = len(ops) - len(live)
            block.ops = [op for i, op in enumerate(ops) if i in live]
            _metrics.counter("compiler/ops_removed").inc(removed)
            program._bump_version()
            return program

    @register_pass("cse")
    class CommonSubexpressionEliminationPass(Pass):
        """Dedup pure global-block ops computing the identical value:
        key (type, per-slot inputs as (name, reaching-def index), output
        arity, attrs). A later duplicate is deleted and its readers
        rewired to the kept op's outputs (``compiler/ops_removed``)."""

        def apply(self, program, scope=None):
            targets = _fetch_targets(program)
            if targets is None:
                return program
            block = program.global_block()
            protected = set(targets) | _outside_reads(program)
            grad_refed = _grad_referenced_ids(program)
            writes = _write_indices(block)
            sub_written = _outside_writes(program)

            def rdef(name, i):
                if name in sub_written:
                    return None
                last = -1
                for w in writes.get(name, ()):
                    if w < i:
                        last = w
                    else:
                        break
                return last

            seen = {}
            rewire = {}
            removed = []
            for i, op in enumerate(block.ops):
                for slot, vs in op.inputs.items():
                    op.inputs[slot] = [rewire.get(v.name, v) for v in vs]
                if not _is_pure(op):
                    continue
                key_in = []
                ok = True
                for slot in sorted(op.inputs):
                    ids = []
                    for v in op.inputs[slot]:
                        d = rdef(v.name, i)
                        if d is None:
                            ok = False
                            break
                        ids.append((v.name, d))
                    if not ok:
                        break
                    key_in.append((slot, tuple(ids)))
                if not ok:
                    continue
                key = (op.type, tuple(key_in),
                       tuple(sorted((s, len(vs))
                                    for s, vs in op.outputs.items())),
                       _attr_fingerprint(op.attrs))
                kept = seen.get(key)
                if kept is None:
                    seen[key] = op
                    continue
                eliminable = id(op) not in grad_refed
                for n in op.output_names():
                    v = block._find_var_recursive(n)
                    if (n in protected or n in sub_written
                            or len(writes.get(n, ())) != 1
                            or (v is not None
                                and (v.persistable or v.is_data))):
                        eliminable = False
                        break
                # the kept op's outputs must be singly written too
                for n in kept.output_names():
                    if n in sub_written or len(writes.get(n, ())) != 1:
                        eliminable = False
                        break
                if not eliminable:
                    continue
                for slot, vs in op.outputs.items():
                    for v, kv in zip(vs, kept.outputs.get(slot, ())):
                        rewire[v.name] = kv
                removed.append(i)
            if removed:
                gone = set(removed)
                block.ops = [op for i, op in enumerate(block.ops)
                             if i not in gone]
                _metrics.counter("compiler/ops_removed").inc(len(removed))
                program._bump_version()
            return program

    @register_pass("constant_fold")
    class ConstantFoldPass(Pass):
        """Evaluate const-only subgraphs once, through the op registry's
        own kernels on the executor's device (``_opt_device``). A small
        boundary value replaces its producer by one inline
        ``assign_value`` op; a large one bakes as a fresh
        content-addressed persistable (``bake_value``) and its readers
        are rewired. fetch_dce sweeps the dead producers
        (``compiler/ops_folded``)."""

        def apply(self, program, scope=None):
            if scope is None:
                return program
            import torch

            from .core.lowering import LoweringContext
            from .framework import Operator, convert_dtype
            from .ops import registry

            targets = set(_fetch_targets(program) or ())
            block = program.global_block()
            outside = _outside_reads(program)
            grad_refed = _grad_referenced_ids(program)
            writes = _write_indices(block)
            sub_written = _outside_writes(program)

            device = getattr(program, "_opt_device", None) or "cpu"
            ctx = LoweringContext(device)
            const_vals = {}
            const_ops = set()
            for op in block.ops:
                if not _is_pure(op) or id(op) in grad_refed:
                    continue
                if op.type in _CTX_SENSITIVE_TYPES \
                        or "__loss_seed__" in op.attrs:
                    continue
                if any(n not in const_vals for n in op.input_names()):
                    continue
                foldable = True
                for n in op.output_names():
                    v = block._find_var_recursive(n)
                    if (n in sub_written or len(writes.get(n, ())) != 1
                            or v is None or v.persistable or v.is_data):
                        foldable = False
                        break
                if not foldable:
                    continue
                ins = {slot: [const_vals[v.name] for v in vs]
                       for slot, vs in op.inputs.items() if vs}
                try:
                    with torch.no_grad():
                        outs = registry.get(op.type).impl(ctx, ins,
                                                          op.attrs)
                except Exception:
                    continue
                vals = {}
                for slot, vs in op.outputs.items():
                    produced = outs.get(slot)
                    if produced is None:
                        continue
                    for v, val in zip(vs, produced):
                        if not isinstance(val, torch.Tensor) or (
                                val.numel() * val.element_size()
                                > _MAX_FOLD_BYTES):
                            vals = None
                            break
                        vals[v.name] = val
                    if vals is None:
                        break
                if vals is None:
                    continue
                const_vals.update(vals)
                const_ops.add(id(op))
            if not const_ops:
                return program

            # boundary values: const vars read by a non-const op
            boundary = set()
            for op in block.ops:
                if id(op) not in const_ops:
                    boundary.update(n for n in op.input_names()
                                    if n in const_vals)
            boundary |= {n for n in const_vals if n in outside}
            producer = {}
            for op in block.ops:
                if id(op) in const_ops:
                    for n in op.output_names():
                        producer[n] = op

            changed = False
            baked = {}
            for name in sorted(boundary):
                val = const_vals[name]
                prod = producer[name]
                if val.numel() <= _INLINE_FOLD_ELEMS:
                    if len(prod.output_names()) != 1 \
                            or prod.type == "assign_value":
                        continue  # multi-output, or already folded
                    dtype = convert_dtype(val.dtype)
                    arr = val.detach().cpu()
                    arr = (arr.float() if dtype == "bfloat16"
                           else arr).numpy()
                    block.ops[block.ops.index(prod)] = Operator(
                        block, "assign_value", inputs={},
                        outputs={"Out": [block.var(name)]},
                        attrs={"shape": list(arr.shape), "dtype": dtype,
                               "values": arr})
                    const_ops.discard(id(prod))
                    changed = True
                elif name not in outside and name not in targets:
                    host = val.detach().cpu()
                    raw = host.view(torch.int16) \
                        if host.dtype == torch.bfloat16 else host
                    digest = hashlib.sha1(
                        raw.numpy().tobytes() + repr(
                            (name, tuple(host.shape),
                             convert_dtype(host.dtype))).encode()
                    ).hexdigest()[:12]
                    fname = "__folded__.%s.%s" % (digest, name)
                    if not block.has_var(fname):
                        block.create_var(name=fname,
                                         shape=tuple(val.shape),
                                         dtype=block.var(name).dtype,
                                         persistable=True)
                    scope.set(fname, val)
                    bake_value(program, fname, val)
                    baked[name] = block.var(fname)
                    changed = True
            if baked:
                for op in block.ops:
                    if id(op) not in const_ops:
                        for slot, vs in op.inputs.items():
                            op.inputs[slot] = [baked.get(v.name, v)
                                               for v in vs]
            if changed:
                _metrics.counter("compiler/ops_folded").inc(len(const_ops))
                program._bump_version()
            return program

    @register_pass("fuse_elewise_add_act")
    class FuseElewiseAddActPass(Pass):
        """elementwise_add -> {relu, tanh, sigmoid} (the add's one
        consumer) -> one ``fused_elemwise_activation`` op, as
        ``BuildStrategy.fuse_elewise_add_act_ops`` asks
        (``compiler/ops_fused``). Only trailing-broadcast adds fuse, and
        neither op may be a grad op's forward."""

        def apply(self, program, scope=None):
            from .framework import Operator

            targets = set(_fetch_targets(program) or ())
            block = program.global_block()
            protected = (targets | _outside_reads(program)
                         | _outside_writes(program))
            grad_refed = _grad_referenced_ids(program)
            writes = _write_indices(block)
            consumers = {}
            for op in block.ops:
                for n in set(op.input_names()):
                    consumers.setdefault(n, []).append(op)

            def trailing_broadcast(add):
                xs, ys = add.inputs.get("X", []), add.inputs.get("Y", [])
                if len(xs) != 1 or len(ys) != 1:
                    return False
                axis = add.attrs.get("axis", -1)
                if axis in (-1, None):
                    return True
                xsh = getattr(xs[0], "shape", None)
                ysh = getattr(ys[0], "shape", None)
                if xsh is None or ysh is None:
                    return False
                return axis == len(xsh) - len(ysh)

            fused = 0
            new_ops = list(block.ops)
            for add in block.ops:
                if add.type != "elementwise_add" or add not in new_ops:
                    continue
                if id(add) in grad_refed or not trailing_broadcast(add):
                    continue
                outs = add.output_names("Out")
                if len(outs) != 1 or outs[0] in protected \
                        or len(writes.get(outs[0], ())) != 1:
                    continue
                users = consumers.get(outs[0], [])
                if len(users) != 1 or users[0] not in new_ops:
                    continue
                act = users[0]
                if act.type not in _FUSABLE_ACTS or id(act) in grad_refed:
                    continue
                if act.attrs or act.input_names() != outs:
                    continue
                act_outs = act.output_names("Out")
                if len(act_outs) != 1 \
                        or len(writes.get(act_outs[0], ())) != 1:
                    continue  # a rebinding: moving the def earlier
                fop = Operator(
                    block, "fused_elemwise_activation",
                    inputs={"X": add.inputs["X"], "Y": add.inputs["Y"]},
                    outputs={"Out": act.outputs["Out"],
                             "IntermediateOut": add.outputs["Out"]},
                    attrs={"functor_list": [act.type, "elementwise_add"],
                           "save_intermediate_out": False})
                new_ops[new_ops.index(add)] = fop
                new_ops.remove(act)
                fused += 1
            if fused:
                block.ops = new_ops
                _metrics.counter("compiler/ops_fused").inc(fused)
                program._bump_version()
            return program

    @register_pass("conv_bn_fold_baked")
    class ConvBNFoldBakedPass(Pass):
        """conv2d -> batch_norm(is_test) folded on a compile clone: the
        algebra of ``conv_bn_fold`` (in numpy on the host, as the JAX
        pass computes it), but the folded filter and shift land in fresh
        content-addressed persistables (``bake_value``) the conv is
        rewired to, so the user's program and weights stay as they
        are."""

        def apply(self, program, scope=None):
            if scope is None:
                return program
            import torch

            from .ir import match_chain

            block = program.global_block()
            protected = set(_fetch_targets(program) or ()) \
                | _outside_reads(program)
            changed = False
            for conv, bn in match_chain(block, ("conv2d", "batch_norm")):
                if not bn.attrs.get("is_test", False):
                    continue
                if any(n in protected for n in conv.output_names()):
                    continue
                w_name = conv.input_names("Filter")[0]
                names = [w_name, bn.input_names("Scale")[0],
                         bn.input_names("Bias")[0],
                         bn.input_names("Mean")[0],
                         bn.input_names("Variance")[0]]
                vals = [scope.get(n) for n in names]
                if any(v is None for v in vals):
                    continue
                device = vals[0].device \
                    if isinstance(vals[0], torch.Tensor) else "cpu"
                w, gamma, beta, mean, var = [
                    v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v) for v in vals]
                eps = bn.attrs.get("epsilon", 1e-5)
                factor = gamma / np.sqrt(var + eps)
                w2 = (w * factor.reshape((-1, 1, 1, 1))).astype(w.dtype)
                shift = (beta - mean * factor).astype(w.dtype)
                digest = hashlib.sha1(
                    w2.tobytes() + shift.tobytes()).hexdigest()[:12]
                wf_name = "%s.bnfold.%s" % (w_name, digest)
                bf_name = "%s.bnfold_bias.%s" % (w_name, digest)
                if not block.has_var(wf_name):
                    block.create_var(name=wf_name, shape=w2.shape,
                                     dtype=str(w.dtype), persistable=True)
                if not block.has_var(bf_name):
                    block.create_var(name=bf_name, shape=shift.shape,
                                     dtype=str(shift.dtype),
                                     persistable=True)
                for name, arr in ((wf_name, w2), (bf_name, shift)):
                    t = torch.from_numpy(arr).to(device)
                    scope.set(name, t)
                    bake_value(program, name, t)
                conv.inputs["Filter"] = [block.var(wf_name)]
                conv.inputs["FoldedBias"] = [block.var(bf_name)]
                conv.outputs["Output"] = bn.outputs["Y"]
                block.ops.remove(bn)
                _metrics.counter("compiler/ops_fused").inc()
                changed = True
            if changed:
                program._bump_version()
            return program


_register_builtin_passes()
