"""Automatic mixed precision (parity: the JAX package's ``amp.py``
:88-600: `AutoMixedPrecisionLists`, `AmpConfig`, `active_config`,
`AmpRewritePass`, `AmpOptimizer`, `decorate`).

AMP is a compile-time dtype rewrite: the `amp_rewrite` pass, scheduled by
the pipeline (``ir_passes.build_pipeline``) ahead of constant_fold and
cse, casts the inputs of white-list ops (matmul, attention) to the low
precision dtype (bfloat16 or float16) on the executor's clone of the
program; black-list ops (softmax, norms, reductions, the loss) and every
persistable parameter stay fp32. Grad ops answer with autograd over what
their forward op recorded (``core/lowering.py``), so a low-precision
forward gives low-precision grads with no grad op rewritten; the fp32
param's grad arrives in the low-precision dtype, sums promote, and sgd
updates the fp32 param (the master) in fp32.

`decorate` marks the program (``program._amp_config``); ``PTPU_AMP=1``
activates a default config process-wide (``PTPU_AMP_LEVEL``,
``PTPU_AMP_DTYPE``). Loss scaling is off by default for bfloat16 and
dynamic for float16 (``check_finite_and_unscale`` and
``update_loss_scaling``, as the contrib decorator). Params stored in
bf16 or fp16 get an fp32 master Parameter each, updated by the optimizer
and cast back in the same step.

``BuildStrategy.amp`` (or ``ParallelExecutor(amp=True)``) selects the
same rewrite for a ``compiler.CompiledProgram``.

Gradient bucketing (the JAX package's :602-744): `mb_to_bucket_bytes`,
`bucket_bytes_from_env` (``PTPU_AMP_BUCKET_MB``), `Bucket`,
`plan_buckets`, `flatten_bucket` and `unflatten_bucket`, which
``parallel/zero.py``'s ShardedAdam lays its flat buffers out with. The
data-parallel step does not bucket yet: it all-reduces each grad as its
contribution is written (ROADMAP.md Queue 1b).
"""

import hashlib

import numpy as np

from . import framework, unique_name
from .flags import env as _env
from .framework import convert_dtype, default_startup_program
from .ir import Pass, register_pass
from .observability import metrics as _metrics

__all__ = ["AutoMixedPrecisionLists", "AmpConfig", "AmpOptimizer",
           "decorate", "amp_env_enabled", "active_config",
           "bucket_bytes_from_env", "mb_to_bucket_bytes", "Bucket",
           "plan_buckets", "flatten_bucket", "unflatten_bucket"]

_DEFAULT_BUCKET_MB = 4.0

# white list: matmul-class ops whose fp32 inputs are cast to the low
# precision dtype (their outputs then carry it)
DEFAULT_WHITE_OPS = frozenset({
    "mul", "matmul", "conv2d", "conv3d", "depthwise_conv2d",
    "conv2d_transpose", "conv2d_fusion", "flash_attention",
    "fused_multihead_attention",
})

# black list: numerically sensitive ops pinned to fp32: low-precision
# values reaching them are cast back up first
DEFAULT_BLACK_OPS = frozenset({
    "softmax", "softmax_with_cross_entropy", "cross_entropy",
    "cross_entropy2", "sigmoid_cross_entropy_with_logits",
    "square_error_cost", "huber_loss", "smooth_l1", "log_loss",
    "mean", "sum", "reduce_sum", "reduce_mean", "reduce_prod",
    "reduce_max", "reduce_min",
    "layer_norm", "batch_norm", "group_norm", "instance_norm",
    "exp", "log", "rsqrt", "sqrt", "pow", "softmax_with_upper_triangular",
})


class AutoMixedPrecisionLists:
    """White list computes in the low-precision dtype, black list stays
    fp32, everything else (gray) follows its inputs."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(DEFAULT_WHITE_OPS) | set(custom_white_list
                                                       or ())
        self.black_list = set(DEFAULT_BLACK_OPS) | set(custom_black_list
                                                       or ())
        self.white_list -= self.black_list


class AmpConfig:
    """The AMP policy the `amp_rewrite` pass applies. Level O1: only
    white-list ops compute in low precision, their outputs cast back to
    fp32 before any other consumer. Level O2: low precision also flows
    through gray ops, raised back to fp32 at black-list and structural
    seams."""

    def __init__(self, level="O1", dtype="bfloat16", lists=None):
        level = str(level).upper()
        if level not in ("O1", "O2"):
            raise ValueError("amp_level must be 'O1' or 'O2', got %r"
                             % (level,))
        dtype = convert_dtype(dtype)
        if dtype not in ("bfloat16", "float16"):
            raise ValueError(
                "AMP compute dtype must be bfloat16 or float16, got %r"
                % (dtype,))
        self.level = level
        self.dtype = dtype
        self.lists = lists or AutoMixedPrecisionLists()

    def cache_key(self):
        """Short stable digest for the compile-cache pipeline key (the
        JAX package's)."""
        h = hashlib.sha1()
        h.update(repr((self.level, self.dtype,
                       sorted(self.lists.white_list),
                       sorted(self.lists.black_list))).encode())
        return "%s:%s:%s" % (self.level, self.dtype, h.hexdigest()[:8])


def amp_env_enabled():
    return bool(_env("PTPU_AMP"))


def active_config(program=None, build_strategy=None):
    """The AMP config in effect for one compile, or None. Precedence:
    the program's decoration (`decorate`) > ``BuildStrategy.amp`` (with
    its ``amp_level`` and ``amp_dtype``) > ``PTPU_AMP=1``'s default
    config."""
    cfg = getattr(program, "_amp_config", None) if program is not None \
        else None
    if cfg is not None:
        return cfg
    if build_strategy is not None and getattr(build_strategy, "amp",
                                              False):
        return AmpConfig(
            level=getattr(build_strategy, "amp_level", "O1") or "O1",
            dtype=getattr(build_strategy, "amp_dtype", "bfloat16")
            or "bfloat16")
    if amp_env_enabled():
        return AmpConfig(level=_env("PTPU_AMP_LEVEL"),
                         dtype=_env("PTPU_AMP_DTYPE"))
    return None


@register_pass("amp_rewrite")
class AmpRewritePass(Pass):
    """Insert low-precision casts around white-list ops on the compile
    clone (``amp/casts_inserted``, ``amp/casts_deduped``,
    ``amp/ops_rewritten``). As in the JAX pass:

      - only forward ops are rewritten; grad, optimizer and AMP state
        ops are skipped (a grad op's name wiring is positional per slot,
        so rewiring its forward op's inputs never breaks it);
      - an op's outputs become low precision only when every float
        output is unfetched, singly written and not persistable;
      - parameters are never rewritten in place: the inserted
        ``cast(param)`` is the compute copy, the fp32 original the
        master the optimizer updates;
      - inserted casts are deduped per (source, reaching definition).
    """

    def apply(self, program, scope=None):
        cfg = active_config(program)
        if cfg is None:
            return program
        from .core.lowering import _SPECIAL, _STRUCTURAL
        from .framework import (_AMP_STATE_OP_TYPES, _OPTIMIZER_OP_TYPES,
                                Block, Operator)
        from .ir_passes import (_fetch_targets, _outside_reads,
                                _outside_writes, _write_indices)

        targets = _fetch_targets(program)
        if targets is None:
            # the fetch set is unknown (a standalone apply): rewriting
            # could hand a fetched name a low-precision value
            return program
        block = program.global_block()
        lp = cfg.dtype
        white = cfg.lists.white_list
        black = cfg.lists.black_list
        protected = (set(targets) | _outside_reads(program)
                     | _outside_writes(program))
        writes = _write_indices(block)

        def rdef(name, i):
            last = -1
            for w in writes.get(name, ()):
                if w < i:
                    last = w
                else:
                    break
            return last

        lp_names = set()   # names whose run-time value is low precision
        cast_cache = {}    # (src name, reaching def, dtype) -> Variable
        new_ops = []
        inserted = [0]
        deduped = [0]
        rewritten = 0

        def cast_to(v, i, dtype):
            key = (v.name, rdef(v.name, i), dtype)
            hit = cast_cache.get(key)
            if hit is not None:
                deduped[0] += 1
                return hit
            cv = block.create_var(
                name=unique_name.generate(v.name + "@amp." + dtype),
                shape=v.shape, dtype=dtype, persistable=False)
            new_ops.append(Operator(
                block, "cast", inputs={"X": [v]}, outputs={"Out": [cv]},
                attrs={"in_dtype": v.dtype, "out_dtype": dtype,
                       "__amp_cast__": True}))
            cast_cache[key] = cv
            inserted[0] += 1
            return cv

        def runtime_lp(v):
            return v.name in lp_names or convert_dtype(v.dtype) == lp

        def float_vars(vs_map):
            return [v for vs in vs_map.values() for v in vs
                    if convert_dtype(v.dtype) in ("float32", lp)]

        def out_markable(n):
            v = block._find_var_recursive(n)
            return (n not in protected and len(writes.get(n, ())) == 1
                    and v is not None and not v.persistable
                    and not v.is_data
                    and convert_dtype(v.dtype) in ("float32", lp))

        def force_fp32_inputs(op, i):
            for slot, vs in op.inputs.items():
                op.inputs[slot] = [
                    cast_to(v, i, "float32") if v.name in lp_names else v
                    for v in vs]

        def skip(op):
            return ("__fwd_op__" in op.attrs
                    or op.type in _OPTIMIZER_OP_TYPES
                    or op.type in _AMP_STATE_OP_TYPES
                    or op.attrs.get("__amp_state__")
                    or op.attrs.get("__amp_cast__"))

        def structural(op):
            return (op.type in _STRUCTURAL or op.type in _SPECIAL
                    or any(isinstance(a, (Block, Operator))
                           for a in op.attrs.values()))

        for i, op in enumerate(block.ops):
            if skip(op):
                new_ops.append(op)
                continue
            fouts = [n for n in op.output_names()
                     if convert_dtype(
                         getattr(block._find_var_recursive(n), "dtype",
                                 "int32")) in ("float32", lp)]
            if op.type in white and all(out_markable(n) for n in fouts) \
                    and fouts:
                touched = False
                for slot, vs in op.inputs.items():
                    nvs = []
                    for v in vs:
                        if runtime_lp(v):
                            nvs.append(v)
                            touched = True
                        elif convert_dtype(v.dtype) == "float32":
                            nvs.append(cast_to(v, i, lp))
                            touched = True
                        else:
                            nvs.append(v)
                    op.inputs[slot] = nvs
                if touched:
                    rewritten += 1
                    for n in fouts:
                        lp_names.add(n)
                        block._find_var_recursive(n).dtype = lp
                new_ops.append(op)
                continue
            if op.type in black or structural(op):
                force_fp32_inputs(op, i)
                for n in op.output_names():
                    lp_names.discard(n)
                new_ops.append(op)
                continue
            # gray op
            if cfg.level == "O1":
                force_fp32_inputs(op, i)
                for n in op.output_names():
                    lp_names.discard(n)
            else:
                fins = float_vars(op.inputs)
                if fins and any(runtime_lp(v) for v in fins) \
                        and not all(out_markable(n) for n in fouts):
                    # a protected or rebound output keeps fp32: raise the
                    # inputs back up instead of tracking the name
                    force_fp32_inputs(op, i)
                    for n in op.output_names():
                        lp_names.discard(n)
                elif op.type == "cast":
                    od = convert_dtype(op.attrs.get("out_dtype",
                                                    "float32"))
                    for n in op.output_names():
                        (lp_names.add if od == lp
                         else lp_names.discard)(n)
                elif fins and all(runtime_lp(v) for v in fins):
                    for n in fouts:
                        lp_names.add(n)
                        block._find_var_recursive(n).dtype = lp
                else:
                    for n in op.output_names():
                        lp_names.discard(n)
            new_ops.append(op)

        if not inserted[0] and not rewritten:
            return program
        block.ops = new_ops
        if inserted[0]:
            _metrics.counter("amp/casts_inserted").inc(inserted[0])
        if deduped[0]:
            _metrics.counter("amp/casts_deduped").inc(deduped[0])
        _metrics.counter("amp/ops_rewritten").inc(rewritten)
        program._bump_version()
        return program


class AmpOptimizer:
    """`decorate(...)`'s result: marks the program for `amp_rewrite`,
    scales the loss (dynamic loss scaling where asked) and keeps fp32
    master weights for params stored in bf16 or fp16."""

    def __init__(self, optimizer, config, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                 master_weight=True):
        self._optimizer = optimizer
        self._config = config
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic = bool(use_dynamic_loss_scaling)
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._master_weight = master_weight
        self._loss_scaling = None
        self._overflow_steps = None
        self._masters = {}  # param name -> master Parameter

    def get_loss_scaling(self):
        return self._loss_scaling

    def get_scaled_loss(self):
        return getattr(self, "_scaled_loss", None)

    def _scaling_on(self):
        return self._use_dynamic or self._init_loss_scaling != 1.0

    def _mk_state(self, prog, startup, name, value, dtype="float32"):
        from .initializer import Constant

        vname = unique_name.generate(name)
        v = prog.global_block().create_var(
            name=vname, shape=(1,), dtype=dtype, persistable=True,
            stop_gradient=True)
        sb = startup.global_block()
        sv = sb.create_var(name=vname, shape=(1,), dtype=dtype,
                           persistable=True)
        Constant(value)(sv, sb)
        return v

    def _create_scaling_state(self, prog, startup):
        self._loss_scaling = self._mk_state(prog, startup, "loss_scaling",
                                            self._init_loss_scaling)
        self._good_steps = self._mk_state(prog, startup, "amp_good_steps",
                                          0, "int32")
        self._bad_steps = self._mk_state(prog, startup, "amp_bad_steps",
                                         0, "int32")
        self._overflow_steps = self._mk_state(
            prog, startup, "amp_overflow_steps", 0, "int32")

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        prog = loss.block.program
        prog._amp_config = self._config
        startup = startup_program or default_startup_program()
        self._startup_program = startup
        if self._scaling_on():
            self._create_scaling_state(prog, startup)
            with framework.program_guard(prog, startup):
                from .layers import nn as nn_layers

                loss = nn_layers.elementwise_mul(loss, self._loss_scaling)
        self._scaled_loss = loss
        return self._optimizer.backward(loss, startup_program,
                                        parameter_list, no_grad_set,
                                        callbacks)

    def _unscale(self, prog, params_grads):
        """check_finite_and_unscale, the dynamic update and a cumulative
        overflow counter; all pruned from for_test clones."""
        block = prog.global_block()
        grads = [g for _, g in params_grads]
        found_inf = block.create_var(
            name=unique_name.generate("amp_found_inf"), dtype="bool",
            shape=(1,))
        unscaled = [block.create_var(name=g.name + "@UNSCALED",
                                     dtype=g.dtype, shape=g.shape)
                    for _, g in params_grads]
        block.append_op(
            type="check_finite_and_unscale",
            inputs={"X": grads, "Scale": [self._loss_scaling]},
            outputs={"Out": unscaled, "FoundInfinite": [found_inf]})
        if self._use_dynamic:
            block.append_op(
                type="update_loss_scaling",
                inputs={"PrevLossScaling": [self._loss_scaling],
                        "InGoodSteps": [self._good_steps],
                        "InBadSteps": [self._bad_steps],
                        "FoundInfinite": [found_inf]},
                outputs={"LossScaling": [self._loss_scaling],
                         "OutGoodSteps": [self._good_steps],
                         "OutBadSteps": [self._bad_steps]},
                attrs={"incr_every_n_steps": self._incr_every_n_steps,
                       "decr_every_n_nan_or_inf":
                           self._decr_every_n_nan_or_inf,
                       "incr_ratio": self._incr_ratio,
                       "decr_ratio": self._decr_ratio})
        inc = block.create_var(name=unique_name.generate("amp_ovf_inc"),
                               dtype="int32", shape=(1,))
        block.append_op(type="cast", inputs={"X": [found_inf]},
                        outputs={"Out": [inc]},
                        attrs={"in_dtype": "bool", "out_dtype": "int32",
                               "__amp_state__": True})
        block.append_op(type="elementwise_add",
                        inputs={"X": [self._overflow_steps], "Y": [inc]},
                        outputs={"Out": [self._overflow_steps]},
                        attrs={"__amp_state__": True})
        return [(p, ug) for (p, _), ug in zip(params_grads, unscaled)]

    def _master_for(self, prog, p):
        """fp32 master Parameter of a low-precision-stored param,
        initialized from it by a cast appended to the startup program."""
        m = self._masters.get(p.name)
        if m is not None:
            return m
        m = prog.global_block().create_parameter(
            shape=tuple(p.shape), dtype="float32", name=p.name + ".master",
            trainable=False)
        m.optimize_attr = dict(p.optimize_attr or {"learning_rate": 1.0})
        m.regularizer = None
        startup = getattr(self, "_startup_program", None) \
            or default_startup_program()
        sb = startup.global_block()
        if sb.has_var(p.name):
            sv = sb.create_var(name=m.name, shape=tuple(p.shape),
                               dtype="float32", persistable=True)
            sb.append_op(type="cast", inputs={"X": [sb.var(p.name)]},
                         outputs={"Out": [sv]},
                         attrs={"in_dtype": p.dtype,
                                "out_dtype": "float32"})
        self._masters[p.name] = m
        return m

    def apply_gradients(self, params_grads):
        if not params_grads:
            return self._optimizer.apply_gradients(params_grads)
        prog = params_grads[0][0].block.program
        block = prog.global_block()
        if self._scaling_on():
            with framework.program_guard(prog):
                params_grads = self._unscale(prog, params_grads)
        low_prec = []
        routed = []
        for p, g in params_grads:
            if self._master_weight and convert_dtype(p.dtype) in (
                    "bfloat16", "float16"):
                master = self._master_for(prog, p)
                low_prec.append((p, master))
                routed.append((master, g))
            else:
                routed.append((p, g))
        ops = self._optimizer.apply_gradients(routed)
        for p, master in low_prec:
            # re-derive the low-precision copy from the updated master in
            # the same step; pruned from for_test clones
            block.append_op(type="cast", inputs={"X": [master]},
                            outputs={"Out": [p]},
                            attrs={"in_dtype": "float32",
                                   "out_dtype": p.dtype,
                                   "__amp_state__": True})
        return ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program,
                                     parameter_list, no_grad_set)
        optimize_ops = self.apply_optimize(loss, startup_program,
                                           params_grads)
        return optimize_ops, params_grads

    def record_metrics(self, scope=None):
        """Publish the loss-scaling state as ``amp/loss_scale`` and
        ``amp/overflow_steps`` gauges and return it as a dict. Reads the
        scope on the host: call it at a sync point, not every step."""
        from .core.scope import global_scope

        scope = scope if scope is not None else global_scope()
        out = {}
        if self._loss_scaling is not None:
            v = scope.get(self._loss_scaling.name)
            if v is not None:
                out["loss_scale"] = float(np.asarray(
                    v.detach().cpu()).reshape(()))
                _metrics.gauge("amp/loss_scale").set(out["loss_scale"])
        if self._overflow_steps is not None:
            v = scope.get(self._overflow_steps.name)
            if v is not None:
                out["overflow_steps"] = int(np.asarray(
                    v.detach().cpu()).reshape(()))
                _metrics.gauge("amp/overflow_steps").set(
                    out["overflow_steps"])
        return out


def decorate(optimizer, amp_lists=None, amp_level="O1", dtype="bfloat16",
             init_loss_scaling=None, use_dynamic_loss_scaling=None,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.5, master_weight=True):
    """Wrap `optimizer` for mixed-precision training. Defaults follow the
    dtype: bfloat16 shares fp32's exponent range, so loss scaling is off
    (a static scale of 1); float16 turns dynamic loss scaling on at
    2**15."""
    cfg = AmpConfig(level=amp_level, dtype=dtype, lists=amp_lists)
    f16 = cfg.dtype == "float16"
    if use_dynamic_loss_scaling is None:
        use_dynamic_loss_scaling = f16
    if init_loss_scaling is None:
        init_loss_scaling = 2.0 ** 15 if f16 else 1.0
    return AmpOptimizer(optimizer, cfg, init_loss_scaling,
                        use_dynamic_loss_scaling, incr_every_n_steps,
                        decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                        master_weight=master_weight)


# ---------------------------------------------------------------------------
# gradient bucketing (Megatron-LM DDP parity)
# ---------------------------------------------------------------------------


def mb_to_bucket_bytes(mb):
    """MiB -> bytes under the one shared convention: 0 is the documented
    off switch (None = bucketing disabled). NaN and negative sizes raise
    here, at the knob, so a mistyped $PTPU_AMP_BUCKET_MB never reaches
    plan_buckets as a NaN capacity."""
    mb = float(mb)
    if np.isnan(mb) or mb < 0:
        raise ValueError(
            "bucket size %r MiB is not a valid capacity (use a positive "
            "number of MiB, or 0 to disable bucketing)" % (mb,))
    return int(mb * (1 << 20)) if mb > 0 else None


def bucket_bytes_from_env(default_mb=_DEFAULT_BUCKET_MB):
    """Bucket size in BYTES from $PTPU_AMP_BUCKET_MB (None = bucketing
    not requested when `default_mb` is None)."""
    try:
        mb = _env("PTPU_AMP_BUCKET_MB")
    except ValueError as exc:
        raise ValueError(
            "PTPU_AMP_BUCKET_MB is not a usable bucket size: %s" % (exc,))
    if mb is not None:
        try:
            return mb_to_bucket_bytes(mb)
        except ValueError as exc:
            raise ValueError(
                "PTPU_AMP_BUCKET_MB=%r is not a usable bucket size: %s"
                % (mb, exc))
    if default_mb is None:
        return None
    return mb_to_bucket_bytes(default_mb)


class Bucket:
    """One flattened same-dtype gradient bucket: leaf indices, their
    flat sizes and offsets, and the padded total length. `segment` is
    the bucket's place in the planned issue order: under backward-order
    planning segment 0 is the bucket whose gradients the backward pass
    produces FIRST, the first collective the overlap chain may issue."""

    __slots__ = ("indices", "sizes", "offsets", "size", "padded", "dtype",
                 "segment")

    def __init__(self, dtype):
        self.indices = []
        self.sizes = []
        self.offsets = []
        self.size = 0
        self.padded = 0
        self.dtype = dtype
        self.segment = None

    def nbytes(self):
        return self.padded * _dtype_itemsize(self.dtype)


def _dtype_itemsize(dtype):
    import torch

    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if "bfloat16" in str(dtype):
        return 2
    return np.dtype(dtype).itemsize


def plan_buckets(leaves, bucket_bytes, pad_multiple=1, dtype=None,
                 order="forward"):
    """Group `leaves` (tensors, or anything with .shape and .dtype) into
    flattened buckets of at most `bucket_bytes` each (a single leaf
    larger than the cap gets its own bucket), grouped by collective
    dtype and padded to a multiple of `pad_multiple` elements. `dtype`
    forces one collective dtype for every bucket (e.g. bf16 gradients);
    None groups by each leaf's own dtype.

    `order` is the issue order the plan encodes (Bucket.segment):
    "forward" walks the leaves in tree order; "backward" walks them
    reversed, so bucket/segment 0 holds the LAST leaves, whose gradients
    the backward pass produces first: the order the overlap chain issues
    its collectives in. Records the amp/bucket_bytes gauge and the
    amp/buckets counter."""
    bb = float(bucket_bytes) if bucket_bytes is not None else float("nan")
    if np.isnan(bb) or bb <= 0:
        raise ValueError(
            "plan_buckets: bucket_bytes=%r is not a positive capacity "
            "(check bucket_mb / $PTPU_AMP_BUCKET_MB)" % (bucket_bytes,))
    if order not in ("forward", "backward"):
        raise ValueError("plan_buckets: unknown order %r" % (order,))
    groups = {}
    out = []
    walk = (reversed(list(enumerate(leaves))) if order == "backward"
            else enumerate(leaves))
    for i, leaf in walk:
        dt = dtype if dtype is not None else leaf.dtype
        size = int(np.prod(tuple(leaf.shape), dtype=np.int64))
        item = _dtype_itemsize(dt)
        bs = groups.setdefault(str(dt), [])
        if not bs or (bs[-1].size
                      and (bs[-1].size + size) * item > bucket_bytes):
            b = Bucket(dt)
            bs.append(b)
            out.append(b)
        b = bs[-1]
        b.indices.append(i)
        b.offsets.append(b.size)
        b.sizes.append(size)
        b.size += size
    for seg, b in enumerate(out):
        b.segment = seg
        b.padded = b.size + (-b.size) % max(int(pad_multiple), 1)
    total = sum(b.nbytes() for b in out)
    _metrics.gauge("amp/bucket_bytes").set(total)
    _metrics.counter("amp/buckets").inc(len(out))
    return out


def flatten_bucket(bucket, leaves, dtype=None, device=None):
    """The bucket's leaves in one padded 1-D tensor in the bucket's
    collective dtype (`dtype` overrides it, e.g. fp32 for the master
    parameters sharing a gradient bucket's layout): each leaf written at
    its offset, cast on the copy, and the pad zeroed. A None leaf (a
    grad the loss never produced) is written as zeros. `device` defaults
    to the first present leaf's."""
    import torch

    present = [leaves[i] for i in bucket.indices if leaves[i] is not None]
    if device is None:
        device = present[0].device if present else "cpu"
    out = torch.empty(bucket.padded, dtype=dtype or bucket.dtype,
                      device=device)
    for i, off, sz in zip(bucket.indices, bucket.offsets, bucket.sizes):
        if leaves[i] is None:
            out[off:off + sz].zero_()
        else:
            out[off:off + sz].copy_(leaves[i].detach().reshape(-1))
    out[bucket.size:].zero_()
    return out


def unflatten_bucket(bucket, flat, like_leaves):
    """{leaf index: tensor} re-slicing `flat` back into the bucket's
    leaves, shaped like (and cast to the dtype of) `like_leaves`: views
    of `flat` where the dtype already matches."""
    out = {}
    for i, off, sz in zip(bucket.indices, bucket.offsets, bucket.sizes):
        ref = like_leaves[i]
        out[i] = flat[off:off + sz].view(tuple(ref.shape)).to(ref.dtype)
    return out
