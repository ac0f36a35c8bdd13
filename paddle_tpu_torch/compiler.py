"""CompiledProgram (parity: the JAX package's ``compiler.py``:
`ExecutionStrategy` :32, `BuildStrategy` :42-106,
`classify_persistable_state` :109, `read_persistable_state` :149,
`normalize_feed_value` :172, `grad_seed_scale_of` :210,
`CompiledProgram` :228 and `_DataParallelStep` :433). The state plan
(`classify_persistable_state`, `read_persistable_state`) is the
executor's, shared with its step and re-exported here.

The JAX package jits the same program once over a ``dp`` mesh and GSPMD
inserts the collectives, so a data-parallel step gives what one device
gives on the global batch. The port runs one process a rank
(``parallel/mesh.py``: NCCL on the card, gloo on the CPU) and keeps that
contract by hand:

- every rank is handed the same global batch and takes its contiguous
  block of rows of each feed whose leading dim divides by the world
  size; a feed that does not divide is used whole on every rank;
- ``parallel/planner.plan_batch`` marks every var batch-sharded or
  replicated and gives each op that reads a batch-sharded var its
  op type's rule (``ops/registry.DpRule``), refusing at plan time an op
  that has none;
- a batch reduction (mean, reduce_*, batch_norm's statistics, accuracy,
  auc) all-reduces its partial sums and finishes on the global value;
  a replicated operand that enters the sharded region has its grad
  all-reduced in backward (``parallel/collective.py``), so every
  replicated var's grad is whole and the same on every rank, and the
  optimizer runs on each rank as on one device;
- a fetched batch-sharded var is all-gathered; a replicated one comes
  back as it is.

`BuildStrategy.gradient_scale_strategy` follows `grad_seed_scale_of`
(the replicas are the data line's ranks).

The planner's model parallelism runs on a (dp, tp) mesh
(``parallel/mesh.fluid_mesh``: rank = d·tp + t, the JAX mesh's layout):

- ``tensor_parallel_degree = tp`` gives the program the JAX planner's
  specs (``parallel/planner.plan_program``: the Megatron walk,
  ``ParamAttr.shard_spec`` and ``BuildStrategy.sharding_specs``); every
  rank of a dp line takes that line's rows of the batch, and each op
  that reads a tp-sharded var runs on the rank's shard under its
  ``TpRule`` (``ops/tp.py``), or gathers it (a seam);
- ``ReduceStrategy.Reduce`` is the planner's ZeRO-1: each rank keeps
  only its dp rows of each optimizer-state var the plan shards over dp,
  updates those rows of the parameter and all-gathers them over the
  data line. Grads stay whole, all-reduced over dp as under AllReduce,
  so the global-norm clip and the AMP unscale read whole grads;
- on its first run the step cuts each such persistable in the scope to
  this rank's shard (the memory the feature buys);
  `gather_persistables` gives the whole values back (every rank must
  call it), and ``io.save_persistables`` of a scope holding shards
  raises;
- a fetched tp-sharded var is all-gathered over tp, a batch-sharded
  one also over dp.

``pipeline_stages = pp`` above 1 runs the program's 1F1B pipeline
(``parallel/pipeline_program.py``) on the (dp, pp, tp) mesh
(``parallel/mesh.fluid_mesh``: rank = (d·pp + p)·tp + t), composed with
tensor parallelism and ZeRO-1; its step runs the program unoptimized, as
the JAX package's does (fused ops would change the stage split), and its
compile key carries no pass-pipeline key.
``sequence_parallel_degree`` above 1 raises: the JAX package runs it
through a module the port does not have yet (ROADMAP.md Queue 1 item 9).

The data-parallel and pipelined runs carry the executor's telemetry
(``step_scope``, the ``optimize`` / ``lower`` / ``compile`` /
``execute`` spans, ``compile_cache/hit|miss``,
``executor/feed_bytes|fetch_bytes``); the other runs go through
``Executor.run``, which carries it.
"""

import numpy as np
import torch

from . import framework, ir_passes
from . import observability as _observability
from .executor import (_feed_signature, _Step, check_feed_int64,
                       classify_persistable_state, note_run_bytes,
                       read_persistable_state, run_step)
from .observability import metrics as _metrics
from .observability import tracing as _tracing

__all__ = ["BuildStrategy", "CompiledProgram", "ExecutionStrategy",
           "classify_persistable_state", "cut_to_layout",
           "gather_persistables",
           "grad_seed_scale_of", "normalize_feed_value",
           "read_persistable_state"]

_ITEM_9 = "(ROADMAP.md Queue 1 item 9)"


class ExecutionStrategy:
    """The knobs of Fluid's ExecutionStrategy, kept for source
    compatibility (the port's step runs its ops in program order on one
    stream a rank)."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.use_thread_barrier = False


class BuildStrategy:
    """The JAX package's BuildStrategy, knob for knob and default for
    default."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""
        self.enable_sequential_execution = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_all_reduce_ops = True
        self.fuse_broadcast_ops = False
        self.memory_optimize = True
        self.enable_inplace = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0
        # the JAX package's extensions: the (dp, pp, tp) mesh, the
        # planner's specs and the pipeline's knobs
        # (parallel/pipeline_program.py); sequence_parallel_degree above
        # 1 raises, naming ROADMAP.md Queue 1 item 9
        self.tensor_parallel_degree = 1
        self.sharding_specs = {}
        self.pipeline_stages = 1
        self.pipeline_microbatches = None
        self.pipeline_virtual_stages = 1
        self.pipeline_activation_stash = False
        self.sequence_parallel_degree = 1
        # the amp_rewrite pass for this compiled program (amp.py)
        self.amp = False
        self.amp_level = "O1"
        self.amp_dtype = "bfloat16"


def check_build_strategy(bs):
    """Raise on the knobs whose modules the port does not have yet."""
    for knob in ("sequence_parallel_degree",):
        if int(getattr(bs, knob, 1) or 1) > 1:
            raise NotImplementedError(
                "BuildStrategy.%s = %s is not ported %s"
                % (knob, getattr(bs, knob), _ITEM_9))


def normalize_feed_value(block, name, arr):
    """A feed as the step takes it: a tensor as it is, a host value as
    numpy (the step casts both to the var's declared dtype). int64 ids
    above the int32 range of an int32 var raise here, on the global
    batch every rank holds, before any rank takes its rows."""
    if not isinstance(arr, torch.Tensor):
        arr = np.asarray(arr)
    v = block._find_var_recursive(name)
    if v is not None and v.shape is not None:
        t = arr if isinstance(arr, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(arr))
        check_feed_int64(name, t, framework.torch_dtype(v.dtype))
    return arr


def grad_seed_scale_of(build_strategy, n_replicas):
    """GradientScaleStrategy -> the backward seed's factor:
    CoeffNumDevice 1 (the global batch's mean gradient), One the number
    of replicas (gradients summed over per-replica means), Customized
    raises."""
    gss = getattr(build_strategy, "gradient_scale_strategy",
                  BuildStrategy.GradientScaleStrategy.CoeffNumDevice)
    if gss == BuildStrategy.GradientScaleStrategy.Customized:
        raise NotImplementedError(
            "GradientScaleStrategy.Customized is not supported: the "
            "TPU lowering computes exact global-batch gradients in one "
            "program, so there is no per-device seed var to customize. "
            "Scale the loss in the program instead (CoeffNumDevice = "
            "exact mean semantics, One = gradients scaled by "
            "num-devices).")
    return (float(n_replicas)
            if gss == BuildStrategy.GradientScaleStrategy.One else 1.0)


def _fetch_names(fetch_list):
    return [v.name if isinstance(v, framework.Variable) else str(v)
            for v in (fetch_list or [])]


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._is_data_parallel = False
        self._loss_name = None
        self._places = None
        self._exec_strategy = None
        self._share_vars_from = None
        self._compiled_steps = {}
        self._infer_opt = False
        # inference-optimized clones of the non-data-parallel path,
        # keyed by (program version, fetch names)
        self._infer_programs = {}

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._share_vars_from = share_vars_from
        self._places = places
        return self

    def with_inference_optimize(self, config):
        """Opt into the inference pass pipeline (dropout_remove,
        conv_bn_fold_baked and conv_elementwise_add_fuse on top of the
        default passes); ``config.switch_ir_optim(False)`` opts out."""
        self._infer_opt = bool(getattr(config, "_ir_optim", True))
        return self

    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        from .core.scope import global_scope
        from .parallel.mesh import fluid_mesh, init_data_group

        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list)
        if not self._is_data_parallel:
            run_program = self._program
            if self._infer_opt and ir_passes.pipeline_enabled():
                ikey = (self._program.version, tuple(fetch_names))
                run_program = self._infer_programs.get(ikey)
                if run_program is None:
                    run_program = ir_passes.optimize_for_execution(
                        self._program, fetch_names, scope,
                        executor.device, infer_opt=True)
                    self._infer_programs[ikey] = run_program
            return executor.run(run_program, feed=feed,
                                fetch_list=fetch_list, scope=scope,
                                return_numpy=return_numpy)
        check_build_strategy(self._build_strategy)
        group = init_data_group(executor.device)
        tp_group = mesh = None
        tp = int(getattr(self._build_strategy, "tensor_parallel_degree", 1)
                 or 1)
        pp = int(getattr(self._build_strategy, "pipeline_stages", 1) or 1)
        if tp > 1 or pp > 1:
            mesh = fluid_mesh(tp, executor.device, pp)
            group, tp_group = mesh.group("dp"), mesh.group("tp")
        if executor.device != group.device:
            raise RuntimeError(
                "this rank's data-parallel step runs on %s, but the "
                "executor is on %s: make the executor on the rank's "
                "device (fluid.ParallelExecutor does)"
                % (group.device, executor.device))
        block = self._program.global_block()
        feed = {k: normalize_feed_value(block, k, v)
                for k, v in (feed or {}).items()}
        # a pipelined step runs the program unoptimized: its key carries
        # no pass-pipeline key
        key = (self._program.version, _feed_signature(feed),
               tuple(fetch_names),
               ir_passes.pipeline_key(self._build_strategy, self._program,
                                      self._infer_opt) if pp == 1 else ())
        keep = ()
        if executor._prefetcher is not None:
            staged = executor._prefetcher.take_if_match(feed)
            if staged is not None:
                feed = staged.consume(executor.device)
                keep = staged.pinned
        rec = _metrics.enabled()
        with _observability.step_scope():
            step = self._compiled_steps.get(key)
            fresh = step is None
            if fresh:
                if rec:
                    _metrics.counter("compile_cache/miss").inc()
                run_program = self._program
                if pp == 1 and ir_passes.pipeline_enabled():
                    with _tracing.span("optimize"):
                        run_program = ir_passes.optimize_for_execution(
                            self._program, fetch_names, scope,
                            executor.device,
                            build_strategy=self._build_strategy,
                            infer_opt=self._infer_opt)
                with _tracing.span("lower"):
                    if pp > 1:
                        from .parallel.pipeline_program import \
                            PipelineProgramStep

                        step = PipelineProgramStep(
                            run_program,
                            {k: tuple(np.shape(v)) for k, v in feed.items()},
                            fetch_names, mesh, self._build_strategy,
                            self._loss_name)
                    else:
                        step = _DataParallelStep(
                            run_program,
                            {k: tuple(np.shape(v)) for k, v in feed.items()},
                            fetch_names, group, self._build_strategy,
                            tp_group)
                self._compiled_steps[key] = step
            elif rec:
                _metrics.counter("compile_cache/hit").inc()
            fetches = run_step(step, fresh, scope, feed, executor.device)
        if rec:
            note_run_bytes(feed, fetches)
        return executor._finish_run(fetches, return_numpy, keep)


class _DataParallelStep(_Step):
    """One rank's step of the program on the global batch: the executor's
    step (`_Step`: state plan, recorded forwards, memory plan) with the
    sharding plan (`_plan`, the JAX planner's), the batch and tp plan
    (`plan`, ``parallel/planner.plan_batch``), the data line `group` and
    the tp line `tp_group` (None without tensor parallelism). It
    changes the executor's step only through its hooks: the persistables
    cut to the rank's shards on the first run, the rank's rows of each
    sharded feed, the lines in the lowering context, and a sharded fetch
    gathered into its global value."""

    def __init__(self, program, feed_shapes, fetch_names, group,
                 build_strategy, tp_group=None):
        from .parallel.planner import plan_batch, plan_program, state_layout

        bs = build_strategy or BuildStrategy()
        inplace = None
        if ir_passes.pipeline_enabled():
            inplace = ir_passes.InplaceInfo(
                enabled=bool(getattr(bs, "enable_inplace", True)))
        super().__init__(program, feed_shapes.keys(), fetch_names,
                         inplace=inplace)
        self.group = group
        self.tp_group = tp_group
        tp = tp_group.world if tp_group is not None else 1
        self._grad_seed_scale = grad_seed_scale_of(bs, group.world)
        self.sharded_feeds = sorted(
            n for n, shape in feed_shapes.items()
            if len(shape) and shape[0] % group.world == 0)
        zero_mode = getattr(bs, "reduce_strategy", 0) \
            == BuildStrategy.ReduceStrategy.Reduce
        axes = {"dp": group.world}
        if tp > 1:
            axes["tp"] = tp
        self._plan = plan_program(program, axes, bs, zero_sharding=zero_mode)
        self.layout, self.zero = state_layout(program, self._plan, tp,
                                              group.world)
        rows = next((shape[0] for n, shape in sorted(feed_shapes.items())
                     if len(shape)), None)
        self.plan = plan_batch(program, self.sharded_feeds, group.world,
                               tp=tp, layout=self.layout, zero=self.zero,
                               rows=rows)

    def expected_collectives(self):
        """(all-reduce calls, bytes) the plan predicts for one step over
        the data line."""
        return self.plan.expected(self.block)

    def expected_tp(self):
        """{count key: (calls, bytes)} the plan predicts for one step
        over the tp line, and ZeRO-1's gathers over the data line."""
        return self.plan.expected_tp()

    def _local_feed(self, name, value):
        from .ops.dp import rows

        if name not in self.sharded_feeds:
            return value
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value))
        return rows(value, self.group)

    def _setup(self, ctx):
        ctx.dp = self.group
        ctx.dp_ops = self.plan.ops
        ctx.grad_seed_scale = self._grad_seed_scale
        ctx.tp = self.tp_group
        ctx.tp_ops = self.plan.tp_ops

    def _fetch(self, name, value):
        from .parallel.collective import _gather, all_gather_rows

        if name in self.zero:
            value = _gather(value, self.group, 0, kind="gather_state")
        d = self.plan.tp_marks.get(name)
        if d is not None:
            value = _gather(value.detach(), self.tp_group, d,
                            kind="gather_state")
        if self.plan.marks.get(name):
            return all_gather_rows(value, self.group)
        return value

    def _check_held(self, held):
        """Refuse a scope holding shards this step reads whole (another
        step's layout); the shards of this step's layout `cut_to_layout`
        checks."""
        mine = set(self.layout) | self.zero
        super()._check_held({n: h for n, h in held.items()
                             if n not in mine})

    def run(self, scope, feed, device):
        if self.layout or self.zero:
            cut_to_layout(scope, self.block, self.layout, self.zero,
                          self.group, self.tp_group)
        return super().run(scope, feed, device)


def cut_to_layout(scope, block, layout, zero, group, tp_group):
    """Cut each sharded persistable the scope holds whole into this
    rank's shard (its tp block of `layout`'s dim over `tp_group`, then
    its `group` rows of the ZeRO-1 state `zero`)."""
    from .ops.dp import rows
    from .parallel.collective import local_part

    shards = _shards(scope)
    for name in sorted(set(layout) | zero):
        t = scope.get(name)
        v = block._find_var_recursive(name)
        if t is None or v is None:
            continue
        d = layout.get(name)
        want = (d, name in zero, group, tp_group)
        whole = tuple(v.shape)
        if tuple(t.shape) != whole:
            if shards.get(name) == want:
                continue
            raise RuntimeError(
                "the scope's %r has shape %s: neither the whole %s "
                "nor this step's shard of it (held as %r)"
                % (name, tuple(t.shape), whole, shards.get(name)))
        if d is not None:
            t = local_part(t, tp_group, d)
        if name in zero:
            t = rows(t, group)
        scope.set(name, t.contiguous().clone())
        shards[name] = want


def _shards(scope):
    """{var name: (tp dim, ZeRO rows, data line, tp line)} of the
    persistables `scope` holds as this rank's shards."""
    if not hasattr(scope, "_ptpu_shards"):
        scope._ptpu_shards = {}
    return scope._ptpu_shards


def gather_persistables(scope, names=None):
    """{name: whole tensor} of the persistables `scope` holds (`names`,
    default all that a sharded step cut, gathered over their lines; a
    var held whole comes back as it is). Collective: every rank of the
    mesh must call it with the same names."""
    from .parallel.collective import _gather

    shards = _shards(scope)
    out = {}
    for name in (sorted(shards) if names is None else names):
        t = scope.get(name)
        held = shards.get(name)
        if held is not None:
            d, zero, group, tp_group = held
            if zero:
                t = _gather(t, group, 0, kind="gather_state")
            if d is not None:
                t = _gather(t, tp_group, d, kind="gather_state")
        out[name] = t
    return out
