"""Any-program pipeline parallelism through ``CompiledProgram`` (parity:
the JAX package's ``parallel/pipeline_program.py``: `split_sections` :68,
`_is_backward_op` :64, `_op_cost` :86, `assign_stages` :116 and
`PipelineProgramStep` :334):

    strategy = BuildStrategy()
    strategy.pipeline_stages = 4            # pp axis size
    strategy.pipeline_microbatches = 8      # defaults to pp
    CompiledProgram(prog).with_data_parallel(loss_name=..., build_strategy=strategy)

The analysis is the JAX package's, function for function: the program's
ops are [forward | backward | optimizer]; the forward section is split
into pp·v contiguous virtual stages, by ``fluid.pipeline_stage(i)``
stamps or by the balanced cumulative-FLOP split; the dataflow gives each
cut its crossing vars; the scalar fetches, the raises and the
post-section check follow it.

The JAX package runs the 1F1B schedule as one ``shard_map`` scan over the
(dp, pp, tp) mesh, every rank tracing every stage as a ``lax.switch``
branch, and takes each stage's grads from ``jax.vjp`` of its lowered
forward. The port runs one process a rank (``parallel/mesh.fluid_mesh``,
rank = (d·pp + p)·tp + t) and its own rows of the tables of
``pipeline_schedule.py``: virtual stage s lives on rank s % pp; a tick
runs at most one forward unit and one backward unit, skips a no-op
unit, and ends with one ``batch_isend_irecv`` on the pp line (a wire sent
at tick t is read at t + 1; ``collective.send_recv``, the call counted
under "pp_p2p", its bytes under "pp_fwd" for activations and "pp_bwd"
for cotangents). Each wire goes in its own dtype; the first wire of each
cut is preceded by its layout (shapes and dtypes, counted under
"pp_layout"), the receiver's buffers made from it. With tracing on
(``observability.tracing``) the units, the exchanges and the update are
the spans "pp/fwd", "pp/bwd", "pp/p2p" and "pp/update", so a profiled
step gives the card's time in each.

The backward is the port's own (``core/lowering.py``): the backward unit
of stage s runs the program's grad ops whose ``__fwd_op__`` lies in
stage s, in program order (the loss seed with the loss's stage), after
seeding the arrived cotangent under the grad names of the cut's crossing
vars, and then reads the grads of its input wire out and sends them
back. An accumulating grad op sums into the seeded cotangent, so a
residual that spans a cut, a sum of grads and a param read in two stages
come out as in one backward. Without ``pipeline_activation_stash`` a
forward unit keeps only its input wire and the backward unit re-runs the
stage's forward from it with recording on (each forward op twice a
microbatch); with it the forward unit records, and its records live
until that microbatch's backward unit. Stateful ops draw from
generators that mix in the microbatch (`LoweringContext.stream`), so
both runs of a forward draw the same masks.

The backward seed of each microbatch is ``grad_seed_scale_of(bs, dp) /
(M·dp)``; a rank sums its units' param grads over the microbatches in
fp32, the sums (and the scalar fetches') are summed over the ("dp",
"pp") union, cast to each grad var's dtype, and the post section (the
optimizer, clip, regularizer and lr ops) runs once, unchanged, on every
rank, so each rank's scope is whole after a step. A scalar forward fetch
is the mean over the M·dp microbatches of each microbatch's value (as
its stage computed it, in fp32) cast to the var's declared dtype, as in
the JAX step. Tensor parallelism runs each stage's ops under the plan's
`TpRule` (``ops/tp.py``) as the data-parallel step does, and
``ReduceStrategy.Reduce`` is its ZeRO-1 over the data line.
"""

import os

import numpy as np
import torch

from ..core.lowering import LoweringContext, execute_op
from ..framework import torch_dtype
from ..observability import tracing as _tracing

__all__ = ["PipelineProgramStep", "split_sections", "assign_stages"]


# ---------------------------------------------------------------------------
# program analysis
# ---------------------------------------------------------------------------


def _is_backward_op(op):
    return "__fwd_op__" in op.attrs or op.attrs.get("__op_role__") == "backward"


def split_sections(block):
    """(fwd_ops, post_ops): forward ops before the first backward op, and
    the non-backward tail (optimizer / clip / regularizer / lr ops)."""
    ops = block.ops
    bwd = next((i for i, op in enumerate(ops) if _is_backward_op(op)), None)
    if bwd is None:
        return list(ops), []
    return list(ops[:bwd]), [op for op in ops[bwd:] if not _is_backward_op(op)]


def _numel(shape):
    n = 1
    for d in shape or ():
        if d is not None and d > 0:
            n *= d
    return n


def _op_cost(op):
    """Relative FLOP estimate for stage balancing. Static shapes with the
    batch dim as -1 are fine: only the ratio between ops matters."""
    sub_cost = 0.0
    for key in ("sub_block", "true_block", "false_block"):
        sub = op.attrs.get(key) if op.attrs else None
        if sub is not None and getattr(sub, "ops", None) is not None:
            sub_cost += sum(_op_cost(o) for o in sub.ops)
    out_n = sum(_numel(v.shape) for vs in op.outputs.values() for v in vs
                if v.shape is not None)
    t = op.type
    if t in ("mul", "matmul"):
        ys = op.inputs.get("Y", [])
        k = 1
        if ys and ys[0].shape and len(ys[0].shape) >= 2:
            k = max(1, ys[0].shape[-2] or 1)
        return sub_cost + 2.0 * out_n * k
    if t in ("conv2d", "depthwise_conv2d", "conv3d"):
        fs = op.inputs.get("Filter", [])
        k = _numel(fs[0].shape[1:]) if fs and fs[0].shape else 1
        return sub_cost + 2.0 * out_n * k
    if t == "flash_attention":
        qs = op.inputs.get("Q", [])
        seq = 1
        if qs and qs[0].shape and len(qs[0].shape) >= 2:
            seq = max(1, qs[0].shape[1] or 1)
        return sub_cost + 4.0 * out_n * seq
    return sub_cost + float(out_n)


def assign_stages(fwd_ops, pp):
    """Stage id per forward op: the `__pipeline_stage__` stamps of
    `fluid.pipeline_stage(i)` when there are any (an unstamped op takes
    the stamp before it), else the minimax contiguous split of the
    cumulative cost into exactly pp non-empty stages."""
    stamped = [op.attrs.get("__pipeline_stage__") for op in fwd_ops]
    if any(s is not None for s in stamped):
        stages, cur = [], 0
        for i, s in enumerate(stamped):
            if s is not None:
                s = int(s)
                if s < cur:
                    raise ValueError(
                        "pipeline_stage annotations must be non-decreasing "
                        "in program order: op #%d (%s) is stage %d after "
                        "stage %d" % (i, fwd_ops[i].type, s, cur))
                cur = s
            if cur >= pp:
                raise ValueError(
                    "pipeline_stage %d out of range for pipeline_stages=%d"
                    % (cur, pp))
            stages.append(cur)
        return stages
    costs = [_op_cost(op) for op in fwd_ops]
    n = len(costs)
    if n < pp:
        raise ValueError(
            "cannot split %d forward ops into %d pipeline stages — "
            "reduce pipeline_stages/pipeline_virtual_stages" % (n, pp))
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    inf = float("inf")
    best = [[inf] * (n + 1) for _ in range(pp + 1)]
    cut = [[0] * (n + 1) for _ in range(pp + 1)]
    best[0][0] = 0.0
    for k in range(1, pp + 1):
        for j in range(k, n - (pp - k) + 1):
            for i in range(k - 1, j):
                v = max(best[k - 1][i], prefix[j] - prefix[i])
                if v < best[k][j]:
                    best[k][j] = v
                    cut[k][j] = i
    bounds = [n]
    j = n
    for k in range(pp, 0, -1):
        j = cut[k][j]
        bounds.append(j)
    bounds.reverse()
    stages = []
    for s in range(pp):
        stages.extend([s] * (bounds[s + 1] - bounds[s]))
    return stages


def _check_nan_inf_on():
    """Fluid's ``FLAGS_check_nan_inf`` as the JAX package reads it from
    the environment."""
    return os.environ.get("FLAGS_check_nan_inf", "") not in (
        "0", "false", "False", "")


# the dtypes a wire's layout names, by code
_WIRE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
                torch.int32, torch.int64, torch.int16, torch.int8,
                torch.uint8, torch.bool)
_MAX_DIMS = 8
_HDR = 2 + _MAX_DIMS  # dtype code, ndim, dims


class _Saved:
    """What a forward unit keeps for its backward unit: the input wire
    (recompute) or the records and the env values its backward ops read
    (stash)."""

    __slots__ = ("wire", "records", "env")

    def __init__(self, wire=None, records=None, env=None):
        self.wire = wire
        self.records = records
        self.env = env


# ---------------------------------------------------------------------------
# the pipelined step
# ---------------------------------------------------------------------------


class PipelineProgramStep:
    """One rank's pipelined (dp × pp × tp) step of a Fluid training
    program, made by ``CompiledProgram`` per feed signature.

    `mesh` is the (dp, pp, tp) `SPMDMesh` of ``mesh.fluid_mesh`` (the
    groups are taken at the first run), or for the analysis alone its
    shape, a {"dp", "pp", "tp"} dict. After each run `units` holds the
    forward and backward units this rank ran."""

    def __init__(self, program, feed_shapes, fetch_names, mesh,
                 build_strategy, loss_name):
        from ..compiler import (BuildStrategy, classify_persistable_state,
                                grad_seed_scale_of)

        if loss_name is None:
            raise ValueError(
                "pipeline_stages > 1 needs with_data_parallel(loss_name=...) "
                "so the 1F1B schedule knows which scalar to differentiate")
        if _check_nan_inf_on():
            raise NotImplementedError(
                "FLAGS_check_nan_inf is not supported under "
                "pipeline_stages > 1 — reproduce on a dp/tp mesh (or "
                "single device) to localize the NaN, then re-enable "
                "pipelining")
        self.program = program
        self.feed_names = list(feed_shapes)
        self.fetch_names = list(fetch_names)
        self.mesh = mesh
        self.loss_name = loss_name
        block = program.global_block()
        self.block = block
        shape = dict(getattr(mesh, "shape", mesh))
        self.dp = int(shape.get("dp", 1))
        self.pp = int(shape.get("pp", 1))
        self.tp = int(shape.get("tp", 1))
        self.M = int(getattr(build_strategy, "pipeline_microbatches", None)
                     or self.pp)
        if self.M < self.pp:
            raise ValueError(
                "pipeline_microbatches (%d) must be >= pipeline_stages (%d)"
                % (self.M, self.pp))
        self.v = int(getattr(build_strategy, "pipeline_virtual_stages", 1)
                     or 1)
        self.S = self.v * self.pp  # virtual stages; stage s on rank s%pp
        self.stash_activations = bool(getattr(
            build_strategy, "pipeline_activation_stash", False))
        self._seed = program.random_seed or 0
        from .pipeline_schedule import build_schedule

        self.schedule = build_schedule(self.pp, self.M, self.v)

        self.fwd_ops, self.post_ops = split_sections(block)
        if not any(_is_backward_op(op) for op in block.ops):
            raise ValueError(
                "pipeline_stages > 1 needs a training program (append "
                "backward via optimizer.minimize); for inference use "
                "dp/tp sharding instead")
        if self.v > 1 and any(
                op.attrs.get("__pipeline_stage__") is not None
                for op in self.fwd_ops):
            raise NotImplementedError(
                "fluid.pipeline_stage(i) annotations name physical "
                "stages and do not compose with "
                "pipeline_virtual_stages > 1 — drop the annotations "
                "(the balanced auto-split spreads ops over all %d "
                "virtual chunks) or set pipeline_virtual_stages=1"
                % self.S)
        self.stage_of = assign_stages(self.fwd_ops, self.S)

        # ---- dataflow over the forward section -------------------------
        feed_set = set(self.feed_names)
        produced_at = {}
        last_use = {}
        for op, s in zip(self.fwd_ops, self.stage_of):
            for name in op.input_names():
                v = block._find_var_recursive(name)
                if name in feed_set or v is None or v.persistable:
                    continue
                if name in produced_at:
                    last_use[name] = max(last_use.get(name, s), s)
            for name in op.output_names():
                v = block._find_var_recursive(name)
                if v is not None and v.persistable:
                    raise ValueError(
                        "forward op %r writes persistable var %r — ops with "
                        "cross-batch state (batch_norm running stats) don't "
                        "commute with pipeline microbatching; use "
                        "layer_norm, or dp/tp parallelism for this model"
                        % (op.type, name))
                if name in feed_set:
                    raise ValueError(
                        "forward op %r writes feed var %r in place — "
                        "pipeline stages read feeds immutably; copy the "
                        "feed into a new var (e.g. layers.assign) first"
                        % (op.type, name))
                prev = produced_at.get(name)
                if prev is not None and prev != s:
                    raise ValueError(
                        "var %r is rewritten in place at stage %d after "
                        "being produced at stage %d — in-place rewrites "
                        "across pipeline stages are unsupported; adjust "
                        "pipeline_stage annotations so all writes to a var "
                        "land in one stage" % (name, s, prev))
                produced_at[name] = s
        self.produced_at = produced_at
        # crossing[c]: produced at stage <= c, still consumed after cut c
        self.crossing = []
        for c in range(self.S - 1):
            names = sorted(
                n for n in produced_at
                if produced_at[n] <= c and last_use.get(n, -1) > c)
            self.crossing.append(names)

        # ---- parameters ------------------------------------------------
        fwd_reads = set()
        for op in self.fwd_ops:
            fwd_reads.update(op.input_names())
        pg = dict(getattr(program, "param_grad_map", {}) or {})
        self.dparam_names = sorted(
            p for p, g in pg.items()
            if p in fwd_reads and block._find_var_recursive(g) is not None)
        self.grad_of = {p: pg[p] for p in self.dparam_names}
        self.cparam_names = sorted(
            n for n in fwd_reads
            if n not in self.grad_of and n not in feed_set
            and (lambda v: v is not None and v.persistable)(
                block._find_var_recursive(n)))

        self.mut_names, self.const_names, self.state_out = \
            classify_persistable_state(block, self.fetch_names)

        # ---- scalar forward fetches (loss, metrics) --------------------
        post_produced = set()
        for op in self.post_ops:
            post_produced.update(op.output_names())
        self.post_produced = post_produced
        scalar = []
        for name in dict.fromkeys([self.loss_name] + self.fetch_names):
            if name in produced_at:
                v = block._find_var_recursive(name)
                if v is not None and v.shape is not None \
                        and _numel(v.shape) == 1 and -1 not in v.shape:
                    scalar.append(name)
                elif name in self.fetch_names:
                    raise ValueError(
                        "fetch %r is a non-scalar forward activation; under "
                        "pipeline parallelism activations live per-"
                        "microbatch per-stage. Fetch scalars (loss/metrics) "
                        "or persistables instead" % name)
        if self.loss_name not in scalar:
            raise ValueError(
                "loss %r must be a scalar produced by the forward section"
                % self.loss_name)
        self.scalar_names = scalar
        self.loss_idx = scalar.index(self.loss_name)
        self.loss_stage = produced_at[self.loss_name]
        for name in self.fetch_names:
            if name in scalar or name in post_produced:
                continue
            v = block._find_var_recursive(name)
            if v is None or not v.persistable:
                raise ValueError(
                    "fetch %r is neither a scalar forward var, an optimizer "
                    "output, nor a persistable — not fetchable under "
                    "pipeline parallelism" % name)

        grad_names = set(self.grad_of.values())
        resolvable = (set(self.mut_names) | set(self.const_names)
                      | set(self.state_out) | grad_names
                      | set(scalar) | feed_set | post_produced)
        for op in self.post_ops:
            for name in op.input_names():
                if name not in resolvable:
                    raise ValueError(
                        "optimizer-section op %r reads %r, which the "
                        "pipelined step cannot provide (it is a non-scalar "
                        "forward activation)" % (op.type, name))

        # ---- the backward, stage by stage ------------------------------
        self._stage_plan(block)

        # ---- sharding plan (tp over the tp line, ZeRO-1 over dp) -------
        from .planner import plan_batch, plan_program, state_layout

        zero_mode = (getattr(build_strategy, "reduce_strategy", 0)
                     == BuildStrategy.ReduceStrategy.Reduce)
        self._grad_seed_scale = grad_seed_scale_of(build_strategy, self.dp)
        axes = {"dp": self.dp, "pp": self.pp}
        if self.tp > 1:
            axes["tp"] = self.tp
        self._plan = plan_program(program, axes, build_strategy,
                                  zero_sharding=zero_mode)
        self.layout, self.zero = state_layout(program, self._plan, self.tp,
                                              self.dp)
        # no feed is batch-sharded inside a stage: each unit runs on one
        # microbatch's rows, whole, and only the tp plan applies (its
        # byte counts at a microbatch's rows)
        rows = next((shape[0] for n, shape in sorted(dict(feed_shapes)
                                                      .items())
                     if len(shape) and getattr(block._find_var_recursive(n),
                                               "is_data", False)), None)
        self.plan = plan_batch(
            program, [], self.dp, tp=self.tp, layout=self.layout,
            zero=self.zero,
            rows=None if rows is None else rows // (self.dp * self.M))
        self.recorded = frozenset(id(op.attrs["__fwd_op__"])
                                  for op in block.ops
                                  if "__fwd_op__" in op.attrs)
        self._groups = None
        self._layouts = {}   # cut -> [(shape, dtype) or None] a wire
        self._sent = set()   # cuts whose layout this rank has sent
        self.units = {}

    # ------------------------------------------------------------------
    # the stage plan of the backward
    # ------------------------------------------------------------------
    def _stage_plan(self, block):
        """Each virtual stage's forward ops, backward ops (program order)
        and the grad names of the crossing vars; the env values a stash
        keeps for the stage's backward ops that are not grad ops."""
        stage_of_op = {id(op): s for op, s in zip(self.fwd_ops,
                                                  self.stage_of)}
        self.stage_ops = [[] for _ in range(self.S)]
        for op, s in zip(self.fwd_ops, self.stage_of):
            self.stage_ops[s].append(op)
        grad_of_var = {}
        bwd = [[] for _ in range(self.S)]
        for op in block.ops:
            if not _is_backward_op(op):
                continue
            fwd = op.attrs.get("__fwd_op__")
            if fwd is not None:
                s = stage_of_op.get(id(fwd))
                if s is None:
                    raise NotImplementedError(
                        "grad op %r: its forward op %r is not in the "
                        "forward section" % (op.type, fwd.type))
                for slot, names in op.attrs["__grad_in_map__"].items():
                    for v, g in zip(fwd.inputs.get(slot, ()), names):
                        if g is not None:
                            grad_of_var.setdefault(v.name, g)
            else:
                # the loss seed: with the stage of the loss it reads
                s = max([self.produced_at.get(n, 0)
                         for n in op.input_names()] + [0])
            bwd[s].append(op)
        self.bwd_ops = bwd
        self.grad_name = grad_of_var
        # the cotangent wire of cut c: its crossing vars with a grad var
        self.cot_names = [[n for n in names if n in grad_of_var]
                          for names in self.crossing]
        need = []
        for s in range(self.S):
            names = set()
            for op in bwd[s]:
                if "__fwd_op__" not in op.attrs:
                    names.update(n for n in op.input_names()
                                 if n in self.produced_at)
            need.append(sorted(names))
        self.stash_env = need
        params = set(self.dparam_names)
        self.stage_params = [
            sorted({n for op in ops for n in op.input_names()} & params)
            for ops in self.stage_ops]
        self.scal_here = [[(k, n) for k, n in enumerate(self.scalar_names)
                           if self.produced_at.get(n) == s]
                          for s in range(self.S)]

    # ------------------------------------------------------------------
    # predictions
    # ------------------------------------------------------------------
    def wire_bytes(self):
        """{cut: (forward bytes, cotangent bytes)} of one microbatch's
        wires, from the layouts the first run learnt (empty before)."""
        def nbytes(ent):
            return int(np.prod(ent[0])) * torch.empty(
                (), dtype=ent[1]).element_size()

        return {c: (sum(nbytes(e) for e in lay if e is not None),
                    sum(nbytes(e) for _, e in self._cot_slots(c)))
                for c, lay in sorted(self._layouts.items())}

    def expected_p2p(self, cut_bytes):
        """(pp_fwd bytes, pp_bwd bytes) this rank sends in one step, for
        `cut_bytes` {cut: (forward, cotangent) bytes a microbatch}: each
        of its stages' outgoing cuts, M microbatches each way."""
        p = self.mesh.axis_index("pp") if self.pp > 1 else 0
        f = b = 0
        for s in range(p, self.S, self.pp):
            if s < self.S - 1:
                f += cut_bytes[s][0] * self.M
            if s > 0:
                b += cut_bytes[s - 1][1] * self.M
        return f, b

    # ------------------------------------------------------------------
    # the run
    # ------------------------------------------------------------------
    def _lines(self):
        if self._groups is None:
            m = self.mesh
            self._groups = {
                "dp": m.group("dp"), "pp": m.group("pp"),
                "tp": m.group("tp"), "dpp": m.group(("dp", "pp"))}
        return self._groups

    def _ctx(self, device, step, stream, recorded):
        g = self._groups
        ctx = LoweringContext(device, self._seed, step, recorded)
        ctx.dp = g["dp"]
        ctx.tp = g["tp"] if self.tp > 1 else None
        ctx.tp_ops = self.plan.tp_ops
        ctx.stream = stream
        ctx.grad_seed_scale = self._grad_seed_scale / float(self.M * self.dp)
        return ctx

    def _micro_feeds(self, feeds):
        """[{name: tensor}] a microbatch: each data feed's rows of this
        rank's dp line, then its M blocks of rows (the JAX step's
        ``P("dp")`` split and ``reshape((M, mb) + ...)``); other feeds
        whole in every one."""
        dp, M = self.dp, self.M
        d = self.mesh.axis_index("dp") if dp > 1 else 0
        batched, repl = {}, {}
        for name, arr in feeds.items():
            v = self.block._find_var_recursive(name)
            if v is not None and bool(getattr(v, "is_data", False)):
                if arr.dim() < 1 or arr.shape[0] % (dp * M) != 0:
                    raise ValueError(
                        "feed %r batch %s must divide dp*microbatches = %d "
                        "for pipeline parallelism"
                        % (name, tuple(arr.shape), dp * M))
                batched[name] = arr
            else:
                repl[name] = arr
        out = []
        for i in range(M):
            mb = dict(repl)
            for name, arr in batched.items():
                rows = arr.shape[0] // (dp * M)
                start = (d * M + i) * rows
                mb[name] = arr[start:start + rows]
            out.append(mb)
        return out

    def _forward_unit(self, s, i, wire, base, mfeeds, device, step, stream,
                      sacc):
        """Run stage s on microbatch i from its input wire: (the outgoing
        wire, what the backward unit keeps)."""
        env = dict(base)
        env.update(mfeeds[i])
        if wire is not None:
            for name, val in zip(self.crossing[s - 1], wire):
                if val is not None:
                    env[name] = val
        record = self.recorded if self.stash_activations else frozenset()
        ctx = self._ctx(device, step, stream, record)
        with torch.no_grad():
            for op in self.stage_ops[s]:
                execute_op(op, env, ctx)
        for k, name in self.scal_here[s]:
            sacc[k] += env[name].detach().float().reshape(())
        out = ([env.get(n) for n in self.crossing[s]]
               if s < self.S - 1 else None)
        if self.stash_activations:
            saved = _Saved(records=ctx.fwd,
                           env={n: env[n] for n in self.stash_env[s]})
        else:
            saved = _Saved(wire=wire)
        return out, saved

    def _backward_unit(self, s, i, saved, cot, base, mfeeds, device, step,
                       stream, gacc):
        """The grad ops of stage s on microbatch i: its params' grads
        summed into `gacc` (fp32), and the cotangent wire of cut s - 1."""
        ctx = self._ctx(device, step, stream, self.recorded)
        if self.stash_activations:
            env = dict(saved.env)
            ctx.fwd = saved.records
            ops = self.bwd_ops[s]
        else:
            env = dict(base)
            env.update(mfeeds[i])
            if saved.wire is not None:
                for name, val in zip(self.crossing[s - 1], saved.wire):
                    if val is not None:
                        env[name] = val
            ops = self.stage_ops[s] + self.bwd_ops[s]
        if cot is not None:
            for (name, _), g in zip(self._cot_slots(s), cot):
                env[self.grad_name[name]] = g
        with torch.no_grad():
            for op in ops:
                execute_op(op, env, ctx)
            for p in self.stage_params[s]:
                g = env.get(self.grad_of[p])
                if g is None:
                    continue
                if p in gacc:
                    gacc[p] += g.float()
                else:
                    gacc[p] = g.to(torch.float32, copy=True)
        if s == 0:
            return None
        out = []
        for name, (shape, dtype) in self._cot_slots(s - 1):
            g = env.get(self.grad_name[name])
            out.append(torch.zeros(shape, dtype=dtype, device=device)
                       if g is None else g.to(dtype).reshape(shape))
        return out

    def _learn_layout(self, c, wire):
        self._layouts[c] = [
            None if t is None else (tuple(t.shape), t.dtype) for t in wire]

    def _header(self, c, device):
        hdr = torch.full((len(self.crossing[c]), _HDR), -1,
                         dtype=torch.int64)
        for j, ent in enumerate(self._layouts[c]):
            if ent is None:
                continue
            shape, dtype = ent
            if len(shape) > _MAX_DIMS:
                raise NotImplementedError(
                    "activation %r crossing a pipeline stage cut has %d "
                    "dims; the wire's layout holds %d"
                    % (self.crossing[c][j], len(shape), _MAX_DIMS))
            hdr[j, 0] = _WIRE_DTYPES.index(dtype)
            hdr[j, 1] = len(shape)
            hdr[j, 2:2 + len(shape)] = torch.tensor(shape)
        return hdr.to(device)

    def _read_header(self, c, hdr):
        hdr = hdr.cpu().tolist()
        lay = []
        for row in hdr:
            if row[0] < 0:
                lay.append(None)
            else:
                lay.append((tuple(row[2:2 + row[1]]), _WIRE_DTYPES[row[0]]))
        self._layouts[c] = lay

    def _cot_slots(self, c):
        """(name, (shape, dtype)) of each var of cut c's cotangent wire:
        the crossing vars with a grad var and a floating value."""
        lay = dict(zip(self.crossing[c], self._layouts[c]))
        return [(n, lay[n]) for n in self.cot_names[c]
                if lay[n] is not None and lay[n][1].is_floating_point]

    def _exchange(self, send_f, send_b, recv_f, recv_b, device):
        """The tick's one batch on the pp line: `send_f` (cut, wire) to
        the next rank, `send_b` (cut, cotangents) to the previous one,
        `recv_f` / `recv_b` the cuts arriving from them (None: nothing).
        The first wire of a cut goes after its layout. Returns (forward
        wire, cotangents) received."""
        from .collective import send_recv

        g = self._groups["pp"]
        p = g.rank
        nxt = g.ranks[(p + 1) % g.world]
        prv = g.ranks[(p - 1) % g.world]
        hs, hr = [], []
        if send_f is not None and send_f[0] not in self._sent:
            hs.append((self._header(send_f[0], device), nxt))
            self._sent.add(send_f[0])
        if recv_f is not None and recv_f not in self._layouts:
            buf = torch.empty((len(self.crossing[recv_f]), _HDR),
                              dtype=torch.int64, device=device)
            hr.append((buf, prv))
        if hs or hr:
            send_recv(hs, hr, g, "pp_layout")
            if hr:
                self._read_header(recv_f, hr[0][0])
        sends, recvs = [], []
        if send_f is not None:
            sends += [(t.contiguous(), nxt, "pp_fwd")
                      for t in send_f[1] if t is not None]
        if send_b is not None:
            sends += [(t.contiguous(), prv, "pp_bwd") for t in send_b[1]]
        got_f = got_b = None
        if recv_f is not None:
            got_f = [None if ent is None else
                     torch.empty(ent[0], dtype=ent[1], device=device)
                     for ent in self._layouts[recv_f]]
            recvs += [(t, prv) for t in got_f if t is not None]
        if recv_b is not None:
            got_b = [torch.empty(shape, dtype=dtype, device=device)
                     for _, (shape, dtype) in self._cot_slots(recv_b)]
            recvs += [(t, nxt) for t in got_b]
        send_recv(sends, recvs, g, "pp_p2p")
        return got_f, got_b

    def run(self, scope, feed, device):
        from ..compiler import cut_to_layout, read_persistable_state
        from ..executor import feed_tensor

        g = self._lines()
        if self.layout or self.zero:
            cut_to_layout(scope, self.block, self.layout, self.zero,
                          g["dp"], g["tp"])
        mut, const = read_persistable_state(scope, self.mut_names,
                                            self.const_names)
        state = dict(const)
        state.update(mut)
        feeds = {name: feed_tensor(self.block, name, feed[name], device)
                 for name in self.feed_names}
        mfeeds = self._micro_feeds(feeds)
        step = int(scope.get("__step_counter__", 0) or 0)
        base = {n: state[n] for n in self.dparam_names + self.cparam_names
                if n in state}
        self.units = {"fwd": 0, "bwd": 0}
        gacc, sacc = self._pipeline(base, mfeeds, device, step)
        with _tracing.span("pp/update"):
            return self._update(scope, state, feeds, gacc, sacc, g, device,
                                step)

    def _update(self, scope, state, feeds, gacc, sacc, g, device, step):
        """The grads and scalar fetches summed over the ("dp", "pp")
        union, then the post section once: the fetched values."""
        from .collective import psum_leaves

        names = self.dparam_names
        for p in names:
            if p not in gacc:
                gacc[p] = torch.zeros(state[p].shape, dtype=torch.float32,
                                      device=device)
        summed = psum_leaves([gacc[p] for p in names] + [sacc], g["dpp"])
        scal = summed[-1] / float(self.M * self.dp)
        env = dict(state)
        env.update(feeds)
        for k, name in enumerate(self.scalar_names):
            v = self.block._find_var_recursive(name)
            val = scal[k]
            if v is not None and v.shape is not None:
                val = val.reshape(tuple(v.shape)).to(torch_dtype(v.dtype))
            env[name] = val
        for p, gsum in zip(names, summed):
            gv = self.block._find_var_recursive(self.grad_of[p])
            if gv is not None and gv.dtype is not None:
                gsum = gsum.to(torch_dtype(gv.dtype))
            env[self.grad_of[p]] = gsum
        ctx = self._ctx(device, step, None, frozenset())
        with torch.no_grad():
            for op in self.post_ops:
                execute_op(op, env, ctx)
        for name in self.state_out:
            if name in env:
                scope.set(name, env[name])
        scope.set("__step_counter__", step + 1)
        return [self._fetch(n, env[n]) for n in self.fetch_names]

    def _fetch(self, name, value):
        from .collective import _gather

        g = self._groups
        if name in self.zero:
            value = _gather(value, g["dp"], 0, kind="gather_state")
        d = self.plan.tp_marks.get(name)
        if d is not None:
            value = _gather(value.detach(), g["tp"], d, kind="gather_state")
        return value

    def _pipeline(self, base, mfeeds, device, step):
        """This rank's rows of the schedule: ({param: fp32 grad sum over
        its units}, fp32 sums of the scalar fetches over its units)."""
        sched = self.schedule
        pp, S = self.pp, self.S
        r = self.mesh.axis_index("pp")
        d = self.mesh.axis_index("dp") if self.dp > 1 else 0
        prv, nxt = (r - 1) % pp, (r + 1) % pp
        arrive = [None] * sched.arrive_slots
        saved = [None] * sched.input_slots
        cots = [None] * sched.cot_slots
        gacc = {}
        sacc = torch.zeros(max(len(self.scalar_names), 1),
                           dtype=torch.float32, device=device)
        got_f = got_b = None
        for t in range(sched.K):
            slot = int(sched.fwd_recv[t, r])
            if slot >= 0:
                arrive[slot] = got_f
            slot = int(sched.cot_recv[t, r])
            if slot >= 0:
                cots[slot] = got_b
            send_f = send_b = None
            i = int(sched.fwd_mb[t, r])
            if i >= 0:
                s = int(sched.fwd_chunk[t, r]) * pp + r
                rd = int(sched.fwd_read[t, r])
                wire = None
                if s > 0:
                    wire, arrive[rd] = arrive[rd], None
                with _tracing.span("pp/fwd"):
                    out, keep = self._forward_unit(
                        s, i, wire, base, mfeeds, device, step,
                        d * self.M + i, sacc)
                saved[int(sched.fwd_save[t, r])] = keep
                if s < S - 1:
                    if s not in self._layouts:
                        self._learn_layout(s, out)
                    send_f = (s, out)
                self.units["fwd"] += 1
            i = int(sched.bwd_mb[t, r])
            if i >= 0:
                s = int(sched.bwd_chunk[t, r]) * pp + r
                rd = int(sched.bwd_read[t, r])
                keep, saved[rd] = saved[rd], None
                cot = None
                cr = int(sched.cot_read[t, r])
                if cr >= 0:
                    cot, cots[cr] = cots[cr], None
                with _tracing.span("pp/bwd"):
                    g_in = self._backward_unit(s, i, keep, cot, base,
                                               mfeeds, device, step,
                                               d * self.M + i, gacc)
                if s > 0:
                    send_b = (s - 1, g_in)
                self.units["bwd"] += 1
            recv_f = recv_b = None
            if t + 1 < sched.K:
                if int(sched.fwd_recv[t + 1, r]) >= 0:
                    recv_f = int(sched.fwd_chunk[t, prv]) * pp + prv
                if int(sched.cot_recv[t + 1, r]) >= 0:
                    recv_b = int(sched.bwd_chunk[t, nxt]) * pp + nxt - 1
            with _tracing.span("pp/p2p"):
                got_f, got_b = self._exchange(send_f, send_b, recv_f,
                                              recv_b, device)
        return gacc, sacc
