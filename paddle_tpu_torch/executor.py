"""Executor (parity: the JAX package's ``executor.py`` `Executor`
:326-544 and its `_CompiledStep` :99-259).

`run()` executes a program's global block op by op in eager PyTorch on
the executor's device (``core/lowering.py``): forward ops, generic grad
ops and the optimizer's update ops. Per (program, feed signature,
fetches, pipeline key) a `_Step` is cached that holds the
persistable-state plan (which scope tensors the step reads and which it
writes) and the step's memory plan (when each intermediate can be
dropped). Parameters are updated in place in the scope, as the JAX step
does by donating its state.

At a cache miss the program goes through the pass pipeline
(``ir_passes.optimize_for_execution``: constant_fold, cse and fetch_dce,
with ``amp_rewrite`` or ``quant_rewrite`` ahead of them when an AMP or
quantization config is in effect) and the step runs the optimized
clone; ``PTPU_NO_PROGRAM_OPT=1`` runs the program itself. The pipeline's
key is part of the cache key. Persistables a pass baked are read back
through ``ir_passes.state_fallback`` into a scope that lacks them.

The asynchronous pipeline (``async_engine.py``): ``run(...,
return_numpy=False)`` returns the fetches as device tensors (a
`LazyFetchList`) and admits the step, as a CUDA event on the executor's
stream, into a window of at most `async_steps` steps in flight
(``PTPU_ASYNC_STEPS``); admitting past it waits for the oldest.
``return_numpy=True`` copies the fetches to the host, which syncs every
step before it. ``sync()`` drains the window. ``prefetch(feed)`` stages
a host feed on the card in the background; the next ``run(feed=feed)``
with the same value objects reads the staged copy.

A var that a sub-block reads stays alive until the op that owns the
sub-block and that op's grad op have run: the op lists every outer var
its sub-block reads as an input (``layers/control_flow.py``), and its
grad op takes the op's inputs. The learning-rate schedules'
`@step_counter@` is a persistable of the program, advanced in place by
its `increment` op; the host's `__step_counter__` only seeds the random
generators.

With metrics on (``PTPU_METRICS``), the first run of each step plan
is counted (``observability/cost.py``: its FLOPs and, on the card, the
peak allocation up to its end) and published as the ``exec/*`` gauges, once a plan,
as the JAX executor publishes XLA's cost analysis at each compile.

`train_from_dataset` / `infer_from_dataset` (the JAX executor's
:545-633) drive a whole dataset through a program: its batches (or,
with a `data_plane.DatasetCursor`, its resumable stream) go through a
`FeedPrefetcher` with one batch of lookahead, so the copy of batch k+1
to the card overlaps step k. The cursor advances, and is mirrored into
the scope's ``__data_cursor__``, as batch k is taken for its step, not
when the lookahead pulls batch k+1. A cache miss is the
``transient_compile`` fault site (``resilience.py``).

A `compiler.CompiledProgram` handed to `run()` runs through its own
``_run`` (the data-parallel step, or the inference-optimized clone),
which ends in the same `_finish_run`: the in-flight window and
`LazyFetchList`. Its data-parallel step is a `_Step` with the rank's
rows of the feeds, the data group in the lowering context and the
fetches gathered.

Telemetry (the JAX executor's names): each run is one
``observability.step_scope()`` (a ``step`` span, ``executor/step_time``
and ``executor/steps``); a cache miss counts ``compile_cache/miss`` and
runs the pass pipeline in an ``optimize`` span and the plan's build in a
``lower`` span, a hit counts ``compile_cache/hit``; every run of a plan
is an ``execute`` span, a plan's first run (where its one-time costs and
the cost count land) also a ``compile`` span around it; then
``executor/feed_bytes`` and ``executor/fetch_bytes``. The JAX-only
metrics have no counterpart, since the port compiles nothing:
``compile_cache/trace_time``, ``compile_cache/compile_time``,
``compile_cache/stablehlo_module_bytes``,
``compile_cache/persistent_hit`` and ``compile_cache/persistent_miss``.

Not ported: RPC ops, the nan checks and the embedding-prefetch branch of
`train_from_dataset` (ROADMAP.md Queue 1 item 9). A CUDA graph of the
step is later work.
"""

from collections import deque

import numpy as np
import torch

from . import framework, ir_passes
from . import observability as _observability
from .async_engine import (FeedPrefetcher, InflightWindow, LazyFetchList,
                           StepEvent, _nbytes, as_numpy, prefetch_iter)
from .core.lowering import LoweringContext, execute_block
from .core.place import resolve_device
from .core.scope import global_scope
from .flags import env
from .observability import cost as _cost
from .observability import metrics as _metrics
from .observability import tracing as _tracing

__all__ = ["Executor", "global_scope"]

_INT32 = np.iinfo(np.int32)


def _feed_signature(feed):
    return tuple(sorted((k, tuple(np.shape(v)), str(v.dtype))
                        for k, v in feed.items()))


def classify_persistable_state(block, fetch_names, inplace=None):
    """(mut_names, const_names, state_out): the persistables a step reads
    before writing them (they must be in the scope), split into those it
    also writes (mut) and the read-only ones (const), and the ones it
    writes (they go back to the scope). `inplace` (an
    ``ir_passes.InplaceInfo``) adjusts the split as
    ``BuildStrategy.enable_inplace`` says; None keeps it."""
    produced, state_in, state_out = set(), [], set()
    for op in block.ops:
        for name in op.input_names():
            v = block._find_var_recursive(name)
            if v is not None and v.persistable and name not in produced \
                    and name not in state_in:
                state_in.append(name)
        for name in op.output_names():
            produced.add(name)
            v = block._find_var_recursive(name)
            if v is not None and v.persistable:
                state_out.add(name)
    for name in fetch_names:
        v = block._find_var_recursive(name)
        if v is not None and v.persistable and name not in produced \
                and name not in state_in:
            state_in.append(name)
    mut = [n for n in state_in if n in state_out]
    const = [n for n in state_in if n not in state_out]
    if inplace is not None:
        mut, const = inplace.adjust(mut, const)
    return mut, const, sorted(state_out)


def read_persistable_state(scope, mut_names, const_names, fallback=None):
    """(mut, const) value dicts of a step's persistable inputs.
    `fallback(name)` supplies a value the scope lacks (a compile-time
    constant of the step, such as a baked int8 weight), which then heals
    into the scope."""
    mut, const = {}, {}
    for names, store in ((mut_names, mut), (const_names, const)):
        for name in names:
            val = scope.get(name)
            if val is None and fallback is not None:
                val = fallback(name)
                if val is not None:
                    scope.set(name, val)
            if val is None:
                raise RuntimeError(
                    "persistable var %r is not initialized — run the "
                    "startup program first (exe.run(startup_program))"
                    % name)
            store[name] = val
    return mut, const


def check_feed_int64(name, value, dtype):
    """An int64 feed narrowed to a declared int32 var must fit: an id
    above 2^31 would be cut silently."""
    if value.dtype not in (torch.int64, torch.uint64) \
            or dtype != torch.int32 or value.numel() == 0:
        return
    mx, mn = int(value.max()), int(value.min())
    if mx > _INT32.max or mn < _INT32.min:
        raise ValueError("feed %r holds int64 ids outside the int32 range "
                         "of its declared var; hash them to int32 first"
                         % name)


def feed_tensor(block, name, value, device):
    """Feed `name`'s value on `device` in its var's declared dtype (an
    int64 one checked against an int32 var's range)."""
    v = block._find_var_recursive(name)
    t = value if isinstance(value, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(value))
    if v is not None and v.shape is not None:
        want = framework.torch_dtype(v.dtype)
        check_feed_int64(name, t, want)
        t = t.to(device=device, dtype=want)
    return t.to(device)


def run_step(step, fresh, scope, feed, device):
    """One run of a step plan inside the ``execute`` span; a plan's
    first run (`fresh`: where its one-time costs and, with metrics on,
    its cost count land) also inside the ``compile`` span."""
    with (_tracing.span("compile") if fresh else _tracing.NULL_SPAN):
        with _cost.first_step(fresh, device):
            with _tracing.span("execute"):
                return step.run(scope, feed, device)


def note_run_bytes(feed, fetches):
    """``executor/feed_bytes`` and ``executor/fetch_bytes`` of one run
    (metrics on)."""
    _metrics.counter("executor/feed_bytes").inc(_nbytes(feed.values()))
    _metrics.counter("executor/fetch_bytes").inc(_nbytes(fetches))


class _Step:
    """The plan of one (program, feed signature, fetches). `inplace` (an
    ``ir_passes.InplaceInfo``) is ``BuildStrategy.enable_inplace``'s
    policy; None keeps the state plan as it is.

    A subclass changes a step through five hooks: `_local_feed` (the
    value a feed enters the step with), `_setup` (the lowering context),
    `_fetch` (a fetched value), `_check_held` (a scope holding another
    step's shards) and the attributes `__init__` sets."""

    def __init__(self, program, feed_names, fetch_names, inplace=None):
        self.program = program
        self.block = block = program.global_block()
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.mut_names, self.const_names, self.state_out = \
            classify_persistable_state(block, self.fetch_names, inplace)
        # the update ops write in place: a written persistable that the
        # plan keeps read-only (enable_inplace=False) is given to them as
        # a copy, so the scope's pre-step tensor stays as it was
        written = set(self.state_out)
        self.copied = [n for n in self.const_names if n in written]
        self.recorded = frozenset(id(op.attrs["__fwd_op__"])
                                  for op in block.ops
                                  if "__fwd_op__" in op.attrs)
        # drop each intermediate after the last op that names it; keep
        # persistables (they go back to the scope) and fetches
        keep = set(self.fetch_names)
        last = {}
        for i, op in enumerate(block.ops):
            for name in op.input_names() + op.output_names():
                v = block._find_var_recursive(name)
                if name not in keep and not (v is not None
                                             and v.persistable):
                    last[name] = i
        self.free_after = {}
        for name, i in last.items():
            self.free_after.setdefault(i, []).append(name)

    def _local_feed(self, name, value):
        return value

    def _setup(self, ctx):
        pass

    def _fetch(self, name, value):
        return value

    def _check_held(self, held):
        """Refuse a scope that holds a sharded step's shards of vars this
        step reads whole (`held`: the scope's record of them)."""
        bad = sorted(n for n in (*self.mut_names, *self.const_names)
                     if n in held)
        if bad:
            raise RuntimeError(
                "the scope holds a tensor-parallel or ZeRO-1 step's shards "
                "of %s, which this step reads whole: run it through that "
                "CompiledProgram, or set the values from "
                "compiler.gather_persistables(scope) into a fresh scope"
                % bad[:4])

    def run(self, scope, feed, device):
        held = getattr(scope, "_ptpu_shards", None)
        if held:
            self._check_held(held)
        mut, const = read_persistable_state(
            scope, self.mut_names, self.const_names,
            fallback=lambda n: ir_passes.state_fallback(self.program, n))
        env = dict(const)
        env.update(mut)
        for name in self.copied:
            env[name] = env[name].clone()
        for name in self.feed_names:
            env[name] = feed_tensor(
                self.block, name, self._local_feed(name, feed[name]), device)
        step = int(scope.get("__step_counter__", 0) or 0)
        ctx = LoweringContext(device, self.program.random_seed or 0, step,
                              self.recorded)
        self._setup(ctx)
        execute_block(self.block, env, ctx, self.free_after)
        for name in self.state_out:
            if name in env:
                scope.set(name, env[name])
        scope.set("__step_counter__", step + 1)
        return [self._fetch(n, env[n]) for n in self.fetch_names]


class Executor:
    """Runs programs on one device: `place=None` is ``cuda:0`` (and raises
    without CUDA); the tests pass ``place="cpu"``. `async_steps` bounds
    the steps kept in flight by ``run(return_numpy=False)`` (default:
    ``PTPU_ASYNC_STEPS``, 12)."""

    def __init__(self, place=None, async_steps=None):
        self.device = resolve_device(place)
        self._cache = {}
        if async_steps is None:
            async_steps = env("PTPU_ASYNC_STEPS")
        self._window = InflightWindow(async_steps)
        self._prefetcher = None

    def sync(self):
        """Block until every in-flight step is done."""
        self._window.drain()

    def prefetch(self, feed):
        """Stage `feed`'s host values on the device in the background,
        overlapping the copy with the current step. A later
        ``run(feed=feed)`` with the same value objects reads the staged
        copies; staged feeds are consumed in prefetch order."""
        if self._prefetcher is None:
            self._prefetcher = FeedPrefetcher(self.device)
        self._prefetcher.put(feed)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        """Run `program` (default: the default main program) once.
        Feeds are numpy arrays or tensors, cast to their declared dtype
        and moved to the device. Fetches come back as numpy arrays (bf16
        as float32), which syncs the step, or with return_numpy=False as
        a LazyFetchList of device tensors, the step admitted to the
        in-flight window."""
        from .compiler import CompiledProgram

        if program is None:
            program = framework.default_main_program()
        if isinstance(program, CompiledProgram):
            return program._run(self, feed, fetch_list, scope, return_numpy)
        feed = {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in (feed or {}).items()}
        scope = scope if scope is not None else global_scope()
        fetch_names = [v.name if isinstance(v, framework.Variable)
                       else str(v) for v in (fetch_list or [])]
        key = (id(program), program.version, _feed_signature(feed),
               tuple(fetch_names), ir_passes.pipeline_key(None, program))
        # the staged copy replaces the feed only after the key is taken
        # from the original values
        keep = ()
        if self._prefetcher is not None:
            staged = self._prefetcher.take_if_match(feed)
            if staged is not None:
                feed = staged.consume(self.device)
                keep = staged.pinned
        rec = _metrics.enabled()
        with _observability.step_scope():
            step = self._cache.get(key) if use_program_cache else None
            fresh = step is None
            if fresh:
                from .resilience import maybe_inject_compile_fault

                maybe_inject_compile_fault()
                if rec:
                    _metrics.counter("compile_cache/miss").inc()
                run_program = program
                if ir_passes.pipeline_enabled():
                    with _tracing.span("optimize"):
                        run_program = ir_passes.optimize_for_execution(
                            program, fetch_names, scope, self.device)
                with _tracing.span("lower"):
                    step = _Step(run_program, feed.keys(), fetch_names)
                if use_program_cache:
                    self._cache[key] = step
            elif rec:
                _metrics.counter("compile_cache/hit").inc()
            fetches = run_step(step, fresh, scope, feed, self.device)
        if rec:
            note_run_bytes(feed, fetches)
        return self._finish_run(fetches, return_numpy, keep)

    def _finish_run(self, fetches, return_numpy, keep=()):
        """The fetches as numpy (the step synced), or as a LazyFetchList
        with the step admitted to the in-flight window; `keep` holds the
        staged feed's pinned buffers until the step is done."""
        if return_numpy:
            out = as_numpy(fetches)
            # the newest step is done; one stream runs in order, so every
            # older step in flight is too
            self._window.reset()
            return out
        self._window.admit(StepEvent(self.device, keep))
        return LazyFetchList(fetches)

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           cursor=None, epochs=None):
        """Drive a whole dataset through `program`, one step a batch;
        returns the last step's fetches (numpy). `thread` (or
        ``dataset.set_thread``) parses shards on that many reader
        threads while the card runs the steps.

        `cursor` (a `data_plane.DatasetCursor`) switches to the
        checkpoint-resumable stream: batches start at the cursor's
        position, and the cursor — mirrored into the run scope's
        ``__data_cursor__`` as each batch is taken for its step — is
        what a later restore resumes the byte-identical stream from.
        `epochs` is the ABSOLUTE epoch bound of that stream (the
        `resumable_batches` contract); default = one pass from the
        cursor's current epoch. No cursor = one pass of the dataset."""
        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset")
        if thread:
            dataset.set_thread(thread)
        program = program or framework.default_main_program()
        fetch_list = list(fetch_list or [])
        fetch_names = [v.name if isinstance(v, framework.Variable)
                       else str(v) for v in fetch_list]
        scope = scope if scope is not None else global_scope()
        cursor_states = None
        if cursor is not None:
            if epochs is None:
                epochs = cursor.epoch + 1
            pair_stream = dataset._resumable_stream(cursor, epochs, None)
            cursor_states = deque()

            def _feeds():
                for feed, state in pair_stream:
                    cursor_states.append(state)
                    yield feed

            batches = _feeds()
        elif epochs is not None:
            raise ValueError("epochs= only applies to the cursor path; "
                             "re-run train_from_dataset per epoch on "
                             "the plain stream")
        else:
            batches = (dataset._batches_prefetched()
                       if getattr(dataset, "_thread", 1) > 1
                       else dataset._batches())
        step = 0
        last = None
        # H2D lookahead: while the card runs batch k, a background
        # thread stages batch k+1 on it
        device_feeder = FeedPrefetcher(self.device)
        try:
            for staged in prefetch_iter(batches, device_feeder):
                if cursor_states is not None:
                    # consumption point: the lookahead has already
                    # PULLED batch k+1, but the mirrored cursor may only
                    # advance as batch k is taken for its step — else a
                    # checkpoint would name a position one batch ahead
                    cursor.advance_to(*cursor_states.popleft())
                    cursor.write_to(scope)
                last = self.run(program, feed=staged.consume(self.device),
                                fetch_list=fetch_list, scope=scope)
                step += 1
                if debug and fetch_names and step % print_period == 0:
                    info = fetch_info or fetch_names
                    print("step %d: %s" % (step, {
                        k: np.asarray(v).ravel()[:4]
                        for k, v in zip(info, last)}))
        finally:
            device_feeder.close()
        return last

    infer_from_dataset = train_from_dataset

    def close(self):
        """Drain the in-flight window, stop the prefetcher and drop the
        cached steps (and the optimized clones they hold)."""
        self.sync()
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
        self._cache.clear()
