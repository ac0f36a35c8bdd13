"""`ServingEngine` — the multi-model continuous-batching generation
service front end of the PyTorch port.

One engine serves N models: each model gets a scope holding its
weights, its own blocked KV pool on the device, scheduler, bounded
request queue, and a worker thread driving the fixed-shape decode step.
On a CUDA device each worker issues its work on a CUDA stream of its
own, so the steps of two workers (two models, or two engine replicas
behind a ``ServingRouter``) can overlap on one card; the weights they
share are only read.
``submit()`` is thread-safe and non-blocking (admission control raises
``AdmissionError`` when the queue is full); ``result()``/``request.wait()``
is the pull side and ``stream=`` callbacks are the push side.

Decode steps run asynchronously on the device. The step's input token
vector chains on the device from the previous step's output, and the
per-step scheduler arrays reach the device through one pinned-memory
copy that does not synchronise, so the worker dispatches step ``k+1``
without waiting for step ``k``. Each step's tokens are copied back to
pinned host memory behind an event, and read only in
``_process_oldest`` — at most ``async_depth`` steps behind dispatch
(default ``$PTPU_SERVE_ASYNC_STEPS`` or 4). Deterministic finishes
(``max_new_tokens``, the sequence-length cap) are known at dispatch
time, so the only cost of the lag is a few discarded steps after an
EOS, whose tokens are never emitted and whose KV writes land in blocks
the retiring sequence owns until ``reap``. A request's emitted tokens
are those ``_process_oldest`` delivered: a step that was dispatched but
not yet read back emits nothing, and a dying worker drops its
in-flight steps unread.

The serving fast path is two switches, both off by default: **chunked
prefill** (``prefill_chunk=C``, default ``$PTPU_SERVE_PREFILL_CHUNK``)
dispatches a ``[max_batch, C]`` window (``prefill_step``, the
paged-attention kernel at C) whenever a row is mid-prompt: prefill rows
consume whole prompt spans while decode rows ride along as 1-token
windows, at most ``prefill_token_budget`` (default 4 chunks) prompt
tokens a step. Chunk steps are asynchronous like decode steps: their
``next_tokens`` chain into the next step on the device. **Radix prefix
caching** (``prefix_cache=True``, default ``$PTPU_SERVE_PREFIX_CACHE``)
content-addresses the KV pool, so requests sharing a prompt prefix
adopt its sealed blocks and skip their prefill.

Speculative decoding (``spec_k=K``, or ``spec_tree="WxD"``; default
``$PTPU_SERVE_SPEC_K`` / ``$PTPU_SERVE_SPEC_TREE``, both off): when every
row is past its prompt, a step is a VERIFY window — each row feeds its
last committed token plus drafts from the ``drafter`` (``NGramDrafter``
by default; ``ModelDrafter`` drafts with a model, or from the artifact
that ``$PTPU_SERVE_DRAFT_MODEL`` names): K in a line (``spec_step``, the
paged-attention kernel at C = K + 1) or a level-order tree of W chains
of depth D (``spec_tree_step``, the tree-mask kernel at C = 1 + W*D).
Each window
is materialized before the next is planned (acceptance and the next
drafts read the committed history), so speculation runs synchronously:
the tokens a step gains replace the async window. A tree window's
accepted path is compacted in the pool (``tree_commit``) only when one
of its slots is out of place; rejected tails roll back through
``KVBlockPool.truncate_owner``. Output stays token-identical to greedy
decoding.

The fleet surface (what ``ServingRouter`` drives): per-request
deadlines (``deadline_s`` / ``$PTPU_SERVE_DEADLINE_S``, checked at step
boundaries once a request carries one), ``load()``, ``health()``,
``kill()`` (every worker aborts at its next step boundary, or out of an
injected stall, and drains through ``fail_all``), a transient failure
at the step boundary retried in place up to ``transient_tolerance``
times in a row, and the ``serve_*`` fault sites. Weight hot swaps go
through ``swap_weights``, the one entry point: the worker pauses
admission, drains its batch and its in-flight steps, then installs new
weight tensors and flushes the prefix cache in one critical section, so
no request's tokens span two weight versions (``weight_version``).

Telemetry. With metrics enabled: ``serving/{queue_depth,
batch_occupancy,peak_batch_occupancy,kv_blocks_in_use,inflight_steps,
tokens_per_sec,request_latency(_p50/_p99),ttft(_p50/_p99),steps,
prefill_tokens,decode_tokens,prefill_chunk_steps,prefix_blocks_reused,
prefix_tokens_skipped,requests_submitted,requests_completed,
requests_rejected,requests_failed,spec_steps,spec_proposed,
spec_accepted,spec_tree_slots,spec_tree_commits,spec_accept_rate,
deadline_expired,step_transient_retries}`` and ``online/swaps``. With
tracing on: a ``serving_step`` span around each dispatched step
(``serving_spec_step`` around a verify window), and for each request
that carries a trace id one ``prefill_chunk`` / ``decode_window`` /
``spec_window`` event a step it rides, beside the scheduler's
``queue_wait`` and ``admit``. With the endpoint on (``PTPU_METRICS_PORT``)
the engine registers its workers' ``health()`` at ``/healthz``. Under
``PTPU_LOCK_CHECK=1`` every step boundary audits the pool's invariants
and the engine's bounds (``_check_invariants``), reporting through
``analysis.concurrency.record_violation``.
"""

import contextlib
import re
import threading
import time

import numpy as np
import torch

from .. import flags as _flags
from .. import resilience as _resil
from ..analysis import concurrency as _conc
from ..core.place import resolve_device
from ..core.scope import Scope
from ..observability import flight_recorder as _blackbox
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from ..ops import paged_attention_tree as _pat
from ..quant import weight_store_bytes
from .kv_cache import KVBlockPool, blocks_needed
from .model import (GenerationModel, ModelDrafter, NGramDrafter,
                    load_generation_artifact, parse_tree_shape,
                    upload_int32)
from .scheduler import (AdmissionError, GenerationRequest, RequestQueue,
                        StepScheduler, spec_tree_acceptance)

__all__ = ["ServingEngine"]


class _ModelWorker:
    """One model's serving state: scope + pool + scheduler + decode
    thread (and, on CUDA, the stream it issues on)."""

    def __init__(self, name, model, max_batch, max_seq_len, block_size,
                 num_blocks, max_queue, async_depth, device,
                 prefill_chunk=0, prefix_cache=False,
                 prefill_token_budget=None, spec_k=0, spec_tree=None,
                 drafter=None, transient_tolerance=2):
        self.name = name
        self.model = model
        self.device = device
        cfg = model.config
        max_seq_len = min(int(max_seq_len), cfg.max_seq_len)
        if num_blocks is None:
            # enough cache for every slot to run a full-length sequence
            # concurrently (no admission stalls from the pool)
            num_blocks = max_batch * blocks_needed(max_seq_len, block_size)
        self.pool = KVBlockPool(cfg.n_layers, cfg.n_heads, cfg.head_dim,
                                block_size, num_blocks, device=device)
        # the chunk is clamped to the context; the per-step prompt-token
        # budget (default 4 chunks) bounds the prefill a mixed step
        # carries beside decode rows
        self.prefill_chunk = max(0, min(int(prefill_chunk or 0),
                                        max_seq_len))
        self.prefix_cache = bool(prefix_cache)
        if self.prefill_chunk and prefill_token_budget is None:
            prefill_token_budget = 4 * self.prefill_chunk
        # speculation: a tree shape implies it, its depth playing
        # spec_k's role; windows are clamped to the context, as the JAX
        # engine clamps them, and nothing more
        self.spec_tree = parse_tree_shape(spec_tree)
        if self.spec_tree:
            width, depth = self.spec_tree
            self.spec_tree = (width, max(1, min(depth, max_seq_len - 1)))
            self.spec_k = self.spec_tree[1]
        else:
            self.spec_k = max(0, min(int(spec_k or 0), max_seq_len - 1))
        if self.spec_k and drafter is None:
            drafter = NGramDrafter()
        if drafter is not None and not callable(
                getattr(drafter, "propose", None)):
            raise TypeError("drafter %r has no propose(history, k) method"
                            % (type(drafter).__name__,))
        self.drafter = drafter if self.spec_k else None
        if self.drafter is not None and hasattr(self.drafter, "bind"):
            # ModelDrafter: its KV pool and batch geometry, once
            self.drafter.bind(max_batch, self.spec_k)
        if self.spec_tree and device.type == "cuda":
            _pat.load()  # a failing build raises here, not mid-serving
        self.spec_tree_commits = 0
        self.chunk_steps = 0
        self.scheduler = StepScheduler(
            max_batch, self.pool, max_seq_len,
            prefill_chunk=self.prefill_chunk,
            prefix_cache=self.prefix_cache,
            prefill_token_budget=(prefill_token_budget
                                  if self.prefill_chunk else None),
            cache_namespace=name, spec_k=self.spec_k,
            drafter=self.drafter, spec_tree=self.spec_tree)
        self.queue = RequestQueue(max_queue)
        self.max_batch = int(max_batch)
        self.async_depth = max(1, int(async_depth))
        # [(host token buffer, copy-done event | None, plan)], FIFO
        self._inflight = []

        # the weights the step reads come from this scope at every
        # dispatch
        self.scope = Scope()
        for wname, val in model.weights.items():
            self.scope.set(wname, val)
        self._weight_names = list(model.weights)
        self._prev_tokens = torch.zeros(self.max_batch, dtype=torch.int32,
                                        device=device)

        # a named lock site, tracked under PTPU_LOCK_CHECK=1; the same
        # flag turns on the invariant audit at step boundaries
        self._cv = _conc.make_condition("serving.engine.cv")
        self._lock_check = _conc.tracking_enabled()
        self._closing = False
        self.error = None
        # weight hot swap: a pending swap pauses admission; the worker
        # applies it at the first step boundary with nothing active or
        # in flight, so no request's tokens span two weight versions
        self.weight_version = 0
        self._pending_swap = None  # [weights, version, event, result]
        # failover: abort() makes the worker raise at its next step
        # boundary (or out of an injected stall) and die through the
        # normal drain path; the transient counters feed the router's
        # health machine
        self._abort_error = None
        self.transient_tolerance = max(0, int(transient_tolerance))
        self._consec_transient = 0
        self._transient_retries = 0
        # set by the first submit carrying a deadline: the deadline scan
        # never runs on a deadline-free engine
        self._track_deadlines = False
        self._tick_retryable = False
        self._gen_tokens = 0
        self._steps_dispatched = 0
        self._t_first_step = None
        self._t_last_step = None
        # a stream of the worker's own on CUDA: its uploads, steps and
        # token copies queue there, beside other workers' streams. It
        # first waits for this thread's stream, where the pool, the
        # scope's weights and the drafter's state were made
        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            self.stream.wait_stream(torch.cuda.current_stream(device))
        self._thread = threading.Thread(
            target=self._run, name="ptpu-torch-serve-%s" % name,
            daemon=True)
        self._thread.start()

    # -- submission side -----------------------------------------------
    def submit(self, request):
        worst = self.scheduler.budget_for(request)
        if worst > self.pool.blocks_total:
            raise AdmissionError(
                "request needs %d KV blocks but the pool holds %d — "
                "shorten the request or grow num_blocks"
                % (worst, self.pool.blocks_total))
        # the liveness checks and the enqueue are one atomic region
        # under the worker's lock: the worker only exits (or drains the
        # queue on death) while holding it, so a request can never land
        # in a queue nobody will pop
        with self._cv:
            if self._closing:
                raise RuntimeError("ServingEngine is closed")
            if self.error is not None:
                raise RuntimeError("serving worker %r died: %r"
                                   % (self.name, self.error))
            if request.deadline is not None:
                self._track_deadlines = True
            self.queue.submit(request)
            self._cv.notify()
        _metrics.counter("serving/requests_submitted").inc()
        _metrics.gauge("serving/queue_depth").set(len(self.queue))
        return request

    # -- failover surface ----------------------------------------------
    def abort(self, error):
        """Make the worker raise ``error`` at its next step boundary (or
        out of an injected stall) and die through the normal drain path:
        fail_all and the queue drain, the pool left empty. Idempotent
        once dead or aborted."""
        with self._cv:
            if self.error is None and self._abort_error is None:
                self._abort_error = error
            self._cv.notify_all()

    # -- decode loop ----------------------------------------------------
    def _idle(self):
        return (not len(self.queue) and not self.scheduler.has_work()
                and not self._inflight)

    def _run(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext()):
                self._loop()
        except BaseException as e:  # deliver, don't vanish
            self._die(e)

    def _loop(self):
        while True:
            with self._cv:
                while (self._abort_error is None and not self._closing
                       and self._pending_swap is None and self._idle()):
                    self._cv.wait(timeout=0.1)
                abort = self._abort_error
                if abort is None and self._closing and self._idle():
                    self._fail_pending_swap(RuntimeError(
                        "ServingEngine closed with a weight swap "
                        "pending"))
                    self._sync_stream()
                    return
            if abort is not None:
                raise abort
            if self._pending_swap is not None and \
                    not self.scheduler.has_work() and not self._inflight:
                # a clean step boundary with the batch drained: install
                # the new weights and flush the prefix cache together
                self._apply_swap()
                continue
            try:
                self._tick()
                self._consec_transient = 0
            except Exception as e:
                # a transient failure raised before any scheduler or
                # pool mutation (the boundary is still consistent) is
                # retried in place, a bounded number of times in a row;
                # anything else is replica death, the router's problem
                if (self._tick_retryable and _resil.is_transient_error(e)
                        and self._consec_transient
                        < self.transient_tolerance):
                    self._consec_transient += 1
                    self._transient_retries += 1
                    _metrics.counter("serving/step_transient_retries").inc()
                    _blackbox.record_event(
                        "step_transient_retry", model=self.name,
                        step=self._steps_dispatched, error=repr(e))
                    continue
                raise

    def _sync_stream(self):
        """Wait for the worker's stream (best effort: a dead context
        raises again here, and the worker is ending either way)."""
        if self.stream is not None:
            try:
                self.stream.synchronize()
            except Exception:
                pass

    def _fail_pending_swap(self, error):
        """Deliver a never-applied swap's failure to its waiter (cv held
        by the caller): death and close never strand a swap_weights()
        caller."""
        if self._pending_swap is None:
            return
        swap = self._pending_swap
        self._pending_swap = None
        swap[3]["error"] = error
        swap[2].set()

    def _apply_swap(self):
        """Install a pending swap at a clean step boundary (_loop checked:
        nothing active, nothing in flight — every dispatched step's
        tokens were read back, so the card has finished with the old
        weights). New tensors replace the scope's entries (the old ones
        may be shared with other replicas' scopes: never written), and
        the prefix cache is flushed in the same cv critical section. The
        upload runs on this worker's stream, so the next step it
        dispatches reads the new weights."""
        with self._cv:
            if self._pending_swap is None:
                return
            weights, version, done, result = self._pending_swap
            self._pending_swap = None
            if result.get("ready") is not None:
                self.stream.wait_event(result["ready"])
            for wname in self._weight_names:
                cur = self.scope.get(wname)
                self.scope.set(wname, torch.as_tensor(weights[wname]).to(
                    device=self.device, dtype=cur.dtype))
            flushed = self.pool.flush_prefix_cache()
            self.weight_version = version
            result["applied"] = True
            result["flushed"] = flushed
            done.set()
        _metrics.counter("online/swaps").inc()
        _blackbox.record_event("weight_swap", model=self.name,
                               version=version, flushed=flushed,
                               step=self._steps_dispatched)

    def _die(self, e):
        """Worker death: the error latch, the swap waiter, fail_all and
        the queue drain run under the lock, atomic with submit()'s
        liveness check. Steps still in flight are dropped unread: their
        tokens were never emitted, so a re-admission continues from what
        the requests received."""
        with self._cv:
            self.error = e
            self._inflight = []
            self._fail_pending_swap(e)
            self.scheduler.fail_all(e)
            while True:
                req = self.queue.pop()
                if req is None:
                    break
                req._finish(e)
                _metrics.counter("serving/requests_failed").inc()
        self._sync_stream()
        # the black box: recorded after the cv region (dump does I/O)
        _blackbox.record_event("worker_dead", model=self.name,
                               error=repr(e), steps=self._steps_dispatched)
        _blackbox.dump("worker_dead")

    def _stall(self):
        """An injected stall (``serve_stall_at_step``): stop making
        progress WITHOUT raising and without holding the worker's lock,
        until the router aborts this worker or the engine closes; then
        die through the normal drain path."""
        while self._abort_error is None and not self._closing:
            time.sleep(0.005)
        raise (self._abort_error
               or RuntimeError("stalled serving worker %r closed while "
                               "wedged" % self.name))

    def _tick(self):
        """One scheduler round: admit at the boundary, dispatch one
        fixed-shape step, lag-process materialized tokens, retire."""
        # up to step planning the scheduler and pool stay consistent, so
        # a transient failure here is retried in place by _loop (the
        # fault sites fire here, before any mutation, for that reason)
        self._tick_retryable = True
        if _resil.maybe_inject_serve_fault(self._steps_dispatched) == \
                "stall":
            self._stall()
        sched = self.scheduler
        if self._track_deadlines:
            sched.expire_deadlines(self.queue)
        if self._pending_swap is None:
            # a pending swap pauses admission so the batch drains to the
            # clean boundary the swap needs
            sched.admit(self.queue)
        _metrics.gauge("serving/queue_depth").set(len(self.queue))
        self._tick_retryable = False
        spec_plan = sched.plan_spec() if self.spec_k else None
        if spec_plan:
            # a verify window is dispatched AND materialized in one
            # round: acceptance feeds the next window's drafts
            self._dispatch_spec(spec_plan)
        else:
            if self.prefill_chunk:
                plan, chunked = sched.plan_chunk()
            else:
                plan, chunked = sched.plan_step(), False
            if plan:
                self._dispatch(plan, chunked)
                if self.spec_k:
                    # speculation is synchronous everywhere: the next
                    # plan (a verify window) reads committed history
                    while self._inflight:
                        self._process_oldest()
                elif len(self._inflight) > self.async_depth - 1:
                    self._process_oldest()
            elif self._inflight:
                # nothing left to dispatch — drain the pipeline
                self._process_oldest()
        sched.reap()
        _metrics.gauge("serving/kv_blocks_in_use").set(
            self.pool.blocks_in_use)
        if self._lock_check:
            self._check_invariants()

    def _check_invariants(self):
        """The step-boundary audit (PTPU_LOCK_CHECK=1 only): the pool's
        conservation, refcount and index invariants and the engine's own
        queue and liveness bounds, reported as concurrency violations,
        then the concurrency/* gauges published."""
        pool_dirty = False
        for msg in self.pool.check_invariants():
            # detail: the problem class (digits stripped) per model, so
            # two kinds of corruption on one pool both report while a
            # recurring one does not report every step
            pool_dirty = True
            _conc.record_violation(
                "pool-invariant", "KVBlockPool[%s]: %s" % (self.name, msg),
                locks=("serving.kv_pool",),
                detail=(self.name, re.sub(r"\d+", "N", msg)))
            _blackbox.record_event("pool_invariant_violation",
                                   model=self.name, message=msg)
        if pool_dirty:
            _blackbox.dump("invariant_violation")
        if len(self._inflight) > self.async_depth:
            _conc.record_violation(
                "engine-invariant",
                "model %r: %d in-flight steps exceed async_depth %d"
                % (self.name, len(self._inflight), self.async_depth),
                locks=("serving.engine.cv",),
                detail=(self.name, "inflight"))
        if self.spec_k and self._inflight:
            # every verify window materializes before the next plan
            _conc.record_violation(
                "engine-invariant",
                "model %r: %d steps in flight with spec_k=%d (spec "
                "windows must run synchronously)"
                % (self.name, len(self._inflight), self.spec_k),
                locks=("serving.engine.cv",),
                detail=(self.name, "spec-inflight"))
        if len(self.queue) > self.queue.max_queue:
            _conc.record_violation(
                "engine-invariant",
                "model %r: queue depth %d exceeds bound %d"
                % (self.name, len(self.queue), self.queue.max_queue),
                locks=("serving.request_queue",),
                detail=(self.name, "queue-depth"))
        occupied = self.scheduler.num_occupied
        if occupied > self.max_batch:
            _conc.record_violation(
                "engine-invariant",
                "model %r: %d occupied slots exceed max_batch %d"
                % (self.name, occupied, self.max_batch),
                locks=("serving.engine.cv",),
                detail=(self.name, "occupancy"))
        _conc.publish_metrics()

    def _trace_windows(self, plan, t0, t1, chunked):
        """One request-scoped event a traced request riding this step:
        ``prefill_chunk`` or ``decode_window`` over [t0, t1] ns."""
        sched = self.scheduler
        for seq, gen_idx in plan:
            tid = seq.request.trace_id
            if tid is None:
                continue
            prefill = (bool(sched.use_prompt[seq.slot]) if chunked
                       else gen_idx is None)
            _tracing.complete(
                "prefill_chunk" if prefill else "decode_window", t0, t1,
                trace_id=tid, request=seq.request.id, model=self.name)

    def _download(self, next_tokens):
        """Start the step's token copy to the host without waiting:
        (host buffer, event recorded after the copy | None on CPU)."""
        if self.device.type != "cuda":
            return next_tokens, None
        host = torch.empty(next_tokens.shape, dtype=next_tokens.dtype,
                           pin_memory=True)
        host.copy_(next_tokens, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _dispatch(self, plan, chunked=False):
        """Dispatch one one-token step, or with ``chunked`` one chunk
        window, without waiting for it: its ``next_tokens`` [B] chain
        into the next step on the device."""
        sched = self.scheduler
        occupancy = int(sched.active.sum())
        traced = _tracing.enabled()
        t0 = time.perf_counter_ns() if traced else 0
        with _tracing.span("serving_step", model=self.name,
                           occupancy=occupancy, chunked=chunked):
            weights = {n: self.scope.get(n) for n in self._weight_names}
            if chunked:
                feed, use_prompt, positions, lengths, active, tables = \
                    upload_int32(self.device, sched.chunk_feed,
                                 sched.use_prompt, sched.positions,
                                 sched.chunk_lens, sched.active,
                                 sched.block_tables)
                next_tokens = self.model.prefill_step(
                    self.pool.k, self.pool.v, feed, use_prompt.bool(),
                    self._prev_tokens, positions, lengths, tables,
                    active.bool(), weights=weights)
                self.chunk_steps += 1
            else:
                feed, use_prompt, positions, active, tables = upload_int32(
                    self.device, sched.prompt_feed, sched.use_prompt,
                    sched.positions, sched.active, sched.block_tables)
                next_tokens = self.model.decode_step(
                    self.pool.k, self.pool.v, feed, use_prompt.bool(),
                    self._prev_tokens, positions, tables, active.bool(),
                    weights=weights)
        if traced:
            self._trace_windows(plan, t0, time.perf_counter_ns(), chunked)
        self._prev_tokens = next_tokens
        self._inflight.append(self._download(next_tokens) + (plan,))
        _metrics.gauge("serving/inflight_steps").set(len(self._inflight))
        self._note_step(occupancy)
        if _metrics.enabled():
            reg = _metrics.registry()
            if chunked:
                reg.counter("serving/prefill_chunk_steps").inc()
                n_prefill = int(sched.chunk_lens[sched.use_prompt].sum())
                n_decode = len(plan) - int(sched.use_prompt.sum())
            else:
                n_prefill = sum(1 for _seq, g in plan if g is None)
                n_decode = len(plan) - n_prefill
            reg.counter("serving/prefill_tokens").inc(n_prefill)
            reg.counter("serving/decode_tokens").inc(n_decode)

    def _dispatch_spec(self, plan):
        """Dispatch one verify window and fold it back at once (the
        window's tokens are read before anything else is planned)."""
        sched = self.scheduler
        occupancy = int(sched.active.sum())
        traced = _tracing.enabled()
        t0 = time.perf_counter_ns() if traced else 0
        with _tracing.span("serving_spec_step", model=self.name,
                           occupancy=occupancy):
            weights = {n: self.scope.get(n) for n in self._weight_names}
            feed, use_prompt, positions, lengths, active, tables = \
                upload_int32(self.device, sched.spec_feed,
                             sched.use_prompt, sched.positions,
                             sched.spec_lens, sched.active,
                             sched.block_tables)
            args = (self.pool.k, self.pool.v, feed, use_prompt.bool(),
                    self._prev_tokens, positions, lengths, tables,
                    active.bool())
            if self.spec_tree:
                out = self.model.spec_tree_step(*args, self.spec_tree,
                                                weights=weights)
            else:
                out = self.model.spec_step(*args, weights=weights)
        outs = out.cpu().numpy()     # materialize now (the sync contract)
        if traced:
            t1 = time.perf_counter_ns()
            for seq, window in plan:
                tid = seq.request.trace_id
                if tid is not None:
                    _tracing.complete(
                        "spec_window", t0, t1, trace_id=tid,
                        request=seq.request.id, model=self.name,
                        window=len(window))
        self._note_step(occupancy)
        if self.spec_tree:
            # the acceptance walk first; the accepted paths' KV is
            # compacted into the committed layout BEFORE record_spec_tree
            # truncates the tail blocks its sources may live in
            accepted = []              # (path, emitted), in plan order
            src = np.zeros(sched.spec_feed.shape, np.int32)
            n_commit = np.zeros(self.max_batch, np.int32)
            for seq, window in plan:
                path, emitted = spec_tree_acceptance(
                    window, outs[seq.slot], self.spec_tree[0])
                accepted.append((path, emitted))
                if any(s != j + 1 for j, s in enumerate(path)):
                    src[seq.slot, 1:1 + len(path)] = path  # [0, path...]
                    n_commit[seq.slot] = 1 + len(path)
            if n_commit.any():
                src_d, n_commit_d, commit_active = upload_int32(
                    self.device, src, n_commit, n_commit > 0)
                self.model.tree_commit(self.pool.k, self.pool.v, positions,
                                       src_d, n_commit_d, tables,
                                       commit_active.bool())
                self.spec_tree_commits += 1
                _metrics.counter("serving/spec_tree_commits").inc()
        # a row's next one-token step chains prev_tokens: point each spec
        # row's entry at its last committed token (rows outside the plan
        # never chain theirs: they retire, or start with a prompt)
        prev = np.zeros(self.max_batch, np.int32)
        n_emitted = 0
        for i, (seq, window) in enumerate(plan):
            was_done = seq.request.finished
            if self.spec_tree:
                n_emitted += sched.record_spec_tree(seq, window,
                                                    *accepted[i])
            else:
                n_emitted += sched.record_spec(seq, window, outs[seq.slot])
            prev[seq.slot] = seq.request.tokens[-1]
            if seq.request.finished and not was_done:
                self._note_completion(seq.request)
        self._prev_tokens = upload_int32(self.device, prev)[0]
        self._count_tokens(n_emitted)
        if _metrics.enabled():
            reg = _metrics.registry()
            reg.counter("serving/decode_tokens").inc(n_emitted)
            reg.gauge("serving/spec_accept_rate").set(
                sched.spec_accepted / max(1, sched.spec_proposed))

    def _note_step(self, occupancy):
        self._steps_dispatched += 1
        now = time.perf_counter()
        if self._t_first_step is None:
            self._t_first_step = now
        self._t_last_step = now
        if _metrics.enabled():
            reg = _metrics.registry()
            reg.counter("serving/steps").inc()
            reg.gauge("serving/batch_occupancy").set(occupancy)
            peak = reg.gauge("serving/peak_batch_occupancy")
            if occupancy > peak.value:
                peak.set(occupancy)

    def _count_tokens(self, n):
        if not n:
            return
        self._gen_tokens += n
        if (self._t_first_step is not None
                and self._t_last_step > self._t_first_step):
            _metrics.gauge("serving/tokens_per_sec").set(
                self._gen_tokens / (self._t_last_step - self._t_first_step))

    def _process_oldest(self):
        host, done, plan = self._inflight.pop(0)
        _metrics.gauge("serving/inflight_steps").set(len(self._inflight))
        if done is not None:
            done.synchronize()  # waits for this step only
        tokens = host.numpy()
        for seq, gen_idx in plan:
            was_done = seq.request.finished
            had_first = seq.request.first_token_time is not None
            self.scheduler.record_token(seq, gen_idx, tokens[seq.slot])
            if not had_first and seq.request.first_token_time is not None:
                self._note_first_token(seq.request)
            if seq.request.finished and not was_done:
                self._note_completion(seq.request)
        self._count_tokens(sum(1 for _, g in plan if g is not None))

    def _note_first_token(self, request):
        ttft = request.ttft
        if ttft is None or not _metrics.enabled():
            return
        reg = _metrics.registry()
        h = reg.histogram("serving/ttft")
        h.observe(ttft)
        reg.gauge("serving/ttft_p50").set(h.quantile(0.50))
        reg.gauge("serving/ttft_p99").set(h.quantile(0.99))

    def _note_completion(self, request):
        _metrics.counter("serving/requests_completed").inc()
        lat = request.latency
        if lat is None or not _metrics.enabled():
            return
        reg = _metrics.registry()
        h = reg.histogram("serving/request_latency")
        h.observe(lat)
        reg.gauge("serving/request_latency_p50").set(h.quantile(0.50))
        reg.gauge("serving/request_latency_p99").set(h.quantile(0.99))

    # -- shutdown -------------------------------------------------------
    def close(self, timeout=30.0):
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        self._thread.join(timeout)


def _resolve_swap_weights(source, worker):
    """A swap source (GenerationModel | Scope | dict | artifact dir) in
    the worker's weight layout, checked name by name against what it
    serves: a swap changes values, never shapes or the store's dtypes.
    An artifact directory is digest-verified on load (a torn export
    never serves); an fp32 model is quantized when the worker serves the
    int8 store."""
    if isinstance(source, str):
        source = load_generation_artifact(source, name=worker.name,
                                          device=worker.device)
    if isinstance(source, GenerationModel):
        if worker.model.weight_only_int8 and not source.weight_only_int8:
            source = source.quantized()
        weights = dict(source.weights)
    elif isinstance(source, Scope):
        weights = {n: source.get(n) for n in worker._weight_names}
    elif isinstance(source, dict):
        weights = source
    else:
        raise TypeError(
            "swap_weights wants a GenerationModel, Scope, weight dict or "
            "artifact directory, got %r" % (type(source).__name__,))
    out = {}
    for n in worker._weight_names:
        val = weights.get(n)
        if val is None:
            raise ValueError(
                "swap_weights: source has no weight %r for model %r "
                "(same-architecture weights required)" % (n, worker.name))
        if not isinstance(val, torch.Tensor):
            val = np.ascontiguousarray(val)
        cur = worker.scope.get(n)
        if tuple(val.shape) != tuple(cur.shape):
            raise ValueError(
                "swap_weights: weight %r shape %s != served shape %s for "
                "model %r — a swap cannot change geometry"
                % (n, tuple(val.shape), tuple(cur.shape), worker.name))
        is_int8 = str(val.dtype).endswith("int8")
        if is_int8 != (cur.dtype == torch.int8):
            raise ValueError(
                "swap_weights: weight %r is %s but model %r serves %s"
                % (n, val.dtype, worker.name, cur.dtype))
        out[n] = val
    return out


class ServingEngine:
    """Multi-model generation service (see the module docstring).

    ``models`` is a ``GenerationModel``, a generation-artifact directory
    (loaded onto the engine's device), or a ``{name: model or artifact
    directory}`` dict; a single model is served as ``"default"``.
    ``device=None`` is ``cuda:0`` and raises without CUDA;
    ``device="cpu"`` runs the plain PyTorch path. Every model must live
    on the engine's device. ``prefill_chunk`` (prompt tokens a prefill
    row takes a step, clamped to the context) turns chunked prefill on,
    with ``prefill_token_budget`` prompt tokens a step at most (default
    4 chunks); ``prefix_cache`` turns radix prefix caching on.
    ``spec_k`` (a linear verify window of ``spec_k`` drafts) or
    ``spec_tree`` (``"WxD"``: W chains of depth D) turns speculative
    decoding on; the windows are clamped to the context (a depth of at
    most ``max_seq_len - 1``), as the JAX engine clamps them. ``drafter``
    (an object with ``propose(history, k)``, optionally ``propose_for``,
    ``propose_tree``, ``propose_batch``, ``propose_tree_batch``, ``bind``
    and ``release``, such as ``ModelDrafter``) defaults to a
    ``ModelDrafter`` over the artifact ``$PTPU_SERVE_DRAFT_MODEL`` names
    (one a model), else to ``NGramDrafter``. ``deadline_s`` is each
    request's default deadline (``submit``). A transient step failure is
    retried in place up to ``transient_tolerance`` times in a row. Each
    switch left ``None`` reads its ``$PTPU_SERVE_*`` flag.
    """

    def __init__(self, models, max_batch=8, max_seq_len=256,
                 block_size=16, num_blocks=None, max_queue=64,
                 async_depth=None, device=None, prefill_chunk=None,
                 prefix_cache=None, prefill_token_budget=None, spec_k=None,
                 spec_tree=None, drafter=None, deadline_s=None,
                 transient_tolerance=2):
        device = resolve_device(device)
        if async_depth is None:
            async_depth = _flags.env("PTPU_SERVE_ASYNC_STEPS")
        if prefill_chunk is None:
            prefill_chunk = _flags.env("PTPU_SERVE_PREFILL_CHUNK")
        if prefix_cache is None:
            prefix_cache = _flags.env("PTPU_SERVE_PREFIX_CACHE")
        if spec_k is None:
            spec_k = _flags.env("PTPU_SERVE_SPEC_K")
        if spec_tree is None:
            spec_tree = _flags.env("PTPU_SERVE_SPEC_TREE")
        if deadline_s is None:
            deadline_s = _flags.env("PTPU_SERVE_DEADLINE_S")
        draft_model = _flags.env("PTPU_SERVE_DRAFT_MODEL")
        self.device = device
        self._deadline_s = deadline_s
        if not isinstance(models, dict):
            models = {"default": models}
        if not models:
            raise ValueError("ServingEngine needs at least one model")
        self._workers = {}
        for name, model in models.items():
            if isinstance(model, str):
                model = load_generation_artifact(model, name=name,
                                                 device=device)
            if not isinstance(model, GenerationModel):
                raise TypeError(
                    "model %r must be a GenerationModel or an artifact "
                    "directory, got %r" % (name, type(model).__name__))
            if model.device != device:
                raise ValueError(
                    "model %r lives on %s but the engine serves on %s — "
                    "build the model with device=%r"
                    % (name, model.device, device, str(device)))
            worker_drafter = drafter
            if worker_drafter is None and draft_model:
                # one ModelDrafter a worker: its pool and slots are
                # never shared across worker threads
                worker_drafter = ModelDrafter(load_generation_artifact(
                    draft_model, name=name + ".draft", device=device))
            self._workers[name] = _ModelWorker(
                name, model, max_batch=max_batch, max_seq_len=max_seq_len,
                block_size=block_size, num_blocks=num_blocks,
                max_queue=max_queue, async_depth=async_depth, device=device,
                prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
                prefill_token_budget=prefill_token_budget, spec_k=spec_k,
                spec_tree=spec_tree, drafter=worker_drafter,
                transient_tolerance=transient_tolerance)
        self._default = next(iter(self._workers))
        self._closed = False
        # the /healthz surface, registered only while the endpoint is
        # enabled (a flag-off engine is never pinned live by it)
        self._health_key = None
        from ..observability import endpoint as _endpoint

        if _endpoint.enabled():
            self._health_key = "engine-%x" % id(self)
            _endpoint.register_health_provider(self._health_key,
                                               self._health_json)

    # -- public API -----------------------------------------------------
    @property
    def model_names(self):
        return list(self._workers)

    def model_scope(self, model=None):
        """The named model's weight scope."""
        return self._workers[model or self._default].scope

    def weight_version(self, model=None):
        """The named model's weight version: 0 for the weights the engine
        was built with, then each applied ``swap_weights``'s (the old
        version + 1, or that call's ``version``)."""
        return self._workers[model or self._default].weight_version

    def export_weights(self, model=None):
        """A host copy (numpy) of the named model's served weights, taken
        under the worker's lock, so never half a swap: what an
        ``OnlineUpdater`` keeps as its rollback source."""
        w = self._workers[model or self._default]
        with w._cv:
            return {n: w.scope.get(n).detach().cpu().numpy()
                    for n in w._weight_names}

    def swap_weights(self, scope_or_artifact, model=None, version=None,
                     timeout=30.0):
        """Hot-swap the named model's served weights, atomically.

        ``scope_or_artifact`` is a ``GenerationModel``, a weight
        ``Scope``, a ``{name: array or tensor}`` dict or an artifact
        directory (digest-verified on load: a torn export raises
        ``GenerationArtifactError`` and is never served). The worker
        pauses admission and lets its batch and its in-flight steps
        drain; then it installs new weight tensors (on its own stream,
        before the next step it dispatches) and flushes the prefix cache
        in one critical section. So no request's tokens span two weight
        versions, and queued requests are served wholly on the new ones.

        Returns the new version (``version``, else the old one + 1).
        Raises ``TimeoutError`` when the batch does not drain within
        ``timeout`` seconds (the swap is cancelled) and ``RuntimeError``
        when the worker dies first."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        name = model or self._default
        if name not in self._workers:
            raise KeyError("unknown model %r (have %r)"
                           % (name, list(self._workers)))
        w = self._workers[name]
        weights = _resolve_swap_weights(scope_or_artifact, w)
        done = threading.Event()
        result = {"applied": False, "error": None, "flushed": 0,
                  "ready": None}
        if w.stream is not None:
            # device sources were made on this thread's stream: the
            # worker's stream waits for them before the install
            result["ready"] = torch.cuda.Event()
            result["ready"].record(torch.cuda.current_stream(w.device))
        with w._cv:
            if w.error is not None:
                raise RuntimeError("serving worker %r died: %r"
                                   % (name, w.error))
            if w._pending_swap is not None:
                raise RuntimeError(
                    "model %r already has a weight swap pending" % name)
            if version is None:
                version = w.weight_version + 1
            entry = [weights, int(version), done, result]
            w._pending_swap = entry
            w._cv.notify_all()
        if not done.wait(timeout):
            with w._cv:
                if w._pending_swap is entry:
                    w._pending_swap = None
                    raise TimeoutError(
                        "swap_weights for model %r not applied within "
                        "%.1fs (active batch still draining) — swap "
                        "cancelled" % (name, timeout))
            # the worker took it as we timed out: the event comes soon
            done.wait(timeout)
        if not result["applied"]:
            raise RuntimeError(
                "serving worker %r failed before applying the swap: %r"
                % (name, result["error"]))
        return int(version)

    def submit(self, prompt, max_new_tokens=32, eos_id=None, stream=None,
               model=None, deadline_s=None):
        """Enqueue one generation request; returns the
        :class:`GenerationRequest` handle. Raises
        :class:`AdmissionError` when the model's queue is full.
        ``deadline_s`` (default: the engine's ``deadline_s`` /
        ``$PTPU_SERVE_DEADLINE_S``; unset waits forever) fails the
        request with ``DeadlineExceededError`` at the next step boundary
        once that many seconds passed."""
        if deadline_s is None:
            deadline_s = self._deadline_s
        trace_id = _tracing.new_trace_id() if _tracing.enabled() else None
        request = GenerationRequest(prompt, max_new_tokens=max_new_tokens,
                                    eos_id=eos_id, stream=stream,
                                    model=model or self._default,
                                    deadline_s=deadline_s,
                                    trace_id=trace_id)
        return self.submit_request(request)

    def submit_request(self, request):
        """Enqueue a pre-built :class:`GenerationRequest` (the router's
        re-admission builds the request first, so its callbacks are
        attached before any token can flow). ``request.model`` picks the
        worker (None: the default)."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        name = request.model or self._default
        if name not in self._workers:
            raise KeyError("unknown model %r (have %r)"
                           % (name, list(self._workers)))
        try:
            return self._workers[name].submit(request)
        except AdmissionError:
            _metrics.counter("serving/requests_rejected").inc()
            raise

    def result(self, request, timeout=None):
        """Block until ``request`` completed; returns its token list."""
        return request.wait(timeout)

    # -- fleet surface --------------------------------------------------
    def load(self):
        """Queued plus in-batch requests across the models: what the
        router's least-loaded dispatch reads."""
        return sum(len(w.queue) + w.scheduler.num_occupied
                   for w in self._workers.values())

    def health(self):
        """Per-model liveness and progress, for the router's watchdog:
        the worker thread's liveness, the latched death error, the
        dispatched-step count (the stall watchdog's progress signal),
        whether work is pending, and the transient-failure counts."""
        out = {}
        for name, w in self._workers.items():
            out[name] = {
                "alive": w.error is None and w._thread.is_alive(),
                "error": w.error,
                "steps": w._steps_dispatched,
                "busy": bool(len(w.queue) or w.scheduler.has_work()
                             or w._inflight),
                "consecutive_transient_errors": w._consec_transient,
                "transient_retries": w._transient_retries,
            }
        return out

    def _health_json(self):
        """``health()`` with the latched error as a string: the
        /healthz body."""
        models = {}
        for name, snap in self.health().items():
            snap = dict(snap)
            snap["error"] = (repr(snap["error"])
                             if snap["error"] is not None else None)
            models[name] = snap
        return {"models": models, "load": self.load()}

    def kill(self, error=None):
        """Put the whole engine down as a dead replica goes down: every
        worker aborts at its next step boundary (or out of an injected
        stall), failing its in-batch and queued requests with ``error``
        and draining its pool through ``fail_all``. New submits are
        refused. Returns ``error``."""
        if error is None:
            error = RuntimeError("ServingEngine killed")
        self._closed = True
        for w in self._workers.values():
            w.abort(error)
        return error

    def generate(self, prompt, max_new_tokens=32, eos_id=None, model=None,
                 timeout=None):
        """Synchronous convenience: submit + wait."""
        return self.result(
            self.submit(prompt, max_new_tokens=max_new_tokens,
                        eos_id=eos_id, model=model), timeout)

    def stats(self):
        """``{model name: {...}}``: the JAX engine's keys, plus the
        worker's death error and its chunk-step count."""
        out = {}
        for name, w in self._workers.items():
            sched = w.scheduler
            out[name] = {
                "queue_depth": len(w.queue),
                "batch_occupancy": sched.num_occupied,
                "generated_tokens": w._gen_tokens,
                "steps": w._steps_dispatched,
                "error": None if w.error is None else repr(w.error),
                "prefill_chunk": w.prefill_chunk,
                "prefill_chunk_steps": w.chunk_steps,
                "prefix_cache": w.prefix_cache,
                "prefix_blocks_reused": sched.prefix_blocks_reused,
                "prefix_tokens_skipped": sched.prefix_tokens_skipped,
                "spec_k": w.spec_k,
                "spec_tree": "%dx%d" % w.spec_tree if w.spec_tree else None,
                "spec_steps": sched.spec_steps,
                "spec_proposed": sched.spec_proposed,
                "spec_accepted": sched.spec_accepted,
                "spec_emitted": sched.spec_emitted,
                "spec_blocks_rolled_back": sched.spec_blocks_rolled_back,
                "spec_tree_slots": sched.spec_tree_slots,
                "spec_tree_commits": w.spec_tree_commits,
                "spec_accept_rate": (sched.spec_accepted
                                     / max(1, sched.spec_proposed)),
                "spec_draft_steps": getattr(w.drafter, "draft_steps", 0),
                "weight_version": w.weight_version,
                "weight_only_int8": w.model.weight_only_int8,
                "weight_store": weight_store_bytes(w.model.weights),
                "deadline_expired": sched.deadline_expired,
                "transient_retries": w._transient_retries,
                **w.pool.stats(),
            }
        return out

    def close(self, timeout=30.0):
        """Drain outstanding requests and stop the worker threads."""
        if self._closed:
            return
        self._closed = True
        if self._health_key is not None:
            from ..observability import endpoint as _endpoint

            _endpoint.unregister_health_provider(self._health_key)
            self._health_key = None
        for w in self._workers.values():
            w.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
