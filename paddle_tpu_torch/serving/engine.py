"""`ServingEngine` — the continuous-batching generation service front
end of the PyTorch port.

The engine serves one model: a scope holding its weights, a blocked KV
pool on the device, a scheduler, a bounded request queue, and a worker
thread driving the fixed-shape decode step.
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
the retiring sequence owns until ``reap``.

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

Telemetry (with metrics enabled): ``serving/{queue_depth,
batch_occupancy,peak_batch_occupancy,kv_blocks_in_use,inflight_steps,
tokens_per_sec,request_latency(_p50/_p99),ttft(_p50/_p99),steps,
prefill_tokens,decode_tokens,prefill_chunk_steps,prefix_blocks_reused,
prefix_tokens_skipped,requests_submitted,requests_completed,
requests_rejected,requests_failed,spec_steps,spec_proposed,
spec_accepted,spec_tree_slots,spec_tree_commits,spec_accept_rate}``.
"""

import threading
import time

import numpy as np
import torch

from .. import flags as _flags
from ..analysis.concurrency import make_condition
from ..core.place import resolve_device
from ..core.scope import Scope
from ..observability import metrics as _metrics
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
    """The model's serving state: scope + pool + scheduler + decode
    thread."""

    def __init__(self, model, max_batch, max_seq_len, block_size,
                 num_blocks, max_queue, async_depth, device,
                 prefill_chunk=0, prefix_cache=False,
                 prefill_token_budget=None, spec_k=0, spec_tree=None,
                 drafter=None):
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
            cache_namespace=model.name, spec_k=self.spec_k,
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

        self._cv = make_condition("serving.engine.cv")
        self._closing = False
        self.error = None
        self._gen_tokens = 0
        self._steps_dispatched = 0
        self._t_first_step = None
        self._t_last_step = None
        self._thread = threading.Thread(
            target=self._run, name="ptpu-torch-serve-%s" % model.name,
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
                                   % (self.model.name, self.error))
            self.queue.submit(request)
            self._cv.notify()
        _metrics.counter("serving/requests_submitted").inc()
        _metrics.gauge("serving/queue_depth").set(len(self.queue))
        return request

    # -- decode loop ----------------------------------------------------
    def _run(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while True:
                with self._cv:
                    while (not self._closing and not len(self.queue)
                           and not self.scheduler.has_work()
                           and not self._inflight):
                        self._cv.wait(timeout=0.1)
                    if (self._closing and not len(self.queue)
                            and not self.scheduler.has_work()
                            and not self._inflight):
                        return
                self._tick()
        except BaseException as e:  # deliver, don't vanish
            self._die(e)

    def _die(self, e):
        """Worker death: the error latch, fail_all and the queue drain
        run under the lock, atomic with submit()'s liveness check."""
        with self._cv:
            self.error = e
            self.scheduler.fail_all(e)
            while True:
                req = self.queue.pop()
                if req is None:
                    break
                req._finish(e)
                _metrics.counter("serving/requests_failed").inc()

    def _tick(self):
        """One scheduler round: admit at the boundary, dispatch one
        fixed-shape step, lag-process materialized tokens, retire."""
        sched = self.scheduler
        sched.admit(self.queue)
        _metrics.gauge("serving/queue_depth").set(len(self.queue))
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
        weights = {n: self.scope.get(n) for n in self._weight_names}
        feed, use_prompt, positions, lengths, active, tables = upload_int32(
            self.device, sched.spec_feed, sched.use_prompt, sched.positions,
            sched.spec_lens, sched.active, sched.block_tables)
        args = (self.pool.k, self.pool.v, feed, use_prompt.bool(),
                self._prev_tokens, positions, lengths, tables,
                active.bool())
        if self.spec_tree:
            out = self.model.spec_tree_step(*args, self.spec_tree,
                                            weights=weights)
        else:
            out = self.model.spec_step(*args, weights=weights)
        outs = out.cpu().numpy()     # materialize now (the sync contract)
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


class ServingEngine:
    """Single-model generation service (see the module docstring).

    ``model`` is a ``GenerationModel`` or a generation-artifact directory
    (loaded onto the engine's device). ``device=None`` is ``cuda:0`` and
    raises without CUDA; ``device="cpu"`` runs the plain PyTorch path.
    The model must live on the engine's device. ``prefill_chunk`` (prompt
    tokens a prefill row takes a step, clamped to the context) turns
    chunked prefill on, with ``prefill_token_budget`` prompt tokens a
    step at most (default 4 chunks); ``prefix_cache`` turns radix prefix
    caching on. ``spec_k`` (a linear verify window of ``spec_k`` drafts)
    or ``spec_tree`` (``"WxD"``: W chains of depth D) turns speculative
    decoding on; the windows are clamped to the context (a depth of at
    most ``max_seq_len - 1``), as the JAX engine clamps them. ``drafter``
    (an object with ``propose(history, k)``, optionally ``propose_for``,
    ``propose_tree``, ``propose_batch``, ``propose_tree_batch``, ``bind``
    and ``release``, such as ``ModelDrafter``) defaults to a
    ``ModelDrafter`` over the artifact ``$PTPU_SERVE_DRAFT_MODEL`` names,
    else to ``NGramDrafter``. Each switch left ``None`` reads its
    ``$PTPU_SERVE_*`` flag.
    """

    def __init__(self, model, max_batch=8, max_seq_len=256,
                 block_size=16, num_blocks=None, max_queue=64,
                 async_depth=None, device=None, prefill_chunk=None,
                 prefix_cache=None, prefill_token_budget=None, spec_k=None,
                 spec_tree=None, drafter=None):
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
        if isinstance(model, str):
            model = load_generation_artifact(model, device=device)
        if not isinstance(model, GenerationModel):
            raise TypeError("model must be a GenerationModel or an artifact "
                            "directory, got %r" % type(model).__name__)
        if model.device != device:
            raise ValueError(
                "the model lives on %s but the engine serves on %s — "
                "build the model with device=%r"
                % (model.device, device, str(device)))
        draft_model = _flags.env("PTPU_SERVE_DRAFT_MODEL")
        if drafter is None and draft_model:
            drafter = ModelDrafter(load_generation_artifact(
                draft_model, name=model.name + ".draft", device=device))
        self.device = device
        self._closed = False
        self._worker = _ModelWorker(
            model, max_batch=max_batch, max_seq_len=max_seq_len,
            block_size=block_size, num_blocks=num_blocks,
            max_queue=max_queue, async_depth=async_depth, device=device,
            prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
            prefill_token_budget=prefill_token_budget, spec_k=spec_k,
            spec_tree=spec_tree, drafter=drafter)

    # -- public API -----------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, eos_id=None, stream=None):
        """Enqueue one generation request; returns the
        :class:`GenerationRequest` handle. Raises
        :class:`AdmissionError` when the queue is full."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        request = GenerationRequest(prompt, max_new_tokens=max_new_tokens,
                                    eos_id=eos_id, stream=stream)
        try:
            return self._worker.submit(request)
        except AdmissionError:
            _metrics.counter("serving/requests_rejected").inc()
            raise

    def result(self, request, timeout=None):
        """Block until ``request`` completed; returns its token list."""
        return request.wait(timeout)

    def generate(self, prompt, max_new_tokens=32, eos_id=None,
                 timeout=None):
        """Synchronous convenience: submit + wait."""
        return self.result(
            self.submit(prompt, max_new_tokens=max_new_tokens,
                        eos_id=eos_id), timeout)

    def stats(self):
        w = self._worker
        sched = w.scheduler
        return {
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
            "spec_accept_rate": (sched.spec_accepted
                                 / max(1, sched.spec_proposed)),
            "spec_tree_slots": sched.spec_tree_slots,
            "spec_tree_commits": w.spec_tree_commits,
            "spec_blocks_rolled_back": sched.spec_blocks_rolled_back,
            "spec_draft_steps": getattr(w.drafter, "draft_steps", 0),
            "weight_only_int8": w.model.weight_only_int8,
            "weight_store": weight_store_bytes(w.model.weights),
            **w.pool.stats(),
        }

    def close(self, timeout=30.0):
        """Drain outstanding requests and stop the worker thread."""
        if self._closed:
            return
        self._closed = True
        self._worker.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
