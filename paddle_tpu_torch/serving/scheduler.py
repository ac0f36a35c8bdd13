"""Request queue and iteration-level (continuous-batching) scheduler
(Orca, OSDI '22, mapped onto a fixed-shape decode step). Host-side
numpy, as in the JAX package.

The unit of scheduling is one *decode step*: every active batch slot
advances by exactly one token per step, and sequences join and retire
only at step boundaries. Admission fills a free slot's row in the fixed
``[max_batch]`` input arrays and flips its ``active`` flag; retirement
flips it back, so the step's shapes never change.

Admission control is two-gated:

  * queue gate — ``RequestQueue`` bounds how many requests may wait;
    past ``max_queue`` a submit fails fast with ``AdmissionError``.
  * KV gate — a queued request joins the batch only when the block pool
    can reserve its worst-case block count (``blocks_needed(prompt +
    max_new)``), so decode can never deadlock on cache exhaustion. If
    the head request doesn't fit, nothing behind it jumps the queue.

Prefill rides the same step: a just-admitted sequence consumes one
prompt token per step (``use_prompt`` rows) until its prompt is
exhausted, after which its input token chains on the device from the
previous step's output. With ``prefill_chunk=C`` (chunked prefill, off
by default) a step with a row mid-prompt is a ``[max_batch, C]`` window
instead (``plan_chunk``): prefill rows consume up to C prompt tokens,
at most ``prefill_token_budget`` across the rows, and decode rows ride
along as 1-token windows. With ``prefix_cache=True`` admission adopts
the longest run of sealed blocks whose content equals the prompt's
prefix (``KVBlockPool.reserve(prefix_keys=)``), the sequence starts
past the shared span, and each full prompt block is sealed into the
pool's index once prefill has moved past it.

Speculative decoding (``spec_k=K``, or ``spec_tree=(W, D)`` with
``spec_k=D``; off by default) changes what a decode step emits: when every occupied row is
past its prompt and nothing is in flight, ``plan_spec`` plans a VERIFY
window — each row feeds its last committed token plus drafted
continuations proposed by a ``drafter`` (n-gram prompt lookup by
default): up to K in a line, or a level-order tree of W chains of depth
D. ``record_spec`` / ``record_spec_tree`` fold the materialized window
back: the accepted drafts plus the target's correction token are
emitted (>= 1 token a window), and the KV blocks past the rewound
position go back through ``KVBlockPool.truncate_owner`` (rollback).

Deadlines (``GenerationRequest(deadline_s=)``, off by default): the
engine calls ``expire_deadlines`` at its step boundaries once a request
carrying one arrives; an expired request fails with
``DeadlineExceededError``, queued or mid-batch, and a mid-batch one
retires through ``reap`` so the pool's accounting is the retirement
path's.
"""

import itertools
import threading
import time
from collections import deque

import numpy as np

from ..analysis.concurrency import make_lock
from ..observability import flight_recorder as _blackbox
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing
from .kv_cache import blocks_needed, prefix_chain_keys

__all__ = ["AdmissionError", "DeadlineExceededError", "GenerationRequest",
           "RequestQueue", "StepScheduler", "check_request_args",
           "spec_tree_acceptance"]

_req_ids = itertools.count()


def spec_tree_acceptance(window, outs, width):
    """The host acceptance walk over ONE materialized tree verify
    window. ``window`` is the level-order token window ``[root, level-1
    slots..., ...]`` the scheduler planned (``width`` chains a level);
    ``outs[j]`` is the target's greedy token after window slot ``j``'s
    root path.

    Each chain is walked on its own: level ``l``'s slot is accepted iff
    its token equals the target argmax after the previously accepted
    slot (the root for ``l == 1``). The DEEPEST accepted root path wins;
    ties go to the lowest chain (at width 1 this is bitwise the linear
    prefix walk). Returns ``(path_slots, emitted)``: the winning path's
    window slots, and its tokens plus the correction token (the argmax
    at the accepted frontier) — every window emits at least one
    sequential-greedy-identical token."""
    width = int(width)
    L = len(window)
    if L <= 1:
        return [], [int(outs[0])]
    levels = (L - 1) // width
    best_path = None
    for c in range(width):
        cur = 0
        path = []
        for lev in range(levels):
            s = 1 + lev * width + c
            if s >= L or int(window[s]) != int(outs[cur]):
                break
            path.append(s)
            cur = s
        if best_path is None or len(path) > len(best_path):
            best_path = path
    frontier = best_path[-1] if best_path else 0
    emitted = ([int(window[s]) for s in best_path]
               + [int(outs[frontier])])
    return best_path, emitted


class AdmissionError(RuntimeError):
    """Raised by submit() when the request queue is at capacity."""


class DeadlineExceededError(TimeoutError):
    """Delivered into a request whose ``deadline_s`` passed before it
    completed: the scheduler fails it at the next step boundary, queued
    or mid-batch. Counted in ``serving/requests_failed`` and
    ``serving/deadline_expired``."""


def check_request_args(prompt, max_new_tokens, deadline_s=None):
    """The request validation ``GenerationRequest`` and the router's
    ``RouterRequest`` share (one rule set for both submit surfaces):
    returns the int-coerced prompt."""
    prompt = [int(t) for t in prompt]
    if not prompt:
        raise ValueError("prompt must hold at least one token")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if deadline_s is not None and float(deadline_s) <= 0:
        raise ValueError("deadline_s must be > 0 (got %r)" % (deadline_s,))
    return prompt


class GenerationRequest:
    """One generation request plus its completion surface.

    ``stream`` (optional) is called as ``stream(request, token_id,
    finished)`` from the engine thread for every generated token, in
    order. ``wait()`` is the pull side. ``model`` names the engine's
    model (None: its default). ``deadline_s`` (None: wait forever) fails
    the request with ``DeadlineExceededError`` once that many seconds
    passed since submit. ``on_finish`` is called once, from ``_finish``,
    on success or error, possibly from an engine thread: it must not
    call back into an engine. ``trace_id`` is the request's tracing
    identity (None with tracing off).
    """

    def __init__(self, prompt, max_new_tokens=32, eos_id=None,
                 stream=None, model=None, deadline_s=None, on_finish=None,
                 trace_id=None):
        prompt = check_request_args(prompt, max_new_tokens, deadline_s)
        self.id = next(_req_ids)
        self.model = model
        self.trace_id = trace_id
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.stream = stream
        self.on_finish = on_finish
        self.submit_time = time.perf_counter()
        # absolute perf_counter deadline; None = wait forever
        self.deadline = (self.submit_time + float(deadline_s)
                         if deadline_s is not None else None)
        self.start_time = None        # admitted to the batch
        self.first_token_time = None  # first generated token materialized
        self.finish_time = None
        self.tokens = []              # generated ids (truncated at EOS)
        self.error = None
        self._done = threading.Event()

    @property
    def finished(self):
        return self._done.is_set()

    def wait(self, timeout=None):
        """Block until the request completed; returns the generated
        token list. Raises the engine-side error, if any."""
        if not self._done.wait(timeout):
            raise TimeoutError("request %d not finished" % self.id)
        if self.error is not None:
            raise self.error
        return list(self.tokens)

    @property
    def latency(self):
        if self.finish_time is None:
            return None
        return self.finish_time - self.submit_time

    @property
    def ttft(self):
        """Submit until the first generated token materialized."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    def _finish(self, error=None):
        self.error = error
        self.finish_time = time.perf_counter()
        self._done.set()
        if self.on_finish is not None:
            try:
                self.on_finish(self)
            except Exception:
                pass  # a completion consumer must not kill the engine


class RequestQueue:
    """Bounded FIFO with fail-fast admission (the queue gate)."""

    def __init__(self, max_queue=64):
        self.max_queue = int(max_queue)
        self._q = deque()
        self._lock = make_lock("serving.request_queue")

    def __len__(self):
        return len(self._q)

    def submit(self, request):
        with self._lock:
            if len(self._q) >= self.max_queue:
                raise AdmissionError(
                    "request queue full (%d waiting); retry later or "
                    "raise max_queue" % len(self._q))
            self._q.append(request)
        return request

    def peek(self):
        with self._lock:
            return self._q[0] if self._q else None

    def pop(self):
        with self._lock:
            return self._q.popleft() if self._q else None

    def pop_expired(self, now):
        """Remove and return every queued request whose deadline passed
        (the survivors keep their order)."""
        with self._lock:
            expired = [r for r in self._q
                       if r.deadline is not None and now >= r.deadline]
            if expired:
                dead = set(id(r) for r in expired)
                self._q = deque(r for r in self._q if id(r) not in dead)
        return expired


class _Sequence:
    """Scheduler-internal per-slot decode state."""

    __slots__ = ("request", "slot", "pos", "n_dispatched", "pending",
                 "finished", "dispatch_done", "prefix_keys", "sealed_upto")

    def __init__(self, request, slot):
        self.request = request
        self.slot = slot
        self.pos = 0             # position of the NEXT token to process
        self.n_dispatched = 0    # generated tokens dispatched so far
        self.pending = 0         # dispatched steps not yet processed
        self.finished = False    # result delivered (EOS/max/seq-cap)
        self.dispatch_done = False  # no more steps will be dispatched
        self.prefix_keys = ()    # content keys of the prompt's full blocks
        self.sealed_upto = 0     # prompt blocks already in the pool index

    @property
    def in_prefill(self):
        return self.pos < len(self.request.prompt)


class StepScheduler:
    """Joins/retires sequences at step boundaries over fixed slots.

    The engine drives it: ``admit()`` -> ``plan_spec()`` (speculation
    on), ``plan_chunk()`` (chunked prefill on) or ``plan_step()`` ->
    dispatch -> ``record_spec[_tree]()`` per verify window or (lagged)
    ``record_token()`` per step output -> ``reap()``.
    """

    def __init__(self, max_batch, pool, max_seq_len, prefill_chunk=0,
                 prefix_cache=False, prefill_token_budget=None,
                 cache_namespace="", spec_k=0, drafter=None,
                 spec_tree=None):
        self.max_batch = int(max_batch)
        self.pool = pool
        self.max_seq_len = int(max_seq_len)
        self.slots = [None] * self.max_batch
        # persistent step-input arrays (host side, fixed shapes)
        mb = blocks_needed(self.max_seq_len, pool.block_size)
        self.max_blocks_per_seq = mb
        self.block_tables = np.zeros((self.max_batch, mb), np.int32)
        self.prompt_feed = np.zeros(self.max_batch, np.int32)
        self.use_prompt = np.zeros(self.max_batch, bool)
        self.positions = np.zeros(self.max_batch, np.int32)
        self.active = np.zeros(self.max_batch, bool)
        # -- chunked prefill and prefix caching (both off: one token a
        # step, no sharing)
        self.prefill_chunk = max(0, int(prefill_chunk or 0))
        self.prefix_cache = bool(prefix_cache)
        self.prefill_token_budget = (
            None if prefill_token_budget is None
            else max(1, int(prefill_token_budget)))
        self.cache_namespace = str(cache_namespace)
        # host-side reuse telemetry (live with metrics off)
        self.prefix_blocks_reused = 0
        self.prefix_tokens_skipped = 0
        if self.prefill_chunk:
            self.chunk_feed = np.zeros(
                (self.max_batch, self.prefill_chunk), np.int32)
            self.chunk_lens = np.zeros(self.max_batch, np.int32)
        # -- speculative decoding (off: the one-token decode path) ------
        # the engine's worker resolves both: a tree (width, depth) comes
        # with spec_k = depth, which gates every `if self.spec_k`
        self.spec_tree = spec_tree
        self.spec_k = int(spec_k)
        self.drafter = drafter
        # host-side spec telemetry (live with metrics off). In tree mode
        # spec_proposed / spec_accepted count PATH DEPTH (deepest branch
        # fed / accepted path length), so the accept rate keeps its
        # per-chain meaning; spec_tree_slots counts every draft slot
        # verified.
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self.spec_blocks_rolled_back = 0
        self.spec_tree_slots = 0
        # host-side deadline telemetry (live with metrics off)
        self.deadline_expired = 0
        if self.spec_k:
            width = (1 + self.spec_tree[0] * self.spec_tree[1]
                     if self.spec_tree else self.spec_k + 1)
            self.spec_feed = np.zeros((self.max_batch, width), np.int32)
            self.spec_lens = np.zeros(self.max_batch, np.int32)

    # -- occupancy ------------------------------------------------------
    @property
    def num_occupied(self):
        return sum(1 for s in self.slots if s is not None)

    def has_work(self):
        return any(s is not None for s in self.slots)

    # -- admission (step boundary) -------------------------------------
    def budget_for(self, request):
        """Worst-case KV blocks of ``request`` (its reservation)."""
        total = min(len(request.prompt) + request.max_new_tokens,
                    self.max_seq_len)
        if self.spec_tree:
            # tree windows write KV up to W*D slots past the committed
            # end (rejected siblings sit at higher window offsets than
            # the emitted path reaches), so the reservation carries that
            # overhang and a window can never exhaust the pool; the
            # per-row depth clamp keeps every write < max_seq_len
            total = min(total + self.spec_tree[0] * self.spec_tree[1],
                        self.max_seq_len)
        return blocks_needed(total, self.pool.block_size)

    def admit(self, queue):
        """Move queued requests into free slots while the KV pool can
        cover their reservations (head-of-line order). Returns the list
        of admitted sequences."""
        admitted = []
        for slot in range(self.max_batch):
            if self.slots[slot] is not None:
                continue
            request = queue.peek()
            if request is None:
                break
            if len(request.prompt) >= self.max_seq_len:
                queue.pop()
                request._finish(ValueError(
                    "prompt length %d >= engine max_seq_len %d"
                    % (len(request.prompt), self.max_seq_len)))
                _metrics.counter("serving/requests_failed").inc()
                continue
            seq = _Sequence(request, slot)
            keys = ()
            if self.prefix_cache:
                # every full prompt block but one holding the last
                # prompt token: that token is processed here, so the
                # first generated token has logits to come from
                bs = self.pool.block_size
                shareable = ((len(request.prompt) - 1) // bs) * bs
                keys = prefix_chain_keys(request.prompt[:shareable], bs,
                                         namespace=self.cache_namespace)
            if not self.pool.reserve(seq, self.budget_for(request),
                                     prefix_keys=keys):
                break  # KV gate: head doesn't fit — keep queue order
            queue.pop()
            request.start_time = time.perf_counter()
            if request.trace_id is not None and _tracing.enabled():
                # a retroactive queue_wait span (submit -> admission) and
                # an admit marker naming the slot the request landed in
                _tracing.complete(
                    "queue_wait", int(request.submit_time * 1e9),
                    int(request.start_time * 1e9),
                    trace_id=request.trace_id, request=request.id)
                _tracing.instant("admit", trace_id=request.trace_id,
                                 request=request.id, slot=slot)
            self.slots[slot] = seq
            self.block_tables[slot, :] = self.pool.NULL_BLOCK
            seq.prefix_keys = tuple(keys)
            matched = self.pool.block_table(seq)
            if matched:
                # adopted shared blocks: their prefill is skipped, the
                # sequence starts past the shared span (and never writes
                # into it)
                n = len(matched) * self.pool.block_size
                self.block_tables[slot, :len(matched)] = matched
                seq.pos = n
                seq.sealed_upto = len(matched)
                self.prefix_blocks_reused += len(matched)
                self.prefix_tokens_skipped += n
                _metrics.counter("serving/prefix_blocks_reused").inc(
                    len(matched))
                _metrics.counter("serving/prefix_tokens_skipped").inc(n)
            self.positions[slot] = seq.pos
            self.active[slot] = True
            admitted.append(seq)
        return admitted

    def _seal_ready(self, slot, seq):
        """Seal every full prompt block that prefill has moved past into
        the pool's content index (its content is fixed), so later
        admissions can adopt it."""
        done = min(seq.pos, len(seq.request.prompt)) // self.pool.block_size
        while seq.sealed_upto < min(done, len(seq.prefix_keys)):
            i = seq.sealed_upto
            self.pool.seal_block(int(self.block_tables[slot, i]),
                                 seq.prefix_keys[i])
            seq.sealed_upto += 1

    # -- step planning --------------------------------------------------
    def plan_step(self):
        """Fill the fixed step-input arrays for the next decode step and
        return the per-step processing plan: a list of
        ``(seq, generated_index | None)`` rows, one per dispatching slot
        (``None`` while the slot is still consuming its prompt)."""
        plan = []
        for slot, seq in enumerate(self.slots):
            if seq is None or seq.dispatch_done:
                self.active[slot] = False
                self.use_prompt[slot] = False
                continue
            pos = seq.pos
            # lazy block allocation at boundary crossings (drawn from
            # the admission-time reservation, so it cannot fail)
            if pos % self.pool.block_size == 0:
                bid = self.pool.alloc_block(seq)
                self.block_tables[slot, pos // self.pool.block_size] = bid
            self.positions[slot] = pos
            self.active[slot] = True
            if seq.in_prefill:
                self.prompt_feed[slot] = seq.request.prompt[pos]
                self.use_prompt[slot] = True
                # the step consuming the LAST prompt token emits the
                # first generated token
                gen_idx = (0 if pos == len(seq.request.prompt) - 1
                           else None)
            else:
                self.use_prompt[slot] = False
                gen_idx = seq.n_dispatched
            if gen_idx is not None:
                seq.n_dispatched = gen_idx + 1
            seq.pos = pos + 1
            seq.pending += 1
            plan.append((seq, gen_idx))
            if (seq.n_dispatched >= seq.request.max_new_tokens
                    or seq.pos >= self.max_seq_len):
                seq.dispatch_done = True
            if seq.prefix_keys:
                self._seal_ready(slot, seq)
        return plan

    def plan_chunk(self):
        """Chunked-prefill planning (Sarathi-style mixed batches). With
        no active row mid-prompt it is ``plan_step`` (the engine then
        dispatches the one-token step). Otherwise it fills the
        ``chunk_feed``/``chunk_lens`` window arrays: prefill rows consume
        up to ``prefill_chunk`` prompt tokens, bounded across rows by
        ``prefill_token_budget`` (a row past the budget sits the step
        out), decode rows are 1-token windows. Returns ``(plan,
        chunked)``."""
        if not any(s is not None and not s.dispatch_done and s.in_prefill
                   for s in self.slots):
            return self.plan_step(), False
        bs = self.pool.block_size
        budget = self.prefill_token_budget
        plan = []
        for slot, seq in enumerate(self.slots):
            if seq is None or seq.dispatch_done:
                self._idle_chunk_row(slot)
                continue
            pos = seq.pos
            prompt = seq.request.prompt
            if seq.in_prefill:
                n = min(self.prefill_chunk, len(prompt) - pos)
                if budget is not None:
                    if budget <= 0:
                        # the step's prefill budget is spent: the row
                        # resumes next step, decode latency stays bounded
                        self._idle_chunk_row(slot)
                        continue
                    n = min(n, budget)
                    budget -= n
                self.chunk_feed[slot, :n] = prompt[pos:pos + n]
                self.use_prompt[slot] = True
                gen_idx = 0 if pos + n == len(prompt) else None
            else:
                n = 1
                self.use_prompt[slot] = False
                gen_idx = seq.n_dispatched
            # lazy block allocation at every boundary the window crosses
            # (drawn from the admission-time reservation)
            for p in range(pos, pos + n):
                if p % bs == 0:
                    self.block_tables[slot, p // bs] = \
                        self.pool.alloc_block(seq)
            self.positions[slot] = pos
            self.chunk_lens[slot] = n
            self.active[slot] = True
            if gen_idx is not None:
                seq.n_dispatched = gen_idx + 1
            seq.pos = pos + n
            seq.pending += 1
            plan.append((seq, gen_idx))
            if (seq.n_dispatched >= seq.request.max_new_tokens
                    or seq.pos >= self.max_seq_len):
                seq.dispatch_done = True
            if seq.prefix_keys:
                self._seal_ready(slot, seq)
        return plan, True

    def _idle_chunk_row(self, slot):
        self.active[slot] = False
        self.use_prompt[slot] = False
        self.chunk_lens[slot] = 0

    # -- speculative verify windows ------------------------------------
    def plan_spec(self):
        """Speculative verify-window planning. Applies only when every
        occupied row is past its prompt with no step in flight — both
        acceptance and the next window's drafts read the committed
        history — and returns ``None`` otherwise, so the engine falls
        back to the one-token plan. When it applies, fills the
        ``spec_feed``/``spec_lens`` window arrays — each dispatching row
        feeds its last committed token plus up to ``spec_k`` drafts,
        clamped so no window can overshoot ``max_new_tokens`` or the
        sequence cap (the admission reservation then always covers the
        window's blocks) — and returns the spec plan, a list of
        ``(seq, window_tokens)`` rows."""
        if not self.spec_k:
            return None
        for seq in self.slots:
            if seq is None:
                continue
            if seq.pending or (not seq.dispatch_done and seq.in_prefill):
                return None
        if self.spec_tree:
            return self._plan_spec_tree()
        # a drafter with propose_batch (ModelDrafter) drafts every row in
        # a few batched device steps before the per-row windows
        batch_drafts = None
        if self.drafter is not None and hasattr(self.drafter,
                                                "propose_batch"):
            rows = [(seq.request.id, seq.request.prompt + seq.request.tokens)
                    for seq in self.slots
                    if seq is not None and not seq.dispatch_done
                    and self._spec_limit(seq) > 1]
            if rows:
                batch_drafts = self.drafter.propose_batch(rows, self.spec_k)
        plan = []
        for slot, seq in enumerate(self.slots):
            if seq is None or seq.dispatch_done:
                self._idle_spec_row(slot)
                continue
            request = seq.request
            history = self._committed_history(seq)
            limit = self._spec_limit(seq)
            drafts = []
            if limit > 1 and self.drafter is not None:
                if batch_drafts is not None:
                    drafts = batch_drafts.get(request.id, [])
                elif hasattr(self.drafter, "propose_for"):
                    # indexed n-gram path: the same tokens at O(k) host
                    # cost a window
                    drafts = self.drafter.propose_for(
                        request.id, history, limit - 1)
                else:
                    drafts = self.drafter.propose(history, limit - 1)
                drafts = [int(t) for t in drafts][:limit - 1]
            plan.append(self._fill_spec_row(slot, seq,
                                            [history[-1]] + drafts))
        return self._count_spec_step(plan)

    def _spec_limit(self, seq):
        """Slots of a row's linear window: every emitted token takes one
        max_new slot and one sequence position (>= 1 here, else
        dispatch_done already)."""
        request = seq.request
        return min(self.spec_k + 1,
                   request.max_new_tokens - len(request.tokens),
                   self.max_seq_len - seq.pos)

    def _plan_spec_tree(self):
        """Tree verify-window planning: each dispatching row feeds a
        LEVEL-ORDER token tree ``[root, level-1 slots..., ...]`` of up to
        ``width`` chains and a per-row depth clamped so the emitted path
        can never overshoot ``max_new_tokens`` and no window slot writes
        at or past the sequence cap. Chains shorter than the row's depth
        pad their missing slots with token 0 (a pad is a draft that will
        not match). Rows whose drafter proposes nothing (or whose clamp
        is 0) ride as 1-slot windows: plain decode through the tree
        step."""
        W, D = self.spec_tree
        rows = []
        for slot, seq in enumerate(self.slots):
            if seq is None or seq.dispatch_done:
                self._idle_spec_row(slot)
                continue
            request = seq.request
            history = self._committed_history(seq)
            # depth clamp: path emission (depth + correction) within the
            # max_new budget, every window slot (pos + 1 .. pos + W*d)
            # strictly below the sequence cap
            d = min(D, request.max_new_tokens - len(request.tokens) - 1,
                    (self.max_seq_len - seq.pos - 1) // W)
            rows.append((slot, seq, history, max(d, 0)))
        # the draft pass: batched when the drafter can (ModelDrafter),
        # per row otherwise
        drafter = self.drafter
        need = [r for r in rows if r[3] > 0] if drafter is not None else []
        chains_by_slot = {}
        if need and hasattr(drafter, "propose_tree_batch"):
            got = drafter.propose_tree_batch(
                [(seq.request.id, h, d) for _s, seq, h, d in need], W)
            for slot, seq, _h, _d in need:
                chains_by_slot[slot] = got.get(seq.request.id, [])
        else:
            for slot, seq, h, d in need:
                if hasattr(drafter, "propose_tree"):
                    chains_by_slot[slot] = drafter.propose_tree(
                        h, W, d, seq_id=seq.request.id)
                else:
                    chains_by_slot[slot] = [list(drafter.propose(h, d))]
        plan = []
        for slot, seq, history, d in rows:
            chains = [[int(t) for t in ch][:d]
                      for ch in chains_by_slot.get(slot, [])][:W]
            chains = [ch for ch in chains if ch]
            d_used = max((len(ch) for ch in chains), default=0)
            window = [history[-1]]
            for lev in range(d_used):
                for c in range(W):
                    ch = chains[c] if c < len(chains) else []
                    window.append(ch[lev] if lev < len(ch) else 0)
            plan.append(self._fill_spec_row(slot, seq, window))
        return self._count_spec_step(plan)

    def _committed_history(self, seq):
        history = seq.request.prompt + seq.request.tokens
        if seq.pos != len(history) - 1:
            raise RuntimeError(
                "spec window planned at pos %d but the committed history "
                "holds %d tokens — a step result was lost"
                % (seq.pos, len(history)))
        return history

    def _idle_spec_row(self, slot):
        self.active[slot] = False
        self.use_prompt[slot] = False
        self.spec_lens[slot] = 0

    def _fill_spec_row(self, slot, seq, window):
        """One dispatching row of a verify window: lazy block allocation
        for every boundary the window crosses (drawn from the admission
        reservation, which covers the clamped window), then the row's
        window arrays. The root comes from ``spec_feed`` (use_prompt)."""
        bs = self.pool.block_size
        pos = seq.pos
        for p in range(pos, pos + len(window)):
            if p % bs == 0:
                self.block_tables[slot, p // bs] = self.pool.alloc_block(seq)
        self.spec_feed[slot, :len(window)] = window
        self.spec_lens[slot] = len(window)
        self.positions[slot] = pos
        self.use_prompt[slot] = True
        self.active[slot] = True
        seq.pending += 1
        return seq, window

    def _count_spec_step(self, plan):
        if plan:
            self.spec_steps += 1
            _metrics.counter("serving/spec_steps").inc()
        return plan

    def record_spec(self, seq, window, outs):
        """Fold one materialized linear verify window back into its
        sequence: acceptance is the longest prefix where draft == the
        target's argmax at the previous slot; the accepted run plus the
        correction token are emitted (``_emit_spec``). Returns the number
        of tokens emitted."""
        seq.pending -= 1
        if seq.finished:
            return 0
        drafts = [int(t) for t in window[1:]]
        m = 0
        while m < len(drafts) and drafts[m] == int(outs[m]):
            m += 1
        self.spec_proposed += len(drafts)
        self.spec_accepted += m
        _metrics.counter("serving/spec_proposed").inc(len(drafts))
        _metrics.counter("serving/spec_accepted").inc(m)
        return self._emit_spec(seq, drafts[:m] + [int(outs[m])])

    def record_spec_tree(self, seq, window, path_slots, emitted):
        """Fold one materialized TREE verify window back into its
        sequence: the engine has already run ``spec_tree_acceptance``
        and compacted the accepted path's KV, so this is the bookkeeping
        half — emission, position advance and the rollback of every
        rejected branch. Returns the number of tokens emitted."""
        seq.pending -= 1
        if seq.finished:
            return 0
        n_slots = len(window) - 1
        depth_fed = n_slots // self.spec_tree[0]  # full levels
        self.spec_proposed += depth_fed
        self.spec_accepted += len(path_slots)
        self.spec_tree_slots += n_slots
        _metrics.counter("serving/spec_proposed").inc(depth_fed)
        _metrics.counter("serving/spec_accepted").inc(len(path_slots))
        _metrics.counter("serving/spec_tree_slots").inc(n_slots)
        return self._emit_spec(seq, emitted)

    def _emit_spec(self, seq, emitted):
        """Emit the accepted run + correction token in order, truncated
        at EOS / ``max_new_tokens`` / the sequence cap (no post-EOS token
        is ever emitted), advance the sequence to its first unverified
        position, and return the KV blocks past it through
        ``KVBlockPool.truncate_owner`` (rollback)."""
        request = seq.request
        pos = seq.pos
        n_emit = 0
        for tok in emitted:
            request.tokens.append(tok)
            n_emit += 1
            if request.first_token_time is None:
                request.first_token_time = time.perf_counter()
            hit_eos = request.eos_id is not None and tok == request.eos_id
            final = (hit_eos
                     or len(request.tokens) >= request.max_new_tokens
                     or pos + n_emit >= self.max_seq_len)
            if request.stream is not None:
                try:
                    request.stream(request, tok, bool(final))
                except Exception:
                    pass  # a streaming consumer must not kill the engine
            if final:
                # the rest of the accepted run is discarded, never
                # emitted; its KV writes are rolled back below
                seq.finished = True
                seq.dispatch_done = True
                request._finish()
                break
        seq.pos = pos + n_emit
        seq.n_dispatched = len(request.tokens)
        if (len(request.tokens) >= request.max_new_tokens
                or seq.pos >= self.max_seq_len):
            seq.dispatch_done = True
        keep = blocks_needed(seq.pos, self.pool.block_size)
        dropped = self.pool.truncate_owner(seq, keep)
        if dropped:
            self.spec_blocks_rolled_back += len(dropped)
            self.block_tables[seq.slot, keep:keep + len(dropped)] = \
                self.pool.NULL_BLOCK
        self.spec_emitted += n_emit
        return n_emit

    # -- lagged result processing --------------------------------------
    def record_token(self, seq, gen_idx, token):
        """Fold one materialized decode output back into its sequence
        (called in dispatch order, possibly several steps after the
        dispatch, under the async window)."""
        seq.pending -= 1
        if gen_idx is None or seq.finished:
            return
        request = seq.request
        if len(request.tokens) != gen_idx:
            # a later step of a sequence that already hit EOS — the
            # overshoot tokens are dropped
            return
        request.tokens.append(int(token))
        if len(request.tokens) == 1:
            request.first_token_time = time.perf_counter()
        hit_eos = (request.eos_id is not None
                   and int(token) == request.eos_id)
        final = (hit_eos
                 or len(request.tokens) >= request.max_new_tokens
                 or (seq.dispatch_done
                     and gen_idx == seq.n_dispatched - 1))
        if request.stream is not None:
            try:
                request.stream(request, int(token), bool(final))
            except Exception:
                pass  # a streaming consumer must not kill the engine
        if final:
            seq.finished = True
            seq.dispatch_done = True
            request._finish()

    # -- deadlines ------------------------------------------------------
    def expire_deadlines(self, queue, now=None):
        """Fail every request whose deadline passed: queued ones leave
        the queue at once; mid-batch sequences stop dispatching and
        retire through ``reap`` once their in-flight steps drain, so the
        pool's accounting is the retirement path's. The engine calls it
        at step boundaries once a request carrying a deadline arrived.
        Returns the number of requests expired."""
        if now is None:
            now = time.perf_counter()
        expired = 0
        for request in queue.pop_expired(now):
            request._finish(DeadlineExceededError(
                "request %d exceeded its deadline while queued "
                "(waited %.3fs)" % (request.id, now - request.submit_time)))
            self._note_expired(request, "queued")
            expired += 1
        for seq in self.slots:
            if seq is None or seq.finished:
                continue
            deadline = seq.request.deadline
            if deadline is None or now < deadline:
                continue
            seq.finished = True
            seq.dispatch_done = True
            seq.request._finish(DeadlineExceededError(
                "request %d exceeded its deadline mid-generation "
                "(%d/%d tokens emitted)"
                % (seq.request.id, len(seq.request.tokens),
                   seq.request.max_new_tokens)))
            self._note_expired(seq.request, "mid_generation")
            expired += 1
        if expired:
            self.deadline_expired += expired
            _metrics.counter("serving/requests_failed").inc(expired)
            _metrics.counter("serving/deadline_expired").inc(expired)
        return expired

    @staticmethod
    def _note_expired(request, where):
        """Trace marker and flight-recorder event for one expired
        request (both no-ops when off)."""
        if request.trace_id is not None and _tracing.enabled():
            _tracing.instant("deadline_expired", trace_id=request.trace_id,
                             request=request.id, where=where)
        _blackbox.record_event("deadline_expired", request=request.id,
                               where=where)

    def reap(self):
        """Retire slots whose sequence is complete AND fully drained (no
        in-flight step still writes into their blocks). Returns the
        number of freed slots."""
        freed = 0
        for slot, seq in enumerate(self.slots):
            if seq is None or seq.pending:
                continue
            if seq.dispatch_done and not seq.finished:
                # ran out of budget (max_new/max_seq) without EOS
                seq.finished = True
                seq.request._finish()
            if seq.finished:
                self.pool.free_owner(seq)
                self._release_draft_state(seq)
                self.slots[slot] = None
                self.active[slot] = False
                freed += 1
        return freed

    def _release_draft_state(self, seq):
        """Drop the drafter's per-sequence state (the n-gram suffix
        index) when its sequence retires."""
        if self.drafter is not None and hasattr(self.drafter, "release"):
            self.drafter.release(seq.request.id)

    def fail_all(self, error):
        """Engine-fatal path: deliver ``error`` to every occupied slot
        and free its blocks."""
        for slot, seq in enumerate(self.slots):
            if seq is None:
                continue
            self.pool.free_owner(seq)
            self._release_draft_state(seq)
            if not seq.request.finished:
                seq.request._finish(error)
                _metrics.counter("serving/requests_failed").inc()
            self.slots[slot] = None
            self.active[slot] = False
