"""Pinned arrivals for the engine parity tests, and the reproduction of
why an unpinned one could fail.

Both engines (the port's and the JAX package's) start their worker thread
when they are built, and each worker tick admits whatever is queued. A
test that submits its prompts in a Python loop therefore races the
worker: under load the worker may admit before every prompt has
arrived, and the number of steps it takes follows the arrival timing.
``submit_pinned`` takes the race out. It holds the worker's condition
(a ``threading.Condition`` over an RLock, so ``submit`` re-enters it),
waits under it until the queue, the scheduler and the in-flight steps
are all empty, and only then submits. A worker tick that is still
running has then passed its admission, and the next admission comes
only after the worker takes the condition again, when every prompt is
queued.

The tests here serve the same prompts through both engines with the
arrivals pinned two ways: all queued before the first admission
(``submit_pinned``), and one admitted a tick (``one_per_admit``). Each
way both engines take the same steps and give the reference's tokens;
the two ways take different numbers of steps. So the step count, and
nothing else, depends on arrival timing.
"""

import contextlib
import functools

import numpy as np
import pytest

from paddle_tpu import serving as jax_serving
from paddle_tpu_torch import serving as port

CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_seq_len=64)


def worker_of(engine):
    """The engine's (only) model worker, ``_workers["default"]`` in both
    packages."""
    return engine._workers["default"]


@contextlib.contextmanager
def settled(engine):
    """Hold the worker's condition once nothing is queued, scheduled or
    in flight: the worker's round has ended and its next admission waits
    for the condition."""
    worker = worker_of(engine)
    with worker._cv:
        while (len(worker.queue) or worker.scheduler.has_work()
               or worker._inflight):
            worker._cv.wait(timeout=0.005)
        yield


def submit_pinned(engine, prompts, max_new_tokens):
    """Submit every prompt before the worker's next admission. Returns
    the requests in prompt order."""
    with settled(engine):
        return [engine.submit(p, max_new_tokens=max_new_tokens)
                for p in prompts]


class _OneRequest:
    """A view of a request queue that yields one request, then looks
    empty: ``admit`` through it takes at most one arrival."""

    def __init__(self, queue):
        self._queue = queue
        self._taken = False

    def peek(self):
        return None if self._taken else self._queue.peek()

    def pop(self):
        self._taken = True
        return self._queue.pop()


def _admit_one(admit, queue):
    return admit(_OneRequest(queue))


def one_per_admit(engine):
    """Pin the arrivals to one a tick: each admission takes at most one
    queued request (the engine's scheduler, not the engine, changes)."""
    sched = worker_of(engine).scheduler
    sched.admit = functools.partial(_admit_one, sched.admit)


def _pair(seed):
    jax_model = jax_serving.GenerationModel.random(
        jax_serving.GenerationConfig(**CFG), seed=seed)
    weights = {k: np.asarray(v) for k, v in jax_model.weights.items()}
    return jax_model, port.GenerationModel.from_jax_weights(
        port.GenerationConfig(**CFG), weights, device="cpu")


def _serve(engine, prompts, max_new, one_at_a_time):
    with engine:
        if one_at_a_time:
            one_per_admit(engine)
        reqs = submit_pinned(engine, prompts, max_new)
        got = [r.wait(300) for r in reqs]
        stats = engine.stats()
    return got, stats["default"]


@pytest.mark.parametrize("kw", [dict(prefill_chunk=4), dict(spec_k=3)],
                         ids=["chunk4", "linear3"])
def test_steps_follow_arrivals_tokens_do_not(kw):
    """Eight prompts through a 3-slot engine, pinned both ways: each way
    the two engines agree on tokens (the reference's) and on steps; the
    two ways differ in steps only."""
    jax_model, model = _pair(seed=17)
    rng = np.random.RandomState(19)
    prompts = [rng.randint(0, CFG["vocab_size"],
                           size=rng.randint(2, 15)).tolist()
               for _ in range(8)]
    refs = [port.reference_decode(model, p, 7) for p in prompts]
    steps = {}
    for one_at_a_time in (False, True):
        got, st = _serve(port.ServingEngine(
            model, max_batch=3, max_seq_len=64, block_size=4, device="cpu",
            **kw), prompts, 7, one_at_a_time)
        want, jst = _serve(jax_serving.ServingEngine(
            jax_model, max_batch=3, max_seq_len=64, block_size=4, **kw),
            prompts, 7, one_at_a_time)
        assert got == want == refs
        assert st["steps"] == jst["steps"]
        steps[one_at_a_time] = st["steps"]
    assert steps[False] != steps[True]


def test_submit_pinned_waits_for_a_primed_worker():
    """After a priming request the worker may still hold the finished
    sequence and discarded steps in flight; the pinned submit waits them
    out, so the batch the next admission sees is the whole set."""
    _, model = _pair(seed=3)
    with port.ServingEngine(model, max_batch=4, max_seq_len=64,
                            block_size=4, device="cpu",
                            async_depth=4) as engine:
        engine.generate([1, 2, 3], max_new_tokens=2, timeout=300)
        seen = []
        sched = worker_of(engine).scheduler
        admit = sched.admit

        def watch(queue):
            seen.append(len(queue))
            return admit(queue)

        sched.admit = watch
        reqs = submit_pinned(engine, [[5, 6], [7, 8, 9], [10]], 3)
        for r in reqs:
            r.wait(300)
    assert [n for n in seen if n][:1] == [3]
