"""The port's asynchronous executor (``async_engine.py``, ``Executor(
async_steps=)``, ``run(return_numpy=False)``, ``sync``, ``prefetch``)
held against the JAX package's contract on the CPU, on bench.py's TINY
program (fp32, plain SGD)."""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import async_engine as ae
from paddle_tpu_torch import bench as p_bench
from paddle_tpu_torch import unique_name as p_unique

TINY = p_bench.TINY


def _program():
    with p_unique.guard():
        main, startup, loss, _ = p_bench.build_program(
            TINY["seq"], "float32", False, TINY["model_kwargs"])
    return main, startup, loss


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, TINY["model_kwargs"]["vocab_size"],
                           (2, TINY["seq"])).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, 1)})
    return out


def _state(main, scope):
    return {v.name: scope.get(v.name).clone()
            for v in main.global_block().vars.values() if v.persistable}


def test_async_steps_reads_the_switch(monkeypatch):
    """`async_steps=None` takes PTPU_ASYNC_STEPS (default 12), in both
    packages; an explicit value wins."""
    def limits():
        return (pfluid.Executor("cpu")._window.limit,
                jfluid.Executor(jfluid.CPUPlace())._window.limit)

    monkeypatch.delenv("PTPU_ASYNC_STEPS", raising=False)
    assert limits() == (12, 12)
    monkeypatch.setenv("PTPU_ASYNC_STEPS", "5")
    assert limits() == (5, 5)
    assert pfluid.Executor("cpu", async_steps=3)._window.limit == 3


class _Token:
    def __init__(self, log, i):
        self.log, self.i = log, i

    def synchronize(self):
        self.log.append(self.i)


def test_window_never_exceeds_its_limit():
    """Admitting past the limit first waits for the oldest step, in
    order; drain waits for all; reset forgets without waiting."""
    log = []
    w = ae.InflightWindow(3)
    for i in range(8):
        w.admit(_Token(log, i))
        assert w.depth <= 3
    assert log == [0, 1, 2, 3, 4] and w.depth == 3 and w.peak == 3
    w.drain()
    assert log == list(range(8)) and w.depth == 0
    w.admit(_Token(log, 8))
    w.reset()
    assert w.depth == 0 and log == list(range(8))


def test_async_and_sync_runs_are_bitwise_equal():
    """Six steps with return_numpy=False (window of 2: the executor waits
    for the oldest step from the third on) and six synced steps from the
    same start give bitwise-equal losses and parameters; the async run's
    fetches are a LazyFetchList of tensors, read through as_numpy."""
    main, startup, loss = _program()
    feeds = _feeds(6)
    results = []
    for async_exec in (True, False):
        exe = pfluid.Executor("cpu", async_steps=2)
        scope = pfluid.Scope()
        torch.manual_seed(0)
        exe.run(startup, scope=scope)
        if results:  # the same start as the first run
            for n, t in results[0][2].items():
                scope.set(n, t.clone())
        start = _state(main, scope)
        outs = []
        for f in feeds:
            out = exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                          return_numpy=not async_exec)
            if async_exec:
                assert isinstance(out, ae.LazyFetchList)
                assert isinstance(out[0], torch.Tensor)
                assert exe._window.depth <= 2
            outs.append(out)
        assert exe._window.peak == (2 if async_exec else 0)
        exe.sync()
        assert exe._window.depth == 0
        losses = [ae.as_numpy(o)[0] for o in outs]
        results.append((losses, _state(main, scope), start))
        exe.close()
    (la, pa, _), (ls, ps, _) = results
    assert all(np.array_equal(a, b) for a, b in zip(la, ls))
    assert all(torch.equal(pa[n], ps[n]) for n in pa)


def test_prefetch_then_run_equals_a_plain_run():
    """``prefetch(feed)`` then ``run(feed=feed)`` reads the staged copy
    and gives the plain run's loss and params bitwise; a feed built from
    other objects (even equal values) is not substituted and leaves the
    staged batch queued for its own run."""
    main, startup, loss = _program()
    a, b = _feeds(2)
    runs = []
    for mode in ("plain", "prefetch"):
        exe = pfluid.Executor("cpu")
        scope = pfluid.Scope()
        exe.run(startup, scope=scope)
        if runs:  # the same start as the plain run
            for n, t in runs[0][0].items():
                scope.set(n, t.clone())
        start = _state(main, scope)
        if mode == "prefetch":
            exe.prefetch(a)
            copy_a = {k: v.copy() for k, v in a.items()}
            assert exe._prefetcher.take_if_match(copy_a) is None
            assert exe._prefetcher.take_if_match(b) is None
        out = []
        for f in (b, a):
            if mode == "prefetch" and f is b:
                staged_before = exe._prefetcher._keys.qsize()
            out.append(exe.run(main, feed=f, fetch_list=[loss],
                               scope=scope)[0])
            if mode == "prefetch" and f is b:
                # b was not substituted: a's batch is still queued
                assert exe._prefetcher._keys.qsize() == staged_before == 1
        if mode == "prefetch":
            assert exe._prefetcher._keys.qsize() == 0  # a consumed it
        runs.append((start, _state(main, scope), out))
        exe.close()
    (_, p_plain, o_plain), (_, p_pre, o_pre) = runs
    assert all(np.array_equal(x, y) for x, y in zip(o_plain, o_pre))
    assert all(torch.equal(p_plain[n], p_pre[n]) for n in p_plain)


def test_prefetcher_keeps_put_order_and_prefetch_iter():
    pf = ae.FeedPrefetcher("cpu", depth=2)
    feeds = _feeds(5)
    got = [s.values for s in ae.prefetch_iter(iter(feeds), pf)]
    assert len(got) == 5
    for f, s in zip(feeds, got):
        assert all(np.array_equal(s[k].numpy(), f[k]) for k in f)
    pf.close()
    with pytest.raises(RuntimeError, match="closed"):
        pf.put(feeds[0])


def test_as_numpy_reads_low_precision_tensors():
    """bf16 (which numpy lacks) comes back as float32, fp16 as float16,
    both by value; lists, LazyFetchLists and numpy pass through."""
    x = torch.tensor([1.5, -2.25], dtype=torch.bfloat16)
    h = torch.tensor([0.5, 3.0], dtype=torch.float16)
    a, b = ae.as_numpy([x, h])
    assert a.dtype == np.float32 and b.dtype == np.float16
    assert a.tolist() == [1.5, -2.25] and b.tolist() == [0.5, 3.0]
    lazy = ae.LazyFetchList([x])
    assert lazy.as_numpy()[0].tolist() == [1.5, -2.25]
    assert ae.as_numpy(np.ones(2)).tolist() == [1.0, 1.0]
