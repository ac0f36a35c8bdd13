"""paddle_tpu_torch radix prefix caching held against the JAX package on
the CPU, at a small size (2 layers, d_model 32, 2 heads, vocab 64):

  (a) ``prefix_chain_keys``: the same sha1 hex digests;
  (b) the pool: the JAX package's fast-path pool scenarios (sharing,
      refcounts, LRU revival and eviction tail first, revival charged
      against availability, seal rules and flush) replayed against both
      pools, every returned block id, table, stat and invariant audit
      equal;
  (c) the scheduler: one request sequence (a shared prefix, a pool small
      enough to evict) through both ``StepScheduler``s, with chunked
      prefill under a token budget and with one-token prefill: every
      step's plan and ``chunk_feed``, ``chunk_lens``, ``positions``,
      ``block_tables`` and ``active`` equal;
  (d) the engine: prefix caching alone (with an eviction) and with
      chunked prefill, token-identical to ``reference_decode`` and to
      the JAX engine, the pool drained to cached blocks.
"""

import numpy as np
import pytest

from paddle_tpu import serving as jax_serving
from paddle_tpu_torch import serving as port
from test_torch_pinned_arrivals import submit_pinned

CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_seq_len=64)


def _pools(num_blocks, block_size=4):
    return (port.KVBlockPool(1, 1, 4, block_size, num_blocks, device="cpu"),
            jax_serving.KVBlockPool(1, 1, 4, block_size, num_blocks))


# ---------------------------------------------------------------------------
# (a) keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs,namespace", [(4, ""), (4, "model"), (1, "m"),
                                          (16, "default"), (5, "x")])
def test_prefix_chain_keys_equal_jax_digests(bs, namespace):
    rng = np.random.RandomState(bs)
    for n in (0, 3, 12, 13, 47):
        toks = rng.randint(0, 32000, size=n).tolist()
        got = port.prefix_chain_keys(toks, bs, namespace=namespace)
        assert got == jax_serving.prefix_chain_keys(toks, bs,
                                                    namespace=namespace)
        assert len(got) == n // bs
        # numpy ints key like Python ints
        assert got == port.prefix_chain_keys(np.array(toks, np.int64), bs,
                                             namespace=namespace)


# ---------------------------------------------------------------------------
# (b) the pool, scenario by scenario on both pools
# ---------------------------------------------------------------------------


def _snap(pool):
    """Counts, per-block refcounts and the audit of a pool."""
    st = pool.stats()
    return ({k: st[k] for k in ("blocks_in_use", "blocks_owned",
                                "blocks_shared", "blocks_cached",
                                "blocks_reserved", "blocks_free")},
            sorted(pool._refs.items()), pool.check_invariants())


def _shared_block_freed_at_refcount_zero(pool, keys):
    log = [pool.reserve("a", 3)]
    b1, b2 = pool.alloc_block("a"), pool.alloc_block("a")
    log += [b1, b2, pool.seal_block(b1, keys[0]),
            pool.seal_block(b2, keys[1]), _snap(pool)]
    log += [pool.reserve("b", 3, prefix_keys=keys), pool.block_table("b"),
            _snap(pool), pool.free_owner("a"), _snap(pool)]
    n = pool.blocks_free
    log += [n, pool.reserve("c", n)]
    log += [[pool.alloc_block("c") for _ in range(n)], pool.free_owner("b"),
            _snap(pool)]
    return log


def _cached_blocks_revive_and_evict(pool, keys):
    log = [pool.reserve("a", 2)]
    b1, b2 = pool.alloc_block("a"), pool.alloc_block("a")
    log += [pool.seal_block(b1, keys[0]), pool.seal_block(b2, keys[1]),
            pool.free_owner("a"), pool.blocks_cached, pool.blocks_free]
    log += [pool.reserve("b", 3, prefix_keys=keys), pool.block_table("b"),
            _snap(pool), pool.free_owner("b"), pool.reserve("c", 4)]
    log += [[pool.alloc_block("c") for _ in range(4)],
            pool.lookup_prefix(keys), _snap(pool)]
    return log


def _eviction_tail_first(pool, keys):
    log = [pool.reserve("a", 3)]
    bids = [pool.alloc_block("a") for _ in range(3)]
    log += bids + [pool.seal_block(b, k) for b, k in zip(bids, keys)]
    log += [pool.free_owner("a"), pool.blocks_cached, pool.reserve("b", 4)]
    log += [[pool.alloc_block("b") for _ in range(4)],
            pool.lookup_prefix(keys), _snap(pool)]
    return log


def _revival_cannot_unback(pool, keys):
    log = [pool.reserve("a", 2)]
    b1, b2 = pool.alloc_block("a"), pool.alloc_block("a")
    log += [pool.seal_block(b1, keys[0]), pool.seal_block(b2, keys[1]),
            pool.free_owner("a"), pool.reserve("B", 4),
            pool.reserve("C", 2, prefix_keys=keys)]
    log += [[pool.alloc_block("B") for _ in range(4)], _snap(pool)]
    return log


def _seal_rules_and_flush(pool, keys):
    log = [pool.seal_block(pool.NULL_BLOCK, keys[0]),
           pool.seal_block(3, keys[0]), pool.reserve("a", 2)]
    b1, b2 = pool.alloc_block("a"), pool.alloc_block("a")
    log += [pool.seal_block(b1, keys[0]), pool.seal_block(b1, keys[0]),
            pool.seal_block(b2, keys[0]), pool.seal_block(b2, keys[1]),
            pool.free_owner("a"), pool.blocks_cached,
            pool.flush_prefix_cache(), pool.blocks_cached,
            pool.lookup_prefix(keys), pool.blocks_free, _snap(pool)]
    return log


def _truncate_refuses_shared_and_sealed(pool, keys):
    log = [pool.reserve("a", 4)]
    b1 = pool.alloc_block("a")
    log += [b1, pool.seal_block(b1, keys[0]),
            pool.reserve("b", 3, prefix_keys=keys[:1]),
            pool.alloc_block("b"), pool.alloc_block("b"),
            pool.truncate_owner("b", 1), _snap(pool)]
    for owner, keep in (("b", 0), ("a", 0)):
        try:
            pool.truncate_owner(owner, keep)
            log.append("no raise")
        except RuntimeError:
            log.append("raised")
    log += [pool.free_owner("a"), pool.free_owner("b"), _snap(pool)]
    return log


@pytest.mark.parametrize("scenario,num_blocks,n_tokens", [
    (_shared_block_freed_at_refcount_zero, 4, 8),
    (_cached_blocks_revive_and_evict, 4, 8),
    (_eviction_tail_first, 6, 12),
    (_revival_cannot_unback, 4, 8),
    (_seal_rules_and_flush, 4, 8),
    (_truncate_refuses_shared_and_sealed, 6, 8)],
    ids=lambda v: getattr(v, "__name__", str(v)).strip("_"))
def test_pool_scenario_matches_jax(scenario, num_blocks, n_tokens):
    """The same calls on both pools return the same block ids, tables,
    counts and audits; every audit is clean."""
    keys = port.prefix_chain_keys(list(range(n_tokens)), 4)
    ours, theirs = _pools(num_blocks)
    got, want = scenario(ours, keys), scenario(theirs, keys)
    assert got == want
    assert ours.check_invariants() == []


def test_pool_random_walk_matches_jax():
    """200 random reserve / adopt / alloc / seal / truncate / free calls
    on both pools: the same results and the same free, cached and index
    state after each, every audit clean."""
    rng = np.random.RandomState(0)
    ours, theirs = _pools(12)
    chains = [port.prefix_chain_keys(rng.randint(0, 3, 16).tolist(), 4)
              for _ in range(3)]
    owners = []
    for i in range(200):
        op = rng.randint(5)
        if op == 0 or not owners:
            keys = chains[rng.randint(3)][:rng.randint(0, 5)]
            args = ("o%d" % i, int(rng.randint(1, 6)), keys)
            res = [p.reserve(*args[:2], prefix_keys=args[2])
                   for p in (ours, theirs)]
            if res[0]:
                owners.append(args[0])
        else:
            owner = owners[rng.randint(len(owners))]
            if op == 1:
                res = []
                for p in (ours, theirs):
                    try:
                        res.append(p.alloc_block(owner))
                    except RuntimeError:
                        res.append("none left")
            elif op == 2:
                table = ours.block_table(owner)
                j = rng.randint(len(table)) if table else 0
                key = chains[rng.randint(3)][rng.randint(4)]
                res = [p.seal_block(p.block_table(owner)[j], key)
                       if table else None for p in (ours, theirs)]
            elif op == 3:
                keep = rng.randint(0, 4)
                res = []
                for p in (ours, theirs):
                    try:
                        res.append(p.truncate_owner(owner, keep))
                    except RuntimeError:
                        res.append("refused")
            else:
                res = [p.free_owner(owner) for p in (ours, theirs)]
                owners.remove(owner)
        assert res[0] == res[1], (i, op, res)
        assert _snap(ours) == _snap(theirs)
        assert list(ours._free) == list(theirs._free)
        assert list(ours._cached.items()) == list(theirs._cached.items())
        assert ours._sealed == theirs._sealed
        assert ours.check_invariants() == []


# ---------------------------------------------------------------------------
# (c) the scheduler, step by step against the JAX scheduler
# ---------------------------------------------------------------------------

SHARED = [5, 9, 2, 7, 1, 3, 3, 8, 6, 0, 4, 2]      # three 4-token blocks


def _arrivals():
    """(step, prompt, max_new): two requests on a shared prefix at once,
    more on it later (after the first sealed it), unrelated ones, a
    prompt whose last token ends a block, one shorter than a block."""
    rng = np.random.RandomState(4)
    tail = lambda n: rng.randint(0, 64, size=n).tolist()  # noqa: E731
    return [(0, SHARED + tail(3), 5), (0, SHARED + tail(1), 4),
            (1, tail(9), 6), (6, SHARED + tail(2), 3),
            (6, SHARED[:8], 4), (9, tail(3), 7), (12, SHARED + tail(6), 5),
            (13, SHARED + tail(5), 2), (14, tail(2), 3),
            (20, SHARED + tail(4), 4)]


def _drive(mod, pool, kw, n_steps=60):
    sched = mod.StepScheduler(3, pool, 48, cache_namespace="m", **kw)
    queue = mod.RequestQueue(32)
    arrivals = _arrivals()
    log = []
    for step in range(n_steps):
        for at, prompt, max_new in arrivals:
            if at == step:
                queue.submit(mod.GenerationRequest(prompt,
                                                   max_new_tokens=max_new))
        admitted = [(s.slot, s.pos) for s in sched.admit(queue)]
        if sched.prefill_chunk:
            plan, chunked = sched.plan_chunk()
        else:
            plan, chunked = sched.plan_step(), False
        arrays = [sched.positions, sched.block_tables, sched.active,
                  sched.use_prompt]
        if chunked:
            lens = sched.chunk_lens
            feed = np.where(np.arange(sched.prefill_chunk)[None, :]
                            < lens[:, None], sched.chunk_feed, -1)
            arrays += [lens, feed]
        else:
            arrays += [np.where(sched.use_prompt, sched.prompt_feed, -1)]
        log.append((step, admitted, chunked,
                    [(s.slot, g) for s, g in plan],
                    [a.copy().tolist() for a in arrays],
                    sched.prefix_blocks_reused, sched.prefix_tokens_skipped,
                    pool.stats()["blocks_cached"], pool.check_invariants()))
        for s, g in plan:
            # a token each request's own: the same on both sides
            sched.record_token(s, g, (len(s.request.prompt) * 7
                                      + 3 * (g or 0)) % 64)
        sched.reap()
    return log


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=4, prefill_token_budget=6, prefix_cache=True),
    dict(prefill_chunk=4, prefix_cache=False),
    dict(prefill_chunk=5, prefill_token_budget=16, prefix_cache=True),
    dict(prefix_cache=True)],
    ids=["chunk4_budget6_prefix", "chunk4", "chunk5_budget16_prefix",
         "one_token_prefix"])
def test_scheduler_steps_match_jax(kw):
    """Every step's admissions, plan and arrays equal the JAX
    scheduler's, over a pool small enough that cached prefix blocks are
    evicted; prefix reuse happened where the cache is on."""
    ours, theirs = _pools(14)
    got = _drive(port, ours, kw)
    want = _drive(jax_serving, theirs, kw)
    assert got == want
    assert all(entry[-1] == [] for entry in got)
    assert got[-1][3] == []                    # every request served
    if kw.get("prefix_cache"):
        assert got[-1][5] > 0
    if kw.get("prefill_chunk"):
        assert any(entry[2] for entry in got)


# ---------------------------------------------------------------------------
# (d) the engine
# ---------------------------------------------------------------------------


def _pair(seed):
    jax_model = jax_serving.GenerationModel.random(
        jax_serving.GenerationConfig(**CFG), seed=seed)
    weights = {k: np.asarray(v) for k, v in jax_model.weights.items()}
    return jax_model, port.GenerationModel.from_jax_weights(
        port.GenerationConfig(**CFG), weights, device="cpu")


def _shared_prompts(seed):
    """A 13-token shared prefix (three full 4-token blocks), an unrelated
    20-token prompt first (in an 8-block pool it evicts the primed
    prefix), then four prompts on the prefix and one without it."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 64, size=13).tolist()
    return shared, ([rng.randint(0, 64, 20).tolist()]
                    + [shared + rng.randint(0, 64, size=n).tolist()
                       for n in (2, 5, 1, 3)]
                    + [rng.randint(0, 64, 6).tolist()])


def _serve(engine, shared, prompts, max_new):
    with engine:
        engine.generate(shared + [7], max_new_tokens=2, timeout=300)
        reqs = submit_pinned(engine, prompts, max_new)
        got = [r.wait(300) for r in reqs]
        stats = engine.stats()["default"]
    return got, stats


@pytest.mark.parametrize("kw", [dict(prefix_cache=True, num_blocks=8),
                                dict(prefix_cache=True, prefill_chunk=4)],
                         ids=["prefix_evicting", "prefix_chunked"])
def test_engine_prefix_cache_matches_jax_and_reference(kw):
    """Shared-prefix traffic after a priming request: token-identical to
    both reference decoders and to the JAX engine; blocks were reused
    (the small pool evicts cached ones); the pool drains to cached
    blocks only, with a clean audit."""
    jax_model, model = _pair(seed=21)
    shared, prompts = _shared_prompts(seed=3)
    refs = [port.reference_decode(model, p, 9) for p in prompts]
    assert refs == [jax_serving.reference_decode(jax_model, p, 9)
                    for p in prompts]
    engine = port.ServingEngine(model, max_batch=3, max_seq_len=64,
                                block_size=4, device="cpu", **kw)
    got, st = _serve(engine, shared, prompts, 9)
    want, jst = _serve(jax_serving.ServingEngine(
        jax_model, max_batch=3, max_seq_len=64, block_size=4, **kw),
        shared, prompts, 9)
    assert got == want == refs
    assert st["prefix_cache"] and st["prefix_blocks_reused"] > 0
    assert st["prefix_blocks_reused"] == \
        jst["prefix_blocks_reused"]
    assert st["prefix_tokens_skipped"] == 4 * st["prefix_blocks_reused"]
    if kw.get("num_blocks"):
        # the long prompt evicted the primed prefix: the first request on
        # it prefilled it again
        assert st["prefix_blocks_reused"] < 3 * 4
    pool = engine._workers["default"].pool
    assert pool.check_invariants() == []
    pst = pool.stats()
    assert pst["blocks_in_use"] == 0 and pst["blocks_cached"] > 0
    assert pst["blocks_free"] == pst["blocks_total"]
