"""paddle_tpu_torch speculative serving held against the JAX package on
the same weights (``GenerationModel.from_jax_weights``) and the same
numpy inputs, at a small size (2 layers, d_model 32, 2 heads, vocab 64),
on the CPU:

  (a) units: ``parse_tree_shape``, ``tree_topology`` (bitwise),
      ``spec_tree_acceptance`` over random windows, ``NGramDrafter``
      proposals and its O(k) index cost, ``truncate_owner`` accounting;
  (b) steps: ``spec_step`` / ``spec_tree_step`` against JAX's
      ``make_spec_step`` / ``make_spec_tree_step`` (next tokens equal,
      logits atol/rtol 1e-4, pools after the step 1e-5: fp32, another
      summation order), ``tree_commit`` against ``make_tree_commit_step``;
  (c) the engine in linear and tree mode: token-identical to the port's
      and JAX's ``reference_decode`` and to JAX's engine; always-wrong
      drafts roll back and drain clean; EOS inside an accepted path
      emits nothing after it; speculation off serves as before.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import serving as jax_serving
from paddle_tpu.serving.scheduler import \
    spec_tree_acceptance as jax_acceptance
from paddle_tpu_torch import serving as port

CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_seq_len=64)


def _pair(seed):
    """(JAX model, the port's model on the CPU) over the same weights."""
    jax_model = jax_serving.GenerationModel.random(
        jax_serving.GenerationConfig(**CFG), seed=seed)
    weights = {k: np.asarray(v) for k, v in jax_model.weights.items()}
    return jax_model, port.GenerationModel.from_jax_weights(
        port.GenerationConfig(**CFG), weights, device="cpu")


def _prompts(n, seed, lo=2, hi=12, vocab=CFG["vocab_size"]):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _repetitive(n, seed):
    """bench.py's speculative traffic at this vocab: a 4-token pattern
    repeated 3 times."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"], size=4).tolist() * 3
            for _ in range(n)]


def _drained(pool):
    assert pool.check_invariants() == []
    st = pool.stats()
    assert st["blocks_in_use"] == 0
    assert st["blocks_free"] == st["blocks_total"]


# ---------------------------------------------------------------------------
# (a) units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["2x3", " 4X1 ", (3, 2), None, "", "0",
                                  "off", "false", "no", "3", "0x2", "2x0"])
def test_parse_tree_shape_matches_jax(spec):
    try:
        want = jax_serving.parse_tree_shape(spec)
    except ValueError:
        with pytest.raises(ValueError):
            port.parse_tree_shape(spec)
        return
    assert port.parse_tree_shape(spec) == want


@pytest.mark.parametrize("W,D", [(1, 1), (1, 4), (2, 3), (2, 6), (3, 4),
                                 (3, 8), (4, 4)])
def test_tree_topology_bitwise(W, D):
    for ours, theirs in zip(port.tree_topology(W, D),
                            jax_serving.tree_topology(W, D)):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        assert (ours == theirs).all()


def test_spec_tree_acceptance_matches_jax():
    """50 random windows: random widths, level-order prefixes of any
    depth (shallow rows), tokens from a small alphabet so paths
    accept."""
    rng = np.random.RandomState(0)
    accepted = 0
    for _ in range(50):
        W = rng.randint(1, 4)
        d = rng.randint(0, 5)
        window = rng.randint(0, 3, size=1 + W * d).tolist()
        outs = rng.randint(0, 3, size=1 + W * d).tolist()
        got = port.spec_tree_acceptance(window, outs, W)
        assert got == jax_acceptance(window, outs, W)
        accepted += len(got[0])
    assert accepted > 0


def _histories():
    rng = np.random.RandomState(5)
    yield rng.randint(0, 16, size=40).tolist() + [7, 8, 4, 5, 7, 8]
    yield ([5, 1, 9, 6, 0] * 4 + [5, 1, 9, 7, 2] * 3 + [5, 1, 9])
    yield rng.randint(0, 4, size=60).tolist()
    yield [3, 1, 4, 1, 5, 9, 2, 6]                   # no recurrence
    yield [2]


@pytest.mark.parametrize("hist", list(_histories()))
def test_ngram_drafter_matches_jax(hist):
    ours, theirs = port.NGramDrafter(), jax_serving.NGramDrafter()
    for k in (1, 3, 6):
        assert ours.propose(hist, k) == theirs.propose(hist, k)
        assert ours.propose_for("s", hist, k) == \
            theirs.propose_for("s", hist, k)
    for W, D in ((1, 3), (2, 3), (2, 6), (3, 4)):
        assert ours.propose_tree(hist, W, D) == \
            theirs.propose_tree(hist, W, D)
        assert ours.propose_tree(hist, W, D, seq_id="t") == \
            theirs.propose_tree(hist, W, D, seq_id="t")
    assert ours.index_ops == theirs.index_ops


def test_ngram_index_is_o_k_per_window():
    """Appending one token a window costs a bounded number of index
    operations, not the history's length; a shrunken history rebuilds
    and stays equal to a fresh scan."""
    rng = np.random.RandomState(5)
    hist = rng.randint(0, 16, size=200).tolist() + [7, 8, 4, 5, 7, 8]
    memo, fresh = port.NGramDrafter(), port.NGramDrafter()
    assert memo.propose_for("s", hist, 4) == fresh.propose(hist, 4)
    deltas = []
    for t in [4, 5, 7, 8, 4, 5, 7, 8, 4, 5]:
        hist = hist + [t]
        before = memo.index_ops
        assert memo.propose_for("s", hist, 4) == fresh.propose(hist, 4)
        deltas.append(memo.index_ops - before)
    assert max(deltas) < 30, deltas
    hist = hist[:20]
    assert memo.propose_for("s", hist, 4) == fresh.propose(hist, 4)
    memo.release("s")
    assert "s" not in memo._index


def test_truncate_owner_accounting_matches_jax():
    """reserve / alloc / truncate / re-alloc / free: the same block ids,
    the same dropped blocks and the same free counts as the JAX pool,
    with clean invariants after every call."""
    ours = port.KVBlockPool(n_layers=1, n_heads=1, head_dim=4, block_size=4,
                            num_blocks=8, device="cpu")
    theirs = jax_serving.KVBlockPool(n_layers=1, n_heads=1, head_dim=4,
                                     block_size=4, num_blocks=8)
    trace = []
    for pool in (ours, theirs):
        log = [pool.reserve("a", 5), pool.reserve("b", 2)]
        log += [pool.alloc_block("a") for _ in range(4)]
        log.append(pool.truncate_owner("a", 1))
        assert pool.check_invariants() == []
        log += [pool.blocks_free, pool.blocks_in_use, pool.block_table("a")]
        log += [pool.alloc_block("a") for _ in range(4)]
        log.append(pool.truncate_owner("a", 5))        # nothing to drop
        log.append(pool.truncate_owner("a", 0))
        log += [pool.alloc_block("b"), pool.truncate_owner("b", 0)]
        assert pool.check_invariants() == []
        with pytest.raises(ValueError):
            pool.truncate_owner("a", -1)
        with pytest.raises(KeyError):
            pool.truncate_owner("nobody", 0)
        log += [pool.free_owner("a"), pool.free_owner("b"), pool.blocks_free,
                pool.truncate_calls, pool.blocks_truncated]
        assert pool.check_invariants() == []
        trace.append(log)
    assert trace[0] == trace[1]


def test_check_invariants_sees_rollback_drift():
    """A reservation that does not grow back when blocks are dropped
    breaks the reserve-time ceiling, and the audit says so."""
    pool = port.KVBlockPool(n_layers=1, n_heads=1, head_dim=4, block_size=4,
                            num_blocks=8, device="cpu")
    assert pool.reserve("a", 3)
    pool.alloc_block("a")
    pool.alloc_block("a")
    pool.truncate_owner("a", 1)
    assert pool.check_invariants() == []
    pool._reserved["a"] -= 1          # drift: a dropped unit lost
    assert any("reservation" in p for p in pool.check_invariants())


# ---------------------------------------------------------------------------
# (b) steps
# ---------------------------------------------------------------------------

BS, MB, NB = 4, 8, 24
TABLES = np.array([[5, 2, 7, 3, 9, 11, 0, 0],
                   [1, 4, 6, 8, 10, 12, 13, 0],
                   [0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
OWNED = np.unique(TABLES[TABLES > 0])


def _pools(seed):
    """The same random pool contents for both packages."""
    shape = (CFG["n_layers"], NB + 1, BS, CFG["n_heads"],
             CFG["d_model"] // CFG["n_heads"])
    rng = np.random.RandomState(seed)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    return (jnp.asarray(k), jnp.asarray(v),
            torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))


def _window_inputs(C, seed):
    """Three rows: a full window, a shorter (shallow) one, and an
    inactive row with a stale position past its table."""
    rng = np.random.RandomState(seed)
    feed = rng.randint(0, CFG["vocab_size"], size=(3, C)).astype(np.int32)
    use_prompt = np.array([True, False, True])
    prev = rng.randint(0, CFG["vocab_size"], size=3).astype(np.int32)
    positions = np.array([9, 14, 40], np.int32)
    lengths = np.array([C, max(1, C - 2), C], np.int32)
    active = np.array([True, True, False])
    return feed, use_prompt, prev, positions, lengths, active


def _run_window(tree, seed):
    jax_model, model = _pair(seed)
    C = 1 + tree[0] * tree[1] if tree else 5
    jk, jv, tk, tv = _pools(seed)
    feed, use_prompt, prev, positions, lengths, active = \
        _window_inputs(C, seed)
    if tree:
        step = jax_model.make_spec_tree_step(3, MB, *tree,
                                             return_logits=True)
    else:
        step = jax_model.make_spec_step(3, MB, C, return_logits=True)
    jk, jv, j_next, j_logits = step(
        jax_model.weights, jk, jv, feed, use_prompt, prev, positions,
        lengths, TABLES, active)
    args = [torch.from_numpy(a) for a in (feed, use_prompt, prev, positions,
                                          lengths, TABLES, active)]
    if tree:
        t_next, t_logits = model.spec_tree_step(tk, tv, *args, tree,
                                                return_logits=True)
    else:
        t_next, t_logits = model.spec_step(tk, tv, *args,
                                           return_logits=True)
    assert tuple(t_next.shape) == (3, C) and t_next.dtype == torch.int32
    for b in range(2):                       # the active rows' valid slots
        n = lengths[b]
        assert t_next.numpy()[b, :n].tolist() == \
            np.asarray(j_next)[b, :n].tolist()
        np.testing.assert_allclose(t_logits.numpy()[b, :n],
                                   np.asarray(j_logits)[b, :n],
                                   atol=1e-4, rtol=1e-4)
    for j_pool, t_pool in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(t_pool.numpy()[:, OWNED],
                                   np.asarray(j_pool)[:, OWNED],
                                   atol=1e-5, rtol=1e-5)
    return jax_model, model, (jk, jv, tk, tv), positions


def test_spec_step_matches_jax():
    _run_window(None, seed=3)


@pytest.mark.parametrize("tree", [(2, 2), (2, 3)])
def test_spec_tree_step_matches_jax(tree):
    _run_window(tree, seed=4)


@pytest.mark.parametrize("tree", [(2, 2), (2, 3)])
def test_tree_commit_matches_jax(tree):
    """After a tree window, compact an accepted path per row (row 0 down
    chain 1, row 1 a one-slot path, row 2 inactive): the same pools."""
    jax_model, model, (jk, jv, tk, tv), positions = _run_window(tree, 5)
    W, D = tree
    C = 1 + W * D
    src = np.zeros((3, C), np.int32)
    path0 = [1 + lev * W + 1 for lev in range(D)]     # chain 1, full depth
    src[0, 1:1 + D] = path0
    src[1, 1] = 2
    n_commit = np.array([1 + D, 2, 3], np.int32)
    active = np.array([True, True, False])
    commit = jax_model.make_tree_commit_step(3, MB, C)
    jk, jv = commit(jk, jv, positions, src, n_commit, TABLES, active)
    model.tree_commit(tk, tv, *[torch.from_numpy(a) for a in (
        positions, src, n_commit, TABLES, active)])
    for j_pool, t_pool in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(t_pool.numpy()[:, OWNED],
                                   np.asarray(j_pool)[:, OWNED],
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) the engine
# ---------------------------------------------------------------------------


def _serve(engine, prompts, max_new, **submit):
    with engine:
        reqs = [engine.submit(p, max_new_tokens=max_new, **submit)
                for p in prompts]
        got = [r.wait(300) for r in reqs]
        stats = engine.stats()["default"]
    return got, stats


@pytest.mark.parametrize("mode", [{"spec_k": 3}, {"spec_tree": "2x2"},
                                  {"spec_tree": "2x3"}],
                         ids=["linear3", "tree2x2", "tree2x3"])
def test_engine_token_identical_to_jax_and_reference(mode):
    """Random and repetitive prompts through a 3-slot engine: the port's
    tokens equal both reference decoders and JAX's engine in the same
    mode; the windows ran and the pool drains clean."""
    jax_model, model = _pair(seed=11)
    prompts = _prompts(3, seed=19) + _repetitive(3, seed=2)
    refs = [port.reference_decode(model, p, 10) for p in prompts]
    assert refs == [jax_serving.reference_decode(jax_model, p, 10)
                    for p in prompts]
    engine = port.ServingEngine(model, max_batch=3, max_seq_len=64,
                                block_size=4, device="cpu", **mode)
    got, st = _serve(engine, prompts, 10)
    want, _ = _serve(jax_serving.ServingEngine(
        jax_model, max_batch=3, max_seq_len=64, block_size=4, **mode),
        prompts, 10)
    assert got == want == refs
    _drained(engine._workers["default"].pool)
    assert st["spec_steps"] > 0 and st["spec_accepted"] > 0
    assert np.isfinite(st["spec_accept_rate"])
    if "spec_tree" in mode:
        assert st["spec_tree"] == mode["spec_tree"]
        assert st["spec_tree_slots"] > 0
    else:
        assert st["spec_tree"] is None and st["spec_tree_slots"] == 0


class _WrongDrafter:
    """Knows each request's reference continuation and proposes tokens
    that differ from it at every level of every chain."""

    def __init__(self, prompts, refs):
        self.cont = {tuple(p): r for p, r in zip(prompts, refs)}

    def _next(self, history):
        for n in range(len(history), 0, -1):
            ref = self.cont.get(tuple(history[:n]))
            if ref is not None:
                return ref[len(history) - n:]
        raise AssertionError("unknown history")

    def propose(self, history, k):
        return [(t + 1) % CFG["vocab_size"]
                for t in self._next(history)[:k]]

    def propose_tree(self, history, width, depth, seq_id=None):
        nxt = self._next(history)[:depth]
        return [[(t + 1 + c) % CFG["vocab_size"] for t in nxt]
                for c in range(width)]


@pytest.mark.parametrize("mode", [{"spec_k": 3}, {"spec_tree": "2x2"}],
                         ids=["linear3", "tree2x2"])
def test_always_wrong_drafts_roll_back(mode):
    _, model = _pair(seed=0)
    prompts = _prompts(4, seed=3)
    refs = [port.reference_decode(model, p, 12) for p in prompts]
    engine = port.ServingEngine(model, max_batch=3, max_seq_len=64,
                                block_size=4, device="cpu",
                                drafter=_WrongDrafter(prompts, refs),
                                **mode)
    got, st = _serve(engine, prompts, 12)
    assert got == refs
    _drained(engine._workers["default"].pool)
    assert st["spec_accepted"] == 0 and st["spec_proposed"] > 0
    assert st["spec_blocks_rolled_back"] > 0
    assert st["spec_tree_commits"] == 0


class _OracleDrafter(_WrongDrafter):
    """Proposes the reference's own continuation on chain 0 (so every
    level accepts down the chain, whose slots sit out of place for
    width > 1) and wrong tokens on the other chains."""

    def propose(self, history, k):
        return self._next(history)[:k]

    def propose_tree(self, history, width, depth, seq_id=None):
        nxt = self._next(history)[:depth]
        return [nxt] + [[(t + c) % CFG["vocab_size"] for t in nxt]
                        for c in range(1, width)]


@pytest.mark.parametrize("mode", [{"spec_k": 4}, {"spec_tree": "2x3"}],
                         ids=["linear4", "tree2x3"])
def test_eos_inside_an_accepted_path(mode):
    """EOS lands inside an accepted run: the request ends at EOS, the
    stream sees exactly the pre-EOS tokens and EOS, nothing after; in
    tree mode the accepted path's KV was compacted (commits ran)."""
    _, model = _pair(seed=5)
    prompt = [3, 7, 11, 2, 9]
    ref = port.reference_decode(model, prompt, 16)
    eos = ref[6]
    want = port.reference_decode(model, prompt, 16, eos_id=eos)
    assert want[-1] == eos and len(want) < 16
    other = _prompts(1, seed=41, lo=4, hi=8)[0]
    other_ref = port.reference_decode(model, other, 10)
    drafter = _OracleDrafter([prompt, other], [ref, other_ref])
    seen = []
    engine = port.ServingEngine(model, max_batch=2, max_seq_len=64,
                                block_size=4, device="cpu",
                                drafter=drafter, **mode)
    with engine:
        r = engine.submit(prompt, max_new_tokens=16, eos_id=eos,
                          stream=lambda rq, t, fin: seen.append((t, fin)))
        r2 = engine.submit(other, max_new_tokens=10)
        got, got2 = r.wait(300), r2.wait(300)
        st = engine.stats()["default"]
    _drained(engine._workers["default"].pool)
    assert got == want and got2 == other_ref
    assert [t for t, _ in seen] == want
    assert [f for _, f in seen] == [False] * (len(want) - 1) + [True]
    assert st["spec_accept_rate"] == 1.0
    if "spec_tree" in mode:
        assert st["spec_tree_commits"] > 0


def test_speculation_off_serves_as_before(monkeypatch):
    """spec_k=0 and no tree: no verify window, the one-token path as
    before (token-identical to JAX's engine and the reference); the env
    flags turn speculation on when the arguments are None."""
    jax_model, model = _pair(seed=9)
    prompts = _prompts(3, seed=13)
    refs = [port.reference_decode(model, p, 6) for p in prompts]
    monkeypatch.setenv("PTPU_SERVE_SPEC_K", "3")
    engine = port.ServingEngine(model, max_batch=2, max_seq_len=64,
                                block_size=4, device="cpu", spec_k=0)
    got, st = _serve(engine, prompts, 6)
    want, _ = _serve(jax_serving.ServingEngine(
        jax_model, max_batch=2, max_seq_len=64, block_size=4, spec_k=0),
        prompts, 6)
    assert got == want == refs
    assert st["spec_k"] == 0 and st["spec_steps"] == 0
    assert engine._workers["default"].drafter is None
    engine = port.ServingEngine(model, max_batch=2, max_seq_len=64,
                                block_size=4, device="cpu")
    assert engine._workers["default"].spec_k == 3
    assert isinstance(engine._workers["default"].drafter, port.NGramDrafter)
    got, st = _serve(engine, prompts, 6)
    assert got == refs and st["spec_steps"] > 0
    monkeypatch.delenv("PTPU_SERVE_SPEC_K")
    monkeypatch.setenv("PTPU_SERVE_SPEC_TREE", "2x2")
    engine = port.ServingEngine(model, max_batch=2, max_seq_len=64,
                                block_size=4, device="cpu")
    assert engine._workers["default"].spec_tree == (2, 2)
    got, st = _serve(engine, prompts, 6)
    assert got == refs and st["spec_tree_slots"] > 0


@pytest.mark.parametrize("mode,want", [
    ({"spec_k": 16}, (16, None)), ({"spec_tree": "4x8"}, (8, (4, 8))),
    ({"spec_k": 500}, (63, None)), ({"spec_tree": "2x500"}, (63, (2, 63)))],
    ids=["linear16", "tree4x8", "linear500", "tree2x500"])
def test_windows_past_the_kernels_limits_raise(mode, want):
    """The name is the test's former contract: the windows the attention
    kernels once refused (spec_k 16: C=17; a 4x8 tree: C=33) now build
    without raising, and it checks the clamps that remain: spec_k and a
    tree's depth are clamped only to the context (max_seq_len - 1), as
    the JAX engine clamps them (paddle_tpu/serving/engine.py:127-135)."""
    _, model = _pair(seed=0)
    with port.ServingEngine(model, max_batch=2, max_seq_len=64,
                            block_size=4, device="cpu", **mode) as engine:
        w = engine._workers["default"]
        assert (w.spec_k, w.spec_tree) == want


@pytest.mark.parametrize("mode", [{"spec_k": 16}, {"spec_tree": "4x8"}],
                         ids=["linear16", "tree4x8"])
def test_engine_serves_windows_past_the_former_kernel_limits(mode):
    """F2: a 17-slot linear window and a 33-slot tree window (two 32-slot
    chunks in the tree kernel), which the port's engine refused while the
    JAX engine served them, serve token-identically to the port's and
    JAX's reference_decode; the windows ran and the pool drains clean."""
    jax_model, model = _pair(seed=13)
    prompts = _repetitive(2, seed=5) + _prompts(1, seed=7)
    refs = [port.reference_decode(model, p, 20) for p in prompts]
    assert refs == [jax_serving.reference_decode(jax_model, p, 20)
                    for p in prompts]
    engine = port.ServingEngine(model, max_batch=3, max_seq_len=64,
                                block_size=4, device="cpu", **mode)
    got, st = _serve(engine, prompts, 20)
    assert got == refs
    _drained(engine._workers["default"].pool)
    assert st["spec_steps"] > 0
    if "spec_tree" in mode:
        assert st["spec_tree_slots"] > 0
