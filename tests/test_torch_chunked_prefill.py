"""paddle_tpu_torch chunked prefill held against the JAX package on the
CPU, at a small size (2 layers, d_model 32, 2 heads, vocab 64), over the
same weights (``GenerationModel.from_jax_weights``):

  (a) ``prefill_step`` against JAX's ``make_prefill_step(...,
      return_logits=True)`` on rows of mixed lengths (a full chunk, a
      short span, a decode row chaining ``prev_tokens``, a window past
      the table's end, an inactive row): next tokens equal, logits
      atol/rtol 1e-4, the pools after the step 1e-5 (fp32, another
      summation order);
  (b) the engine: chunked and chunked under a token budget,
      token-identical to both reference decoders and to the JAX engine;
      staggered arrivals across chunk boundaries with four steps in
      flight; EOS inside a chunked run.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import serving as jax_serving
from paddle_tpu_torch import serving as port
from test_torch_pinned_arrivals import submit_pinned

CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_seq_len=64)


def _pair(seed):
    jax_model = jax_serving.GenerationModel.random(
        jax_serving.GenerationConfig(**CFG), seed=seed)
    weights = {k: np.asarray(v) for k, v in jax_model.weights.items()}
    return jax_model, port.GenerationModel.from_jax_weights(
        port.GenerationConfig(**CFG), weights, device="cpu")


# ---------------------------------------------------------------------------
# (a) the step
# ---------------------------------------------------------------------------

BS, MB, NB = 4, 8, 32
TABLES = np.array([[5, 2, 7, 3, 9, 11, 0, 0],
                   [1, 4, 6, 8, 10, 12, 13, 0],
                   [14, 15, 16, 17, 18, 19, 20, 21],
                   [22, 23, 24, 25, 26, 27, 28, 29],
                   [0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
OWNED = np.unique(TABLES[TABLES > 0])


@pytest.mark.parametrize("C", [4, 8, 13])
def test_prefill_step_matches_jax(C):
    """Five rows: a prompt span of the whole chunk, a short span, a
    decode row (slot 0 from ``prev_tokens``), a span running to the
    table's end, and an inactive row with a stale position."""
    jax_model, model = _pair(seed=C)
    shape = (CFG["n_layers"], NB + 1, BS, CFG["n_heads"],
             CFG["d_model"] // CFG["n_heads"])
    rng = np.random.RandomState(C)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    feed = rng.randint(0, CFG["vocab_size"], size=(5, C)).astype(np.int32)
    use_prompt = np.array([True, True, False, True, True])
    prev = rng.randint(0, CFG["vocab_size"], size=5).astype(np.int32)
    positions = np.array([3, 17, 22, MB * BS - C, 40], np.int32)
    lengths = np.array([C, 2, 1, C, C], np.int32)
    active = np.array([True, True, True, True, False])
    step = jax_model.make_prefill_step(5, MB, C, return_logits=True)
    jk, jv, j_next, j_logits = step(
        jax_model.weights, jnp.asarray(k), jnp.asarray(v), feed, use_prompt,
        prev, positions, lengths, TABLES, active)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    args = [torch.from_numpy(a) for a in (feed, use_prompt, prev, positions,
                                          lengths, TABLES, active)]
    t_next, t_logits = model.prefill_step(tk, tv, *args, return_logits=True)
    assert tuple(t_next.shape) == (5,) and t_next.dtype == torch.int32
    assert tuple(t_logits.shape) == (5, CFG["vocab_size"])
    assert t_next.numpy()[:4].tolist() == np.asarray(j_next)[:4].tolist()
    np.testing.assert_allclose(t_logits.numpy()[:4],
                               np.asarray(j_logits)[:4], atol=1e-4,
                               rtol=1e-4)
    for j_pool, t_pool in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(t_pool.numpy()[:, OWNED],
                                   np.asarray(j_pool)[:, OWNED],
                                   atol=1e-5, rtol=1e-5)
    # the null block took the masked writes; no owned block was touched
    # outside the active rows' spans
    untouched = np.setdiff1d(np.arange(1, NB + 1), OWNED)
    assert (tk.numpy()[:, untouched] == k[:, untouched]).all()
    # without return_logits: the tokens alone
    tk2, tv2 = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    assert model.prefill_step(tk2, tv2, *args).tolist() == t_next.tolist()


def test_prefill_step_equals_decode_steps():
    """A chunk window's KV and last token equal those of the same tokens
    fed one decode step at a time (one row, two layers)."""
    _, model = _pair(seed=2)
    shape = (CFG["n_layers"], NB + 1, BS, CFG["n_heads"],
             CFG["d_model"] // CFG["n_heads"])
    toks = [11, 3, 60, 7, 7, 21]
    tables = torch.from_numpy(TABLES[:1].copy())
    one = torch.ones(1, dtype=torch.bool)
    k1, v1 = torch.zeros(shape), torch.zeros(shape)
    nxt = model.prefill_step(
        k1, v1, torch.tensor([toks], dtype=torch.int32), one,
        torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        torch.tensor([len(toks)], dtype=torch.int32), tables, one)
    k2, v2 = torch.zeros(shape), torch.zeros(shape)
    for p, t in enumerate(toks):
        step = model.decode_step(
            k2, v2, torch.tensor([t], dtype=torch.int32), one,
            torch.zeros(1, dtype=torch.int32),
            torch.tensor([p], dtype=torch.int32), tables, one)
    assert nxt.tolist() == step.tolist()
    np.testing.assert_allclose(k1.numpy(), k2.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (b) the engine
# ---------------------------------------------------------------------------


def _prompts(n, seed, lo=2, hi=15):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"],
                        size=rng.randint(lo, hi)).tolist() for _ in range(n)]


def _serve(engine, prompts, max_new):
    with engine:
        reqs = submit_pinned(engine, prompts, max_new)
        got = [r.wait(300) for r in reqs]
        stats = engine.stats()["default"]
    return got, stats


@pytest.mark.parametrize("kw", [dict(prefill_chunk=4),
                                dict(prefill_chunk=4,
                                     prefill_token_budget=3),
                                dict(prefill_chunk=8, async_depth=1)],
                         ids=["chunk4", "chunk4_budget3", "chunk8_sync"])
def test_engine_chunked_matches_jax_and_reference(kw):
    """Eight prompts through a 3-slot engine: token-identical to both
    reference decoders and to JAX's engine; chunk steps ran, and the
    pool drains clean."""
    jax_model, model = _pair(seed=17)
    prompts = _prompts(8, seed=19)
    refs = [port.reference_decode(model, p, 7) for p in prompts]
    assert refs == [jax_serving.reference_decode(jax_model, p, 7)
                    for p in prompts]
    engine = port.ServingEngine(model, max_batch=3, max_seq_len=64,
                                block_size=4, device="cpu", **kw)
    got, st = _serve(engine, prompts, 7)
    want, jst = _serve(jax_serving.ServingEngine(
        jax_model, max_batch=3, max_seq_len=64, block_size=4, **kw),
        prompts, 7)
    assert got == want == refs
    assert st["prefill_chunk"] == kw["prefill_chunk"]
    assert st["prefill_chunk_steps"] > 0
    assert st["steps"] == jst["steps"]
    pool = engine._workers["default"].pool
    assert pool.check_invariants() == []
    assert pool.stats()["blocks_in_use"] == 0


def test_engine_chunked_staggered_arrivals_in_flight():
    """Chunked prefill rows join around decode rows with four steps in
    flight (the decode rows' slot 0 chains the previous chunk step's
    tokens on the device): every request token-identical to
    reference_decode."""
    _, model = _pair(seed=5)
    rng = np.random.RandomState(3)
    p1 = rng.randint(0, 64, size=9).tolist()    # 4 + 4 + 1
    p2 = rng.randint(0, 64, size=11).tolist()   # 4 + 4 + 3
    p3 = rng.randint(0, 64, size=2).tolist()    # shorter than a chunk
    p4 = rng.randint(0, 64, size=13).tolist()   # joins after retires
    first_tok = threading.Event()
    with port.ServingEngine(model, max_batch=3, max_seq_len=64,
                            block_size=4, prefill_chunk=4, async_depth=4,
                            device="cpu") as eng:
        r1 = eng.submit(p1, max_new_tokens=12,
                        stream=lambda *_: first_tok.set())
        assert first_tok.wait(120)               # r1 is decoding now
        r2 = eng.submit(p2, max_new_tokens=6)
        r3 = eng.submit(p3, max_new_tokens=9)
        outs = [r.wait(120) for r in (r1, r2, r3)]
        out4 = eng.submit(p4, max_new_tokens=5).wait(120)
    refs = [port.reference_decode(model, p, n)
            for p, n in ((p1, 12), (p2, 6), (p3, 9), (p4, 5))]
    assert outs + [out4] == refs
    assert eng._workers["default"].pool.check_invariants() == []


def test_engine_chunked_eos_truncates_like_reference():
    _, model = _pair(seed=0)
    prompt = [3, 7, 11, 2, 9]
    ref = port.reference_decode(model, prompt, 16)
    eos = ref[4]
    want = port.reference_decode(model, prompt, 16, eos_id=eos)
    with port.ServingEngine(model, max_batch=2, max_seq_len=64,
                            block_size=4, prefill_chunk=4,
                            device="cpu") as eng:
        got = eng.generate(prompt, max_new_tokens=16, eos_id=eos,
                           timeout=120)
    assert got == want and got[-1] == eos
