"""paddle_tpu_torch serving held against the JAX package on the same
weights (the JAX model's flat dict handed over with
``GenerationModel.from_jax_weights``) and the same inputs, at a small
size (2 layers, d_model 32, 2 heads, vocab 64), on the CPU:

  (a) one decode step's logits against JAX's
      ``make_decode_step(return_logits=True)``, atol 1e-4 (fp32, a
      different summation order), next tokens identical;
  (b) the port's ``ServingEngine(device="cpu")`` against JAX's
      ``ServingEngine`` (Pallas kernels forced on, interpret mode) and
      ``reference_decode`` on staggered prompts: token-identical;
  (c) the KV pool's accounting (reserve / alloc / free / null block),
      block for block the JAX pool's.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import serving as jax_serving
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


def test_decode_step_logits_match_jax():
    """Three rows over a scattered pool: two active (one switching from
    prompt feed to on-device chaining halfway), one inactive with a
    stale position past its table (its write goes to the null block).
    Every step's logits of the active rows, their next tokens and the
    pool pages they own agree with JAX's step."""
    jax_model, model = _pair(seed=3)
    cfg = model.config
    bs, mb, nb = 4, 4, 12
    shape = (cfg.n_layers, nb + 1, bs, cfg.n_heads, cfg.head_dim)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    step = jax_model.make_decode_step(3, mb, return_logits=True)
    tables = np.array([[5, 2, 7, 3], [1, 4, 6, 8], [0, 0, 0, 0]], np.int32)
    active = np.array([True, True, False])
    rng = np.random.RandomState(0)
    feeds = rng.randint(0, cfg.vocab_size, size=(12, 3)).astype(np.int32)
    j_prev = jnp.zeros((3,), jnp.int32)
    t_prev = torch.zeros(3, dtype=torch.int32)
    for pos in range(12):
        use_prompt = np.array([True, pos < 6, True])
        positions = np.array([pos, pos, 17], np.int32)
        jk, jv, j_prev, j_logits = step(
            jax_model.weights, jk, jv, feeds[pos], use_prompt, j_prev,
            positions, tables, active)
        t_prev, t_logits = model.decode_step(
            tk, tv, torch.from_numpy(feeds[pos]),
            torch.from_numpy(use_prompt), t_prev,
            torch.from_numpy(positions), torch.from_numpy(tables),
            torch.from_numpy(active), return_logits=True)
        np.testing.assert_allclose(t_logits.numpy()[:2],
                                   np.asarray(j_logits)[:2],
                                   atol=1e-4, rtol=1e-4)
        assert t_prev.numpy()[:2].tolist() == \
            np.asarray(j_prev)[:2].tolist()
    owned = tables[:2].ravel()
    for j_pool, t_pool in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(t_pool.numpy()[:, owned],
                                   np.asarray(j_pool)[:, owned],
                                   atol=1e-5, rtol=1e-5)


def test_engine_token_identical_to_jax_engine_and_reference(monkeypatch):
    """Staggered arrivals (requests joining while others are
    mid-decode) through a 2-slot engine: the port's tokens equal JAX's
    engine (kernels forced on) and both reference decoders."""
    monkeypatch.setenv("PTPU_KERNELS", "1")
    jax_model, model = _pair(seed=11)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, CFG["vocab_size"],
                           size=rng.randint(1, 10)).tolist()
               for _ in range(5)]
    max_new = [8, 3, 10, 5, 7]

    def serve(engine):
        with engine:
            first = [engine.submit(p, max_new_tokens=n)
                     for p, n in zip(prompts[:2], max_new[:2])]
            first[1].wait(300)
            late = [engine.submit(p, max_new_tokens=n)
                    for p, n in zip(prompts[2:], max_new[2:])]
            return [r.wait(300) for r in first + late]

    got = serve(port.ServingEngine(model, max_batch=2, max_seq_len=64,
                                   block_size=4, device="cpu"))
    want = serve(jax_serving.ServingEngine(jax_model, max_batch=2,
                                           max_seq_len=64, block_size=4))
    refs = [jax_serving.reference_decode(jax_model, p, n)
            for p, n in zip(prompts, max_new)]
    port_refs = [port.reference_decode(model, p, n)
                 for p, n in zip(prompts, max_new)]
    assert got == want == refs == port_refs
    assert [len(t) for t in got] == max_new


def test_pool_accounting_matches_jax():
    """reserve / alloc / free / null block: the same admissions, block
    ids and refusals as the JAX pool, with clean invariants."""
    ours = port.KVBlockPool(n_layers=1, n_heads=1, head_dim=4, block_size=4,
                            num_blocks=6, device="cpu")
    theirs = jax_serving.KVBlockPool(n_layers=1, n_heads=1, head_dim=4,
                                     block_size=4, num_blocks=6)
    assert tuple(ours.k.shape) == (1, 7, 4, 1, 4)  # +1 null block
    assert ours.k.device.type == "cpu" and ours.k.dtype == torch.float32
    trace = []
    for pool in (ours, theirs):
        log = [pool.reserve("a", 2), pool.reserve("b", 3)]
        log += [pool.alloc_block("a"), pool.alloc_block("a")]
        log += [pool.alloc_block("b") for _ in range(3)]
        log.append(pool.block_table("a"))
        with pytest.raises(RuntimeError):
            pool.alloc_block("a")  # reservation spent: loud, no overdraw
        log += [pool.reserve("c", 2), pool.reserve("c", 1),
                pool.free_owner("c"), pool.free_owner("a"),
                pool.blocks_in_use, pool.reserve("d", 3)]
        log += [pool.alloc_block("d") for _ in range(3)]
        log += [pool.blocks_in_use, pool.blocks_free,
                pool.free_owner("b"), pool.free_owner("b")]
        assert pool.check_invariants() == []
        trace.append(log)
    assert trace[0] == trace[1]
    assert port.KVBlockPool.NULL_BLOCK not in trace[0][2:7]
    stats = ours.stats()
    assert stats["blocks_in_use"] == 3 and stats["blocks_total"] == 6
    assert stats["blocks_reserved"] == 0 and stats["blocks_free"] == 3
    assert port.blocks_needed(0, 16) == 0
    assert port.blocks_needed(17, 16) == 2


def test_eos_and_streaming_match_jax_reference():
    """EOS stops a request early under the async window: the tokens
    (and the streamed sequence) equal JAX's reference_decode with the
    same eos_id; no post-EOS token is emitted."""
    jax_model, model = _pair(seed=5)
    prompt = [3, 7, 11, 2]
    eos = jax_serving.reference_decode(jax_model, prompt, 16)[5]
    want = jax_serving.reference_decode(jax_model, prompt, 16, eos_id=eos)
    seen = []
    with port.ServingEngine(model, max_batch=2, max_seq_len=64,
                            block_size=4, device="cpu") as engine:
        req = engine.submit(prompt, max_new_tokens=16, eos_id=eos,
                            stream=lambda r, t, fin: seen.append((t, fin)))
        got = req.wait(300)
    assert got == want and got[-1] == eos and eos not in got[:-1]
    assert [t for t, _ in seen] == got
    assert [fin for _, fin in seen] == [False] * (len(got) - 1) + [True]


def test_admission_control():
    """The queue gate, the KV gate up front, and a too-long prompt
    failing its request (not the engine)."""
    _, model = _pair(seed=0)
    queue = port.RequestQueue(max_queue=2)
    queue.submit(port.GenerationRequest([1]))
    queue.submit(port.GenerationRequest([2]))
    with pytest.raises(port.AdmissionError):
        queue.submit(port.GenerationRequest([3]))
    with port.ServingEngine(model, max_batch=2, max_seq_len=32,
                            block_size=4, num_blocks=4,
                            device="cpu") as engine:
        with pytest.raises(port.AdmissionError):
            engine.submit([1] * 10, max_new_tokens=10)  # needs 5 blocks
        assert engine.generate([1, 2], max_new_tokens=3, timeout=60) == \
            port.reference_decode(model, [1, 2], 3)
        # the request finishes when its last token lands; the worker
        # frees its blocks at its next reap, a moment later
        deadline = time.monotonic() + 30
        while engine.stats()["default"]["blocks_in_use"] and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine.stats()["default"]["blocks_in_use"] == 0
    with port.ServingEngine(model, max_batch=2, max_seq_len=32,
                            block_size=4, device="cpu") as engine:
        bad = engine.submit([1] * 40, max_new_tokens=1)
        with pytest.raises(ValueError, match="max_seq_len"):
            bad.wait(60)
        assert engine.generate([3], max_new_tokens=2, timeout=60) == \
            port.reference_decode(model, [3], 2)


def test_worker_death_is_delivered_to_requests(monkeypatch):
    """A failing step kills the worker through _die: the in-flight and
    queued requests get the error, later submits are refused."""
    _, model = _pair(seed=0)

    def broken(*args, **kwargs):
        raise RuntimeError("injected step failure")

    monkeypatch.setattr(model, "decode_step", broken)
    with port.ServingEngine(model, max_batch=1, max_seq_len=64,
                            block_size=4, device="cpu") as engine:
        reqs = [engine.submit([1, 2, 3], max_new_tokens=4)
                for _ in range(3)]
        for r in reqs:
            with pytest.raises(RuntimeError, match="injected"):
                r.wait(60)
        with pytest.raises(RuntimeError, match="died"):
            engine.submit([1], max_new_tokens=1)
        assert "injected" in engine.stats()["default"]["error"]


def test_serving_metrics_surface():
    """With metrics on, the engine keeps the JAX package's serving/*
    names: steps, token counts, completions, latency percentiles."""
    from paddle_tpu_torch.observability import metrics

    _, model = _pair(seed=0)
    was = metrics.enabled()
    metrics.reset()
    metrics.enable()
    try:
        with port.ServingEngine(model, max_batch=2, max_seq_len=64,
                                block_size=4, device="cpu") as engine:
            reqs = [engine.submit([5, 6, 7], max_new_tokens=4)
                    for _ in range(3)]
            for r in reqs:
                r.wait(60)
            steps = engine.stats()["default"]["steps"]
        d = metrics.registry().to_dict()
        c, g, h = d["counters"], d["gauges"], d["histograms"]
        assert c["serving/steps"] == steps > 0
        assert c["serving/requests_submitted"] == 3
        assert c["serving/requests_completed"] == 3
        assert c["serving/decode_tokens"] + c["serving/prefill_tokens"] \
            == 3 * (3 + 4 - 1)
        assert g["serving/peak_batch_occupancy"] == 2
        assert h["serving/request_latency"]["count"] == 3
        assert g["serving/request_latency_p99"] > 0
        assert h["serving/ttft"]["count"] == 3
    finally:
        metrics.reset()
        if not was:
            metrics.disable()
