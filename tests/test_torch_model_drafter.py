"""paddle_tpu_torch's model drafter and generation artifact held against
the JAX package on the CPU, at a small size (2 layers, d_model 32, 2
heads, vocab 64), over the same weights:

  (a) ``draft_step`` against JAX's ``make_draft_step`` (tokens equal,
      pools 1e-5);
  (b) ``ModelDrafter``: ``propose_batch`` / ``propose_tree_batch``
      chains equal the JAX drafter's over windows of growing, shrinking
      and retiring histories, the draft pool's audit clean after each;
      the host oracle ``propose`` equal;
  (c) the artifact: a JAX-written artifact loads in the port bitwise (and
      the port's in JAX), a corrupt weight raises
      ``GenerationArtifactError``;
  (d) the engine: a ``ModelDrafter`` in linear and tree windows over
      chunked prefill, token-identical to both reference decoders and to
      the JAX engine; a self-drafting linear drafter accepted at exactly
      1.0; every ``PTPU_SERVE_*`` switch of the fast path from the
      environment.
"""

import os

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


def _draft_pair(jax_model, scale=0.02, seed=1):
    """(JAX, port) draft models: the target with its head perturbed, so
    drafts are partly right."""
    w = {k: np.asarray(v).copy() for k, v in jax_model.weights.items()}
    w["lm_head"] += scale * np.random.RandomState(seed).randn(
        *w["lm_head"].shape).astype(np.float32)
    return (jax_serving.GenerationModel(jax_model.config, w, name="draft"),
            port.GenerationModel.from_jax_weights(
                port.GenerationConfig(**CFG), w, name="draft",
                device="cpu"))


def _prompts(n, seed, lo=3, hi=12):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG["vocab_size"],
                        size=rng.randint(lo, hi)).tolist() for _ in range(n)]


# ---------------------------------------------------------------------------
# (a) the draft step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_new", [1, 3, 6])
def test_draft_step_matches_jax(n_new):
    """Three rows: two drafting from different positions (one across a
    block boundary), one inactive."""
    jax_model, model = _pair(seed=n_new)
    bs, mb, nb = 4, 8, 24
    tables = np.array([[5, 2, 7, 3, 9, 11, 0, 0],
                       [1, 4, 6, 8, 10, 12, 13, 14],
                       [0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    shape = (CFG["n_layers"], nb + 1, bs, CFG["n_heads"],
             CFG["d_model"] // CFG["n_heads"])
    rng = np.random.RandomState(n_new)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    first = rng.randint(0, 64, size=3).astype(np.int32)
    positions = np.array([9, 26, 0], np.int32)
    active = np.array([True, True, False])
    step = jax_model.make_draft_step(3, mb, n_new)
    jk, jv, j_toks = step(jax_model.weights, jnp.asarray(k), jnp.asarray(v),
                          first, positions, tables, active)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    t_toks = model.draft_step(tk, tv, *[torch.from_numpy(a) for a in (
        first, positions, tables, active)], n_new)
    assert tuple(t_toks.shape) == (3, n_new) and t_toks.dtype == torch.int32
    assert t_toks.numpy()[:2].tolist() == np.asarray(j_toks)[:2].tolist()
    owned = np.unique(tables[tables > 0])
    for j_pool, t_pool in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(t_pool.numpy()[:, owned],
                                   np.asarray(j_pool)[:, owned],
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (b) the drafter
# ---------------------------------------------------------------------------


def _windows(seed):
    """A sequence of drafting windows: (rows, retired ids). Histories
    grow by a few committed tokens a window, one shrinks (a rebuild),
    rows retire and new ones join, one sits near the sequence cap."""
    rng = np.random.RandomState(seed)
    hist = {i: p for i, p in enumerate(_prompts(4, seed))}
    hist[9] = rng.randint(0, 64, size=52).tolist()   # ends at 62 tokens
    out = []
    for w in range(6):
        rows = [(sid, list(h), int(rng.randint(1, 6)))
                for sid, h in sorted(hist.items())]
        retire = [w] if w < 3 else []
        out.append((rows, retire))
        for sid in list(hist):
            if sid in retire:
                del hist[sid]
            else:
                # a window commits at least one token
                n = 2 if sid == 9 else rng.randint(1, 5)
                hist[sid] += rng.randint(0, 64, size=n).tolist()
        if w == 1:
            hist[3] = hist[3][:4]                      # shrank: rebuild
        if w == 2:
            hist[10] = _prompts(1, seed + 1, 20, 30)[0]
    return out


@pytest.mark.parametrize("width", [1, 2, 3])
def test_model_drafter_chains_match_jax(width):
    jax_model, model = _pair(seed=31)
    ours = port.ModelDrafter(model, block_size=4, chunk=5)
    theirs = jax_serving.ModelDrafter(jax_model, block_size=4, chunk=5)
    for d in (ours, theirs):
        d.bind(6, 5)
    longest = 0
    for rows, retire in _windows(seed=width):
        if width == 1:
            got = ours.propose_batch([(s, h) for s, h, _d in rows], 4)
            want = theirs.propose_batch([(s, h) for s, h, _d in rows], 4)
        else:
            got = ours.propose_tree_batch(rows, width)
            want = theirs.propose_tree_batch(rows, width)
        assert got == want
        longest = max([longest] + [len(ch if width == 1 else ch[0])
                                   for ch in got.values() if ch])
        assert ours.pool.check_invariants() == []
        assert ours.pool.stats() == {k: v for k, v in
                                     theirs._pool.stats().items()}
        for sid in retire:
            ours.release(sid)
            theirs.release(sid)
    assert ours.draft_steps == theirs.draft_steps > 0
    assert longest > 1                       # draft_step chains ran
    for sid in list(ours._states):
        ours.release(sid)
    assert ours.pool.stats()["blocks_in_use"] == 0


def test_model_drafter_oracle_and_unbound_use():
    """``propose`` is reference_decode; ``propose_batch`` binds itself
    on first use and grows when a call outruns it."""
    jax_model, model = _pair(seed=2)
    ours, theirs = port.ModelDrafter(model), jax_serving.ModelDrafter(
        jax_model)
    hist = _prompts(1, seed=4)[0]
    assert ours.propose(hist, 4) == theirs.propose(hist, 4) == \
        port.reference_decode(model, hist, 4)
    assert ours.propose(hist, 0) == [] and ours.propose([], 3) == []
    rows = [(i, h) for i, h in enumerate(_prompts(3, seed=8))]
    assert ours.propose_batch(rows[:1], 2) == theirs.propose_batch(
        rows[:1], 2)
    assert ours.propose_batch(rows, 5) == theirs.propose_batch(rows, 5)
    assert ours.pool.check_invariants() == []


# ---------------------------------------------------------------------------
# (c) the artifact
# ---------------------------------------------------------------------------


def test_jax_artifact_loads_bitwise(tmp_path):
    jax_model, _ = _pair(seed=6)
    jax_dir = str(tmp_path / "jax_art")
    jax_serving.save_generation_artifact(jax_dir, jax_model.config,
                                         jax_model.weights)
    assert port.verify_generation_artifact(jax_dir)
    model = port.load_generation_artifact(jax_dir, device="cpu")
    assert model.name == "jax_art"
    assert model.config.to_dict() == jax_model.config.to_dict()
    for name, val in jax_model.weights.items():
        assert np.array_equal(model.weights[name].numpy(), np.asarray(val))
    # and the port's artifact in the JAX package, the same bytes
    port_dir = str(tmp_path / "port_art")
    port.save_generation_artifact(port_dir, model.config, model.weights)
    back = jax_serving.load_generation_artifact(port_dir)
    for name, val in back.weights.items():
        assert np.array_equal(np.asarray(val), model.weights[name].numpy())
    # publishing over an existing artifact replaces it
    port.save_generation_artifact(port_dir, model.config, model.weights)
    assert port.verify_generation_artifact(port_dir)
    # served from the int8 weight store, bitwise the JAX package's
    q = port.load_generation_artifact(jax_dir, quantize="weight_only",
                                      device="cpu")
    jq = jax_serving.load_generation_artifact(jax_dir,
                                              quantize="weight_only")
    assert q.weight_only_int8 and set(q.weights) == set(jq.weights)
    for name, val in jq.weights.items():
        assert np.array_equal(q.weights[name].numpy(), np.asarray(val))


def test_corrupt_artifact_raises(tmp_path):
    jax_model, _ = _pair(seed=6)
    art = str(tmp_path / "art")
    jax_serving.save_generation_artifact(art, jax_model.config,
                                         jax_model.weights)
    # one weight changed, the file size kept: the digest catches it
    path = os.path.join(art, port.model.GENERATION_WEIGHTS)
    with np.load(path) as z:
        weights = {k: z[k] for k in z.files}
    weights["l0/wqkv"] = weights["l0/wqkv"].copy()
    weights["l0/wqkv"][0, 0] += 1.0
    np.savez(path, **weights)
    with pytest.raises(port.GenerationArtifactError, match="l0/wqkv"):
        port.load_generation_artifact(art, device="cpu")
    model = port.load_generation_artifact(art, verify=False, device="cpu")
    assert model.weights["l0/wqkv"][0, 0].item() == weights["l0/wqkv"][0, 0]
    # a truncated payload: the size check
    with open(path, "r+b") as f:
        f.truncate(100)
    with pytest.raises(port.GenerationArtifactError, match="bytes"):
        port.verify_generation_artifact(art)
    os.remove(os.path.join(art, port.model.GENERATION_MANIFEST))
    assert port.verify_generation_artifact(art) is False
    with pytest.raises(port.GenerationArtifactError, match="unreadable"):
        port.load_generation_artifact(art, device="cpu")
    with pytest.raises(FileNotFoundError):
        port.load_generation_artifact(str(tmp_path), device="cpu")


# ---------------------------------------------------------------------------
# (d) the engine
# ---------------------------------------------------------------------------


def _serve(engine, prompts, max_new):
    with engine:
        reqs = submit_pinned(engine, prompts, max_new)
        got = [r.wait(300) for r in reqs]
        stats = engine.stats()["default"]
    return got, stats


@pytest.mark.parametrize("mode", [{"spec_k": 4}, {"spec_tree": "2x3"}],
                         ids=["linear4", "tree2x3"])
def test_engine_model_drafter_matches_jax_and_reference(mode):
    """A draft model whose drafts are partly right (the target's head
    perturbed) over chunked prefill: token-identical to both reference
    decoders and to JAX's engine with JAX's drafter; the same acceptance,
    neither none nor all; both pools drain clean."""
    jax_model, model = _pair(seed=11)
    jax_draft, draft = _draft_pair(jax_model)
    prompts = _prompts(5, seed=29)
    refs = [port.reference_decode(model, p, 10) for p in prompts]
    assert refs == [jax_serving.reference_decode(jax_model, p, 10)
                    for p in prompts]
    drafter = port.ModelDrafter(draft, block_size=4, chunk=4)
    engine = port.ServingEngine(model, max_batch=3, max_seq_len=64,
                                block_size=4, prefill_chunk=4,
                                device="cpu", drafter=drafter, **mode)
    got, st = _serve(engine, prompts, 10)
    want, jst = _serve(jax_serving.ServingEngine(
        jax_model, max_batch=3, max_seq_len=64, block_size=4,
        prefill_chunk=4, drafter=jax_serving.ModelDrafter(
            jax_draft, block_size=4, chunk=4), **mode), prompts, 10)
    assert got == want == refs
    for key in ("spec_steps", "spec_proposed", "spec_accepted",
                "spec_draft_steps", "steps"):
        assert st[key] == jst[key], key
    assert st["spec_draft_steps"] > 0
    assert 0 < st["spec_accepted"] < st["spec_proposed"]
    assert st["prefill_chunk_steps"] > 0
    for pool in (engine._workers["default"].pool, drafter.pool):
        assert pool.check_invariants() == []
        assert pool.stats()["blocks_in_use"] == 0


@pytest.mark.parametrize("mode", [{"spec_k": 4}, {"spec_tree": "2x3"}],
                         ids=["linear4", "tree2x3"])
def test_self_drafting_accepts_every_draft(mode):
    """The target drafting for itself: every draft accepted (rate
    exactly 1.0), windows full, token-identical to reference_decode."""
    _, model = _pair(seed=0)
    prompts = _prompts(4, seed=23, lo=3, hi=9)
    refs = [port.reference_decode(model, p, 10) for p in prompts]
    engine = port.ServingEngine(model, max_batch=3, max_seq_len=64,
                                block_size=4, prefill_chunk=8, device="cpu",
                                drafter=port.ModelDrafter(model), **mode)
    got, st = _serve(engine, prompts, 10)
    assert got == refs
    assert st["spec_proposed"] > 0
    assert st["spec_accepted"] == st["spec_proposed"]
    assert st["spec_accept_rate"] == 1.0
    assert st["spec_draft_steps"] > 0
    assert st["spec_emitted"] / st["spec_steps"] > 2


def test_fast_path_switches_from_the_environment(monkeypatch, tmp_path):
    """``PTPU_SERVE_PREFILL_CHUNK``, ``PTPU_SERVE_PREFIX_CACHE``,
    ``PTPU_SERVE_DRAFT_MODEL`` (a JAX-written artifact) and
    ``PTPU_SERVE_DRAFT_CHUNK`` turn the fast path on when the arguments
    are None; the engine also serves an artifact directory. Tokens equal
    reference_decode and the JAX engine's under the same environment."""
    jax_model, model = _pair(seed=7)
    art = str(tmp_path / "draft")
    jax_serving.save_generation_artifact(art, jax_model.config,
                                         jax_model.weights)
    prompts = [[4, 8, 15, 16, 23, 42, 4, 8, 15, 16] + t
               for t in ([1, 2], [3], [5, 6, 7])]
    refs = [port.reference_decode(model, p, 8) for p in prompts]
    monkeypatch.setenv("PTPU_SERVE_PREFILL_CHUNK", "4")
    monkeypatch.setenv("PTPU_SERVE_PREFIX_CACHE", "1")
    monkeypatch.setenv("PTPU_SERVE_DRAFT_MODEL", art)
    monkeypatch.setenv("PTPU_SERVE_DRAFT_CHUNK", "3")
    monkeypatch.setenv("PTPU_SERVE_SPEC_K", "3")
    engine = port.ServingEngine(art, max_batch=2, max_seq_len=64,
                                block_size=4, device="cpu")
    w = engine._workers["default"]
    assert (w.prefill_chunk, w.prefix_cache, w.spec_k) == (4, True, 3)
    assert w.scheduler.prefill_token_budget == 16
    assert isinstance(w.drafter, port.ModelDrafter)
    assert w.drafter._chunk == 3 and w.drafter.model.name == "default.draft"
    got, st = _serve(engine, prompts, 8)
    want, jst = _serve(jax_serving.ServingEngine(
        art, max_batch=2, max_seq_len=64, block_size=4), prompts, 8)
    assert got == want == refs
    assert st["spec_accept_rate"] == 1.0 and st["spec_draft_steps"] > 0
    assert st["spec_draft_steps"] == jst["spec_draft_steps"]
    assert st["prefix_blocks_reused"] > 0 and st["prefill_chunk_steps"] > 0
    monkeypatch.setenv("PTPU_SERVE_DRAFT_MODEL", "0")
    monkeypatch.setenv("PTPU_SERVE_PREFIX_CACHE", "0")
    with port.ServingEngine(model, max_batch=2, max_seq_len=64,
                            block_size=4, device="cpu") as engine:
        w = engine._workers["default"]
        assert isinstance(w.drafter, port.NGramDrafter)
        assert not w.prefix_cache
