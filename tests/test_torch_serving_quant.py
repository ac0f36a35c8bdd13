"""The port's weight-only int8 store held against the JAX package on the
CPU, over the same seeded weights:

  (a) ``quantize_symmetric``, ``weight_store_bytes`` and
      ``record_weight_store`` give bitwise the JAX package's arrays and
      numbers at the flagship's weight shapes (vocab 32000, d_model 512,
      d_ff 2048; one layer's shapes);
  (b) ``GenerationModel.quantized()`` (vocab 96, d_model 32, 2 layers):
      bitwise JAX's int8 and ``@qscale`` arrays, the JAX key set, the
      ``quant/*`` counters, idempotent, ``n_int8 == 2 + 4 n_layers``;
      ``dequantized_weights()`` exactly ``q * s``; the step's logits
      equal those of the fp32 model over the dequantized weights;
  (c) the engine over the int8 store — one-token decode, chunked
      prefill (chunk 4), linear speculation (k=3) and a 2x3 tree drafted
      by a ``ModelDrafter`` over an int8 drafter — token-identical to
      the port's ``reference_decode``, to JAX's and to JAX's engine, with
      the same steps (arrivals pinned) and ``stats()["weight_store"]``
      equal to JAX's;
  (d) a JAX-written artifact served with ``quantize="weight_only"``
      (bitwise JAX's loaded store), and ``quantize="fp4"`` refused with
      JAX's ``ValueError``.

Every comparison is exact.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import quant as jquant
from paddle_tpu import serving as jax_serving
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch import quant as pquant
from paddle_tpu_torch import serving as port
from paddle_tpu_torch.observability import metrics as pmetrics
from test_torch_pinned_arrivals import submit_pinned

CFG = dict(vocab_size=96, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_seq_len=64)
FLAGSHIP = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=1,
                d_ff=2048, max_seq_len=512)
COUNTERS = ("quant/weights_quantized", "quant/weight_bytes_saved",
            "quant/weight_fp32_bytes")


def _pair(seed, cfg=CFG):
    jax_model = jax_serving.GenerationModel.random(
        jax_serving.GenerationConfig(**cfg), seed=seed)
    weights = {k: np.asarray(v) for k, v in jax_model.weights.items()}
    return jax_model, port.GenerationModel.from_jax_weights(
        port.GenerationConfig(**cfg), weights, device="cpu")


def _numpy(weights):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in weights.items()}


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.fixture
def metrics_on():
    """Both packages' metrics on and zeroed; restored after."""
    was = (jmetrics.enabled(), pmetrics.enabled())
    for m in (jmetrics, pmetrics):
        m.reset()
        m.enable()
    yield
    for m, on in zip((jmetrics, pmetrics), was):
        m.reset()
        if not on:
            m.disable()


def _counters(m):
    return tuple(m.registry().counter(n).value for n in COUNTERS)


# ---------------------------------------------------------------------------
# (a) the quantization helpers
# ---------------------------------------------------------------------------


def test_quant_helpers_bitwise_at_flagship_shapes(metrics_on):
    weights = port.random_weights(port.GenerationConfig(**FLAGSHIP), seed=0)
    store = {}
    for k, w in weights.items():
        for axis in ((1, 0) if w.ndim == 2 else (0,)):
            q, s = pquant.quantize_symmetric(w, channel_axis=axis)
            jq, js = jquant.quantize_symmetric(w, channel_axis=axis)
            assert q.dtype == jq.dtype == np.int8
            assert s.dtype == js.dtype == np.float32
            assert np.array_equal(q, jq) and np.array_equal(s, js), k
        if w.ndim == 2:
            store[k] = q
            store[k + "@qscale"] = (s / 127.0).astype(np.float32)
        else:
            store[k] = w
    assert pquant.weight_store_bytes(store) == \
        jquant.weight_store_bytes(store)
    tensors = {k: torch.from_numpy(v) for k, v in store.items()}
    assert pquant.weight_store_bytes(tensors) == \
        jquant.weight_store_bytes(store)
    pquant.record_weight_store(6, 123, 4567)
    jquant.record_weight_store(6, 123, 4567)
    assert _counters(pmetrics) == _counters(jmetrics) == (6, 123, 4567)


# ---------------------------------------------------------------------------
# (b) the store
# ---------------------------------------------------------------------------


def test_quantized_store_bitwise_jax(metrics_on):
    jax_model, model = _pair(seed=5)
    jq = jax_model.quantized()
    q = model.quantized()
    assert q.weight_only_int8 and jq.weight_only_int8
    assert not model.weight_only_int8
    assert q.name == jq.name == "model.int8"
    _assert_bitwise(_numpy(q.weights), _numpy(jq.weights))
    assert _counters(pmetrics) == _counters(jmetrics)
    assert _counters(pmetrics)[0] == 2 + 4 * CFG["n_layers"]
    assert q.quantized() is q                       # idempotent
    assert _counters(pmetrics) == _counters(jmetrics)
    st = pquant.weight_store_bytes(q.weights)
    assert st == jquant.weight_store_bytes(jq.weights)
    assert st["n_int8"] == 2 + 4 * CFG["n_layers"]
    # dequantized: exactly q * s, the JAX package's values
    dq = _numpy(q.dequantized_weights())
    _assert_bitwise(dq, _numpy(jq.dequantized_weights()))
    w = q.weights
    for k in dq:
        s = w.get(k + "@qscale")
        if s is not None:
            assert np.array_equal(dq[k], w[k].numpy().astype(np.float32)
                                  * s.numpy()), k
    # the JAX quantized dict carried across is the same store
    again = port.GenerationModel.from_jax_weights(
        q.config, _numpy(jq.weights), device="cpu")
    assert again.weight_only_int8
    _assert_bitwise(_numpy(again.weights), _numpy(q.weights))


def test_int8_step_computes_with_the_dequantized_weights():
    """The window step over the int8 store gives bitwise the logits of
    the fp32 model over ``dequantized_weights()``."""
    _, model = _pair(seed=9)
    q = model.quantized()
    ref = port.GenerationModel(q.config, q.dequantized_weights(),
                               device="cpu")
    bs, mb, nb, B, C = 4, 8, 24, 3, 5
    shape = (CFG["n_layers"], nb + 1, bs, CFG["n_heads"],
             CFG["d_model"] // CFG["n_heads"])
    rng = np.random.RandomState(2)
    tables = torch.from_numpy(
        (rng.permutation(nb)[:B * mb] + 1).reshape(B, mb).astype(np.int32))
    feed = torch.from_numpy(
        rng.randint(0, CFG["vocab_size"], (B, C)).astype(np.int32))
    ones = torch.ones(B, dtype=torch.bool)
    pos = torch.tensor([0, 7, 20], dtype=torch.int32)
    lens = torch.tensor([C, 3, 1], dtype=torch.int32)
    prev = torch.zeros(B, dtype=torch.int32)
    outs = []
    for m in (q, ref):
        k, v = torch.zeros(shape), torch.zeros(shape)
        outs.append(m.spec_step(k, v, feed, ones, prev, pos, lens, tables,
                                ones, return_logits=True) + (k, v))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (c) the engine
# ---------------------------------------------------------------------------


def _serve(engine, prompts, max_new):
    """Serve with the arrivals pinned; the stats read once the worker
    has stopped (a finished request's tokens are counted after it
    completes)."""
    with engine:
        reqs = submit_pinned(engine, prompts, max_new)
        got = [r.wait(300) for r in reqs]
    return got, engine.stats()["default"]


MODES = {"decode": {}, "chunk4": dict(prefill_chunk=4),
         "linear3": dict(spec_k=3),
         "tree2x3_model": dict(spec_tree="2x3", prefill_chunk=4,
                               model_drafter=True)}


@pytest.mark.parametrize("mode", list(MODES))
def test_int8_engine_matches_jax_and_references(mode):
    kw = dict(MODES[mode])
    jax_model, model = _pair(seed=13)
    jq, q = jax_model.quantized(), model.quantized()
    rng = np.random.RandomState(31)
    pattern = rng.randint(0, CFG["vocab_size"], size=4).tolist()
    prompts = [pattern * 3] + [
        rng.randint(0, CFG["vocab_size"], size=rng.randint(3, 12)).tolist()
        for _ in range(4)]
    refs = [port.reference_decode(q, p, 9) for p in prompts]
    assert refs == [jax_serving.reference_decode(jq, p, 9) for p in prompts]
    jkw = dict(kw)
    if kw.pop("model_drafter", False):
        # the drafter over another int8 store: the target's drafts are
        # partly right
        _, draft = _pair(seed=14)
        jdraft, _ = _pair(seed=14)
        kw["drafter"] = port.ModelDrafter(draft.quantized(), block_size=4,
                                          chunk=4)
        jkw.pop("model_drafter")
        jkw["drafter"] = jax_serving.ModelDrafter(jdraft.quantized(),
                                                  block_size=4, chunk=4)
    got, st = _serve(port.ServingEngine(q, max_batch=3, max_seq_len=64,
                                        block_size=4, device="cpu", **kw),
                     prompts, 9)
    want, jst = _serve(jax_serving.ServingEngine(
        jq, max_batch=3, max_seq_len=64, block_size=4, **jkw), prompts, 9)
    assert got == want == refs
    for key in ("steps", "generated_tokens", "spec_steps", "spec_proposed",
                "spec_accepted", "spec_draft_steps", "weight_only_int8",
                "weight_store"):
        assert st[key] == jst[key], key
    assert st["weight_only_int8"] is True
    assert st["weight_store"]["n_int8"] == 2 + 4 * CFG["n_layers"]
    if kw.get("spec_k") or kw.get("spec_tree"):
        assert st["spec_steps"] > 0
    if "drafter" in kw:
        assert st["spec_draft_steps"] > 0
        assert kw["drafter"].pool.check_invariants() == []


def test_fp32_engine_reports_its_store():
    jax_model, model = _pair(seed=1)
    with port.ServingEngine(model, max_batch=2, max_seq_len=64,
                            block_size=4, device="cpu") as eng:
        st = eng.stats()["default"]
    with jax_serving.ServingEngine(jax_model, max_batch=2, max_seq_len=64,
                                   block_size=4) as jeng:
        jst = jeng.stats()["default"]
    assert st["weight_only_int8"] is False is jst["weight_only_int8"]
    assert st["weight_store"] == jst["weight_store"] == \
        {"n_int8": 0, "int8_bytes": 0, "fp32_bytes": 0}


# ---------------------------------------------------------------------------
# (d) the artifact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [True, "weight_only", "int8"])
def test_artifact_served_int8(tmp_path, quantize):
    jax_model, _ = _pair(seed=21)
    art = str(tmp_path / "gen")
    jax_serving.save_generation_artifact(art, jax_model.config,
                                         jax_model.weights)
    q = port.load_generation_artifact(art, quantize=quantize, device="cpu")
    jq = jax_serving.load_generation_artifact(art, quantize=quantize)
    assert q.weight_only_int8 and q.name == jq.name == "gen.int8"
    _assert_bitwise(_numpy(q.weights), _numpy(jq.weights))
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    with port.ServingEngine(q, max_batch=2, max_seq_len=64, block_size=4,
                            device="cpu") as eng:
        got = eng.generate(prompt, max_new_tokens=8, timeout=300)
    assert got == port.reference_decode(q, prompt, 8) == \
        jax_serving.reference_decode(jq, prompt, 8)


def test_artifact_refuses_another_quantization(tmp_path):
    jax_model, _ = _pair(seed=21)
    art = str(tmp_path / "gen")
    jax_serving.save_generation_artifact(art, jax_model.config,
                                         jax_model.weights)
    with pytest.raises(ValueError) as jerr:
        jax_serving.load_generation_artifact(art, quantize="fp4")
    with pytest.raises(ValueError) as perr:
        port.load_generation_artifact(art, quantize="fp4", device="cpu")
    assert str(perr.value) == str(jerr.value)
