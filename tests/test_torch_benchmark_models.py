"""The rest of benchmark/fluid's model set and the book's word2vec built
and trained through the port's Fluid API, held against the JAX package
on the CPU at a small size:

* each model's programs (main after Adam's ``minimize``, and startup)
  equal the JAX package's: op types in order, slots, var names, attrs
  (the per-op seeds aside) and every var's shape, dtype and
  persistability — DeepFM, word2vec, the stacked LSTM, machine
  translation and the beam decoder;
* two fp32 Adam steps (lr 0.01) of each trainable model from the JAX
  startup's weights: the loss to rtol 1e-5, every grad of both steps to
  1e-4 of its tensor's largest plus 1e-7 of the largest of all (the
  worst measured: 1.4e-6, the LSTM and machine translation), every
  parameter after step 2 to 1e-4 of its update plus the larger of 3e-8
  and 2 ulps plus what Adam may move it with the grads apart by their
  limit (``chip_smoke.adam_param_limit``);
* DeepFM's AUC histograms StatPos / StatNeg bitwise equal to JAX's after
  each of 3 runs, and the AUC to 1e-6;
* the beam decoder on the JAX startup's weights: the sentence ids equal
  JAX's and the scores within 1e-5;
* the learning checks of the JAX package's book tests, on the port
  alone: DeepFM's loss falls and its AUC passes 0.6, word2vec's and the
  stacked LSTM's losses fall, machine translation's loss falls by a
  tenth on the copy task and, trained longer, its test clone copies
  teacher-forced (over 90%) and greedily (over 30%), and the beam
  decoder's ids and scores equal an independent numpy beam search over
  its weights."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import models as j_models
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import models as p_models
from paddle_tpu_torch import unique_name as p_unique

from torch_parity import (assert_programs_equal, carry_scope,  # noqa: F401
                          one_torch_thread, persistable_names,
                          pin_jax_init_draw)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LR = 0.01
BETA1, BETA2 = 0.9, 0.999

# model -> build(models) returning (loss, auc or None)
BUILDERS = {
    "deepfm": lambda m: m.deepfm.build(
        sparse_feature_dim=1000, num_fields=8, dense_dim=5, embed_dim=8,
        mlp_dims=(32, 32))[2:],
    "word2vec": lambda m: (m.word2vec.build(
        dict_size=64, embed_size=8, hidden_size=32)[2], None),
    "stacked_lstm": lambda m: (m.stacked_lstm.build(
        dict_size=200, emb_dim=16, hid_dim=16, stacked_num=3,
        seq_len=24)[4], None),
    "machine_translation": lambda m: (m.machine_translation.build(
        src_dict_size=40, trg_dict_size=40, embed_dim=16, hidden_dim=16,
        max_len=10)[2], None),
}
BEAM = dict(dict_size=50, word_dim=12, decoder_size=24, beam_size=2,
            max_length=6, src_len=5, end_id=1)


def feed(name, seed=0):
    rng = np.random.RandomState(seed)
    if name == "deepfm":
        return {"sparse_ids": rng.randint(0, 1000, (16, 8)).astype(np.int64),
                "dense_x": rng.rand(16, 5).astype(np.float32),
                "label": rng.randint(0, 2, (16, 1)).astype(np.int64)}
    if name == "word2vec":
        return {n: rng.randint(0, 64, (16, 1)).astype(np.int64)
                for n in ("firstw", "secondw", "thirdw", "forthw", "nextw")}
    if name == "stacked_lstm":
        return {"words": rng.randint(0, 200, (4, 24)).astype(np.int64),
                "label": rng.randint(0, 2, (4, 1)).astype(np.int64),
                "seq_len": rng.randint(8, 25, (4, 1)).astype(np.int64)}
    return {"src_word": rng.randint(3, 40, (4, 10)).astype(np.int64),
            "src_len": rng.randint(4, 11, (4, 1)).astype(np.int64),
            "trg_word": rng.randint(3, 40, (4, 10)).astype(np.int64),
            "trg_next": rng.randint(3, 40, (4, 10)).astype(np.int64),
            "trg_len": rng.randint(4, 11, (4, 1)).astype(np.int64)}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_benchmark_models", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(fluid, models, unique_name, name):
    """(main, startup, loss, auc) of model `name` under Adam(LR)."""
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        loss, auc = BUILDERS[name](models)
        fluid.optimizer.Adam(LR).minimize(loss)
    return main, startup, loss, auc


def build_beam(fluid, models, unique_name):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        _, ids, scores = models.machine_translation.build_beam_decoder(
            **BEAM)
    return main, startup, ids, scores


@pytest.mark.parametrize("name", sorted(BUILDERS) + ["beam_decoder"])
def test_programs_match_the_jax_package(name):
    if name == "beam_decoder":
        jp = build_beam(jfluid, j_models, j_unique)
        pp = build_beam(pfluid, p_models, p_unique)
    else:
        jp = build(jfluid, j_models, j_unique, name)
        pp = build(pfluid, p_models, p_unique, name)
    for label, j, p in zip(("main", "startup"), jp, pp):
        assert_programs_equal(j, p, "%s %s" % (name, label))


class Pair:
    """One model in both packages on the JAX startup's weights."""

    def __init__(self, name):
        self.j = build(jfluid, j_models, j_unique, name)
        self.p = build(pfluid, p_models, p_unique, name)
        self.jexe, self.jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
        self.pexe, self.pscope = pfluid.Executor("cpu"), pfluid.Scope()
        self.jexe.run(self.j[1], scope=self.jscope)
        self.pexe.run(self.p[1], scope=self.pscope)
        self.names = persistable_names(self.p[0])
        assert self.names == persistable_names(self.j[0])
        self.start = carry_scope(self.jscope, self.pscope, self.names)
        self.params = sorted(self.p[0].param_grad_map)
        self.grads = [self.p[0].param_grad_map[q] for q in self.params]

    def step(self, batch, fetch):
        jo = self.jexe.run(self.j[0], feed=batch, fetch_list=fetch,
                           scope=self.jscope)
        po = self.pexe.run(self.p[0], feed=batch, fetch_list=fetch,
                           scope=self.pscope)
        return [np.asarray(v, np.float64) for v in jo], \
            [np.asarray(v, np.float64) for v in po]

    def value(self, scope, name):
        v = scope.get(name)
        return (v.double().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float64))


def fp32_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 23).astype(np.float32)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_two_adam_steps_match_jax(name):
    pair = Pair(name)
    limit = _smoke().adam_param_limit
    fetch = [pair.p[2].name] + pair.grads
    g_ref = {q: [] for q in pair.params}
    g_err = {q: [] for q in pair.params}
    for step in range(2):
        jo, po = pair.step(feed(name), fetch)
        np.testing.assert_allclose(po[0], jo[0], rtol=1e-5,
                                   err_msg="loss of step %d" % step)
        top = max(float(np.abs(g).max()) for g in jo[1:])
        for q, j, g in zip(pair.params, jo[1:], po[1:]):
            lim = 1e-4 * float(np.abs(j).max()) + 1e-7 * top
            assert float(np.abs(g - j).max()) <= lim, (q, step)
            g_ref[q].append(j)
            g_err[q].append(np.full_like(j, lim))
    for q in pair.params:
        want, got = pair.value(pair.jscope, q), pair.value(pair.pscope, q)
        s = pair.start[q].astype(np.float64)
        bound = 1e-4 * np.abs(want - s) + np.maximum(
            2 * fp32_ulp(want), 3e-8) + limit(g_ref[q], g_err[q], [LR, LR],
                                              BETA1, BETA2)
        err = np.abs(got - want)
        i = int(np.argmax(err - bound))
        assert err.flat[i] <= bound.flat[i], (q, got.flat[i], want.flat[i])


def test_deepfm_auc_histograms_bitwise_over_three_runs():
    pair = Pair("deepfm")
    auc = pair.p[3]
    stats = sorted(n for n in pair.names if n.startswith("auc"))
    assert len(stats) == 2
    for run in range(3):
        jo, po = pair.step(feed("deepfm", seed=run), [auc.name])
        np.testing.assert_allclose(po[0], jo[0], atol=1e-6, rtol=0)
        for n in stats:
            np.testing.assert_array_equal(pair.value(pair.pscope, n),
                                          pair.value(pair.jscope, n))
        total = sum(float(pair.value(pair.pscope, n).sum()) for n in stats)
        assert total == 16 * (run + 1)


def _beam_feed(seed=11):
    rng = np.random.RandomState(seed)
    batch, beam = 3, BEAM["beam_size"]
    src = rng.randint(2, BEAM["dict_size"],
                      (batch, BEAM["src_len"])).astype(np.int64)
    ids = np.full((batch, beam), 2, np.int64)
    scores = np.full((batch, beam), -1e9, np.float32)
    scores[:, 0] = 0.0   # lane 0 live, the others at -inf
    return {"bd_src": src, "bd_init_ids": ids, "bd_init_scores": scores}


def test_beam_decoder_ids_match_jax():
    j = build_beam(jfluid, j_models, j_unique)
    p = build_beam(pfluid, p_models, p_unique)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    pexe, pscope = pfluid.Executor("cpu"), pfluid.Scope()
    jexe.run(j[1], scope=jscope)
    pexe.run(p[1], scope=pscope)
    carry_scope(jscope, pscope, persistable_names(p[0]))
    f = _beam_feed()
    j_ids, j_scores = jexe.run(j[0], feed=f, fetch_list=list(j[2:]),
                               scope=jscope)
    p_ids, p_scores = pexe.run(p[0], feed=f, fetch_list=list(p[2:]),
                               scope=pscope)
    assert p_ids.shape == (3, BEAM["beam_size"], BEAM["max_length"])
    np.testing.assert_array_equal(p_ids, np.asarray(j_ids))
    np.testing.assert_allclose(p_scores, np.asarray(j_scores), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# the book tests' learning checks on the port
# ---------------------------------------------------------------------------


def _train(net, batches, epochs, lr=None, opt=None, fetch_more=()):
    """Train the program `net(models)` builds (its first return the loss)
    for `epochs` passes over `batches` under Adam(lr) or `opt`; returns
    (each epoch's fetches on its last batch, (main, exe, scope, net's
    returns))."""
    main, startup = pfluid.Program(), pfluid.Program()
    with p_unique.guard(), pfluid.program_guard(main, startup):
        out = net(p_models)
        loss = out[0]
        (opt or pfluid.optimizer.Adam(lr)).minimize(loss)
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    hist = []
    for _ in range(epochs):
        for b in batches:
            vals = exe.run(main, feed=b, fetch_list=[loss] + [
                out[i] for i in fetch_more], scope=scope)
        hist.append([float(np.asarray(v).ravel()[0]) for v in vals])
    return hist, (main, exe, scope, out)


def test_deepfm_trains_and_auc_improves():
    F, D, V = 8, 5, 1000
    rng = np.random.RandomState(5)
    n = 256
    ids = rng.randint(0, V, size=(n, F)).astype(np.int64)
    dense = rng.normal(size=(n, D)).astype(np.float32)
    signal = (ids % 2).mean(axis=1) + 0.3 * np.tanh(dense.sum(axis=1))
    label = (signal > np.median(signal)).astype(np.int64)[:, None]
    batches = [{"sparse_ids": ids[i:i + 64], "dense_x": dense[i:i + 64],
                "label": label[i:i + 64]} for i in range(0, n, 64)]

    def net(m):
        _, _, loss, auc = m.deepfm.build(
            sparse_feature_dim=V, num_fields=F, dense_dim=D, embed_dim=8,
            mlp_dims=(32, 32))
        return loss, auc

    hist, _ = _train(net, batches, 8, lr=2e-3, fetch_more=(1,))
    losses, aucs = [h[0] for h in hist], [h[1] for h in hist]
    assert losses[-1] < losses[0], losses
    assert aucs[-1] > 0.6, aucs


def test_word2vec_trains():
    dict_size = 64
    rng = np.random.RandomState(3)
    n = 256
    ctx = rng.randint(0, dict_size, size=(n, 4)).astype(np.int64)
    nxt = (ctx.sum(axis=1) % dict_size).astype(np.int64)[:, None]
    names = ["firstw", "secondw", "thirdw", "forthw"]
    batches = []
    for i in range(0, n, 64):
        b = {names[j]: ctx[i:i + 64, j:j + 1] for j in range(4)}
        b["nextw"] = nxt[i:i + 64]
        batches.append(b)

    def net(m):
        return (m.word2vec.build(dict_size=dict_size, embed_size=8,
                                 hidden_size=32)[2],)

    hist, _ = _train(net, batches, 15,
                     opt=pfluid.optimizer.SGD(learning_rate=0.05))
    losses = [h[0] for h in hist]
    assert losses[-1] < losses[0], losses


def _synthetic_imdb(n=128, seq_len=24, dict_size=200, seed=2):
    """Class 1 sequences draw from the top half of the vocab."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, size=(n, 1)).astype(np.int64)
    lens = rng.randint(seq_len // 2, seq_len + 1,
                       size=(n, 1)).astype(np.int64)
    words = np.zeros((n, seq_len), np.int64)
    for i in range(n):
        lo, hi = ((dict_size // 2, dict_size) if labels[i, 0]
                  else (0, dict_size // 2))
        words[i, :lens[i, 0]] = rng.randint(lo, hi, size=lens[i, 0])
    return words, labels, lens


def test_stacked_lstm_sentiment_trains():
    words, labels, lens = _synthetic_imdb()
    batches = [{"words": words[i:i + 32], "label": labels[i:i + 32],
                "seq_len": lens[i:i + 32]} for i in range(0, 128, 32)]

    def net(m):
        return (m.stacked_lstm.build(dict_size=200, emb_dim=16, hid_dim=16,
                                     stacked_num=2, seq_len=24)[4],)

    hist, _ = _train(net, batches, 6, lr=2e-3)
    losses = [h[0] for h in hist]
    assert losses[-1] < losses[0], losses


def test_nmt_attention_trains_on_copy_task():
    V, T = 40, 10
    rng = np.random.RandomState(4)
    n = 96
    lens = rng.randint(3, T + 1, size=(n, 1)).astype(np.int64)
    src = np.zeros((n, T), np.int64)
    for i in range(n):
        src[i, :lens[i, 0]] = rng.randint(2, V, size=lens[i, 0])
    trg = np.zeros((n, T), np.int64)
    trg[:, 0] = 1
    trg[:, 1:] = src[:, :-1]
    data = {"src_word": src, "src_len": lens, "trg_word": trg,
            "trg_next": src, "trg_len": lens}
    batches = [{k: v[i:i + 32] for k, v in data.items()}
               for i in range(0, n, 32)]

    def net(m):
        return (m.machine_translation.build(
            src_dict_size=V, trg_dict_size=V, embed_dim=16, hidden_dim=16,
            max_len=T)[2],)

    hist, _ = _train(net, batches, 12, lr=1e-2)
    losses = [h[0] for h in hist]
    assert losses[-1] < losses[0] * 0.9, losses


def test_nmt_greedy_decode_reproduces_copy():
    V, T = 30, 8
    rng = np.random.RandomState(7)
    n = 128
    full = np.full((n, 1), T, np.int64)
    src = rng.randint(2, V, size=(n, T)).astype(np.int64)
    trg = np.zeros((n, T), np.int64)
    trg[:, 0] = 1
    trg[:, 1:] = src[:, :-1]
    batches = [{"src_word": src[i:i + 32], "src_len": full[i:i + 32],
                "trg_word": trg[i:i + 32], "trg_next": src[i:i + 32],
                "trg_len": full[i:i + 32]} for i in range(0, n, 32)]

    def net(m):
        _, logits, loss = m.machine_translation.build(
            src_dict_size=V, trg_dict_size=V, embed_dim=32, hidden_dim=32,
            max_len=T)
        return loss, logits, pfluid.default_main_program().clone(
            for_test=True)

    hist, (main, exe, scope, out) = _train(net, batches, 60, lr=2e-2)
    logits, infer = out[1], out[2]
    lg, = exe.run(infer, feed=batches[0], fetch_list=[logits], scope=scope)
    tf_acc = (np.asarray(lg).reshape(32, T, V).argmax(-1) == src[:32]).mean()
    assert tf_acc > 0.9, (tf_acc, hist[-1])
    m = 8
    dec = np.zeros((m, T), np.int64)
    dec[:, 0] = 1
    lens_m = np.full((m, 1), T, np.int64)
    for t in range(T):
        lg, = exe.run(infer, feed={
            "src_word": src[:m], "src_len": lens_m, "trg_word": dec,
            "trg_next": np.zeros((m, T), np.int64), "trg_len": lens_m},
            fetch_list=[logits], scope=scope)
        nxt = np.asarray(lg).reshape(m, T, V)[:, t].argmax(-1)
        if t + 1 < T:
            dec[:, t + 1] = nxt
        last = nxt
    decoded = np.concatenate([dec[:, 1:], last[:, None]], axis=1)
    assert (decoded == src[:m]).mean() > 0.3, decoded


def numpy_beam_search(W, src, ids, scores, beam, maxlen, end):
    """The decoder's beam search in numpy over its weights `W`: (ids
    [batch, beam, maxlen] backtracked, final scores)."""
    batch, H = src.shape[0], W["bd_enc_w"].shape[1]

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    ctx = np.tanh(W["bd_vemb"][src].mean(1) @ W["bd_enc_w"] + W["bd_enc_b"])
    state = np.repeat(ctx[:, None, :], beam, axis=1)
    steps_ids, steps_par = [], []
    for _ in range(maxlen):
        emb = W["bd_vemb_dec"][ids]
        cur = np.tanh(np.concatenate([state, emb], -1) @ W["bd_dec_w"]
                      + W["bd_dec_b"])
        prob = softmax(cur @ W["bd_out_w"] + W["bd_out_b"])
        k_idx = np.argsort(-prob, axis=-1, kind="stable")[..., :beam]
        k_sc = np.take_along_axis(prob, k_idx, axis=-1)
        finished = ids == end
        cand = scores[:, :, None] + np.log(np.maximum(k_sc, 1e-20))
        first = np.arange(beam)[None, None, :] == 0
        cand = np.where(finished[:, :, None],
                        np.where(first, scores[:, :, None], -1e30), cand)
        cand_ids = np.where(finished[:, :, None], end, k_idx)
        flat = cand.reshape(batch, beam * beam)
        top = np.argsort(-flat, kind="stable", axis=1)[:, :beam]
        parent = top // beam
        scores = np.take_along_axis(flat, top, axis=1).astype(np.float32)
        ids = np.take_along_axis(cand_ids.reshape(batch, -1), top, axis=1)
        state = np.take_along_axis(
            cur, parent[:, :, None].repeat(H, axis=2), axis=1)
        steps_ids.append(ids.copy())
        steps_par.append(parent.copy())
    want = np.zeros((batch, beam, maxlen), np.int64)
    ptr = np.tile(np.arange(beam), (batch, 1))
    for t in range(maxlen - 1, -1, -1):
        want[:, :, t] = np.take_along_axis(steps_ids[t], ptr, axis=1)
        ptr = np.take_along_axis(steps_par[t], ptr, axis=1)
    return want, scores


def test_beam_search_decode_matches_a_numpy_beam_search():
    main, startup, ids, scores = build_beam(pfluid, p_models, p_unique)
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    exe.run(startup, scope=scope)
    f = _beam_feed()
    got_ids, got_scores = exe.run(main, feed=f, fetch_list=[ids, scores],
                                  scope=scope)
    W = {n: scope.get(n).numpy() for n in (
        "bd_vemb", "bd_enc_w", "bd_enc_b", "bd_vemb_dec", "bd_dec_w",
        "bd_dec_b", "bd_out_w", "bd_out_b")}
    want, want_scores = numpy_beam_search(
        W, f["bd_src"], f["bd_init_ids"], f["bd_init_scores"],
        BEAM["beam_size"], BEAM["max_length"], BEAM["end_id"])
    np.testing.assert_array_equal(got_ids, want)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-4, atol=1e-5)
