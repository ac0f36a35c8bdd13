"""The port's native flagship (``paddle_tpu_torch/models/transformer.py``)
and its bench step held against the JAX package on the CPU, at a small
config (vocab 64, d_model 32, 2 heads, 2 layers, d_ff 64, T 16, and T
320 for the CE head's short last chunk). The weights are the JAX
package's ``init_params(PRNGKey(seed))``, carried by
``params_from_numpy``; tokens come from a seeded numpy generator.

Limits (``chip_smoke.STEP_TOL``): fp32 values and the loss to 1e-5 of
their largest magnitude, grads to 1e-3 of each tensor's largest; bf16
to 2e-3 (the loss) and 5e-2 of each tensor's largest (values and grads:
GEMMs and reductions round in other places; the tied embedding's grad
sums its gather's scatter in bf16 on the JAX side). Params after an Adam
step lie within what those grad limits let Adam move them
(``chip_smoke.adam_param_limit``) plus 2 ulps.

Cases: every ported function; ``single_chip_forward``;
``single_chip_loss`` and its grads against ``jax.value_and_grad`` with
remat on and off (the port's two bitwise equal); ``lm_logits``'s bf16
grads against ``jax.vjp``, by the CPU's route and the card's;
``causal_attention`` against both JAX branches (einsum, and
``use_flash=True``, whose Pallas kernel runs in interpret mode as the
JAX package's tests run it); two
``bench.native_train_step``s against bench.py's update (:55-73, written
out below); the parameter tree with ``tie_embeddings=False`` and
``n_experts=2``; the card as the default device; ``seq_offset != 0``
raising on the kernel route; ``bench_transformer`` at a tiny size."""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import transformer as J
from paddle_tpu_torch import bench as pbench
from paddle_tpu_torch.models import transformer as P

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq_len=320)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"float32": dict(value=1e-5, loss=1e-5, grad=1e-3, bits=23),
       "bfloat16": dict(value=5e-2, loss=2e-3, grad=5e-2, bits=7)}
# (dtype, parameter store): bf16 parameters as bench.py stores them, or
# fp32 ones computing in bf16 (the graft entry's); in fp32 the two agree
STORES = [("float32", "bench"), ("bfloat16", "bench"),
          ("bfloat16", "fp32")]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_native", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def configs(dtype, remat=False, **kw):
    tdt, jdt = DTYPES[dtype]
    return (J.TransformerConfig(**SMALL, dtype=jdt, remat=remat, **kw),
            P.TransformerConfig(**SMALL, dtype=tdt, remat=remat, **kw))


def params(jc, seed=0, store="bench"):
    """(JAX tree, the port's tree on the CPU) of one draw."""
    jp = J.init_params(jax.random.PRNGKey(seed), jc)
    if store == "bench" and jc.dtype == jnp.bfloat16:
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                          if x.ndim >= 2 else x, jp)
    return jp, P.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")


def tokens(B=2, T=16, seed=0, vocab=64):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (B, T)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1).astype(np.int32)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, want, rel, label=""):
    """|got - want| within `rel` of want's largest magnitude."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, label
    lim = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= lim, "%s: %.3g > %.3g" % (label, err, lim)


def port_loss_and_grads(pp, toks, labs, pc):
    leaves = [t.detach().requires_grad_() for t in P.tree_leaves(pp)]
    it = iter(leaves)
    loss = P.single_chip_loss(P.tree_map(lambda _: next(it), pp),
                              torch.from_numpy(toks),
                              torch.from_numpy(labs), pc)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, [torch.zeros_like(x) if g is None else g
                  for g, x in zip(grads, leaves)]


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------


def test_tree_matches_jax_keys_shapes_and_dtypes():
    jc, pc = configs("float32", tie_embeddings=False, n_experts=2)
    jp = J.init_params(jax.random.PRNGKey(0), jc)
    pp = P.init_params(pc, device="cpu")
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    pflat = {}

    def walk(tree, path):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], path + "['%s']" % k)
            else:
                pflat[path + "['%s']" % k] = tree[k]

    walk(pp, "")
    assert sorted(pflat) == sorted(jflat)
    assert "['lm_head']" in pflat and "['moe']['router']" in pflat
    for k, v in jflat.items():
        assert tuple(pflat[k].shape) == v.shape, k
        assert pflat[k].dtype == torch.float32, k
    # the JAX package's scales: normal x 1/sqrt(fan_in), ones and zeros
    for k, fan_in in (("['layers']['wqkv']", 32), ("['layers']['w2']", 64),
                      ("['embed']", 32)):
        std = float(pflat[k].std())
        assert abs(std * math.sqrt(fan_in) - 1) < 0.1, (k, std)
    assert torch.equal(pflat["['layers']['ln1_scale']"],
                       torch.ones(2, 32))
    assert not pflat["['layers']['b1']"].any()
    assert P.param_count(pp) == J.param_count(jp)


def test_params_from_numpy_carries_every_leaf_bitwise():
    jc, _ = configs("bfloat16")
    jp, pp = params(jc, store="bench")
    for (path, jv), pv in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            P.tree_leaves(pp)):
        want = np.asarray(jv)
        assert str(pv.dtype).split(".")[1] == want.dtype.name, path
        assert np.array_equal(f32(pv), want.astype(np.float32)), path


def test_config_takes_a_dtype_name():
    assert P.TransformerConfig(dtype="float32").dtype == torch.float32
    assert P.TransformerConfig().dtype == torch.bfloat16
    assert P.TransformerConfig(d_model=64, n_heads=4).head_dim == 16


# ---------------------------------------------------------------------------
# the functions, one by one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layer_norm_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3 + 1
    s = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    want = J.layer_norm(jnp.asarray(x, jdt), s, b)
    got = P.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(s),
                       torch.from_numpy(b))
    assert got.dtype == tdt
    assert_close(got, want, TOL[dtype]["value"], "layer_norm")


def _qkv(B, Tq, Tk, H=2, Dh=16, seed=2):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Tq, H, Dh), (B, Tk, H, Dh), (B, Tk, H, Dh),
                      (B, Tq, H, Dh))]


def _attention_vjp(fn_j, fn_p, dtype, arrays):
    """Outputs and dq/dk/dv of both sides on the same inputs and dO."""
    tdt, jdt = DTYPES[dtype]
    q, k, v, do = arrays
    out_j, vjp = jax.vjp(fn_j, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    g_j = vjp(jnp.asarray(do, jdt))
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out_p = fn_p(*ts)
    g_p = torch.autograd.grad(out_p, ts, torch.from_numpy(do).to(tdt))
    return out_j, g_j, out_p, g_p


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("Tq,Tk,offset", [(16, 16, 0), (8, 16, 8)])
def test_causal_attention_matches_jax_einsum_branch(dtype, Tq, Tk, offset):
    out_j, g_j, out_p, g_p = _attention_vjp(
        lambda q, k, v: J.causal_attention(q, k, v, offset, use_flash=False),
        lambda q, k, v: P.causal_attention(q, k, v, offset), dtype,
        _qkv(2, Tq, Tk))
    tol = TOL[dtype]
    assert out_p.dtype == DTYPES[dtype][0]
    assert_close(out_p, out_j, tol["value"], "out")
    for name, a, b in zip("qkv", g_p, g_j):
        assert_close(a, b, tol["grad"], "d" + name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_causal_attention_matches_jax_flash_branch(dtype):
    """``use_flash=True`` on both sides: the JAX package's Pallas kernel
    in interpret mode, and K1's plain version (the kernel's on the
    card)."""
    out_j, g_j, out_p, g_p = _attention_vjp(
        lambda q, k, v: J.causal_attention(q, k, v, use_flash=True),
        lambda q, k, v: P.causal_attention(q, k, v, use_flash=True), dtype,
        _qkv(2, 16, 16))
    tol = TOL[dtype]
    assert_close(out_p, out_j, tol["value"], "out")
    for name, a, b in zip("qkv", g_p, g_j):
        assert_close(a, b, tol["grad"], "d" + name)


def test_seq_offset_raises_on_the_kernel_route():
    """The kernel route (every CUDA call, ``use_flash`` on the CPU) takes
    seq_offset 0 only: the SPMD trainer's sequence parallelism gathers
    the whole sequence before attention, so no caller passes one."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(1, 8, 8))
    with pytest.raises(NotImplementedError,
                       match="seq_offset=4 on the kernel route"):
        P.causal_attention(q, k, v, seq_offset=4, use_flash=True)
    P.causal_attention(q, k, v, seq_offset=0, use_flash=True)


@pytest.mark.parametrize("dtype,store", STORES)
def test_blocks_match_jax(dtype, store):
    """attention_block, ffn_block, embed_tokens and lm_logits of layer 0
    (forward)."""
    tdt, jdt = DTYPES[dtype]
    jc, pc = configs(dtype)
    jp, pp = params(jc, store=store)
    toks, _ = tokens()
    tol = TOL[dtype]["value"]
    h_j = J.embed_tokens(jp, toks, jc)
    h_p = P.embed_tokens(pp, torch.from_numpy(toks), pc)
    assert h_p.dtype == tdt
    assert_close(h_p, h_j, tol, "embed_tokens")
    # the same input to each block from here on
    x = np.asarray(jnp.asarray(h_j, jnp.float32))
    x_j, x_p = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    lp_j = jax.tree.map(lambda a: a[0], jp["layers"])
    lp_p = {k: v[0] for k, v in pp["layers"].items()}
    assert_close(P.attention_block(lp_p, x_p, tdt),
                 J.attention_block(lp_j, x_j, jdt), tol, "attention_block")
    assert_close(P.ffn_block(lp_p, x_p, tdt), J.ffn_block(lp_j, x_j, jdt),
                 tol, "ffn_block")
    lo_p = P.lm_logits(pp, x_p, pc)
    assert lo_p.dtype == torch.float32
    assert_close(lo_p, J.lm_logits(jp, x_j, jc), tol, "lm_logits")


@pytest.mark.parametrize("tied", [True, False])
def test_lm_logits_grads_match_jax_vjp_in_bf16(tied):
    """``lm_logits``'s grads in bf16 (``_F32Logits``) against ``jax.vjp``
    of the JAX ``lm_logits`` on the same inputs and fp32 cotangent: the
    CPU's route to a bf16 rounding of each element; the card's
    (``logits_grads`` with the cotangent rounded to bf16 first, run here
    on the CPU's bf16 GEMM)
    within LOGITS_GRAD_RTOL of each grad's norm. A transposed or
    mis-scaled grad is off by its whole norm."""
    rng = np.random.RandomState(7)
    N, D, V = 96, 32, 80
    h = rng.standard_normal((N, D)).astype(np.float32)
    w = (rng.standard_normal((V, D) if tied else (D, V)) / np.sqrt(D)
         ).astype(np.float32)
    g = rng.standard_normal((N, V)).astype(np.float32)
    jc, pc = configs("bfloat16")
    key = "embed" if tied else "lm_head"
    out_j, vjp = jax.vjp(lambda hh, ww: J.lm_logits({key: ww}, hh, jc),
                         jnp.asarray(h, jnp.bfloat16), jnp.asarray(w))
    gh_j, gw_j = (np.asarray(jnp.asarray(x, jnp.float32))
                  for x in vjp(jnp.asarray(g)))
    h_p = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    w_p = torch.from_numpy(w).requires_grad_()
    out_p = P.lm_logits({key: w_p}, h_p, pc)
    # fp32 sums in another order; a grad's rounding to bf16 may then
    # flip by one ulp (2^-7 of the element at most)
    np.testing.assert_allclose(out_p.detach().numpy(), np.asarray(out_j),
                               rtol=1e-6, atol=1e-6)
    gh_p, gw_p = torch.autograd.grad(out_p, (h_p, w_p), torch.from_numpy(g))
    assert gh_p.dtype == torch.bfloat16 and gw_p.dtype == torch.float32
    np.testing.assert_allclose(gh_p.float().numpy(), gh_j, rtol=2 ** -7)
    np.testing.assert_allclose(gw_p.numpy(), gw_j, rtol=2 ** -7)
    # the card's route on the same operands: w as the head uses it
    w16 = P._head_weight({key: torch.from_numpy(w)}, torch.bfloat16)
    gh_c, gw_c = P.logits_grads(h_p.detach(), w16, torch.from_numpy(g),
                                round_cotangent=True)
    gw_c = gw_c.float().t() if tied else gw_c.float()
    for got, want in ((gh_c.float().numpy(), gh_j), (gw_c.numpy(), gw_j)):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert 0 < rel <= P.LOGITS_GRAD_RTOL, rel
        assert np.linalg.norm(2 * got - want) / np.linalg.norm(want) > 0.5


def test_embed_scale_is_rounded_to_bf16_first():
    """jnp multiplies a bf16 tensor by sqrt(D) rounded to bf16 (D=512:
    22.627 -> 22.625); the port takes the same scalar."""
    cfg = P.TransformerConfig(vocab_size=4, d_model=512, n_heads=8,
                              max_seq_len=2, dtype="bfloat16")
    p = {"embed": torch.ones(4, 512), "pos_embed": torch.zeros(2, 512)}
    h = P.embed_tokens(p, torch.zeros(1, 1, dtype=torch.int32), cfg)
    assert float(h[0, 0, 0]) == 22.625


@pytest.mark.parametrize("dtype,store", STORES)
def test_single_chip_forward_matches_jax(dtype, store):
    jc, pc = configs(dtype)
    jp, pp = params(jc, seed=3, store=store)
    toks, _ = tokens(seed=3)
    want = J.single_chip_forward(jp, toks, jc)
    got = P.single_chip_forward(pp, torch.from_numpy(toks), pc)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 64)
    assert_close(got, want, TOL[dtype]["value"], "logits")
    hid = P.single_chip_hidden(pp, torch.from_numpy(toks), pc)
    assert_close(hid, J.single_chip_hidden(jp, toks, jc),
                 TOL[dtype]["value"], "hidden")


def test_token_cross_entropy_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.standard_normal((2, 8, 64)).astype(np.float32) * 2
    labels = rng.randint(0, 64, (2, 8)).astype(np.int32)
    want = float(J.token_cross_entropy(logits, labels))
    got = float(P.token_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("T", [16, 320])
@pytest.mark.parametrize("dtype,store", STORES)
def test_single_chip_loss_and_grads_match_jax(dtype, store, T):
    """With remat on and off on both sides; T=320 runs the head in
    chunks of 256 and 64. The port's two are bitwise equal."""
    tol = TOL[dtype]
    toks, labs = tokens(T=T, seed=5)
    got = {}
    for remat in (False, True):
        jc, pc = configs(dtype, remat=remat)
        jp, pp = params(jc, seed=5, store=store)
        loss_j, g_j = jax.value_and_grad(
            lambda p: J.single_chip_loss(p, toks, labs, jc))(jp)
        loss_p, g_p = port_loss_and_grads(pp, toks, labs, pc)
        got[remat] = (loss_p, g_p)
        assert loss_p.dtype == torch.float32
        assert abs(float(loss_p) - float(loss_j)) <= \
            tol["loss"] * abs(float(loss_j))
        for (path, gj), gp in zip(
                jax.tree_util.tree_flatten_with_path(g_j)[0], g_p):
            assert str(gp.dtype).split(".")[1] == gj.dtype.name, path
            assert_close(gp, gj, tol["grad"], jax.tree_util.keystr(path))
    assert torch.equal(got[False][0], got[True][0])
    for a, b in zip(got[False][1], got[True][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# bench.py's step
# ---------------------------------------------------------------------------

LR, B1, B2, EPS = 1e-4, 0.9, 0.999, 1e-8


def jax_train_step(params, m, v, t, tokens, labels, cfg):
    """bench.py:55-73, written out: the loss and grads, then Adam with
    bias correction from the int32 step counter."""
    loss, grads = jax.value_and_grad(
        lambda p: J.single_chip_loss(p, tokens, labels, cfg))(params)
    t = t + 1
    tf = t.astype(jnp.float32)

    def upd(p, g, mm, vv):
        gf = g.astype(jnp.float32)
        m2 = B1 * mm + (1 - B1) * gf
        v2 = B2 * vv + (1 - B2) * gf * gf
        p2 = (p.astype(jnp.float32)
              - LR * (m2 / (1 - B1 ** tf))
              / (jnp.sqrt(v2 / (1 - B2 ** tf)) + EPS))
        return p2.astype(p.dtype), m2, v2

    flat_p, tdef = jax.tree.flatten(params)
    out = [upd(p, g, mm, vv) for p, g, mm, vv in zip(
        flat_p, tdef.flatten_up_to(grads),
        tdef.flatten_up_to(m), tdef.flatten_up_to(v))]
    return (tdef.unflatten([o[0] for o in out]),
            tdef.unflatten([o[1] for o in out]),
            tdef.unflatten([o[2] for o in out]), t, loss), grads


def test_native_adam_is_bench_pys():
    assert pbench.NATIVE_ADAM == dict(lr=LR, b1=B1, b2=B2, eps=EPS)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_two_native_train_steps_match_bench_py(dtype):
    """Two steps, each from one state (the JAX side's, carried into the
    port before each): the loss, the grads (the port's recomputed at that
    state), the moments and the parameters, the step counter."""
    smoke = _smoke()
    tol = TOL[dtype]
    jc, pc = configs(dtype, remat=True)
    jp, _ = params(jc, seed=6, store="bench")
    jm = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
    jv = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
    jt = jnp.zeros((), jnp.int32)
    toks, labs = tokens(B=2, T=16, seed=6)
    g_ref = []
    for step in range(2):
        carry = [P.params_from_numpy(jax.tree.map(np.asarray, x),
                                     device="cpu") for x in (jp, jm, jv)]
        start = [f32(x) for x in P.tree_leaves(carry[0])]
        _, g_port = port_loss_and_grads(carry[0], toks, labs, pc)
        pp, pm, pv, pt, loss_p = pbench.native_train_step(
            *carry, torch.tensor(int(jt), dtype=torch.int32),
            torch.from_numpy(toks), torch.from_numpy(labs), pc)
        (jp, jm, jv, jt, loss_j), g_j = jax_train_step(
            jp, jm, jv, jt, toks, labs, jc)
        assert int(pt) == int(jt) == step + 1 and pt.dtype == torch.int32
        assert abs(float(loss_p) - float(loss_j)) <= \
            tol["loss"] * abs(float(loss_j))
        g_j = [f32(g) for g in jax.tree.leaves(g_j)]
        g_ref.append(g_j)
        floor = 1e-7 * max(float(np.abs(g).max()) for g in g_j)
        for i, (gp, gj, p_new, p_want, m_new, m_want, s) in enumerate(zip(
                g_port, g_j, P.tree_leaves(pp), jax.tree.leaves(jp),
                P.tree_leaves(pm), jax.tree.leaves(jm), start)):
            lim = tol["grad"] * float(np.abs(gj).max()) + floor
            assert float(np.abs(f32(gp) - gj).max()) <= lim, i
            assert str(p_new.dtype).split(".")[1] == \
                np.asarray(p_want).dtype.name, i
            assert float(np.abs(f32(m_new) - f32(m_want)).max()) <= \
                (1 - B1) * lim + 2 * float(smoke.ulp(
                    np.abs(f32(m_want)).max(), 23)), i
            g_err = [np.zeros_like(gj)] * step + [np.full_like(gj, lim)]
            mag = np.maximum(np.maximum(np.abs(f32(p_new)),
                                        np.abs(f32(p_want))), np.abs(s))
            p_lim = smoke.adam_param_limit(
                [g[i] for g in g_ref], g_err, [LR] * (step + 1), B1, B2) \
                + 2 * smoke.ulp(mag, tol["bits"])
            assert (np.abs(f32(p_new) - f32(p_want)) <= p_lim).all(), i


# ---------------------------------------------------------------------------
# the card as the default device; the bench at a tiny size
# ---------------------------------------------------------------------------


def test_the_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = P.TransformerConfig(**SMALL)
    for call in (lambda: P.init_params(cfg),
                 lambda: P.params_from_numpy({"embed": np.zeros((2, 2))}),
                 lambda: pbench.bench_transformer(steps=1, warmup=0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_bench_transformer_on_the_cpu():
    """bench.py's configuration at full width on a tiny batch: the
    return value, ``last_native`` and the bf16 storage rule."""
    tps, last = pbench.bench_transformer(steps=2, warmup=1, batch=2, seq=16,
                                         device="cpu")
    rec = pbench.last_native
    assert tps > 0 and rec["losses"][-1] == last
    assert len(rec["losses"]) == 3 and np.isfinite(rec["losses"]).all()
    assert rec["step_ms"] is None and rec["peak_bytes"] is None
    assert len(rec["host_ms"]) == 2 and rec["remat"] is False
    assert rec["step_flops"] is None           # metrics off
    cfg = pbench.native_config(192)
    assert (cfg.vocab_size, cfg.d_model, cfg.n_heads, cfg.n_layers,
            cfg.d_ff, cfg.max_seq_len, cfg.dtype, cfg.remat) == (
        32000, 512, 8, 6, 2048, 512, torch.bfloat16, True)
    p, m, v, t = pbench.native_state(pbench.native_config(2, 16),
                                     device="cpu")
    assert p["layers"]["ln1_scale"].dtype == torch.bfloat16
    assert p["layers"]["b1"].dtype == torch.bfloat16
    assert p["final_ln_scale"].dtype == torch.float32
    assert p["embed"].dtype == torch.bfloat16
    assert all(x.dtype == torch.float32 and not x.any()
               for x in P.tree_leaves(m) + P.tree_leaves(v))
    assert t.dtype == torch.int32 and int(t) == 0
