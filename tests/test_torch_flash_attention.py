"""The port's flash_attention graph op (its plain version on the CPU)
held against the JAX package's op, whose Pallas kernel runs in interpret
mode as ``tests/test_pallas.py`` runs it: forward and dQ/dK/dV (autograd
against ``jax.vjp``), causal self-attention at T 128 and 256 and
non-causal cross-attention (Tq 128, Tk 256), Dh 64, in both layouts
(``bhtd`` and the ``bthd`` the fused attention op hands over), fp32 and
bf16; and at T 128 with Dh 128, 256, a head dim the kernels reach
through padding (96) and one past 256 (320). Inputs come from a seeded
numpy generator.

Also: numpy emulations of the bf16 tensor-core kernels' numerics
(``csrc/flash_attention_tc.cu``) and of the 3xTF32 forward and backward
(``csrc/flash_attention_f32tc.cu``, ``csrc/flash_attention_f32tc_bwd.cu``)
held against the same JAX op within the limits ``chip_smoke.py`` holds
those kernels to on the card, and the wrapper's route, alignment and
head-dim decisions as pure functions."""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import registry as j_registry
from paddle_tpu_torch.ops import compat_ops as p_compat
from paddle_tpu_torch.ops import flash_attention as p_flash
from paddle_tpu_torch.ops import registry as p_registry

# fp32: different summation orders; bf16: one bf16 rounding of values
# and grads of magnitude ~1 (2^-8 relative), plus the order of sums
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _inputs(Tq, Tk, layout, seed=0, Dh=64):
    rng = np.random.RandomState(seed)
    B, H = 2, 2
    shape = ((lambda T: (B, H, T, Dh)) if layout == "bhtd"
             else (lambda T: (B, T, H, Dh)))
    return [rng.standard_normal(s).astype(np.float32)
            for s in (shape(Tq), shape(Tk), shape(Tk), shape(Tq))]


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("Tq,Tk,causal", [(128, 128, True),
                                          (256, 256, True),
                                          (128, 256, False)])
def test_flash_attention_op_matches_jax(Tq, Tk, causal, layout, dtype):
    _op_matches_jax(Tq, Tk, causal, layout, dtype, 64)


# the head dims F1 opened: 128 and 256 (instantiations), 96 (padded to
# 128); F1c: 320 (padded to 384, three 128-column parts)
@pytest.mark.parametrize("layout,dtype,Dh", [("bthd", "float32", 128),
                                             ("bhtd", "bfloat16", 128),
                                             ("bthd", "float32", 96),
                                             ("bhtd", "float32", 256),
                                             ("bthd", "float32", 256),
                                             ("bhtd", "bfloat16", 256),
                                             ("bthd", "bfloat16", 256),
                                             ("bthd", "float32", 320),
                                             ("bhtd", "bfloat16", 320)])
def test_flash_attention_op_matches_jax_wide_heads(layout, dtype, Dh):
    _op_matches_jax(128, 128, True, layout, dtype, Dh)


def _op_matches_jax(Tq, Tk, causal, layout, dtype, Dh):
    """The port's flash_attention op against the JAX package's, forward
    and autograd against jax.vjp, to TOL[dtype]."""
    q, k, v, g = _inputs(Tq, Tk, layout, Dh=Dh)
    attrs = {"causal": causal, "sm_scale": Dh ** -0.5, "layout": layout}

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j_impl = j_registry.get("flash_attention").impl

    def j_fn(q, k, v):
        return j_impl(None, {"Q": [q], "K": [k], "V": [v]}, attrs)["Out"][0]

    j_args = [jnp.asarray(x, jdt) for x in (q, k, v)]
    j_out, vjp = jax.vjp(j_fn, *j_args)
    j_grads = vjp(jnp.asarray(g, jdt))

    tdt = getattr(torch, dtype)
    p_args = [torch.from_numpy(x).to(tdt).requires_grad_()
              for x in (q, k, v)]
    p_out = p_registry.get("flash_attention").impl(
        None, {"Q": [p_args[0]], "K": [p_args[1]], "V": [p_args[2]]},
        attrs)["Out"][0]
    p_grads = torch.autograd.grad(p_out, p_args,
                                  torch.from_numpy(g).to(tdt))

    assert p_out.dtype == tdt and tuple(p_out.shape) == j_out.shape
    np.testing.assert_allclose(p_out.float().detach().numpy(), _f32(j_out),
                               err_msg="out", **TOL[dtype])
    for name, pg, jg in zip("qkv", p_grads, j_grads):
        assert pg.dtype == tdt
        np.testing.assert_allclose(pg.float().numpy(), _f32(jg),
                                   err_msg="d" + name, **TOL[dtype])


def test_plain_version_is_the_cpu_route_and_counts_no_launch():
    """CPU tensors take the plain version (no kernel launch counted);
    causal attention with Tq != Tk raises, as the JAX gate refuses it."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(128, 128, "bhtd"))
    fwd, bwd = (p_flash.flash_attention_fwd.launches,
                p_flash.flash_attention_bwd.launches)
    out = p_flash.flash_attention(q, k, v, causal=True)
    want = p_flash.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(out, want)
    assert (p_flash.flash_attention_fwd.launches,
            p_flash.flash_attention_bwd.launches) == (fwd, bwd)
    with pytest.raises(ValueError, match="Tq == Tk"):
        p_flash.flash_attention(q, k[:, :, :64], v[:, :, :64], causal=True)


# chip_smoke.py FLASH_TOL["bfloat16"]: |got - want| <= atol + rtol |want|
CARD_TOL = {"out": (1e-2, 1e-2), "grads": (3e-2, 1e-2)}


def _bf16(x):
    """x rounded to bf16 (nearest even), as fp32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _tc_emulation(q, k, v, do, causal, scale):
    """What the tensor-core kernels compute from bf16-valued fp32 arrays
    [B, H, T, Dh]: 64-key tiles, an fp32 online softmax in exp2 on scores
    prescaled by scale·log2(e), P rounded to bf16 before P·V, O rounded to
    bf16; the backward rebuilds P from the fp32 lse, delta from the bf16
    O, rounds P and dS to bf16 before their products; sums in fp32.
    Returns (o, dq, dk, dv), bf16-valued."""
    f32 = np.float32
    Tq, Tk = q.shape[2], k.shape[2]
    c = f32(scale * np.log2(np.e))
    rows = np.arange(Tq)[:, None]
    m = np.full(q.shape[:3] + (1,), -np.inf, f32)
    l = np.zeros_like(m)
    acc = np.zeros(q.shape, f32)
    with np.errstate(invalid="ignore"):
        for k0 in range(0, Tk, 64):
            kt, vt = k[:, :, k0:k0 + 64], v[:, :, k0:k0 + 64]
            s = (q @ kt.swapaxes(-1, -2)) * c
            if causal:
                cols = k0 + np.arange(kt.shape[2])[None, :]
                s = np.where(cols <= rows, s, -np.inf).astype(f32)
            mx = np.maximum(m, s.max(-1, keepdims=True))
            mu = np.where(mx == -np.inf, 0, mx).astype(f32)
            alpha, p = np.exp2(m - mu), np.exp2(s - mu)
            l = l * alpha + p.sum(-1, keepdims=True)
            acc = acc * alpha + _bf16(p) @ vt
            m = mx
    o = _bf16(acc / l)
    lse = m * f32(np.log(2)) + np.log(l)
    delta = (o * do).sum(-1, keepdims=True)
    p = np.exp2((q @ k.swapaxes(-1, -2)) * c - lse * f32(np.log2(np.e)))
    if causal:
        p = np.where(np.arange(Tk)[None, :] <= rows, p, 0).astype(f32)
    ds = p * (do @ v.swapaxes(-1, -2) - delta)
    dv = _bf16(p).swapaxes(-1, -2) @ do
    dk = (_bf16(ds).swapaxes(-1, -2) @ q) * f32(scale)
    dq = (_bf16(ds) @ k) * f32(scale)
    return o, _bf16(dq), _bf16(dk), _bf16(dv)


@pytest.mark.parametrize("Tq,Tk,causal", [(128, 128, True),
                                          (256, 256, True),
                                          (128, 256, False)])
def test_tc_kernel_numerics_within_card_limits(Tq, Tk, causal):
    """The tensor-core kernels' numerics (P and dS rounded to bf16) stay
    inside the card limits against the JAX op on the same bf16 inputs,
    forward and dQ/dK/dV; prints the largest ratio to each limit."""
    _tc_numerics(Tq, Tk, causal, 64)


def test_tc_kernel_numerics_within_card_limits_dh128():
    """The same at head dim 128 (T 128, causal)."""
    _tc_numerics(128, 128, True, 128)


def _tc_numerics(Tq, Tk, causal, Dh):
    q, k, v, g = (_bf16(x) for x in _inputs(Tq, Tk, "bhtd", Dh=Dh))
    scale = Dh ** -0.5
    attrs = {"causal": causal, "sm_scale": scale, "layout": "bhtd"}
    j_impl = j_registry.get("flash_attention").impl

    def j_fn(q, k, v):
        return j_impl(None, {"Q": [q], "K": [k], "V": [v]}, attrs)["Out"][0]

    j_out, vjp = jax.vjp(j_fn, *(jnp.asarray(x, jnp.bfloat16)
                                 for x in (q, k, v)))
    want = (j_out,) + vjp(jnp.asarray(g, jnp.bfloat16))
    got = _tc_emulation(q, k, v, g, causal, scale)
    ratios = {}
    for name, x, w in zip(("out", "dq", "dk", "dv"), got, want):
        w = _f32(w)
        atol, rtol = CARD_TOL["out" if name == "out" else "grads"]
        assert np.isfinite(x).all(), name
        ratios[name] = float((np.abs(x - w) / (atol + rtol * np.abs(w)))
                             .max())
    print("tc numerics Tq=%d Tk=%d causal=%s Dh=%d: largest |err| / card "
          "limit %s" % (Tq, Tk, causal, Dh, ratios))
    assert max(ratios.values()) <= 1, ratios


# chip_smoke.py FLASH_TOL["float32"]["out"]
F32_CARD_TOL = (1e-4, 1e-4)


def _tf32(x):
    """x rounded to TF32 (10 stored mantissa bits, to nearest, ties away
    from zero: cvt.rna.tf32.f32), as fp32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _mm3(a, b):
    """a @ b by 3xTF32: big·big + big·small + small·big, fp32 sums."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _f32tc_emulation(q, k, v, causal, scale, kv_tile):
    """What ``csrc/flash_attention_f32tc.cu`` computes from fp32 arrays
    [B, H, T, Dh]: kv tiles of `kv_tile` keys, S = Q Kᵀ by 3xTF32, an
    fp32 online softmax in exp2 on scores prescaled by scale·log2(e), P
    split from its fp32 value and P V by 3xTF32. Returns (o, lse)."""
    f32 = np.float32
    Tq, Tk = q.shape[2], k.shape[2]
    c = f32(scale * np.log2(np.e))
    rows = np.arange(Tq)[:, None]
    m = np.full(q.shape[:3] + (1,), -np.inf, f32)
    l = np.zeros_like(m)
    acc = np.zeros(q.shape, f32)
    with np.errstate(invalid="ignore"):
        for k0 in range(0, Tk, kv_tile):
            kt, vt = k[:, :, k0:k0 + kv_tile], v[:, :, k0:k0 + kv_tile]
            s = _mm3(q, kt.swapaxes(-1, -2)) * c
            if causal:
                cols = k0 + np.arange(kt.shape[2])[None, :]
                s = np.where(cols <= rows, s, -np.inf).astype(f32)
            mx = np.maximum(m, s.max(-1, keepdims=True))
            mu = np.where(mx == -np.inf, 0, mx).astype(f32)
            alpha, p = np.exp2(m - mu), np.exp2(s - mu)
            l = l * alpha + p.sum(-1, keepdims=True)
            acc = acc * alpha + _mm3(p, vt)
            m = mx
    return acc / l, m * f32(np.log(2)) + np.log(l)


# the 3xTF32 forward's kv tile rows by head dim: Cfg<DH>::kKT in
# paddle_tpu_torch/csrc/flash_attention_f32tc.cu
F32TC_KV_TILE = {64: 64, 128: 32, 256: 16}


@pytest.mark.parametrize("Dh", sorted(F32TC_KV_TILE))
def test_f32tc_kernel_numerics_within_card_limits(Dh):
    """The 3xTF32 forward's numerics (both products from TF32 halves, P
    split from fp32) stay inside the fp32 card limit against the JAX op
    on the same fp32 inputs (T 128, causal), at each instantiated head
    dim with its kv tile; prints the largest ratio to the limit. One TF32
    product alone (big·big) would not: its ratio is printed beside."""
    q, k, v, _ = _inputs(128, 128, "bhtd", seed=3, Dh=Dh)
    q, k, v = (2 * x for x in (q, k, v))
    scale = Dh ** -0.5
    attrs = {"causal": True, "sm_scale": scale, "layout": "bhtd"}
    want = _f32(j_registry.get("flash_attention").impl(
        None, {"Q": [jnp.asarray(q)], "K": [jnp.asarray(k)],
               "V": [jnp.asarray(v)]}, attrs)["Out"][0])
    src = (pathlib.Path(p_flash.__file__).parents[1] / "csrc"
           / "flash_attention_f32tc.cu").read_text()
    cfg = re.search(r"struct Cfg<%d> \{\s*static constexpr int kRows = "
                    r"\d+, kKT = (\d+);" % Dh, src)
    assert cfg and int(cfg.group(1)) == F32TC_KV_TILE[Dh]
    got, lse = _f32tc_emulation(q, k, v, True, scale, F32TC_KV_TILE[Dh])
    atol, rtol = F32_CARD_TOL
    ratio = float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * scale
    s = np.where(np.tril(np.ones((128, 128), bool)), s, -np.inf)
    lse_want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    lse_err = float(np.abs(lse[..., 0] - lse_want).max())
    one = _tf32(q) @ _tf32(k).swapaxes(-1, -2) * scale
    one = np.where(np.tril(np.ones((128, 128), bool)), one, -np.inf)
    p1 = np.exp(one - one.max(-1, keepdims=True))
    o1 = (_tf32(p1 / p1.sum(-1, keepdims=True)) @ _tf32(v))
    ratio1 = float((np.abs(o1 - want) / (atol + rtol * np.abs(want))).max())
    print("f32tc numerics Dh=%d: largest |err| / card limit %.4f (one TF32 "
          "product: %.2f); lse max abs err %.3g"
          % (Dh, ratio, ratio1, lse_err))
    assert np.isfinite(got).all()
    assert ratio <= 1 and lse_err <= 1e-4
    assert ratio1 > 1


def _f32tc_bwd_emulation(q, k, v, o, do, lse, causal, scale, tile, mm=None):
    """What ``csrc/flash_attention_f32tc_bwd.cu`` computes from fp32
    arrays [B, H, T, Dh] and the forward's o and lse: delta = rowsum(dO·O)
    in fp32; per tile of `tile` streamed rows, S = Q Kᵀ and dP = dO Vᵀ by
    3xTF32, P = exp2(S·scale·log2(e) − lse·log2(e)) (0 where masked), dS =
    P (dP − delta); the dK/dV pass adds Pᵀ dO and dSᵀ Q over the q tiles,
    the dQ pass dS K over the kv tiles, every product by 3xTF32 (`mm`,
    default ``_mm3``) and every tile's term added in fp32. Returns (dq,
    dk, dv)."""
    mm = _mm3 if mm is None else mm
    f32 = np.float32
    Tq, Tk = q.shape[2], k.shape[2]
    c, log2e = f32(scale * np.log2(np.e)), f32(np.log2(np.e))
    delta = (do * o).sum(-1, keepdims=True, dtype=f32)
    l2 = lse * log2e

    def p_ds(qs, dos, q0, ks, vs, k0, rows_l2, rows_delta):
        p = np.exp2(mm(qs, ks.swapaxes(-1, -2)) * c - rows_l2)
        if causal:
            vis = (k0 + np.arange(ks.shape[2]))[None, :] \
                <= (q0 + np.arange(qs.shape[2]))[:, None]
            p = np.where(vis, p, 0).astype(f32)
        return p, p * (mm(dos, vs.swapaxes(-1, -2)) - rows_delta)

    dq, dk, dv = (np.zeros(x.shape, f32) for x in (q, k, v))
    with np.errstate(over="ignore", invalid="ignore"):
        for q0 in range(0, Tq, tile):   # dK/dV pass: q tiles streamed
            sl = slice(q0, q0 + tile)
            p, ds = p_ds(q[:, :, sl], do[:, :, sl], q0, k, v, 0,
                         l2[:, :, sl], delta[:, :, sl])
            dv += mm(p.swapaxes(-1, -2), do[:, :, sl])
            dk += mm(ds.swapaxes(-1, -2), q[:, :, sl])
        for k0 in range(0, Tk, tile):   # dQ pass: kv tiles streamed
            sl = slice(k0, k0 + tile)
            _, ds = p_ds(q, do, 0, k[:, :, sl], v[:, :, sl], k0, l2, delta)
            dq += mm(ds, k[:, :, sl])
    return dq * f32(scale), dk * f32(scale), dv


# the 3xTF32 backward's streamed rows a tile by head dim (the first pass's
# BwdCfg<DH, kKV>::kT in paddle_tpu_torch/csrc/flash_attention_f32tc_bwd.cu)
F32TC_BWD_TILE = {64: 32, 128: 16, 256: 16}


@pytest.mark.parametrize("Dh", sorted(F32TC_BWD_TILE))
def test_f32tc_backward_numerics_within_card_limits(Dh):
    """The 3xTF32 backward's numerics (every product from TF32 halves, P
    and dS split from fp32, the forward's emulated o and lse) stay inside
    the fp32 card limit for the grads against the JAX op's vjp on the
    same fp32 inputs (T 128, causal), at each of its head-dim configs with
    its tile; prints the largest ratio to the limit. One TF32 product
    alone would not: its ratio is printed beside."""
    q, k, v, g = _inputs(128, 128, "bhtd", seed=4, Dh=Dh)
    q, k, v, g = (2 * x for x in (q, k, v, g))
    scale = Dh ** -0.5
    attrs = {"causal": True, "sm_scale": scale, "layout": "bhtd"}
    j_impl = j_registry.get("flash_attention").impl

    def j_fn(q, k, v):
        return j_impl(None, {"Q": [q], "K": [k], "V": [v]}, attrs)["Out"][0]

    _, vjp = jax.vjp(j_fn, *(jnp.asarray(x) for x in (q, k, v)))
    want = [_f32(x) for x in vjp(jnp.asarray(g))]
    src = (pathlib.Path(p_flash.__file__).parents[1] / "csrc"
           / "flash_attention_f32tc_bwd.cu").read_text()
    cfg = re.search(r"struct BwdCfg<%d, \w+> \{\s*static constexpr int "
                    r"kR = \d+, kT = (\d+)," % Dh, src)
    assert cfg and int(cfg.group(1)) == F32TC_BWD_TILE[Dh]
    o, lse = _f32tc_emulation(q, k, v, True, scale, F32TC_KV_TILE[Dh])
    atol, rtol = F32_CARD_TOL

    def ratios(got):
        return {n: float((np.abs(x - w) / (atol + rtol * np.abs(w))).max())
                for n, x, w in zip(("dq", "dk", "dv"), got, want)}

    got = _f32tc_bwd_emulation(q, k, v, o, g, lse, True, scale,
                               F32TC_BWD_TILE[Dh])
    one = _f32tc_bwd_emulation(q, k, v, o, g, lse, True, scale,
                               F32TC_BWD_TILE[Dh],
                               mm=lambda a, b: _tf32(a) @ _tf32(b))
    r, r1 = ratios(got), ratios(one)
    print("f32tc backward numerics Dh=%d: largest |err| / card limit %s "
          "(one TF32 product: %s)" % (Dh, r, r1))
    assert all(np.isfinite(x).all() for x in got)
    assert max(r.values()) <= 1 and max(r1.values()) > 1


def test_route_and_alignment_decisions():
    """bf16 CUDA -> tc both ways, fp16 CUDA -> fp16 both ways (F3: it
    raised before), fp32 CUDA -> f32tc both ways, CPU -> plain, other
    CUDA dtypes and devices raise; a view
    the tensor-core kernels cannot read 16 bytes at a time is copied, an
    aligned one is read in place."""
    route = p_flash.kernel_route
    for dt in (torch.bfloat16, torch.float16, torch.float32, torch.float64):
        assert route("cpu", dt) == "plain"
        assert route("cpu", dt, backward=True) == "plain"
    assert route("cuda", torch.bfloat16) == "tc"
    assert route("cuda", torch.bfloat16, backward=True) == "tc"
    assert route("cuda", torch.float32) == "f32tc"
    assert route("cuda", torch.float32, backward=True) == "f32tc"
    assert route("cuda", torch.float16) == "fp16"
    assert route("cuda", torch.float16, backward=True) == "fp16"
    for dt in (torch.float64, torch.int8):
        with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
            route("cuda", dt)
    with pytest.raises(RuntimeError, match="CUDA"):
        route("meta", torch.bfloat16)

    bthd = torch.zeros(2, 130, 3, 64, dtype=torch.bfloat16).transpose(1, 2)
    t, copied = p_flash.tc_operand(bthd)
    assert t is bthd and not copied
    odd_rows = torch.randn(2, 3, 130, 68).to(torch.bfloat16)[..., :64]
    flat = torch.randn(2 * 3 * 130 * 64 + 1).to(torch.bfloat16)
    odd_base = flat[1:].view(2, 3, 130, 64)
    for view in (odd_rows, odd_base):
        t, copied = p_flash.tc_operand(view)
        assert copied and torch.equal(t, view) and t.is_contiguous()
        assert p_flash.tc_aligned(t.data_ptr(), t.shape, t.stride(), 2)
    aligned = p_flash.tc_aligned
    assert aligned(0, (2, 3, 5, 64), (960, 320, 64, 1), 4)   # fp32 rows
    assert not aligned(0, (2, 3, 5, 66), (990, 330, 66, 1), 4)
    assert aligned(0, (1, 1, 5, 64), (3, 5, 64, 1), 2)  # size-1 dims
    assert not aligned(0, (2, 1, 5, 64), (3, 5, 64, 1), 2)
    assert not aligned(0, (1, 1, 5, 64), (320, 320, 64, 2), 2)
    assert not aligned(2, (1, 1, 5, 64), (320, 320, 64, 1), 2)


def test_every_gated_head_dim_has_a_kernel_or_raises_named():
    """F1, F1c: every head dim from 64 to 520 that the op's gate sends to
    the kernels runs at a width the kernels take, no narrower than itself
    (itself when it is one; otherwise the wrapper pads to it): up to 256
    the narrowest instantiation that fits, above it the next multiple of
    ``PART_WIDTH``, the part width every route's wide kernels are built
    for (read from their sources). Nothing raises any more: the name is
    the contract before F1c was closed. No kernel needed: the wrapper's
    decision function and the sources' constants."""
    largest = max(p_flash.SUPPORTED_HEAD_DIMS)
    assert set(p_flash.SUPPORTED_HEAD_DIMS) == {64, 128, 256}
    part = p_flash.PART_WIDTH
    csrc = pathlib.Path(p_flash.__file__).parents[1] / "csrc"
    for name, const in (("flash_attention_tc.cu", "kWide"),
                        ("flash_attention_f32tc.cuh", "kPart")):
        m = re.search(r"constexpr int %s = (\d+);" % const,
                      (csrc / name).read_text())
        assert m and int(m.group(1)) == part, name
    gated = [Dh for Dh in range(64, 521)
             if p_compat.flash_qualify(128, 128, Dh, True)]
    assert gated == list(range(64, 521))
    for Dh in gated:
        d = p_flash.kernel_head_dim(Dh)
        assert d >= Dh, Dh
        if Dh <= largest:
            assert d in p_flash.SUPPORTED_HEAD_DIMS, Dh
            assert not [s for s in p_flash.SUPPORTED_HEAD_DIMS
                        if Dh <= s < d], Dh   # the narrowest that fits
            assert (d == Dh) == (Dh in p_flash.SUPPORTED_HEAD_DIMS), Dh
        else:
            assert d % part == 0 and d - Dh < part, Dh
            assert (d == Dh) == (Dh % part == 0), Dh
    assert [p_flash.kernel_head_dim(d) for d in (257, 320, 384, 512, 520)] \
        == [384, 384, 384, 512, 640]
