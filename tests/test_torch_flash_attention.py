"""The port's flash_attention graph op (its plain version on the CPU)
held against the JAX package's op, whose Pallas kernel runs in interpret
mode as ``tests/test_pallas.py`` runs it: forward and dQ/dK/dV (autograd
against ``jax.vjp``), causal self-attention at T 128 and 256 and
non-causal cross-attention (Tq 128, Tk 256), Dh 64, in both layouts
(``bhtd`` and the ``bthd`` the fused attention op hands over), fp32 and
bf16. Inputs come from a seeded numpy generator."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import registry as j_registry
from paddle_tpu_torch.ops import flash_attention as p_flash
from paddle_tpu_torch.ops import registry as p_registry

# fp32: different summation orders; bf16: one bf16 rounding of values
# and grads of magnitude ~1 (2^-8 relative), plus the order of sums
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _inputs(Tq, Tk, layout, seed=0):
    rng = np.random.RandomState(seed)
    B, H, Dh = 2, 2, 64
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
    q, k, v, g = _inputs(Tq, Tk, layout)
    attrs = {"causal": causal, "sm_scale": 64 ** -0.5, "layout": layout}

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
