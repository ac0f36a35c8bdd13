"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``cuda``: they skip where there is no CUDA device (a
hand-written kernel has no CPU mode). This file imports no jax, so it
also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as pa


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,C,bs", [(64, 1, 16), (32, 3, 4),
                                      (128, 16, 16), (64, 4, 5)])
def test_kernel_matches_plain_on_card(Dh, C, bs):
    """The CUDA kernel against the plain version on the card: ragged
    positions, scattered pages, null tails, head dims 32/64/128 and
    windows up to 16 (atol 1e-4: fp32, different summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, H, Mb = 6, 4, 8
    rng = np.random.RandomState(Dh + C)
    last = rng.randint(C - 1, Mb * bs, size=B)
    last[:2] = [Mb * bs - 1, C - 1]
    pos = last[:, None] - (C - 1) + np.arange(C)[None, :]
    tables = np.zeros((B, Mb), np.int32)
    perm = rng.permutation(B * Mb) + 1
    for b in range(B):
        n = last[b] // bs + 1
        tables[b, :n] = perm[b * Mb:b * Mb + n]
    dev = torch.device("cuda")
    k = torch.from_numpy(
        rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)).to(dev)
    v = torch.from_numpy(
        rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.randn(B, C, H, Dh).astype(np.float32)).to(dev)
    t = torch.from_numpy(tables).to(dev)
    p = torch.from_numpy(pos.astype(np.int32)).to(dev)
    launches = pa.paged_attention.launches
    got = pa.paged_attention(k, v, q, t, p)
    want = pa.paged_attention_reference(k, v, q, t, p)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Tq,Tk,causal,dtype,layout", [
    (2, 3, 256, 256, True, "float32", "bhtd"),
    (2, 2, 192, 192, True, "bfloat16", "bthd"),
    (1, 2, 128, 320, False, "float32", "bthd"),
    (1, 1, 100, 100, True, "bfloat16", "bhtd"),   # ragged tiles
    (1, 2, 72, 200, False, "bfloat16", "bhtd"),
])
def test_flash_attention_kernels_match_plain_on_card(B, H, Tq, Tk, causal,
                                                     dtype, layout):
    """K1's forward and backward kernels against the plain version's
    forward and autograd on the same inputs on the card, in [B, H, T, Dh]
    and through the strided views of [B, T, H, Dh] tensors. Tolerance:
    fp32 atol/rtol 1e-4 (different order of sums); bf16 outputs atol/rtol
    1e-2 (both sides round to bf16, 1 ulp is at most 2^-7 |want|), bf16
    grads atol 3e-2, rtol 1e-2 (the kernel's delta uses the bf16-rounded
    O)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(Tq + Tk)
    dev, tdt = torch.device("cuda"), getattr(torch, dtype)

    def make(T):
        shape = (B, H, T, 64) if layout == "bhtd" else (B, T, H, 64)
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        t = t.to(dev, tdt)
        return t if layout == "bhtd" else t.transpose(1, 2)

    q, k, v, g = make(Tq), make(Tk), make(Tk), make(Tq)
    tols = ({"out": (1e-4, 1e-4), "grads": (1e-4, 1e-4)}
            if dtype == "float32"
            else {"out": (1e-2, 1e-2), "grads": (3e-2, 1e-2)})
    fwd = fa.flash_attention_fwd.launches
    bwd = fa.flash_attention_bwd.launches
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == (fwd + 1, bwd + 1)
    assert out.stride() == q.stride()   # written where the layout says
    ref_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention_reference(*ref_leaves, causal=causal)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g)
    for name, got, want in zip(("out", "dq", "dk", "dv"),
                               (out,) + grads, (ref,) + ref_grads):
        assert got.dtype == tdt and torch.isfinite(got).all(), name
        atol, rtol = tols["out" if name == "out" else "grads"]
        np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                                   want.detach().float().cpu().numpy(),
                                   err_msg=name, atol=atol, rtol=rtol)
