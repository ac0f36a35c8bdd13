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
    launches = pa.paged_attention.window_launches.get(C, 0)
    got = pa.paged_attention(k, v, q, t, p)
    want = pa.paged_attention_reference(k, v, q, t, p)
    torch.cuda.synchronize()
    assert pa.paged_attention.window_launches[C] == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("W,D,Dh,bs", [(2, 6, 64, 16), (1, 4, 32, 4),
                                       (3, 8, 128, 16), (1, 31, 128, 16),
                                       (4, 4, 64, 5)])
def test_tree_kernel_matches_plain_on_card(W, D, Dh, bs):
    """K3 against its plain version on the card: tree windows C = 1 + W*D
    up to 32 (shared memory past 48 KB at Dh 128), window bases on and
    off block boundaries, a window running past the table, an inactive
    row (position 0, null table), null tails; at width 1 also against
    K2 (atol 1e-4: fp32, different summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import paged_attention_tree as pat
    from paddle_tpu_torch.serving import tree_topology

    B, H, Mb = 6, 4, 8
    C = 1 + W * D
    T = Mb * bs
    rng = np.random.RandomState(W * 100 + D)
    pos0 = rng.randint(1, T - C + 1, size=B)
    pos0[:3] = [0, T - C + 2, bs]
    tables = np.zeros((B, Mb), np.int32)
    perm = rng.permutation(B * Mb) + 1
    for b in range(1, B):
        n = min((pos0[b] + C - 1) // bs + 1, Mb)
        tables[b, :n] = perm[b * Mb:b * Mb + n]
    pos = pos0[:, None] + np.arange(C)[None, :]
    dev = torch.device("cuda")
    k = torch.from_numpy(
        rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)).to(dev)
    v = torch.from_numpy(
        rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.randn(B, C, H, Dh).astype(np.float32)).to(dev)
    t = torch.from_numpy(tables).to(dev)
    p = torch.from_numpy(pos.astype(np.int32)).to(dev)
    anc = torch.from_numpy(tree_topology(W, D)[2]).to(dev)
    launches = pat.paged_attention_tree.launches
    got = pat.paged_attention_tree(k, v, q, t, p, anc)
    want = pat.paged_attention_tree_reference(k, v, q, t, p, anc)
    torch.cuda.synchronize()
    assert pat.paged_attention_tree.launches == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)
    if W == 1 and C <= pa.MAX_WINDOW:
        lin = pa.paged_attention(k, v, q, t, p)
        np.testing.assert_allclose(got.cpu().numpy(), lin.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_tree_kernel_wrapper_checks_on_card():
    """The wrapper refuses what the kernel does not take, naming it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from paddle_tpu_torch.ops import paged_attention_tree as pat

    dev = torch.device("cuda")
    k = torch.zeros(5, 4, 2, 64, device=dev)
    tables = torch.zeros(1, 2, dtype=torch.int32, device=dev)

    def call(C=5, anc=None, Dh=64):
        kk = k if Dh == 64 else torch.zeros(5, 4, 2, Dh, device=dev)
        q = torch.zeros(1, C, 2, Dh, device=dev)
        pos = torch.arange(C, dtype=torch.int32, device=dev)[None]
        if anc is None:
            anc = torch.eye(C, dtype=torch.bool, device=dev)
        return pat.paged_attention_tree(kk, kk, q, tables, pos, anc)

    with pytest.raises(ValueError, match="C <= 32"):
        call(C=33)
    with pytest.raises(ValueError, match="head_dim 48"):
        call(Dh=48)
    with pytest.raises(TypeError, match="anc must be torch.bool"):
        call(anc=torch.eye(5, device=dev))
    with pytest.raises(ValueError, match=r"anc must be \[C, C\]"):
        call(anc=torch.eye(4, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match="anc is on cpu"):
        call(anc=torch.eye(5, dtype=torch.bool))


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
