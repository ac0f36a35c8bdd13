"""The split-and-combine design of the port's paged attention kernels (K2
``csrc/paged_attention.cu``, K3 ``csrc/paged_attention_tree.cu``, body
``csrc/paged_attention.cuh``) emulated in numpy and held against the JAX
package's ``paged_attention_reference`` / ``paged_attention_tree_reference``
and the port's plain versions, on the same numpy inputs from a seed.

The emulation follows the kernel's plan: ``plan_splits`` cuts each row's
context into splits; a (row, head, 32-slot chunk) whose visible run fills
one split writes the output, others write (m, l, acc) partials that are
combined in split order, splits with l = 0 skipped; inside a split the
online softmax walks inner tiles of the instantiated width's size; the
tree mask is ceil(C / 32) uint32 words a slot. Cases: head dims 48 and 80
(masked columns), windows of 17 and 33 slots (one and two chunks; two
mask words), splits past a short row's end (never run), and a split that
holds in-window positions none of which a slot may see (l = 0).
Tolerance: atol = rtol = 1e-5 (fp32, different summation order). The
kernel itself runs only on the card (tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import \
    paged_attention_reference as jax_paged_reference
from paddle_tpu.ops.pallas_kernels import \
    paged_attention_tree_reference as jax_tree_reference
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import paged_attention_tree as pat
from paddle_tpu_torch.serving import tree_topology

TOL = dict(atol=1e-5, rtol=1e-5)
SMS = 132   # the H100's SMs: plan_splits' input


def _inner_tile(Dh):
    """The kernel's inner tile (Geom<DP>::kT) at Dh's instantiated width."""
    dp = -(-Dh // 32) * 32
    return 32 if dp <= 64 else (16 if dp <= 128 else 8)


def _mask_words(anc):
    """[C, ceil(C / 32)] uint32: bit r of word w of slot c is anc[c, 32 w
    + r], as the kernel builds them."""
    C = anc.shape[0]
    words = np.zeros((C, -(-C // 32)), np.uint32)
    for c in range(C):
        for r in np.nonzero(anc[c])[0]:
            words[c, r >> 5] |= np.uint32(1 << (r & 31))
    return words


def split_emulation(k, v, q, tables, positions, anc=None, stats=None):
    """What the kernels compute, by their plan (see the module
    docstring). `stats` (a dict) collects the splits run, the splits
    skipped past a row's end and the (slot, split) partials with l = 0."""
    f32 = np.float32
    B, C, H, Dh = q.shape
    num_pages, bs = k.shape[0], k.shape[1]
    Mb = tables.shape[1]
    scale = f32(Dh ** -0.5)
    splits, split_len = pa.plan_splits(B, H, C, Mb * bs, SMS)
    assert splits * split_len >= Mb * bs and split_len % 64 == 0
    kT = _inner_tile(Dh)
    words = None if anc is None else _mask_words(anc)
    st = stats if stats is not None else {}
    for key in ("run", "past_end", "empty"):
        st.setdefault(key, 0)
    out = np.zeros_like(q)
    pos = np.maximum(positions, 0)
    for b in range(B):
        pos0 = int(pos[b, 0])
        for c0 in range(0, C, 32):
            cs = np.arange(c0, min(C, c0 + 32))
            last = pos0 + C - 1 if anc is not None else int(pos[b, cs].max())
            n_ctx = min(last + 1, Mb * bs)
            n_used = -(-n_ctx // split_len)
            st["past_end"] += (splits - n_used) * H
            for h in range(H):
                parts = []
                for sp in range(n_used):
                    st["run"] += 1
                    m = np.full(len(cs), -np.inf, f32)
                    l = np.zeros(len(cs), f32)
                    acc = np.zeros((len(cs), Dh), f32)
                    t_end = min((sp + 1) * split_len, n_ctx)
                    for t0 in range(sp * split_len, t_end, kT):
                        t = np.arange(t0, min(t0 + kT, t_end))
                        page = np.clip(tables[b, t // bs], 0, num_pages - 1)
                        kt = k[page, t % bs, h]            # [n, Dh]
                        vt = v[page, t % bs, h]
                        s = (q[b, cs, h] @ kt.T) * scale   # [Cc, n]
                        if anc is None:
                            vis = t[None, :] <= pos[b, cs][:, None]
                        else:
                            rel = t[None, :] - pos0
                            inw = (rel >= 0) & (rel < C)
                            w = words[cs][:, np.clip(rel[0], 0, C - 1) >> 5]
                            bit = (w >> (np.clip(rel, 0, C - 1) & 31)) & 1
                            vis = (rel < 0) | (inw & (bit == 1))
                        s = np.where(vis, s, -np.inf).astype(f32)
                        m_new = np.maximum(m, s.max(1))
                        m_use = np.where(m_new == -np.inf, 0, m_new)
                        p = np.exp(s - m_use[:, None]).astype(f32)
                        alpha = np.exp(m - m_use).astype(f32)
                        l = l * alpha + p.sum(1)
                        acc = acc * alpha[:, None] + p @ vt
                        m = m_new
                    st["empty"] += int((l == 0).sum())
                    parts.append((m, l, acc))
                if n_used == 1:
                    m, l, acc = parts[0]
                    out[b, cs, h] = acc / l[:, None]
                    continue
                ms = np.stack([p[0] for p in parts])     # [n_used, Cc]
                ls = np.stack([p[1] for p in parts])
                mx = np.where(ls > 0, ms, -np.inf).max(0)
                o = np.zeros((len(cs), Dh), f32)
                lt = np.zeros(len(cs), f32)
                for sp, (m_s, l_s, acc_s) in enumerate(parts):
                    w = np.where(l_s > 0, np.exp(m_s - mx), 0).astype(f32)
                    lt += l_s * w
                    o += w[:, None] * acc_s
                out[b, cs, h] = o / lt[:, None]
    return out


def _inputs(C, Dh, seed, pos0, bs=16, Mb=8, H=2):
    """Rows whose windows start at `pos0` (one row each): pages scattered
    over the pool, each row's table holding the pages its window reaches
    and null pages after them."""
    B = len(pos0)
    rng = np.random.RandomState(seed)
    pos0 = np.asarray(pos0)
    tables = np.zeros((B, Mb), np.int32)
    perm = rng.permutation(B * Mb) + 1
    for b in range(B):
        n = min((pos0[b] + C - 1) // bs + 1, Mb)
        tables[b, :n] = perm[b * Mb:b * Mb + n]
    positions = (pos0[:, None] + np.arange(C)[None, :]).astype(np.int32)
    k = rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)
    v = rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)
    q = rng.randn(B, C, H, Dh).astype(np.float32)
    return k, v, q, tables, positions


@pytest.mark.parametrize("Dh", [48, 80])
@pytest.mark.parametrize("C", [1, 17, 33])
def test_causal_split_matches_jax(C, Dh):
    """K2's plan: a long row (several splits, combined), a short one
    (one split written directly; the rest past its end never run)."""
    pos0 = [128 - C, 2, 60]
    k, v, q, tables, positions = _inputs(C, Dh, seed=C + Dh, pos0=pos0)
    stats = {}
    got = split_emulation(k, v, q, tables, positions, stats=stats)
    want = np.asarray(jax_paged_reference(*(jnp.asarray(a) for a in (
        k, v, q, tables, positions))))
    plain = pa.paged_attention_reference(*(torch.from_numpy(a) for a in (
        k, v, q, tables, positions))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(plain, want, **TOL)
    assert stats["past_end"] > 0 and stats["run"] > 0


@pytest.mark.parametrize("Dh", [48, 80])
@pytest.mark.parametrize("W,D", [(4, 4), (4, 8), (2, 8)])
def test_tree_split_matches_jax(W, D, Dh):
    """K3's plan at C = 17 and 33 (two mask words a slot, two chunks):
    windows across a split edge, so some slots see nothing of a split
    (l = 0, skipped by the combine), an inactive row (position 0)."""
    C = 1 + W * D
    _, _, anc = tree_topology(W, D)
    pos0 = [64 - C // 2, 0, 128 - C]
    k, v, q, tables, positions = _inputs(C, Dh, seed=W * D + Dh, pos0=pos0)
    tables[1] = 0                       # the inactive row: null table
    stats = {}
    got = split_emulation(k, v, q, tables, positions, anc=anc, stats=stats)
    j_args = [jnp.asarray(a) for a in (k, v, q, tables, positions)]
    want = np.asarray(jax_tree_reference(*j_args, jnp.asarray(anc)))
    plain = pat.paged_attention_tree_reference(
        *(torch.from_numpy(a) for a in (k, v, q, tables, positions)),
        torch.from_numpy(anc)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(plain, want, **TOL)
    assert stats["empty"] > 0 and stats["past_end"] > 0


@pytest.mark.parametrize("B,H,C,ctx", [(32, 8, 1, 512), (8, 8, 7, 512),
                                       (8, 8, 13, 512), (1, 1, 1, 16),
                                       (2, 4, 33, 100), (512, 32, 1, 4096)])
def test_plan_splits_covers_the_context(B, H, C, ctx):
    """Every plan covers the table's positions with whole 64-position
    units, no split wholly past them, at least one split."""
    splits, split_len = pa.plan_splits(B, H, C, ctx, SMS)
    assert splits >= 1 and split_len % 64 == 0
    assert splits * split_len >= ctx > (splits - 1) * split_len
