"""paddle_tpu_torch's tree-mask paged attention (K3) held against the JAX
package's ``paged_attention_tree`` (run in interpret mode on the CPU, as
tests/test_serving_spec_tree.py runs it) and its
``paged_attention_tree_reference``, on the same numpy inputs from a seed:
tree shapes 1x3, 2x2, 2x6 and 3x4, block sizes 4 and 16, window bases on
and off block boundaries, null table tails and rows of different
lengths. At width 1 the tree window is the causal window of K2.

The port's plain version and the CPU route of its wrapper are checked
here; the CUDA kernel has no CPU mode and is held against the plain
version on the card by tests/test_torch_kernels_cuda.py. Tolerance:
atol = rtol = 2e-5 (fp32, different summation order; the JAX test's
own)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import paged_attention_tree as jax_tree
from paddle_tpu.ops.pallas_kernels import \
    paged_attention_tree_reference as jax_tree_reference
from paddle_tpu.serving import tree_topology as jax_tree_topology
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import paged_attention_tree as pat
from paddle_tpu_torch.serving import tree_topology

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(W, D, bs, aligned, seed, B=3, H=2, Dh=16):
    """Rows of different lengths: each row's window base pos0 on a block
    boundary (``aligned``) or off it, its table holding just the pages
    its window reaches and null pages after them."""
    C = 1 + W * D
    Mb = -(-(3 * bs + C) // bs)
    rng = np.random.RandomState(seed)
    if aligned:
        pos0 = bs * np.array([1, 2, 3])[:B]
    else:
        pos0 = np.array([1, bs + 3, 2 * bs + bs // 2 + 1])[:B]
    tables = np.zeros((B, Mb), np.int32)
    perm = rng.permutation(B * Mb) + 1
    for b in range(B):
        n = (pos0[b] + C - 1) // bs + 1
        tables[b, :n] = perm[b * Mb:b * Mb + n]
    positions = (pos0[:, None] + np.arange(C)[None, :]).astype(np.int32)
    k = rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)
    v = rng.randn(B * Mb + 1, bs, H, Dh).astype(np.float32)
    q = rng.randn(B, C, H, Dh).astype(np.float32)
    return k, v, q, tables, positions


@pytest.mark.parametrize("aligned", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("W,D", [(1, 3), (2, 2), (2, 6), (3, 4)])
def test_tree_window_matches_jax(W, D, bs, aligned):
    k, v, q, tables, positions = _inputs(W, D, bs, aligned, seed=W * D + bs)
    _p, _d, anc = jax_tree_topology(W, D)
    j_args = [jnp.asarray(a) for a in (k, v, q, tables, positions)]
    want = np.asarray(jax_tree(*j_args, jnp.asarray(anc, jnp.float32)))
    want_ref = np.asarray(jax_tree_reference(*j_args, jnp.asarray(anc)))
    args = [torch.from_numpy(a) for a in (k, v, q, tables, positions)]
    t_anc = torch.from_numpy(tree_topology(W, D)[2])
    launches = pat.paged_attention_tree.launches
    plain = pat.paged_attention_tree_reference(*args, t_anc).numpy()
    wrapped = pat.paged_attention_tree(*args, t_anc).numpy()
    assert pat.paged_attention_tree.launches == launches  # CPU: no kernel
    assert plain.shape == want.shape == q.shape
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_allclose(plain, want_ref, **TOL)
    np.testing.assert_allclose(wrapped, want, **TOL)


@pytest.mark.parametrize("bs", [4, 16])
def test_width_one_is_the_causal_window(bs):
    """At width 1 the ancestor matrix is lower triangular: the plain K3
    equals the plain K2 on the same inputs (a float anc works too)."""
    k, v, q, tables, positions = _inputs(1, 5, bs, aligned=False, seed=bs)
    args = [torch.from_numpy(a) for a in (k, v, q, tables, positions)]
    anc = torch.from_numpy(tree_topology(1, 5)[2])
    lin = pa.paged_attention_reference(*args).numpy()
    for a in (anc, anc.float()):
        np.testing.assert_allclose(
            pat.paged_attention_tree_reference(*args, a).numpy(), lin, **TOL)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel route never takes CPU tensors and never falls back:
    it raises naming the kernel; without a card the build refuses."""
    k, v, q, tables, positions = _inputs(2, 2, 4, aligned=True, seed=0)
    args = [torch.from_numpy(a) for a in (k, v, q, tables, positions)]
    anc = torch.from_numpy(tree_topology(2, 2)[2])
    with pytest.raises(RuntimeError, match="paged_attention_tree kernel "
                                           "takes CUDA tensors"):
        pat._paged_attention_tree_cuda(*args, anc)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pat.load()
