"""paddle_tpu_torch paged attention held against the JAX package's
``paged_attention`` (run in interpret mode on the CPU, as
tests/test_pallas.py runs it), on the same numpy inputs from a seed:
the block-table edge cases (scattered pages, a partially filled last
page, null tails, a post-truncate table) and a C=3 window.

The port's plain version and the CPU route of its wrapper are checked
here; the CUDA kernel has no CPU mode and is held against the plain
version on the card by tests/test_torch_kernels_cuda.py. Tolerance:
atol = rtol = 1e-5 (fp32, different summation order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import paged_attention as jax_paged
from paddle_tpu.serving.kv_cache import KVBlockPool as JaxKVBlockPool
from paddle_tpu_torch.ops import paged_attention as pa


def _pages(seed, NB=8, bs=4, H=2, Dh=16):
    rng = np.random.RandomState(seed)
    k = rng.randn(NB + 1, bs, H, Dh).astype(np.float32)
    v = rng.randn(NB + 1, bs, H, Dh).astype(np.float32)
    return rng, k, v


def _hold(k, v, q, table, pos):
    """JAX kernel vs the port's plain version and CPU wrapper route."""
    table = np.asarray(table, np.int32)
    pos = np.asarray(pos, np.int32)
    want = np.asarray(jax_paged(jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(q), jnp.asarray(table),
                                jnp.asarray(pos)))
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in (k, v, q, table, pos)]
    launches = dict(pa.paged_attention.window_launches)
    plain = pa.paged_attention_reference(*args).numpy()
    wrapped = pa.paged_attention(*args).numpy()
    # CPU route: no kernel
    assert pa.paged_attention.window_launches == launches
    assert plain.shape == want.shape == q.shape
    np.testing.assert_allclose(plain, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(wrapped, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("table,positions", [
    # full tables, scattered non-monotone physical pages
    ([[5, 2, 7, 3], [1, 4, 6, 8]], [[15], [9]]),
    # partially filled last page (position mid-page)
    ([[5, 2, 7, 0], [3, 0, 0, 0]], [[9], [2]]),
    # unallocated tail slots hold the null page (id 0)
    ([[6, 0, 0, 0], [2, 8, 0, 0]], [[1], [4]]),
])
def test_paged_decode_matches_jax(table, positions):
    rng, k, v = _pages(seed=0)
    q = rng.randn(2, 1, 2, 16).astype(np.float32)
    _hold(k, v, q, table, positions)


def test_spec_window_c3_matches_jax():
    """A C=3 window: each slot masked to its own causal prefix."""
    rng, k, v = _pages(seed=3)
    q = rng.randn(2, 3, 2, 16).astype(np.float32)
    _hold(k, v, q, [[5, 2, 7, 3], [4, 1, 0, 0]], [[7, 8, 9], [0, 1, 2]])


def test_post_truncate_table_matches_jax():
    """A block table after the JAX pool's speculative rollback
    (truncate_owner): the kept prefix, then null pages."""
    pool = JaxKVBlockPool(n_layers=1, n_heads=2, head_dim=16, block_size=4,
                          num_blocks=8)
    assert pool.reserve("s", 3)
    for _ in range(3):
        pool.alloc_block("s")
    pool.truncate_owner("s", 1)
    kept = pool.block_table("s")
    table = np.full((1, 4), JaxKVBlockPool.NULL_BLOCK, np.int32)
    table[0, :len(kept)] = kept
    rng, k, v = _pages(seed=5)
    q = rng.randn(1, 1, 2, 16).astype(np.float32)
    _hold(k, v, q, table, [[3]])
