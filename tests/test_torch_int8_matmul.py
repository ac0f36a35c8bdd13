"""The fused int8 matmul (K4) of the PyTorch port held BITWISE against
the JAX package (the ROADMAP's contract for this kernel): the port's
plain version (what its wrapper runs for CPU tensors) against the JAX
package's Pallas ``int8_matmul`` in interpret mode (``PTPU_KERNELS=1``,
as ``tests/test_pallas.py`` runs it) and its ``int8_matmul_reference``,
on the same numpy inputs; and the ``fused_int8_matmul`` op of both
packages in its ``mul`` form. The CUDA kernel itself is held against the
plain version on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops import registry as j_registry

from paddle_tpu_torch.ops import int8_matmul as im
from paddle_tpu_torch.ops import registry as p_registry


@pytest.fixture(autouse=True)
def _kernels_on(monkeypatch):
    monkeypatch.setenv("PTPU_KERNELS", "1")


def _inputs(M, K, N, seed, act_range=3.0):
    """x ~ N(0, 1) with a few elements past the int8 range, w over the
    whole int8 range (-128 included), a positive per-channel dq vector,
    act_scale = 127 / act_range as quant_rewrite sets it."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = rng.randint(-128, 128, size=(K, N)).astype(np.int8)
    w.flat[::7] = -128
    dq = ((rng.rand(N).astype(np.float32) + 0.1) / 127.0
          * np.float32(act_range / 127.0)).astype(np.float32)
    return x, w, dq, 127.0 / act_range


def _jax_both(x, w, dq, act_scale):
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(dq), act_scale)
    return (np.asarray(pk.int8_matmul(*args)),
            np.asarray(pk.int8_matmul_reference(*args)))


def _port(x, w, dq, act_scale):
    out = im.int8_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(dq), act_scale)
    assert out.dtype == torch.float32
    return out.numpy()


def _assert_bitwise(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    # bit patterns, so a -0.0 against a +0.0 counts as a difference
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
        "max |diff| %g" % np.abs(got - want).max())


@pytest.mark.parametrize("M,K,N", [(5, 96, 70), (32, 128, 128), (1, 7, 3),
                                   (3, 2048, 32000)])
def test_plain_version_is_bitwise_the_jax_kernel(M, K, N):
    """test_pallas.py's shapes, and K = 2048 (the FFN's second layer) with
    N = 32000 (the lm_head) at small M."""
    x, w, dq, s = _inputs(M, K, N, seed=M + K + N)
    kernel, reference = _jax_both(x, w, dq, s)
    got = _port(x, w, dq, s)
    _assert_bitwise(got, kernel)
    _assert_bitwise(got, reference)
    assert im.int8_matmul.launches == {}  # CPU tensors launch nothing


def test_ties_round_half_to_even():
    """x * act_scale lands exactly on k + 0.5 (act_scale 2, x = k/2 +
    1/4, both exact in fp32): each tie rounds to the even neighbour."""
    k = np.arange(-20, 20, dtype=np.float32)
    x = (k / 2 + np.float32(0.25)).reshape(4, 10)
    w = np.eye(10, dtype=np.int8)
    dq = np.ones(10, np.float32)
    kernel, reference = _jax_both(x, w, dq, 2.0)
    got = _port(x, w, dq, 2.0)
    _assert_bitwise(got, kernel)
    _assert_bitwise(got, reference)
    np.testing.assert_array_equal(got.ravel(), np.round(k + 0.5))
    assert (np.abs(got.ravel() % 2) == 0).all()  # every tie went even


def test_saturation_and_infinities():
    """Values past +-127.5 clamp to 127 / -128 (the ties at 127.5 and
    -128.5 round to 128 and -128 first), and +-inf saturate the same
    way; w holds -128 too."""
    vals = np.array([127.49, 127.5, 127.51, 300.0, 1e30, np.inf,
                     -127.5, -128.49, -128.5, -128.51, -300.0, -np.inf],
                    np.float32)
    x = np.stack([vals, vals[::-1]])
    w = np.zeros((12, 3), np.int8)
    w[np.arange(12), np.arange(12) % 3] = [1, -128, 127, -1, 2, -128,
                                           1, -128, 127, -1, 2, -128]
    dq = np.array([1.0, 0.5, 0.25], np.float32)
    kernel, reference = _jax_both(x, w, dq, 1.0)
    got = _port(x, w, dq, 1.0)
    _assert_bitwise(got, kernel)
    _assert_bitwise(got, reference)
    q = np.clip(np.round(vals), -128, 127)
    assert np.isfinite(got).all() and q.min() == -128 and q.max() == 127


def test_act_scale_is_rounded_to_fp32_once():
    """An act_scale that is not an fp32 number: the JAX kernel multiplies
    by its fp32 rounding, and so does the port."""
    x, w, dq, _ = _inputs(16, 64, 24, seed=3)
    s = 127.0 / 2.9137
    assert float(np.float32(s)) != s
    kernel, reference = _jax_both(x, w, dq, s)
    _assert_bitwise(_port(x, w, dq, s), kernel)
    _assert_bitwise(_port(x, w, dq, s), reference)


@pytest.mark.parametrize("strided", [False, True])
def test_fused_op_mul_form_matches_the_jax_op(strided):
    """The ``fused_int8_matmul`` op with mul's attrs on a 3-D x (the
    LM's FFN and lm_head layers): the port's op, given x as is or as a
    slice view along the sequence (the lm_head's input), bitwise the
    JAX op through its Pallas kernel."""
    B, T, K, N = 2, 24, 40, 36
    rng = np.random.RandomState(7)
    full = rng.randn(B, 2 * T, K).astype(np.float32)
    x = full[:, T:]
    _, w, dq, s = _inputs(B * T, K, N, seed=8)
    attrs = {"act_scale": s, "__quant__": True, "x_num_col_dims": 2,
             "y_num_col_dims": 1}
    j_out = j_registry.get("fused_int8_matmul").impl(
        None, {"X": [jnp.asarray(np.ascontiguousarray(x))],
               "Y": [jnp.asarray(w)], "Scale": [jnp.asarray(dq)]}, attrs)
    px = torch.from_numpy(full)[:, T:] if strided \
        else torch.from_numpy(np.ascontiguousarray(x))
    assert px.is_contiguous() != strided
    p_out = p_registry.get("fused_int8_matmul").impl(
        None, {"X": [px], "Y": [torch.from_numpy(w)],
               "Scale": [torch.from_numpy(dq)]}, attrs)
    got, want = p_out["Out"][0].numpy(), np.asarray(j_out["Out"][0])
    assert got.shape == (B, T, N)
    _assert_bitwise(got, want)


def test_mul_int8_branch_matches_the_jax_op():
    """mul's ``__quant_int8__`` branch (the unfused chain's product): int8
    operands, an exact int32 result, as the JAX op's."""
    rng = np.random.RandomState(9)
    x = rng.randint(-128, 128, size=(3, 5, 33)).astype(np.int8)
    w = rng.randint(-128, 128, size=(33, 17)).astype(np.int8)
    attrs = {"x_num_col_dims": 2, "y_num_col_dims": 1,
             "__quant_int8__": True}
    j_out = j_registry.get("mul").impl(
        None, {"X": [jnp.asarray(x)], "Y": [jnp.asarray(w)]}, attrs)
    p_out = p_registry.get("mul").impl(
        None, {"X": [torch.from_numpy(x)], "Y": [torch.from_numpy(w)]},
        attrs)
    got, want = p_out["Out"][0].numpy(), np.asarray(j_out["Out"][0])
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_padded_k_is_the_next_stage_multiple():
    """The kernel's quantized x and transposed w are K wide rounded up to
    its 128-k stage (zeros past K add nothing to the int32 sums): the
    narrowest multiple of 128 at least K, 0 for K 0."""
    for K in (0, 1, 31, 32, 33, 127, 128, 129, 512, 2048, im.MAX_K):
        Kp = im.padded_k(K)
        assert Kp % im.BLOCK_K == 0 and K <= Kp < K + im.BLOCK_K, K
