"""The fused int8 matmul: the CUDA kernel ``csrc/int8_matmul.cu`` (K4)
and its plain PyTorch version.

The port of ``paddle_tpu/ops/pallas_kernels.py`` ``int8_matmul`` (:598,
the TPU kernel registered as ``int8_matmul``), with the same signature:

    x         : [..., K] fp32 activation; the leading dims are the M rows
    w_int8    : [K, N] int8 weight
    dq_scale  : [N] fp32 combined per-output-channel dequantize scale
                ((w_scales / 127) * (s_act / 127))
    act_scale : the activation quantize scale (127 / s_act), a float
    returns   : [..., N] fp32 =
                float(clip(round_half_even(x * act_scale), -128, 127)
                      @ w_int8, accumulated in int32) * dq_scale

act_scale is rounded to fp32 once, and x * act_scale is one fp32
multiply, as in the JAX kernel (a weakly typed Python float there). The
int32 sum is exact for K < 2^17 and the final multiply is IEEE, so the
kernel, the plain version and the JAX package's kernel and reference are
bitwise equal on finite inputs (+-inf saturate to 127 / -128).

``int8_matmul`` runs the plain version for tensors on the CPU and the
kernel for tensors on a CUDA device; anything else raises. There is no
fallback from the kernel to the plain version. While a step's FLOPs are
counted (``observability/cost.py``), a launch adds 2·M·N·K, the plain
version's product (which its own mm counts on the CPU).
"""

import ctypes

import numpy as np
import torch

from ..observability import cost as _cost
from . import _build

__all__ = ["MAX_K", "int8_matmul", "int8_matmul_reference", "padded_k"]

MAX_K = (1 << 17) - 1   # 128 * 128 * K stays below 2^31
BLOCK_M = 128           # output rows a block of the product
BLOCK_K = 128           # k a stage of the product: K is padded to it


def padded_k(K):
    """The width of the kernel's quantized x and transposed w: K rounded
    up to a multiple of ``BLOCK_K`` (the zeros past K add nothing)."""
    return -(-K // BLOCK_K) * BLOCK_K


def _act_scale_f32(act_scale):
    return float(np.float32(act_scale))


def int8_matmul_reference(x, w_int8, dq_scale, act_scale):
    """The plain version: the same quantize in torch, the product exact
    in int32 (on a card, where there is no int32 product, a float64 one,
    exact since |acc| < 2^31 < 2^53, taken back to int32 so that a zero
    sum is +0 as in integers), then one fp32 multiply."""
    K, N = w_int8.shape
    s = _act_scale_f32(act_scale)
    qa = torch.clamp(torch.round(x.reshape(-1, K) * s), -128,
                     127).to(torch.int8)
    if x.device.type == "cpu":
        acc = qa.to(torch.int32) @ w_int8.to(torch.int32)
    else:
        acc = (qa.to(torch.float64) @ w_int8.to(torch.float64)).to(
            torch.int32)
    out = acc.to(torch.float32) * dq_scale.to(torch.float32)
    return out.reshape(tuple(x.shape[:-1]) + (N,))


def int8_matmul(x, w_int8, dq_scale, act_scale):
    """``dequant(quant(x) @ w_int8)`` (see the module docstring). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_int8, dq_scale, act_scale)
    return _int8_matmul_cuda(x, w_int8, dq_scale, act_scale)


# kernel launches since the last reset, by (M, K, N): one a call, which
# runs the kernel's two passes (quantize x and transpose w, then the
# product); the plain CPU route never counts
int8_matmul.launches = {}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("int8_matmul").ptpu_int8_matmul
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * 3
                       + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def load():
    """Build (if needed) and load the kernel library; raises without a
    CUDA device or when the build fails."""
    _kernel()


def _rows(x):
    """(x, T, s0, s1): x with at most two leading dims, whose row m
    starts at element (m // T) * s0 + (m % T) * s1. A view where the
    strides allow it (the lm_head's sliced input is one), a copy
    otherwise."""
    if x.stride(-1) != 1:
        x = x.contiguous()
    if x.dim() > 3:
        x = x.reshape(-1, x.shape[-1])
    if x.dim() == 2:
        return x, max(x.shape[0], 1), 0, x.stride(0)
    return x, max(x.shape[1], 1), x.stride(0), x.stride(1)


def _int8_matmul_cuda(x, w_int8, dq_scale, act_scale):
    if x.device.type != "cuda":
        raise RuntimeError("the int8_matmul kernel takes CUDA tensors, got "
                           "x on %s" % x.device)
    for name, t, dtype in (("x", x, torch.float32),
                           ("w_int8", w_int8, torch.int8),
                           ("dq_scale", dq_scale, torch.float32)):
        if t.device != x.device:
            raise ValueError("%s is on %s, x on %s"
                             % (name, t.device, x.device))
        if t.dtype != dtype:
            raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if x.dim() < 2 or w_int8.dim() != 2:
        raise ValueError("x must be [..., K] and w_int8 [K, N], got %s and "
                         "%s" % (tuple(x.shape), tuple(w_int8.shape)))
    K, N = w_int8.shape
    if x.shape[-1] != K or tuple(dq_scale.shape) != (N,):
        raise ValueError("x %s, w_int8 %s and dq_scale %s do not match"
                         % (tuple(x.shape), tuple(w_int8.shape),
                            tuple(dq_scale.shape)))
    if K > MAX_K:
        raise ValueError("K=%d: the int32 sum is exact only for K <= %d"
                         % (K, MAX_K))
    if not w_int8.is_contiguous() or not dq_scale.is_contiguous():
        raise ValueError("w_int8 and dq_scale must be contiguous")
    lead = tuple(x.shape[:-1])
    M = int(np.prod(lead))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out.reshape(lead + (N,))
    if -(-M // BLOCK_M) > 65535:
        raise ValueError("M=%d rows: at most %d" % (M, 65535 * BLOCK_M))
    xr, T, s0, s1 = _rows(x)
    fn = _kernel()
    # scratch of the prep pass: x quantized [M, Kp], w transposed [N, Kp]
    Kp = padded_k(K)
    xq = torch.empty((M, Kp), dtype=torch.int8, device=x.device)
    wt = torch.empty((N, Kp), dtype=torch.int8, device=x.device)
    # the C function launches on the runtime's current device: make it
    # the tensors' device for the call
    with torch.cuda.device(x.device):
        err = fn(xr.data_ptr(), T, s0, s1, w_int8.data_ptr(),
                 dq_scale.data_ptr(), out.data_ptr(), xq.data_ptr(),
                 wt.data_ptr(), M, K, N, Kp, _act_scale_f32(act_scale),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("int8_matmul kernel launch failed: CUDA error %d"
                           % err)
    _cost.kernel_flops(2 * M * N * K)
    key = (M, K, N)
    int8_matmul.launches[key] = int8_matmul.launches.get(key, 0) + 1
    return out.reshape(lead + (N,))
