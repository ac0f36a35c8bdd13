"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu`` (forward
and backward) and their plain PyTorch version.

The port of ``paddle_tpu/ops/pallas_kernels.py`` ``flash_attention``
(:120, forward `_fwd_kernel` :58 through ``pl.pallas_call`` :191;
backward `_flash_bwd_rule` :212), with its layout and numerics:

    q       : [B, H, Tq, Dh]   bf16 or fp32, any strides with a unit
                               last-dim stride (the bthd tensors of the
                               fused attention op are read through them)
    k, v    : [B, H, Tk, Dh]   same dtype
    returns : [B, H, Tq, Dh]   in q's dtype

softmax(q kᵀ · sm_scale) v with fp32 accumulation; `causal` masks keys
after the query's position (Tq == Tk required, as the JAX op's
qualification requires). Grads come back in the inputs' dtype.

``flash_attention`` runs the plain version for CPU tensors, with autograd
supplying its grads; for CUDA tensors it runs the kernels through
``_FlashAttention`` (an autograd Function whose backward is the backward
kernel) or raises — there is no fallback from the card to the plain
version. ``flash_attention_fwd.launches`` and
``flash_attention_bwd.launches`` count the kernel launches.
"""

import ctypes

import torch

from . import _build

__all__ = ["SUPPORTED_HEAD_DIMS", "flash_attention",
           "flash_attention_reference", "flash_attention_fwd",
           "flash_attention_bwd"]

SUPPORTED_HEAD_DIMS = (64,)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q, k, v, causal=True, sm_scale=None):
    """The plain version: fp32 scores, masked fp32 softmax, fp32 product
    with v, output in q's dtype (the JAX `attention_reference`)."""
    Tq, Tk = q.shape[2], k.shape[2]
    if causal and Tq != Tk:
        raise ValueError("causal attention needs Tq == Tk, got %d and %d"
                         % (Tq, Tk))
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention(q, k, v, causal=True, sm_scale=None):
    """Attention over [B, H, T, Dh] (see the module docstring). CPU
    tensors take the plain version; CUDA tensors the kernels."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:  # the kernel reads rows of Dh in order
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.sm_scale)
        return dq, dk, dv, None, None


_fns = {}


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("flash_attention"), name)
        n_ptrs = 5 if name == "ptpu_flash_attention_fwd" else 10
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def load():
    """Build (if needed) and load the kernel library; raises without a
    CUDA device or when the build fails."""
    _kernel("ptpu_flash_attention_fwd")
    _kernel("ptpu_flash_attention_bwd")


def _check(q, k, v, causal, named=()):
    if q.device.type != "cuda":
        raise RuntimeError("the flash_attention kernels take CUDA tensors, "
                           "got q on %s" % q.device)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError("flash_attention kernel takes float32 or bfloat16, "
                        "got %s" % q.dtype)
    for name, t in (("k", k), ("v", v)) + tuple(named):
        if t.device != q.device:
            raise ValueError("%s is on %s, q on %s"
                             % (name, t.device, q.device))
        if t.dtype != q.dtype:
            raise TypeError("%s is %s, q is %s" % (name, t.dtype, q.dtype))
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(named):
        if t.dim() != 4:
            raise ValueError("%s must be [B, H, T, Dh], got shape %s"
                             % (name, tuple(t.shape)))
        if t.stride(-1) != 1:
            raise ValueError("%s must have a unit stride on its last dim, "
                             "got strides %s" % (name, t.stride()))
    B, H, Tq, Dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != Dh:
        raise ValueError("k %s / v %s do not match q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError("head_dim %d not supported (kernel takes %s)"
                         % (Dh, SUPPORTED_HEAD_DIMS))
    if causal and k.shape[2] != Tq:
        raise ValueError("causal attention needs Tq == Tk, got %d and %d"
                         % (Tq, k.shape[2]))
    if not (1 <= B * H <= 2 ** 31 - 1 and 1 <= Tq and 1 <= k.shape[2]):
        raise ValueError("empty or oversized attention %s / %s"
                         % (tuple(q.shape), tuple(k.shape)))


def _strides(*tensors):
    """[B, H, T] element strides of each tensor, as one int64 array."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(name, ptrs, q, k, strides, causal, sm_scale):
    B, H, Tq, Dh = q.shape
    fn = _kernel(name)
    # the C function launches on the runtime's current device
    with torch.cuda.device(q.device):
        err = fn(*ptrs, _DTYPE_CODES[q.dtype], B, H, Tq, k.shape[2], Dh,
                 strides, sm_scale, int(causal),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (name, err))


def flash_attention_fwd(q, k, v, causal, sm_scale):
    """The forward kernel: (o [like q, q's strides], lse [B, H, Tq] fp32,
    the row log-sum-exp of the scaled scores)."""
    _check(q, k, v, causal)
    o = torch.empty_like(q)
    B, H, Tq, _ = q.shape
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    _launch("ptpu_flash_attention_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()),
            q, k, _strides(q, k, v, o), causal, sm_scale)
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal, sm_scale):
    """The backward kernels (a rowsum(dO∘O) pass, a dK/dV pass over kv
    tiles, a dQ pass over q tiles): (dq, dk, dv) in the inputs' dtype,
    each with its input's strides."""
    _check(q, k, v, causal, (("o", o), ("do", do)))
    B, H, Tq, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("o %s / do %s do not match q %s"
                         % (tuple(o.shape), tuple(do.shape),
                            tuple(q.shape)))
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Tq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("lse must be a contiguous fp32 [B, H, Tq] tensor "
                         "on q's device")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty_like(lse)
    _launch("ptpu_flash_attention_bwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k, _strides(q, k, v, o, do, dq, dk, dv), causal, sm_scale)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


# kernel launches since the last reset (the plain CPU route never counts)
flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
