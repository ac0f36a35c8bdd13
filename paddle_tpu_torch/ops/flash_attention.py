"""Flash attention: the CUDA kernels (forward and backward) and their
plain PyTorch version.

The port of ``paddle_tpu/ops/pallas_kernels.py`` ``flash_attention``
(:120, forward `_fwd_kernel` :58 through ``pl.pallas_call`` :191;
backward `_flash_bwd_rule` :212), with its layout and numerics:

    q       : [B, H, Tq, Dh]   bf16, fp16 or fp32, any strides with a unit
                               last-dim stride (the bthd tensors of the
                               fused attention op are read through them)
    k, v    : [B, H, Tk, Dh]   same dtype
    returns : [B, H, Tq, Dh]   in q's dtype

softmax(q kᵀ · sm_scale) v with fp32 accumulation; `causal` masks keys
after the query's position (Tq == Tk required, as the JAX op's
qualification requires). Grads come back in the inputs' dtype.

Each call takes one route, decided by ``kernel_route`` from the device,
the dtype and the pass alone; the route names the kernel that ran:

    "plain"  CPU tensors: the plain version, autograd supplying its grads
    "tc"     bf16 CUDA tensors, forward and backward:
             ``csrc/flash_attention_tc.cu``, mma.sync on the tensor cores,
             P and dS rounded to bf16 before the second product
    "fp16"   fp16 CUDA tensors, forward and backward: the same source's
             kernels instantiated for fp16 (mma.sync m16n8k16 f16), P and
             dS rounded to fp16
    "f32tc"  fp32 CUDA tensors, forward and backward:
             ``csrc/flash_attention_f32tc.cu`` and
             ``csrc/flash_attention_f32tc_bwd.cu``, 3xTF32 mma.sync on the
             tensor cores (fp32 accuracy)

Anything else raises; no route gives way to another. The tensor-core
kernels copy rows 16 bytes at a time: a tensor they read whose base
address or whose B, H, T strides are not multiples of 16 bytes is first
copied to a contiguous tensor (``tc_operand``), and the copy is counted.

Every route runs any head dim. Its kernels are instantiated for head
dims 64, 128 and 256 (``SUPPORTED_HEAD_DIMS``; the fp32 backward runs 256
in parts, as it runs the wider ones), and above 256 for any multiple of
``PART_WIDTH``: a block then accumulates one ``PART_WIDTH``-column part
of its outputs and streams the head dim through its tiles in chunks of
that width to form the scores, so every part recomputes them (the
products of S and dP grow with Dh / ``PART_WIDTH``). Any other head dim runs at the width
``kernel_head_dim`` gives: q, k and v (and in the backward o and dO) are
zero-padded on their last dim, each pad a counted copy, and the results
sliced back. Zero columns leave Q Kᵀ unchanged and give zero columns of
O and of the grads; sm_scale stays the caller's (by default the true head
dim's ``Dh ** -0.5``).

While a step's FLOPs are counted (``observability/cost.py``), each
launch adds its products: 4·B·H·Tq·Tk·Dh forward, 8·B·H·Tq·Tk·Dh
backward, the plain version's (whose own aten products count on the
CPU).

``flash_attention_fwd`` and ``flash_attention_bwd`` count their launches
(``.launches``, and ``.launches_by_route`` split into "tc", "fp16" and
"f32tc")
and the copies they made (``.copies``); ``reset_counts()``
zeroes all.
"""

import ctypes

import torch

from ..observability import cost as _cost
from . import _build

__all__ = ["PART_WIDTH", "SUPPORTED_HEAD_DIMS", "flash_attention",
           "flash_attention_reference", "flash_attention_fwd",
           "flash_attention_bwd", "kernel_head_dim", "kernel_route",
           "tc_aligned", "tc_operand", "reset_counts", "load"]

SUPPORTED_HEAD_DIMS = (64, 128, 256)   # the kernels' instantiations
PART_WIDTH = 128   # the output columns a block takes above 256
_ROUTES = ("tc", "fp16", "f32tc")


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


def kernel_route(device_type, dtype, backward=False):
    """The route of a call on tensors of `device_type` and `dtype`, for
    the forward or the `backward` pass: "plain" on the CPU (any dtype);
    on CUDA "tc" for bf16, "fp16" for fp16 and "f32tc" for fp32, both
    ways. Raises for any other device (RuntimeError) or CUDA dtype
    (TypeError)."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise RuntimeError("the flash_attention kernels take CUDA tensors, "
                           "got q on %s" % device_type)
    if dtype == torch.bfloat16:
        return "tc"
    if dtype == torch.float16:
        return "fp16"
    if dtype == torch.float32:
        return "f32tc"
    raise TypeError("flash_attention kernels take bfloat16, float16 or "
                    "float32, got %s" % dtype)


def kernel_head_dim(Dh):
    """The head dim the kernels run a call of head dim `Dh` at: the
    smallest of ``SUPPORTED_HEAD_DIMS`` that is at least Dh, and above
    the largest Dh rounded up to a multiple of ``PART_WIDTH`` (Dh itself
    when it is one; otherwise the operands are zero-padded to it)."""
    for d in SUPPORTED_HEAD_DIMS:
        if Dh <= d:
            return d
    return -(-Dh // PART_WIDTH) * PART_WIDTH


def tc_aligned(ptr, shape, strides, elem_size):
    """Whether the tensor-core kernels (bf16 and fp32) can read a [B, H,
    T, Dh] tensor in place: a unit last-dim stride, and the base address
    and the B, H, T strides of its dims longer than 1 multiples of 16
    bytes."""
    return (strides[-1] == 1 and ptr % 16 == 0
            and all(n == 1 or s * elem_size % 16 == 0
                    for n, s in zip(shape[:3], strides[:3])))


def tc_operand(t):
    """(t, False) when the tensor-core kernels can read t in place, else
    (a contiguous copy in a fresh allocation, True)."""
    if tc_aligned(t.data_ptr(), t.shape, t.stride(), t.element_size()):
        return t, False
    return t.clone(memory_format=torch.contiguous_format), True


def flash_attention(q, k, v, causal=True, sm_scale=None):
    """Attention over [B, H, T, Dh] (see the module docstring). CPU
    tensors take the plain version; CUDA tensors the kernels."""
    if kernel_route(q.device.type, q.dtype) == "plain":
        return flash_attention_reference(q, k, v, causal, sm_scale)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        # no graph to record (a recompute segment's first forward): the
        # kernel alone, keeping no residuals for a backward
        return flash_attention_fwd(q, k, v, bool(causal), float(sm_scale))[0]
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        Dh = q.shape[-1]
        # q, k, v as the kernel read them (padded, copied) and o unsliced,
        # so that the backward pads only dO
        o, lse, (q, k, v) = _fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale, ctx.dh = causal, sm_scale, Dh
        return o if o.shape[-1] == Dh else o[..., :Dh]

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.shape[-1] != o.shape[-1]:
            do, = _pad_head(flash_attention_bwd, o.shape[-1], do)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.sm_scale)
        Dh = ctx.dh
        return dq[..., :Dh], dk[..., :Dh], dv[..., :Dh], None, None


# C entry points: (library, pointer args)
_ENTRY = {"ptpu_flash_attention_f32tc_fwd": ("flash_attention_f32tc", 5),
          "ptpu_flash_attention_f32tc_bwd": ("flash_attention_f32tc_bwd",
                                             10),
          "ptpu_flash_attention_tc_fwd": ("flash_attention_tc", 5),
          "ptpu_flash_attention_tc_bwd": ("flash_attention_tc", 10),
          "ptpu_flash_attention_fp16_fwd": ("flash_attention_tc", 5),
          "ptpu_flash_attention_fp16_bwd": ("flash_attention_tc", 10)}
_fns = {}


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        lib, n_ptrs = _ENTRY[name]
        fn = getattr(_build.load(lib), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def load():
    """Build (if needed) and load the kernel libraries; raises without a
    CUDA device or when a build fails."""
    for name in _ENTRY:
        _kernel(name)


def _check(q, k, v, causal, named=(), backward=False):
    """(route, the head dim the kernels run at) of a kernel call, after
    checking what the kernels take."""
    route = kernel_route(q.device.type, q.dtype, backward)
    if route == "plain":
        raise RuntimeError("the flash_attention kernels take CUDA tensors, "
                           "got q on %s" % q.device)
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
    Dp = kernel_head_dim(Dh)
    if causal and k.shape[2] != Tq:
        raise ValueError("causal attention needs Tq == Tk, got %d and %d"
                         % (Tq, k.shape[2]))
    if not (1 <= B * H <= 2 ** 31 - 1 and 1 <= Tq and 1 <= k.shape[2]
            and max(Tq, k.shape[2]) <= 64 * 65535 and 1 <= Dh):
        raise ValueError("empty or oversized attention %s / %s"
                         % (tuple(q.shape), tuple(k.shape)))
    return route, Dp


def _pad_head(counter, Dp, *tensors):
    """The tensors zero-padded on their last dim to Dp (fresh contiguous
    tensors), each pad counted on `counter` as a copy."""
    out = []
    for t in tensors:
        out.append(torch.nn.functional.pad(t, (0, Dp - t.shape[-1])))
        counter.copies += 1
    return out


def _tc_operands(counter, *tensors):
    """The tensors as the tensor-core kernels can read them, each copy
    counted on `counter`."""
    out = []
    for t in tensors:
        t, copied = tc_operand(t)
        counter.copies += copied
        out.append(t)
    return out


def _strides(*tensors):
    """[B, H, T] element strides of each tensor, as one int64 array."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(name, ptrs, q, k, strides, causal, sm_scale):
    B, H, Tq, Dh = q.shape
    fn = _kernel(name)
    # the C function launches on the runtime's current device
    with torch.cuda.device(q.device):
        err = fn(*ptrs, B, H, Tq, k.shape[2], Dh, strides, sm_scale,
                 int(causal),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (name, err))


def _count(counter, route):
    counter.launches += 1
    counter.launches_by_route[route] += 1


def _fwd(q, k, v, causal, sm_scale):
    """The forward kernel of q's route: (o, lse, the q, k, v it read), o
    and those at the kernels' head dim."""
    route, Dp = _check(q, k, v, causal)
    B, H, Tq, Dh = q.shape
    _cost.kernel_flops(4 * B * H * Tq * k.shape[2] * Dh)
    if Dp != Dh:
        q, k, v = _pad_head(flash_attention_fwd, Dp, q, k, v)
    q, k, v = _tc_operands(flash_attention_fwd, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr())
    _launch("ptpu_flash_attention_%s_fwd" % route, ptrs, q, k,
            _strides(q, k, v, o), causal, sm_scale)
    _count(flash_attention_fwd, route)
    return o, lse, (q, k, v)


def flash_attention_fwd(q, k, v, causal, sm_scale):
    """The forward kernel of q's route: (o [like q, q's strides unless
    the tc route copied q or the head dim was padded], lse [B, H, Tq]
    fp32, the row log-sum-exp of the scaled scores)."""
    o, lse, _ = _fwd(q, k, v, causal, sm_scale)
    return o[..., :q.shape[-1]], lse


def flash_attention_bwd(q, k, v, o, lse, do, causal, sm_scale):
    """The backward kernels of q's route (a rowsum(dO∘O) pass, a dK/dV
    pass over kv tiles, a dQ pass over q tiles): (dq, dk, dv) in the
    inputs' dtype, each with its input's strides (or its copy's, or a
    slice of the padded grad's)."""
    if do.stride(-1) != 1:  # the kernels read rows of Dh in order
        do = do.contiguous()
        flash_attention_bwd.copies += 1
    route, Dp = _check(q, k, v, causal, (("o", o), ("do", do)),
                       backward=True)
    Dh = q.shape[-1]
    B, H, Tq, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("o %s / do %s do not match q %s"
                         % (tuple(o.shape), tuple(do.shape),
                            tuple(q.shape)))
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Tq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("lse must be a contiguous fp32 [B, H, Tq] tensor "
                         "on q's device")
    _cost.kernel_flops(8 * B * H * Tq * k.shape[2] * Dh)
    if Dp != Dh:
        q, k, v, o, do = _pad_head(flash_attention_bwd, Dp, q, k, v, o, do)
    q, k, v, o, do = _tc_operands(flash_attention_bwd, q, k, v, o, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty_like(lse)
    _launch("ptpu_flash_attention_%s_bwd" % route,
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k, _strides(q, k, v, o, do, dq, dk, dv), causal, sm_scale)
    _count(flash_attention_bwd, route)
    return dq[..., :Dh], dk[..., :Dh], dv[..., :Dh]


def reset_counts():
    """Zero the launch and copy counts of both wrappers (the plain CPU
    route never counts)."""
    for counter in (flash_attention_fwd, flash_attention_bwd):
        counter.launches = 0
        counter.launches_by_route = dict.fromkeys(_ROUTES, 0)
        counter.copies = 0


reset_counts()
