"""Paged attention over a KVBlockPool layer: the CUDA kernel
``csrc/paged_attention.cu`` and its plain PyTorch version.

The port of ``paddle_tpu/ops/pallas_kernels.py`` ``paged_attention``
(the TPU kernel registered as ``paged_decode`` and ``spec_window``),
with the same signature and layout:

    k_pages, v_pages : [num_blocks + 1, block_size, H, Dh] fp32 — one
                       layer of the pool (page 0 is the null page)
    q                : [B, C, H, Dh] fp32 query window (C = 1 to decode)
    block_tables     : [B, Mb] int32 — table slot j holds the page of
                       logical positions [j * bs, (j + 1) * bs)
    positions        : [B, C] int32 — window slot c sees t <= positions
    returns          : [B, C, H, Dh] fp32

``paged_attention`` runs the plain version for tensors on the CPU and
the kernel for tensors on a CUDA device; anything else raises. There is
no fallback from the kernel to the plain version.
"""

import ctypes

import torch

from . import _build

__all__ = ["MAX_WINDOW", "SUPPORTED_HEAD_DIMS", "paged_attention",
           "paged_attention_reference"]

# one kernel instantiation each: every multiple of 32 up to 256
SUPPORTED_HEAD_DIMS = tuple(range(32, 257, 32))
MAX_WINDOW = 16


def paged_attention_reference(k_pages, v_pages, q, block_tables,
                              positions, sm_scale=None):
    """The plain version: gather each row's pages through its block
    table into a contiguous context, then masked softmax attention.
    Positions are clamped at 0 and page ids into the pool, as the
    kernel does."""
    B, C, H, Dh = q.shape
    num_pages, bs = k_pages.shape[0], k_pages.shape[1]
    max_ctx = block_tables.shape[1] * bs
    if sm_scale is None:
        sm_scale = Dh ** -0.5
    tables = block_tables.long().clamp(0, num_pages - 1)
    k_ctx = k_pages[tables].reshape(B, max_ctx, H, Dh)
    v_ctx = v_pages[tables].reshape(B, max_ctx, H, Dh)
    scores = torch.einsum("bchd,bthd->bcht", q, k_ctx) * sm_scale
    t_ids = torch.arange(max_ctx, device=q.device)
    valid = t_ids[None, None, :] <= positions.clamp(min=0)[:, :, None]
    scores = scores.masked_fill(~valid[:, :, None, :], float("-inf"))
    w = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("bcht,bthd->bchd", w, v_ctx)


def paged_attention(k_pages, v_pages, q, block_tables, positions,
                    sm_scale=None):
    """Attention of ``q`` over the paged pool, block tables read inside
    the kernel (see the module docstring for shapes). CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return paged_attention_reference(k_pages, v_pages, q, block_tables,
                                         positions, sm_scale)
    return _paged_attention_cuda(k_pages, v_pages, q, block_tables,
                                 positions, sm_scale)


# kernel launches since the last reset, by window size C (the plain CPU
# route never counts)
paged_attention.window_launches = {}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("paged_attention").ptpu_paged_attention_f32
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def load():
    """Build (if needed) and load the kernel library; raises without a
    CUDA device or when the build fails."""
    _kernel()


def _check(k_pages, v_pages, q, block_tables, positions,
           max_window=MAX_WINDOW, kernel="paged_attention"):
    """What the kernels take (K2 here, K3 with its own ``max_window``):
    raises naming the argument or the limit it breaks."""
    if q.device.type != "cuda":
        raise RuntimeError("the %s kernel takes CUDA tensors, got q on %s"
                           % (kernel, q.device))
    named = (("k_pages", k_pages, torch.float32, 4),
             ("v_pages", v_pages, torch.float32, 4),
             ("q", q, torch.float32, 4),
             ("block_tables", block_tables, torch.int32, 2),
             ("positions", positions, torch.int32, 2))
    for name, t, dtype, ndim in named:
        if t.device != q.device:
            raise ValueError("%s is on %s, q on %s"
                             % (name, t.device, q.device))
        if t.dtype != dtype:
            raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
        if t.dim() != ndim:
            raise ValueError("%s must be %d-D, got shape %s"
                             % (name, ndim, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if name == "v_pages" and t.data_ptr() % 16:  # 16-byte V loads
            raise ValueError("%s must start on a 16-byte boundary" % name)
    B, C, H, Dh = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (H, Dh):
        raise ValueError("pages %s / %s do not match q %s"
                         % (tuple(k_pages.shape), tuple(v_pages.shape),
                            tuple(q.shape)))
    if block_tables.shape[0] != B or tuple(positions.shape) != (B, C):
        raise ValueError("block_tables %s / positions %s do not match q %s"
                         % (tuple(block_tables.shape),
                            tuple(positions.shape), tuple(q.shape)))
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError("head_dim %d not supported (kernel takes %s)"
                         % (Dh, SUPPORTED_HEAD_DIMS))
    if not 1 <= C <= max_window:
        raise ValueError("window C=%d not supported by %s (1 <= C <= %d)"
                         % (C, kernel, max_window))
    if not 1 <= B <= 65535:
        raise ValueError("batch %d not supported (1..65535)" % B)


def _paged_attention_cuda(k_pages, v_pages, q, block_tables, positions,
                          sm_scale=None):
    _check(k_pages, v_pages, q, block_tables, positions)
    B, C, H, Dh = q.shape
    if sm_scale is None:
        sm_scale = Dh ** -0.5
    fn = _kernel()
    out = torch.empty_like(q)
    # the C function launches on the runtime's current device: make it
    # the tensors' device for the call
    with torch.cuda.device(q.device):
        err = fn(k_pages.data_ptr(), v_pages.data_ptr(), q.data_ptr(),
                 block_tables.data_ptr(), positions.data_ptr(),
                 out.data_ptr(), B, C, H, Dh, k_pages.shape[1],
                 block_tables.shape[1], k_pages.shape[0], sm_scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("paged_attention kernel launch failed: CUDA "
                           "error %d" % err)
    by_c = paged_attention.window_launches
    by_c[C] = by_c.get(C, 0) + 1
    return out
