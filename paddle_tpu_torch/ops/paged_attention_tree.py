"""Tree-mask paged attention (the speculative tree verify window) over a
KVBlockPool layer: the CUDA kernel ``csrc/paged_attention_tree.cu`` and
its plain PyTorch version.

The port of ``paddle_tpu/ops/pallas_kernels.py`` ``paged_attention_tree``
(the TPU kernel registered as ``spec_window_tree``), with the same
signature and layout:

    k_pages, v_pages : [num_blocks + 1, block_size, H, Dh] fp32 — one
                       layer of the pool (page 0 is the null page)
    q                : [B, C, H, Dh] fp32 query window, a level-order
                       token tree (``serving.model.tree_topology``)
    block_tables     : [B, Mb] int32
    positions        : [B, C] int32 — the cache position of each window
                       slot, ``pos0 + c``; only ``positions[:, 0]`` is read
    anc              : [C, C] — ``anc[c, r]`` true iff window slot r is c
                       or an ancestor of c (bool for the kernel)
    returns          : [B, C, H, Dh] fp32

A key at logical position t is visible to slot c iff ``t < pos0`` (the
committed prefix, strict) or ``0 <= t - pos0 < C`` and
``anc[c, t - pos0]``. With the linear chain's ancestor matrix (lower
triangular) this is the causal window of ``paged_attention``.

``paged_attention_tree`` runs the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device; anything else raises. There
is no fallback from the kernel to the plain version. The kernel takes
any head dim up to 256 and windows up to ``MAX_TREE_WINDOW`` slots, and
splits the context across blocks as K2 does (one call, one launch, one
count in ``.launches``). A counted step's FLOPs take K2's formula, a
row attending pos0 + C keys (``paged_attention.count_window_flops``).
"""

import ctypes

import torch

from ..observability import cost as _cost
from . import _build
from .paged_attention import (_check, _count_lock, count_window_flops,
                              launch_split)

__all__ = ["MAX_TREE_WINDOW", "paged_attention_tree",
           "paged_attention_tree_reference"]

# the kernel keeps ceil(C / 32) uint32 ancestor words for each of a
# block's 32 slots in shared memory: 32 KB at this window
MAX_TREE_WINDOW = 8192


def paged_attention_tree_reference(k_pages, v_pages, q, block_tables,
                                   positions, anc, sm_scale=None):
    """The plain version: gather each row's pages through its block
    table into a contiguous context, then tree-masked softmax attention.
    pos0 is clamped at 0 and page ids into the pool, as the kernel
    does."""
    B, C, H, Dh = q.shape
    num_pages, bs = k_pages.shape[0], k_pages.shape[1]
    max_ctx = block_tables.shape[1] * bs
    if sm_scale is None:
        sm_scale = Dh ** -0.5
    tables = block_tables.long().clamp(0, num_pages - 1)
    k_ctx = k_pages[tables].reshape(B, max_ctx, H, Dh)
    v_ctx = v_pages[tables].reshape(B, max_ctx, H, Dh)
    scores = torch.einsum("bchd,bthd->bcht", q, k_ctx) * sm_scale
    pos0 = positions[:, 0].long().clamp(min=0)
    rel = (torch.arange(max_ctx, device=q.device)[None, None, :]
           - pos0[:, None, None])                        # [B, 1, T]
    in_win = (rel >= 0) & (rel < C)
    anc_b = anc.to(q.device) != 0
    anc_t = anc_b[torch.arange(C, device=q.device)[None, :, None],
                  rel.clamp(0, C - 1)]                   # [B, C, T]
    valid = (rel < 0) | (in_win & anc_t)
    scores = scores.masked_fill(~valid[:, :, None, :], float("-inf"))
    w = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("bcht,bthd->bchd", w, v_ctx)


def paged_attention_tree(k_pages, v_pages, q, block_tables, positions, anc,
                         sm_scale=None):
    """Tree-masked attention of ``q`` over the paged pool, block tables
    read inside the kernel (see the module docstring for shapes). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if _cost.counting():
        count_window_flops(q, positions[:, 0].clamp(min=0) + q.shape[1])
    if q.device.type == "cpu":
        with _cost.uncounted():
            return paged_attention_tree_reference(
                k_pages, v_pages, q, block_tables, positions, anc, sm_scale)
    return _paged_attention_tree_cuda(k_pages, v_pages, q, block_tables,
                                      positions, anc, sm_scale)


# kernel launches since the last reset (the plain CPU route never counts)
paged_attention_tree.launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(
            "paged_attention_tree").ptpu_paged_attention_tree_f32
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def load():
    """Build (if needed) and load the kernel library; raises without a
    CUDA device or when the build fails."""
    _kernel()


def _check_tree(k_pages, v_pages, q, block_tables, positions, anc):
    _check(k_pages, v_pages, q, block_tables, positions,
           kernel="paged_attention_tree")
    C = q.shape[1]
    if C > MAX_TREE_WINDOW:
        raise ValueError("tree window C=%d is above the largest the "
                         "paged_attention_tree kernel's ancestor masks hold "
                         "(%d)" % (C, MAX_TREE_WINDOW))
    if anc.device != q.device:
        raise ValueError("anc is on %s, q on %s" % (anc.device, q.device))
    if anc.dtype != torch.bool:
        raise TypeError("anc must be torch.bool, got %s" % anc.dtype)
    if tuple(anc.shape) != (C, C):
        raise ValueError("anc must be [C, C] = [%d, %d], got shape %s"
                         % (C, C, tuple(anc.shape)))
    if not anc.is_contiguous():
        raise ValueError("anc must be contiguous")


def _paged_attention_tree_cuda(k_pages, v_pages, q, block_tables, positions,
                               anc, sm_scale=None):
    _check_tree(k_pages, v_pages, q, block_tables, positions, anc)
    out = launch_split(_kernel(), k_pages, v_pages, q, block_tables,
                       positions, (anc,), sm_scale)
    with _count_lock:
        paged_attention_tree.launches += 1
    return out
