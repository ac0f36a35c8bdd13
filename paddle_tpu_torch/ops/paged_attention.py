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
no fallback from the kernel to the plain version. The kernel takes any
head dim up to ``MAX_HEAD_DIM`` and any window C; it splits each row's
context across blocks (``plan_splits``), and the last block of a row to
finish combines the row's splits: one call, one launch, one count in
``window_launches``.

While a step's FLOPs are counted (``observability/cost.py``), a call
adds 4·H·Dh·Σ over rows of C × the keys the row attends (the context
through its last window slot); the plain version, which reads the whole
block table, runs uncounted.
"""

import ctypes
import threading

import torch

from ..observability import cost as _cost
from . import _build

__all__ = ["MAX_HEAD_DIM", "paged_attention", "paged_attention_reference",
           "plan_splits"]

# the kernels' widest instantiation: any Dh up to it runs
MAX_HEAD_DIM = 256
SPLIT_UNIT = 64   # positions: a split covers a multiple of this
MAX_SPLITS = 64   # the kernel's combine keeps each slot's split weights


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
    if _cost.counting():
        count_window_flops(q, positions.clamp(min=0).amax(dim=1) + 1)
    if q.device.type == "cpu":
        with _cost.uncounted():
            return paged_attention_reference(k_pages, v_pages, q,
                                             block_tables, positions,
                                             sm_scale)
    return _paged_attention_cuda(k_pages, v_pages, q, block_tables,
                                 positions, sm_scale)


def count_window_flops(q, keys):
    """Add a window's products to the step's count: q [B, C, H, Dh],
    `keys` [B] the keys each row attends (read on the host: counting
    only)."""
    B, C, H, Dh = q.shape
    _cost.kernel_flops(4 * H * Dh * C * int(keys.long().sum()))


# kernel launches since the last reset, by window size C (the plain CPU
# route never counts). Serving workers launch from threads of their own,
# so every count is taken under _count_lock: a bare += could lose one
paged_attention.window_launches = {}
# (splits, split_len) of the last kernel launch, K2's or K3's
paged_attention.last_plan = None
_count_lock = threading.Lock()

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("paged_attention").ptpu_paged_attention_f32
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def load():
    """Build (if needed) and load the kernel library; raises without a
    CUDA device or when the build fails."""
    _kernel()


def plan_splits(B, H, C, max_ctx, sm_count):
    """(splits, split_len) of a call: the context of max_ctx positions (the
    block table's length) cut into `splits` runs of `split_len` positions
    (a multiple of SPLIT_UNIT), as many as put about two blocks on each of
    `sm_count` SMs next to the B * H * ceil(C / 32) (row, head, chunk)
    blocks, no more than the context has units, and at most
    MAX_SPLITS."""
    units = -(-max_ctx // SPLIT_UNIT)
    base = B * H * -(-C // 32)
    splits = max(1, min(units, MAX_SPLITS, -(-2 * sm_count // base)))
    per = -(-units // splits)
    return -(-units // per), per * SPLIT_UNIT


_sm_counts = {}
_counters = {}   # (device, stream) -> int32 zeros the kernels leave zero


def _sm_count(device):
    n = _sm_counts.get(device)
    if n is None:
        n = _sm_counts[device] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _check(k_pages, v_pages, q, block_tables, positions,
           kernel="paged_attention"):
    """What the kernels take (K2 here, K3 with its own mask checks):
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
    B, C, H, Dh = q.shape
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if Dh % 4 == 0 and t.data_ptr() % 16:   # 16-byte row copies
            raise ValueError("%s must start on a 16-byte boundary" % name)
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (H, Dh):
        raise ValueError("pages %s / %s do not match q %s"
                         % (tuple(k_pages.shape), tuple(v_pages.shape),
                            tuple(q.shape)))
    if block_tables.shape[0] != B or tuple(positions.shape) != (B, C):
        raise ValueError("block_tables %s / positions %s do not match q %s"
                         % (tuple(block_tables.shape),
                            tuple(positions.shape), tuple(q.shape)))
    if Dh > MAX_HEAD_DIM:
        raise ValueError("head_dim %d is above the largest the %s kernel "
                         "takes (%d)" % (Dh, kernel, MAX_HEAD_DIM))
    if min(C, H, Dh, block_tables.shape[1], k_pages.shape[1]) < 1:
        raise ValueError("empty window, head, table or page: q %s, "
                         "block_tables %s, pages %s"
                         % (tuple(q.shape), tuple(block_tables.shape),
                            tuple(k_pages.shape)))
    if not 1 <= B <= 65535:
        raise ValueError("batch %d not supported (1..65535: the grid's "
                         "second dimension)" % B)


def launch_split(fn, k_pages, v_pages, q, block_tables, positions, extra,
                 sm_scale):
    """Call K2's or K3's C function `fn` (pointers k, v, q, tables,
    positions, then `extra`, then out, the partials and the counts) on
    the tensors' device: the context split as ``plan_splits`` says, the
    partials from torch's caching allocator, the per-(row, head, chunk)
    counts of finished splits from a zeroed buffer kept for the stream
    (the kernel leaves it zero). Returns out; raises on a launch
    error."""
    B, C, H, Dh = q.shape
    if sm_scale is None:
        sm_scale = Dh ** -0.5
    bs, Mb = k_pages.shape[1], block_tables.shape[1]
    splits, split_len = plan_splits(B, H, C, Mb * bs, _sm_count(q.device))
    paged_attention.last_plan = (splits, split_len)
    out = torch.empty_like(q)
    parts = (0, 0, 0, 0)
    stream = torch.cuda.current_stream(q.device)
    if splits > 1:
        n = B * C * H * splits
        scratch = torch.empty(n * (Dh + 2), dtype=torch.float32,
                              device=q.device)
        n_counts = B * H * -(-C // 32)
        # one buffer a stream: a stream's launches run in order, so
        # they can share it, and only that stream's thread grows it
        key = (q.device, stream.cuda_stream)
        counts = _counters.get(key)
        if counts is None or counts.numel() < n_counts:
            counts = _counters[key] = torch.zeros(
                n_counts, dtype=torch.int32, device=q.device)
        # acc first: 16-byte aligned for its float4 stores
        parts = (scratch[n * Dh:].data_ptr(),
                 scratch[n * Dh + n:].data_ptr(), scratch.data_ptr(),
                 counts.data_ptr())
    # the C function launches on the runtime's current device: make it
    # the tensors' device for the call
    with torch.cuda.device(q.device):
        err = fn(k_pages.data_ptr(), v_pages.data_ptr(), q.data_ptr(),
                 block_tables.data_ptr(), positions.data_ptr(),
                 *[t.data_ptr() for t in extra], out.data_ptr(), *parts,
                 B, C, H, Dh, bs, Mb, k_pages.shape[0], splits, split_len,
                 sm_scale, stream.cuda_stream)
    if err != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (fn.__name__, err))
    return out


def _paged_attention_cuda(k_pages, v_pages, q, block_tables, positions,
                          sm_scale=None):
    _check(k_pages, v_pages, q, block_tables, positions)
    out = launch_split(_kernel(), k_pages, v_pages, q, block_tables,
                       positions, (), sm_scale)
    _count_launch(q.shape[1])
    return out


def _count_launch(C):
    """One K2 launch at window C in ``window_launches``, under the lock
    that K3's count shares."""
    with _count_lock:
        by_c = paged_attention.window_launches
        by_c[C] = by_c.get(C, 0) + 1
