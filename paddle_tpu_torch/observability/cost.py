"""Step cost accounting and MFU (model-FLOPs utilization): the port of
``paddle_tpu/observability/cost.py``.

The JAX package reads XLA's cost analysis of each compiled step. The
port has no compiled step, so it counts one executed step instead
(``count_flops``):

  * ``torch.utils.flop_counter.FlopCounterMode`` counts the aten
    products the step dispatches (mm, addmm, bmm, baddbmm, convolution
    and their backward ops), in the calling thread and in the autograd
    threads its backward runs on;
  * each hand-written kernel's wrapper adds its own count where it
    launches (``kernel_flops``): ctypes launches are invisible to a
    dispatch mode. K1 (flash attention) forward 4·B·H·Tq·Tk·Dh and
    backward 8·B·H·Tq·Tk·Dh, with no causal discount; K4 (int8 matmul)
    2·M·N·K; K2 and K3 (paged attention) 4·H·Dh·Σ over rows of C × the
    keys the row attends. These are the products of each kernel's plain
    version, so a step counts the same on the CPU, where the plain
    versions run, and on the card: K1's and K4's plain versions are
    counted by their own aten products, which are these formulas; K2's
    and K3's read the whole block table, so they run ``uncounted`` and
    add the formula instead.

The count becomes the JAX package's gauges (``publish``):

  exec/step_flops           FLOPs of one step
  exec/peak_hbm_bytes       the card's peak allocation in the process
                            up to the end of the counted step (CUDA
                            only; read, never reset: the peak
                            statistics belong to the caller)

``exec/step_bytes_accessed`` is not counted: nothing in the port reads
a step's memory traffic. Callers count through ``first_step``, only
with ``metrics.enabled()`` (``PTPU_METRICS``); with metrics off nothing
is counted and no step gets slower.

``mfu_pct`` is ``step_flops * steps_per_sec / peak_flops``. The peak
table is keyed by the card's name as ``torch.cuda.get_device_name``
gives it (the dense bf16 tensor-core peak); an unknown card raises
rather than borrow another's peak. The CPU keeps the JAX package's
token figure, so the CPU's arithmetic matches it.
"""

import contextlib
import threading

import torch

__all__ = ["PLATFORM_PEAK_FLOPS", "analyze", "count_flops", "counting",
           "first_step", "kernel_flops", "mfu_pct", "peak_flops",
           "publish", "uncounted"]

# nominal dense peak per card (bf16 tensor cores, no sparsity); the CPU
# figure is the JAX package's token reference point, not a host's rate
PLATFORM_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
    "cpu": 1e11,
}

# counts in progress in any thread; kernel wrappers skip their count
# while it is 0
_active = [0]
_active_lock = threading.Lock()

# the op a wrapper's count travels by: a no-op that the dispatch mode
# counting the step sees in whichever thread it runs (autograd's device
# threads included), and that FlopCounterMode maps to its `flops`
_LIB = torch.library.Library("ptpu_cost", "DEF")
_LIB.define("kernel_flops(Tensor anchor, int flops) -> Tensor")
_LIB.impl("kernel_flops", lambda anchor, flops: anchor.new_empty(0),
          "CompositeExplicitAutograd")
_KERNEL_FLOPS = torch.ops.ptpu_cost.kernel_flops
_ANCHOR = torch.empty(0)


def _kernel_flops_formula(anchor_shape, flops, *args, out_shape=None,
                          **kwargs):
    return flops


def counting():
    """Whether a count is being taken in any thread."""
    return _active[0] > 0


def kernel_flops(n):
    """Add `n` FLOPs to the count the calling thread's step is under
    (a kernel wrapper's count, at its launch); nothing without one."""
    if _active[0]:
        _KERNEL_FLOPS(_ANCHOR, int(n))


def uncounted():
    """A context in which aten products go uncounted: a wrapper's plain
    version whose products differ from its kernel's formula runs in it
    and adds the formula (``kernel_flops``)."""
    if not _active[0]:
        return contextlib.nullcontext()
    return torch._C._DisableTorchDispatch()


class count_flops:
    """Count the FLOPs of what runs in the with-block (see the module
    docstring). On a CUDA `device` the process's peak allocation is read
    at exit too (never reset). ``.flops`` and ``.peak_bytes`` (None off
    the card) hold the result after exit."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.flops = None
        self.peak_bytes = None
        self._mode = None

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self._mode = FlopCounterMode(display=False, custom_mapping={
            _KERNEL_FLOPS: _kernel_flops_formula})
        self._mode.__enter__()
        with _active_lock:
            _active[0] += 1
        return self

    def __exit__(self, *exc):
        with _active_lock:
            _active[0] -= 1
        self._mode.__exit__(*exc)
        self.flops = int(self._mode.get_total_flops())
        if self._cuda():
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        return False

    def _cuda(self):
        return self.device is not None and self.device.type == "cuda"


class _published(count_flops):
    def __exit__(self, *exc):
        super().__exit__(*exc)
        if exc[0] is None:
            publish(self)
        return False


def first_step(fresh, device=None):
    """The with-block a caller puts around one step: with metrics on and
    `fresh` (a plan's, a window shape's or a leg's first step), the
    block is counted (``count_flops``) and the exec/* gauges published
    at its exit; the count is the block's target. Otherwise nothing is
    counted and the target is None."""
    from . import metrics as _metrics

    if fresh and _metrics.enabled():
        return _published(device)
    return contextlib.nullcontext()


def analyze(count):
    """{step_flops, peak_hbm_bytes} of a finished ``count_flops``: the
    keys the count has."""
    out = {}
    if count.flops is not None:
        out["step_flops"] = count.flops
    if count.peak_bytes is not None:
        out["peak_hbm_bytes"] = count.peak_bytes
    return out


def publish(count):
    """Publish the exec/* gauges of a finished ``count_flops`` into the
    process-wide registry (the last count wins: on a steady engine that
    is THE step) and return ``analyze(count)``. ``first_step`` calls it
    with metrics on."""
    vals = analyze(count)
    if not vals:
        return vals
    from . import metrics as _metrics

    reg = _metrics.registry()
    if "step_flops" in vals:
        reg.gauge("exec/step_flops").set(vals["step_flops"])
    if "peak_hbm_bytes" in vals:
        reg.gauge("exec/peak_hbm_bytes").set(vals["peak_hbm_bytes"])
    return vals


def peak_flops(platform=None):
    """The peak of `platform`: a card's name as
    ``torch.cuda.get_device_name`` gives it, "cpu", a CUDA device (its
    card's name) or None (card 0 where there is one, else the CPU).
    Raises KeyError for a card the table lacks."""
    if platform is None:
        platform = torch.device("cuda", 0) if torch.cuda.is_available() \
            else "cpu"
    if isinstance(platform, str) and platform.startswith("cuda"):
        platform = torch.device(platform)
    if isinstance(platform, torch.device):
        platform = "cpu" if platform.type == "cpu" \
            else torch.cuda.get_device_name(platform)
    if platform not in PLATFORM_PEAK_FLOPS:
        raise KeyError("no peak FLOP/s for %r: add the card's dense bf16 "
                       "peak to PLATFORM_PEAK_FLOPS" % (platform,))
    return PLATFORM_PEAK_FLOPS[platform]


def mfu_pct(step_flops, steps_per_sec, platform=None):
    """Model-FLOPs utilization percent against `platform`'s peak."""
    peak = peak_flops(platform)
    if not step_flops or not steps_per_sec or peak <= 0:
        return 0.0
    return 100.0 * float(step_flops) * float(steps_per_sec) / peak
