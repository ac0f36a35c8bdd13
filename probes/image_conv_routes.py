"""The fp32 convolution routes on a card, and phase 9c over init draws.

For each of 16 init draws of ``chip_smoke.build_image_cvc``'s model
(cifar ResNet-8 + a bottleneck stage, batch 8): phase 9c's verdict and
readings, the relu inputs the card's fp32 step puts on the other side of
0 from a float64 run's, and how far step 1's grads lie from that run
(each grad over its tensor's largest, the worst of the 41) by route:
the conv op as shipped (fp32 GEMMs over the unfolded input, on the card
and on the CPU) and cuDNN's / oneDNN's own fp32 convolution
(``F.conv2d`` and ATen's convolution backward, TF32 off). Then a
ResNet-50 ImageNet fp32 training step at batch 64 by route (cuDNN, the
GEMMs, the GEMMs, cuDNN; 2 warm-up and 5 timed steps each).

Run from the repository's root on a machine with one CUDA card:
``python3 probes/image_conv_routes.py``. Prints JSON lines.
"""
import contextlib
import importlib.util
import io
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch import framework  # noqa: E402
from paddle_tpu_torch.ops import conv  # noqa: E402

OP = conv._Conv2dFp32
SHIPPED = (OP.forward, OP.backward)


def library_forward(ctx, x, w, stride, padding, dilation, groups):
    ctx.save_for_backward(x, w)
    ctx.conf = (stride, padding, dilation, groups)
    with no_tf32():
        return F.conv2d(x, w, None, stride, padding, dilation, groups)


def library_backward(ctx, g):
    x, w = ctx.saved_tensors
    stride, padding, dilation, groups = ctx.conf
    with no_tf32():
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, stride, padding, dilation, False, [0, 0], groups,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
    return gx, gw, None, None, None, None


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def use(route):
    fwd, bwd = SHIPPED if route == "gemm" else (
        staticmethod(library_forward), staticmethod(library_backward))
    OP.forward, OP.backward = fwd, bwd


def step_grads(main, fetch, start, device, dtype, feed):
    """Step 1's loss and grads from `start` on `device` in `dtype`."""
    framework._TORCH_DTYPES["float32"] = dtype
    try:
        scope = fluid.Scope()
        for n, t in start.items():
            scope.set(n, t.to(device=device, dtype=dtype, copy=True)
                      if t.is_floating_point() else t.to(device, copy=True))
        out = fluid.Executor(device).run(
            main, feed={k: v.to(device) for k, v in feed.items()},
            fetch_list=fetch, scope=scope)
    finally:
        framework._TORCH_DTYPES["float32"] = torch.float32
    return [np.asarray(o, np.float64) for o in out]


@contextlib.contextmanager
def relu_inputs(into):
    """Each relu op's input, in run order, into `into` (float64, CPU)."""
    from paddle_tpu_torch.ops import registry

    op = registry.get("relu")
    impl = op.impl

    def traced(ctx, ins, attrs):
        into.append(ins["X"][0].detach().double().cpu())
        return impl(ctx, ins, attrs)

    op.impl = traced
    try:
        yield
    finally:
        op.impl = impl


def worst_off(got, ref):
    return max(float(np.abs(got[i] - ref[i]).max() / np.abs(ref[i]).max())
               for i in range(1, len(ref)))


def draws(n=16):
    failed = []
    for draw in range(n):
        use("gemm")
        program = cs.build_image_cvc(fluid)
        main, startup, loss, _ = program
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
            try:
                cs.image_card_vs_cpu_phase(torch, fluid, program)
                ok = True
            except SystemExit:
                ok = False
        line = json.loads([x for x in buf.getvalue().splitlines()
                           if x.startswith("card_vs_cpu_image ")][0]
                          .split(" ", 1)[1])
        params = sorted(main.param_grad_map)
        fetch = [loss] + [main.param_grad_map[p] for p in params]
        exe, scope = fluid.Executor("cuda:0"), fluid.Scope()
        exe.run(startup, scope=scope)
        start = {k: scope.get(k).detach().cpu().clone()
                 for k in scope.local_var_names() if k != "__step_counter__"}
        feed = cs.image_feed(torch, (3, 32, 32), 10, 8, "cpu")
        x64, x32 = [], []
        with relu_inputs(x64):
            ref = step_grads(main, fetch, start, "cpu", torch.float64, feed)
        with relu_inputs(x32):
            step_grads(main, fetch, start, "cuda:0", torch.float32, feed)
        crossed = [(a > 0) != (b > 0) for a, b in zip(x32, x64)]
        row = {"draw": draw, "cvc_ok": ok,
               # relu inputs the card's fp32 step puts on the other side
               # of 0 from float64's, and the largest such in float64
               "relu_card_fp32_vs_float64_crossed": int(sum(
                   c.sum() for c in crossed)),
               "relu_crossed_max_abs_float64": max(
                   [float(b[c].abs().max()) for b, c in zip(x64, crossed)
                    if c.any()] or [0.0])}
        row.update({k: line[k] for k in (
            "loss_rel_err", "worst_grad_err_over_limit", "worst_grad",
            "worst_stat_err_over_limit", "worst_param_err_over_limit",
            "relu_elements_the_cpu_would_cross")})
        for route in ("gemm", "library"):
            use(route)
            for device in ("cuda:0", "cpu"):
                row["%s_%s_off_float64" % (route, device.split(":")[0])] = \
                    worst_off(step_grads(main, fetch, start, device,
                                         torch.float32, feed), ref)
        use("gemm")
        failed += [] if ok else [draw]
        print("image_cvc_draw " + json.dumps(row), flush=True)
    print("image_cvc_draws " + json.dumps({"draws": n, "failed": failed}),
          flush=True)


def resnet50_step():
    main, startup, loss, _ = cs.build_image(fluid, "resnet50_imagenet")
    exe, scope = fluid.Executor("cuda:0"), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = cs.image_feed(torch, (3, 224, 224), 1000, 64, "cuda:0")
    for route in ("library", "gemm", "gemm", "library"):
        use(route)
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t = time.perf_counter()
        marks[0].record()
        for _ in range(5):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        marks[1].record()
        torch.cuda.synchronize()
        print("resnet50_fp32_step " + json.dumps({
            "route": route, "host_ms": (time.perf_counter() - t) * 1e3 / 5,
            "device_ms": marks[0].elapsed_time(marks[1]) / 5,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "card": cs.card_line()}), flush=True)
    use("gemm")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(cs.card_line(), torch.__version__, flush=True)
    draws()
    resnet50_step()
