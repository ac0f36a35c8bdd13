#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

  1. card: require torch.cuda; print the card's name and power limit as
     ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
     gives them.
  2. build: compile every CUDA kernel of the port from its sources in
     ``paddle_tpu_torch/csrc`` (one nvcc per source, started together);
     print the build seconds and nvcc's register report.
  3. kernels: hold each kernel against its plain PyTorch version on the
     card at the serving path's shapes, and time kernel, plain version,
     the least time the card could take (bound) and one PyTorch library
     call computing the same function (a yardstick the port never
     calls).
  4. serving: the flagship decoder at full width (vocab 32000, d_model
     512, 8 heads, 6 layers, d_ff 2048, max_seq_len 512; random weights
     from seed 0) served by ``ServingEngine`` on cuda:0 for 64 open-loop
     Poisson requests. Every request must finish without error, the
     first 4 must be token-identical to the numpy ``reference_decode``,
     and the kernel launch counts must show the path went through the
     kernels (paged attention: once per layer per decode step). A second
     stream of 32 requests then runs under torch.profiler (the card
     only) for the device's busy share and the kernels' time per step.

  5. flash attention kernels: K1's forward and backward CUDA kernels
     against the plain version's forward and autograd at the training
     path's shape (B=160, H=8, T=512, Dh=64, causal, bf16, through the
     strided views of [B, T, H, Dh] tensors), at B=4 fp32, and at a
     non-causal Tq=128/Tk=256 case; kernel, plain and library
     (scaled_dot_product_attention) times and the bound at the first.
  6. training: the Fluid-API Transformer LM (bench.py's headline step)
     through the port's entry points on cuda:0 — full width, 6 layers,
     seq 512, batch 160, bf16 params and residual stream, the legacy AMP
     decorator over SGD(0.01) — 3 warm-up and 10 timed steps on fixed
     seeded tokens. Every loss finite, the loss falling from the first
     step to the last, flash attention launched exactly 6 times forward
     and 6 backward per step; then 2 more steps under torch.profiler.
  7. card vs CPU: the same program from one set of weights (startup run
     once on the card, the scope copied to the CPU), two SGD steps at
     batch 2 on cuda:0 (the kernels) and on the CPU (the plain
     versions); per-step losses, step 1's grads and every updated
     parameter must agree. Twice: the headline bf16 program, and the
     same model in fp32 without AMP, where the updates do not round
     away and the limits are tight enough to see a skipped one.

Then one JSON line ``{"kernels": [...]}`` and, last, the result line
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
H100_BF16_FLOPS = 989e12     # bf16 tensor cores, dense
ATOL = 1e-4                  # fp32, different summation order
# flash attention vs its plain version, |got - want| <= atol + rtol|want|,
# (atol, rtol) for the output and for the three grads: fp32 sums in
# another order; in bf16 both sides round to bf16 (1 ulp is 2^-8 to 2^-7
# of |want|), and the grads are reductions over up to 512 rounded terms
# that the kernel's backward forms from the bf16-rounded O
FLASH_TOL = {"float32": {"out": (1e-4, 1e-4), "grads": (1e-4, 1e-4)},
             "bfloat16": {"out": (1e-2, 1e-2), "grads": (3e-2, 1e-2)}}


def fail(msg):
    print("chip_smoke FAILED: %s" % msg, file=sys.stderr)
    sys.exit(1)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail("nvidia-smi did not run: %r" % (e,))
    if out.returncode != 0 or not out.stdout.strip():
        fail("nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters=20):
    """Mean device time of ``fn`` in ms over ``iters`` launches, each
    after evicting the 50 MB L2 (a decode step finds the pool cold).

    Before each launch the card spins, so that the host has queued the
    start event, ``fn`` and the end event before the card reaches the
    start event: the time between the events is then the card's alone,
    not the host's enqueue. A sample whose start event the card had
    already passed when the end event was queued is taken again after
    a longer spin."""
    fn()
    torch.cuda.synchronize()
    spin = 1 << 21            # clock cycles, about 1 ms
    total, n = 0.0, 0
    while n < iters:
        flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        host_late = start.query()
        end.synchronize()
        if host_late:
            if spin >= 1 << 28:
                fail("timing: the host took longer than a %d-cycle spin "
                     "to queue one launch" % spin)
            spin *= 2
            continue
        total += start.elapsed_time(end)
        n += 1
    return total / iters


def paged_inputs(torch, C, seed=0):
    """The serving path's attention shapes at full width: B=32 rows,
    H=8, Dh=64, block_size 16, 32 table slots (max_seq_len 512); ragged
    positions up to 511, pages scattered over the pool, null tails."""
    B, H, Dh, bs, Mb = 32, 8, 64, 16, 32
    rng = np.random.RandomState(seed)
    last = rng.randint(C - 1, 512, size=B)
    last[:4] = [511, C - 1, 15 + C, 16 + C]  # full row, first page, edges
    pos = (last[:, None] - (C - 1) + np.arange(C)[None, :]).astype(np.int32)
    tables = np.zeros((B, Mb), np.int32)      # page 0: the null page
    perm = rng.permutation(B * Mb) + 1
    for b in range(B):
        n = last[b] // bs + 1
        tables[b, :n] = perm[b * Mb:b * Mb + n]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn(B * Mb + 1, bs, H, Dh, device="cuda", generator=gen)
    v = torch.randn(B * Mb + 1, bs, H, Dh, device="cuda", generator=gen)
    q = torch.randn(B, C, H, Dh, device="cuda", generator=gen)
    return (k, v, q, torch.from_numpy(tables).cuda(),
            torch.from_numpy(pos).cuda())


def paged_bound_ms(k, q, tables, pos):
    """Least time for the work: K and V of every visible position read
    once, q/tables/positions read and the output written once, over the
    memory rate; against the flops (QK and PV) over the fp32 rate."""
    B, C, H, Dh = q.shape
    pos = pos.cpu().numpy().astype(np.int64)
    row = H * Dh * 4
    visible = pos.max(axis=1) + 1
    nbytes = (2 * int(visible.sum()) * row + 2 * q.numel() * 4
              + tables.numel() * 4 + pos.size * 4)
    flops = 4 * int((pos + 1).sum()) * H * Dh
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, pa_mod):
    import torch.nn.functional as F

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for C in (1, 4):
        k, v, q, tables, pos = paged_inputs(torch, C)
        got = pa_mod.paged_attention(k, v, q, tables, pos)
        want = pa_mod.paged_attention_reference(k, v, q, tables, pos)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail("paged_attention C=%d: non-finite output" % C)
        err = float((got - want).abs().max())
        if err > ATOL:
            fail("paged_attention C=%d disagrees with its plain version: "
                 "max abs err %.3g > %g" % (C, err, ATOL))
        B, _, H, Dh = q.shape
        T = tables.shape[1] * k.shape[1]
        # library yardstick: SDPA over K/V gathered contiguous outside
        # the timed region, with the same visibility mask
        tl = tables.long()
        k_ctx = k[tl].reshape(B, T, H, Dh).transpose(1, 2).contiguous()
        v_ctx = v[tl].reshape(B, T, H, Dh).transpose(1, 2).contiguous()
        q_l = q.transpose(1, 2).contiguous()
        mask = (torch.arange(T, device="cuda")[None, None, :]
                <= pos.long()[:, :, None])[:, None]
        lib_out = F.scaled_dot_product_attention(q_l, k_ctx, v_ctx,
                                                 attn_mask=mask)
        lib_err = float((lib_out.transpose(1, 2) - want).abs().max())
        if lib_err > ATOL:
            fail("library yardstick C=%d disagrees: %.3g" % (C, lib_err))
        ms = time_ms(torch, lambda: pa_mod.paged_attention(
            k, v, q, tables, pos), flush)
        plain_ms = time_ms(torch, lambda: pa_mod.paged_attention_reference(
            k, v, q, tables, pos), flush)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q_l, k_ctx, v_ctx, attn_mask=mask), flush)
        bound_ms, bound_by = paged_bound_ms(k, q, tables, pos)
        rows.append({
            "name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:316",
            "C": C, "shape": "B=32 H=8 Dh=64 bs=16 Mb=32 pos<=511 fp32",
            "max_abs_err": err, "max_err": err,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention over K/V gathered "
                       "contiguous outside the timed region (yardstick)"})
        print("kernel paged_attention C=%d: max_abs_err %.3g (limit %g), "
              "%.4f ms (plain %.4f ms, library %.4f ms, bound %.4f ms by %s)"
              % (C, err, ATOL, ms, plain_ms, library_ms, bound_ms, bound_by),
              flush=True)
        del k, v, q, k_ctx, v_ctx
    return rows


def kernel_times(prof, steps, top=8):
    """(device busy seconds, the kernels with the most device time, per
    step) from a torch.profiler run over `steps` steps."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(us for us, _, _ in rows) / 1e6
    return busy_s, [{"kernel": key[:80], "calls": n,
                     "ms_per_step": us / 1e3 / max(steps, 1)}
                    for us, n, key in rows[:top]]


def device_profile(torch, engine, cfg):
    """Where a serving step's time goes: a second open-loop stream of 32
    requests (seed 1) through the same engine under torch.profiler,
    tracing the card only. Returns the device's busy share of the wall
    time and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import PoissonLoadGenerator

    loadgen = PoissonLoadGenerator(rate=200.0, n_requests=32,
                                   prompt_len=(16, 64), max_new_tokens=32,
                                   vocab_size=cfg.vocab_size, seed=1)
    steps0 = engine.stats()["steps"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        accepted, _ = loadgen.run(engine)
        for r in accepted:
            r.wait(900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = engine.stats()["steps"] - steps0
    busy_s, top = kernel_times(prof, steps)
    return {"wall_s": wall, "steps": steps,
            "step_ms": 1e3 * wall / max(steps, 1),
            "device_busy_ms_per_step": 1e3 * busy_s / max(steps, 1),
            "device_busy_share": busy_s / wall,
            "top_kernels": top}


def serving_phase(torch, pa_mod):
    from paddle_tpu_torch.serving import (GenerationConfig, GenerationModel,
                                          PoissonLoadGenerator,
                                          ServingEngine, reference_decode)

    cfg = GenerationConfig(vocab_size=32000, d_model=512, n_heads=8,
                           n_layers=6, d_ff=2048, max_seq_len=512)
    model = GenerationModel.random(cfg, seed=0)   # device None: cuda:0
    if model.device.type != "cuda":
        fail("the model resolved to %s, not the card" % model.device)
    loadgen = PoissonLoadGenerator(rate=200.0, n_requests=64,
                                   prompt_len=(16, 64), max_new_tokens=32,
                                   vocab_size=cfg.vocab_size, seed=0)
    with ServingEngine(model, max_batch=32, max_seq_len=cfg.max_seq_len,
                       block_size=16, max_queue=128) as engine:
        warm = engine.generate([1, 2, 3, 4], max_new_tokens=4, timeout=600)
        if len(warm) != 4:
            fail("warm-up request returned %r" % (warm,))
        steps0 = engine.stats()["steps"]
        torch.cuda.synchronize()
        pa_mod.paged_attention.launches = 0          # main path starts
        t0 = time.perf_counter()
        accepted, rejected = loadgen.run(engine)
        errors = []
        for r in accepted:
            try:
                r.wait(900)
            except Exception as e:  # every request's result is checked
                errors.append("request %d: %r" % (r.id, e))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pa_mod.paged_attention.launches   # main path ends
        stats = engine.stats()
        profile = device_profile(torch, engine, cfg)
    if rejected:
        fail("%d requests were rejected at admission" % len(rejected))
    if errors:
        fail("%d requests ended with an error: %s"
             % (len(errors), "; ".join(errors[:3])))
    steps = stats["steps"] - steps0
    specs = loadgen.make_requests()
    short = [(r.id, len(r.tokens), s["max_new_tokens"])
             for r, s in zip(accepted, specs)
             if len(r.tokens) != s["max_new_tokens"]]
    if short:
        fail("requests ended short of max_new_tokens: %r" % short[:4])
    for r, s in list(zip(accepted, specs))[:4]:
        ref = reference_decode(model, s["prompt"], s["max_new_tokens"])
        if r.tokens != ref:
            first = next(i for i, (a, b) in enumerate(zip(r.tokens, ref))
                         if a != b)
            fail("request %d differs from reference_decode at token %d: "
                 "%r vs %r" % (r.id, first, r.tokens, ref))
    if launches < 1 or launches != cfg.n_layers * steps:
        fail("paged_attention launched %d times over %d decode steps "
             "(expected %d x %d)" % (launches, steps, cfg.n_layers, steps))
    tokens = sum(len(r.tokens) for r in accepted)
    lat = np.array([r.latency for r in accepted])
    summary = {
        "model": "vocab 32000, d_model 512, 8 heads, 6 layers, d_ff 2048",
        "requests": len(accepted), "generated_tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "steps": steps, "steps_per_s": steps / wall,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "paged_attention_launches": launches,
        "reference_checked": 4,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    print("serving " + json.dumps(summary), flush=True)
    print("profile " + json.dumps(profile), flush=True)
    return launches


def flash_inputs(torch, B, H, Tq, Tk, dtype, seed):
    """q, k, v and an upstream grad dO as [B, H, T, 64] views of
    [B, T, H, 64] tensors (the layout the fused attention op hands the
    kernel), from a seeded generator on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def make(T):
        t = torch.randn(B, T, H, 64, device="cuda", generator=gen)
        return t.to(dt).transpose(1, 2)

    return make(Tq), make(Tk), make(Tk), make(Tq)


def flash_check(torch, fa, B, H, Tq, Tk, causal, dtype, seed=0):
    """K1's kernels against the plain version's forward and autograd on
    the same inputs. Returns (inputs, max abs errors, shape label)."""
    q, k, v, g = flash_inputs(torch, B, H, Tq, Tk, dtype, seed)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention_reference(*ref_leaves, causal=causal)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g)
    torch.cuda.synchronize()
    shape = "B=%d H=%d Tq=%d Tk=%d Dh=64 causal=%s %s" % (
        B, H, Tq, Tk, causal, dtype)
    errs, report = {}, []
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out,) + grads,
                               (ref,) + ref_grads):
        atol, rtol = FLASH_TOL[dtype]["out" if name == "out" else "grads"]
        if got.dtype != q.dtype:
            fail("flash_attention %s: %s came back as %s"
                 % (dtype, name, got.dtype))
        got, want = got.detach().float(), want.detach().float()
        if not torch.isfinite(got).all():
            fail("flash_attention %s: non-finite %s" % (dtype, name))
        diff, mag = (got - want).abs(), want.abs()
        errs[name] = float(diff.max())
        ratio = float((diff / (atol + rtol * mag)).max())
        report.append("%s %.3g (%.3f of limit %g + %g|want|; |want| mean "
                      "%.3g, max %.3g)" % (name, errs[name], ratio, atol,
                                           rtol, float(mag.mean()),
                                           float(mag.max())))
        if ratio > 1:
            fail("flash_attention %s: %s disagrees with the plain version: "
                 "max abs err %.3g, %.3f of its limit %g + %g|want|"
                 % (shape, name, errs[name], ratio, atol, rtol))
    print("kernel flash_attention %s: max_abs_err %s" % (
        shape, "; ".join(report)), flush=True)
    return (q, k, v, g), errs, shape


def flash_bound_ms(B, H, T, Dh, elem_bytes, fwd):
    """Least time for the work: each input read once and each output
    written once over the memory rate (forward: q, k, v in, o and the
    fp32 lse out; backward: q, k, v, o, dO and lse in, dq, dk, dv out),
    against the products over the bf16 tensor-core rate, counting the
    T(T+1)/2 visible (query, key) pairs of causal attention per (b, h):
    forward QK^T and PV, 4 Dh flops a pair; backward QK^T, dO V^T, P^T dO,
    dS^T Q and dS K, 10 Dh flops a pair."""
    n = B * H * T * Dh * elem_bytes
    lse = B * H * T * 4
    nbytes = 4 * n + lse if fwd else 8 * n + lse
    pairs = B * H * T * (T + 1) // 2
    flops = (4 if fwd else 10) * Dh * pairs
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_phase(torch, fa):
    import torch.nn.functional as F

    flash_check(torch, fa, 4, 8, 512, 512, True, "float32", seed=1)
    flash_check(torch, fa, 16, 8, 128, 256, False, "bfloat16", seed=2)
    B, H, T, Dh = 160, 8, 512, 64
    (q, k, v, g), errs, shape = flash_check(torch, fa, B, H, T, T, True,
                                            "bfloat16", seed=3)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    scale = Dh ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    ms_fwd = time_ms(torch, lambda: fa.flash_attention_fwd(
        q, k, v, True, scale), flush, iters=10)
    ms_bwd = time_ms(torch, lambda: fa.flash_attention_bwd(
        q, k, v, o, lse, g, True, scale), flush, iters=10)
    plain_fwd = time_ms(torch, lambda: fa.flash_attention_reference(
        q, k, v, True, scale), flush, iters=5)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention_reference(*leaves, causal=True)
    plain_bwd = time_ms(torch, lambda: torch.autograd.grad(
        ref, leaves, g, retain_graph=True), flush, iters=5)
    del ref
    # library yardstick: SDPA over contiguous [B, H, T, Dh] copies
    lib = [t.contiguous().detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib, is_causal=True)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        *lib, is_causal=True), flush, iters=10)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, lib, g, retain_graph=True), flush, iters=10)
    lib_err = float((lib_out.detach().float() - o.float()).abs().max())
    print("kernel flash_attention %s: fwd %.4f ms, bwd %.4f ms (plain fwd "
          "%.4f, bwd %.4f ms; SDPA fwd %.4f, bwd %.4f, fwd+bwd %.4f ms, "
          "max |SDPA - kernel| %.3g)" % (shape, ms_fwd, ms_bwd, plain_fwd,
                                         plain_bwd, lib_fwd, lib_bwd,
                                         lib_fwd + lib_bwd, lib_err),
          flush=True)
    rows = []
    for name, fwd, ms, plain, library, err in (
            ("flash_attention_fwd", True, ms_fwd, plain_fwd, lib_fwd,
             errs["out"]),
            ("flash_attention_bwd", False, ms_bwd, plain_bwd, lib_bwd,
             max(errs["dq"], errs["dk"], errs["dv"]))):
        bound_ms, bound_by = flash_bound_ms(B, H, T, Dh, 2, fwd)
        print("kernel %s: bound %.4f ms by %s" % (name, bound_ms, bound_by))
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": ("paddle_tpu/ops/pallas_kernels.py:162" if fwd
                         else "paddle_tpu/ops/pallas_kernels.py:212"),
            "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library,
            "library": "F.scaled_dot_product_attention(is_causal=True) %s "
                       "on contiguous copies (yardstick)"
                       % ("forward" if fwd else "backward")})
    del q, k, v, g, o, lse, leaves, lib, lib_out
    torch.cuda.empty_cache()
    return rows


TRAIN = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
             d_ff=2048, seq_len=512)


def build_lm(fluid, dtype="bfloat16"):
    """bench.py's headline program through the port's entry points (bf16
    under the legacy AMP decorator), or the same model in fp32 with plain
    SGD."""
    from paddle_tpu_torch.models import transformer_fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        _, _, loss = transformer_fluid.build(remat=False, dtype=dtype,
                                             **TRAIN)
        opt = fluid.optimizer.SGD(0.01)
        if dtype == "bfloat16":
            opt = fluid.contrib.mixed_precision.decorate(
                opt, init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
        opt.minimize(loss)
    return main, startup, loss


def lm_feed(torch, batch, device):
    """bench.py's fixed batch: RandomState(0) tokens, labels shifted."""
    rng = np.random.RandomState(0)
    toks = rng.randint(0, TRAIN["vocab_size"],
                       (batch, TRAIN["seq_len"])).astype(np.int32)
    labs = np.roll(toks, -1, axis=1).astype(np.int32)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(labs).to(device)}


def training_phase(torch, fa, fluid, program):
    from torch.profiler import ProfilerActivity, profile

    main, startup, loss = program
    batch, warmup, steps = 160, 3, 10
    exe = fluid.Executor()                     # place None: cuda:0
    if exe.device.type != "cuda":
        fail("the executor resolved to %s, not the card" % exe.device)
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    feed = lm_feed(torch, batch, exe.device)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0        # main path starts
    fa.flash_attention_bwd.launches = 0
    losses = []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)
        losses.append(out)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = (fa.flash_attention_fwd.launches,
                fa.flash_attention_bwd.launches)  # main path ends
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x.float().cpu()[0]) for x in losses]
    n = warmup + steps
    if not all(np.isfinite(losses)):
        fail("training: non-finite loss %r" % losses)
    if not losses[-1] < losses[0]:
        fail("training: the loss did not fall: %r" % losses)
    want = TRAIN["n_layers"] * n
    if launches != (want, want):
        fail("training: flash attention launched %d forward / %d backward "
             "times over %d steps (expected %d each)"
             % (launches + (n, want)))
    step_s = (t2 - t1) / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tp = time.perf_counter()
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tp
    busy_s, top = kernel_times(prof, 2, top=10)
    summary = {
        "model": "Fluid-API Transformer LM: vocab 32000, d_model 512, 8 "
                 "heads, 6 layers, d_ff 2048, seq 512, bf16, legacy AMP, "
                 "SGD(0.01)",
        "batch": batch, "warmup_steps": warmup, "timed_steps": steps,
        "startup_s": startup_s, "losses": losses, "ms_per_step": step_s * 1e3,
        "tokens_per_s": batch * TRAIN["seq_len"] / step_s,
        "flash_attention_launches": {"fwd": launches[0],
                                     "bwd": launches[1], "steps": n},
        "max_memory_allocated_gib": peak / 2 ** 30}
    print("training " + json.dumps(summary), flush=True)
    print("training_profile " + json.dumps({
        "steps": 2, "wall_ms_per_step": wall * 1e3 / 2,
        "device_busy_ms_per_step": busy_s * 1e3 / 2,
        "device_busy_share": busy_s / wall, "top_kernels": top}),
        flush=True)
    return launches


def ulp(x, mantissa_bits):
    """The spacing of floats with `mantissa_bits` stored fraction bits
    (bf16 7, fp32 23) at |x|."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - mantissa_bits).astype(np.float32)


# card vs CPU limits: losses to loss_rtol; step 1's grad of every
# parameter to grad_rtol of that tensor's largest grad plus a floor of
# floor_rel of the largest grad of any parameter (the floor covers grads
# that are zero in exact arithmetic, such as the attention key bias,
# where both devices return rounding noise); after step 2 every element
# of every parameter to 2 ulps of the largest magnitude it takes (a
# sub-ulp update may round the other way once a step) plus what the grad
# limit lets two SGD steps move it, 2 lr (grad_rtol max|grad| + floor).
# bf16: GEMMs and reductions round in other places on the two devices,
# and the kernel's backward uses the bf16-rounded O. fp32: only the
# summation order differs (TF32 is off).
STEP_TOL = {
    "bfloat16": dict(loss_rtol=2e-3, grad_rtol=5e-2, floor_rel=1e-3,
                     mantissa_bits=7),
    "float32": dict(loss_rtol=1e-5, grad_rtol=1e-3, floor_rel=1e-7,
                    mantissa_bits=23),
}


def card_vs_cpu_phase(torch, fluid, program, dtype,
                      devices=("cuda:0", "cpu")):
    """Two SGD steps of the same program from the same weights on cuda:0
    (the kernels) and on the CPU (the plain versions), batch 2, held to
    STEP_TOL[dtype]. Also reads what the parameter check would have said
    had the card skipped its updates (the card's parameters left at
    their start): in fp32 that reading must fail the check on most
    parameters, or the check could not see a lost update. `devices` is
    (card, reference); the tests pass two CPUs and plant faults in the
    first."""
    main, startup, loss = program
    if dtype == "float32" and torch.backends.cuda.matmul.allow_tf32:
        fail("card vs CPU fp32: TF32 matmuls are on; the limits assume "
             "fp32 products")
    tol = STEP_TOL[dtype]
    lr, rel, bits = 0.01, tol["grad_rtol"], tol["mantissa_bits"]
    params = sorted(main.param_grad_map)
    fetch = [loss] + [main.param_grad_map[p] for p in params]
    exe_c, exe_h = fluid.Executor(devices[0]), fluid.Executor(devices[1])
    scope_c, scope_h = fluid.Scope(), fluid.Scope()
    exe_c.run(startup, scope=scope_c)
    for n in scope_c.local_var_names():
        if n != "__step_counter__":
            scope_h.set(n, scope_c.get(n).to("cpu", copy=True))
    # a copy: sgd updates the scope's tensors in place, and .float() of
    # an fp32 tensor is the tensor itself
    start = {p: scope_h.get(p).float().numpy().copy() for p in params}
    t0 = time.perf_counter()
    runs = []
    for exe, scope in ((exe_c, scope_c), (exe_h, scope_h)):
        feed = lm_feed(torch, 2, exe.device)
        first = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        second, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        runs.append(([float(first[0][0]), float(second[0])],
                     dict(zip(params, first[1:]))))
    seconds = time.perf_counter() - t0
    (lc, gc), (lh, gh) = runs
    loss_rel = float(np.abs(np.array(lc) - np.array(lh)).max()
                     / np.abs(lh).max())
    floor = tol["floor_rel"] * max(float(np.abs(g).max())
                                   for g in gh.values())
    worst_g, worst_p = (0.0, ""), (-np.inf, "")
    worst_skip, skip_caught = -np.inf, 0
    for p in params:
        g_lim = rel * float(np.abs(gh[p]).max()) + floor
        ratio = float(np.abs(gc[p] - gh[p]).max()) / g_lim
        worst_g = max(worst_g, (ratio, p))
        pc = scope_c.get(p).float().cpu().numpy()
        ph = scope_h.get(p).float().numpy()
        # each step rounds once, at most at the largest of the magnitudes
        mag = np.maximum(np.maximum(np.abs(pc), np.abs(ph)),
                         np.abs(start[p]))
        slack, p_lim = 2 * ulp(mag, bits), 2 * lr * g_lim
        excess = (np.abs(pc - ph) - slack) / p_lim
        i = int(np.argmax(excess))
        worst_p = max(worst_p, (float(excess.flat[i]), p, float(pc.flat[i]),
                                float(ph.flat[i]), float(start[p].flat[i])))
        skipped = float(((np.abs(start[p] - ph) - slack) / p_lim).max())
        worst_skip = max(worst_skip, skipped)
        skip_caught += skipped > 1
    report = {
        "dtype": dtype, "batch": 2, "steps": 2,
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        "loss_cuda": lc, "loss_cpu": lh,
        "loss_max_rel_err": loss_rel, "loss_limit": tol["loss_rtol"],
        "grad_rtol": rel, "grad_floor": floor, "params": len(params),
        "worst_grad_err_over_limit": worst_g[0], "worst_grad": worst_g[1],
        "worst_param_excess_over_limit": worst_p[0],
        "worst_param": worst_p[1:],
        "skipped_update_worst_reading": worst_skip,
        "skipped_update_fails_params": skip_caught, "seconds": seconds}
    print("card_vs_cpu " + json.dumps(report), flush=True)
    if not loss_rel <= tol["loss_rtol"]:
        fail("card vs CPU %s: losses %r vs %r (rel %.3g > %g)"
             % (dtype, lc, lh, loss_rel, tol["loss_rtol"]))
    if worst_g[0] > 1:
        fail("card vs CPU %s: the grad of %s differs by %.3g of its limit"
             % (dtype, worst_g[1], worst_g[0]))
    if worst_p[0] > 1:
        fail("card vs CPU %s: %s differs by %.3g of its limit after two "
             "steps" % (dtype, worst_p[1], worst_p[0]))
    if dtype == "float32" and 2 * skip_caught < len(params):
        fail("card vs CPU fp32: a skipped update would pass the parameter "
             "check on %d of %d parameters"
             % (len(params) - skip_caught, len(params)))


def main():
    try:
        import torch
    except ImportError as e:
        fail("PyTorch is not importable: %r" % (e,))
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port runs on a "
             "CUDA card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch")):
        fail("no paddle_tpu_torch package beside chip_smoke.py")
    sys.path.insert(0, root)
    print(card_line(), flush=True)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)),
          flush=True)

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa_mod
    from paddle_tpu_torch.ops import paged_attention as pa_mod

    t0 = time.perf_counter()
    paths = _build.build()
    print("build: %s in %.2f s" % (", ".join(sorted(paths)),
                                   time.perf_counter() - t0), flush=True)
    for name, path in sorted(paths.items()):
        with open(path[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print("  %s: %s" % (name, line.strip()))

    rows = kernel_phase(torch, pa_mod)
    flash_rows = flash_phase(torch, fa_mod)
    launches = serving_phase(torch, pa_mod)
    # the serving path decodes one token per step: it launches the C=1
    # shape only, and the C=4 row (the later spec_window shape) none
    for row in rows:
        row["launches"] = launches if row["C"] == 1 else 0
    program = build_lm(fluid)
    fwd, bwd = training_phase(torch, fa_mod, fluid, program)
    flash_rows[0]["launches"], flash_rows[1]["launches"] = fwd, bwd
    card_vs_cpu_phase(torch, fluid, program, "bfloat16")
    del program
    card_vs_cpu_phase(torch, fluid, build_lm(fluid, "float32"), "float32")
    print(json.dumps({"kernels": rows + flash_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
