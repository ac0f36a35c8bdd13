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
     calls): paged attention (K2) at C=1 (decode) and C=7 (the linear
     verify window), the tree-mask window (K3) at the tree leg's shape
     (C=13) and on an edge matrix (width 1 against K2, null tails,
     windows past the table, an inactive row, Dh 32/128, C=25 and 32).
  4. serving: the flagship decoder at full width (vocab 32000, d_model
     512, 8 heads, 6 layers, d_ff 2048, max_seq_len 512; random weights
     from seed 0) served by ``ServingEngine`` on cuda:0 for 64 open-loop
     Poisson requests. Every request must finish without error, the
     first 4 must be token-identical to the numpy ``reference_decode``,
     and the kernel launch counts must show the path went through the
     kernels (paged attention: once per layer per decode step). A second
     stream of 32 requests then runs under torch.profiler (the card
     only) for the device's busy share and the kernels' time per step.
  4b. speculative serving: the same decoder behind ``ServingEngine(
     max_batch=8, block_size=16)`` on bench.py's speculative traffic (16
     repetitive prompts, 48 new tokens each, all submitted at once) in
     three legs — legacy (spec_k=0), linear (spec_k=6: K2 at C=7) and
     tree (spec_tree="2x6": K3 at C=13). Every request of every leg must
     be token-identical to ``reference_decode`` (a difference prints the
     position and the reference's top-2 logit margin there), the pool
     must drain clean, and the launch counts must show K2 at C=7 once a
     layer a linear window and K3 once a layer a tree window. Then one
     tree window under torch.profiler.

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
  8. int8 inference: the fused int8 matmul (K4) bitwise against its
     plain version on an edge matrix (M 1/7/33 x K 1/5/129/2048 x N
     1/3/129/32000), ties, saturation, strided and unaligned x, and at
     the path's three shapes, where kernel, plain version, the library
     yardstick (torch._int_mm, the product alone) and the fp32 matmul
     are timed; then the fp32 LM's inference clone at batch 32,
     calibrated on 4 batches and decorated full_int8, against the same
     clone in fp32 (3 warm-up and 10 timed steps each): every loss
     finite, K4 launched exactly once a dense layer a step (12 FFN, 2
     lm_head chunks) and never by the fp32 clone, the int8 loss within
     1% of the fp32 loss; a profiled int8 step. Last, the int8 program
     card vs CPU at batch 2: every dense layer's output on the card
     bitwise the plain version's on its own input, the loss to rtol
     1e-4, a 1% act-scale fault caught at every layer.

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
H100_INT8_OPS = 1979e12      # int8 tensor cores, dense
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


# K2's timed shapes, each its main path's: (C, rows, window starts drawn
# from [lo, hi), the first rows' starts). C=1 is the serving phase
# (max_batch 32, positions up to 511: a full row, the first page, page
# edges); C=7 the linear leg (max_batch 8, 12-token prompts and 48 new
# tokens: a window starts at 12..58; the first and last start, one
# crossing a page)
PAGED_CASES = ((1, 32, 0, 512, (511, 0, 16, 17)),
               (7, 8, 12, 59, (12, 58, 13)))


def paged_inputs(torch, C, B, lo, hi, edges, seed=0):
    """Attention inputs at the serving path's width: B rows, H=8, Dh=64,
    block_size 16, 32 table slots (max_seq_len 512), a pool of B*32 + 1
    pages; row b's window covers positions pos0[b] .. pos0[b] + C - 1,
    pages scattered over the pool, null tails."""
    H, Dh, bs, Mb = 8, 64, 16, 32
    rng = np.random.RandomState(seed)
    pos0 = rng.randint(lo, hi, size=B)
    pos0[:len(edges)] = edges
    last = pos0 + C - 1
    pos = (pos0[:, None] + np.arange(C)[None, :]).astype(np.int32)
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
    for C, B, lo, hi, edges in PAGED_CASES:
        k, v, q, tables, pos = paged_inputs(torch, C, B, lo, hi, edges)
        got = pa_mod.paged_attention(k, v, q, tables, pos)
        want = pa_mod.paged_attention_reference(k, v, q, tables, pos)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail("paged_attention C=%d: non-finite output" % C)
        err = float((got - want).abs().max())
        if err > ATOL:
            fail("paged_attention C=%d disagrees with its plain version: "
                 "max abs err %.3g > %g" % (C, err, ATOL))
        _, _, H, Dh = q.shape
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
            "C": C, "shape": "B=%d H=8 Dh=64 bs=16 Mb=32 pool=%d pos %d..%d "
                             "fp32" % (B, k.shape[0], int(pos.min()),
                                       int(pos.max())),
            "max_abs_err": err, "max_err": err,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention over K/V gathered "
                       "contiguous outside the timed region (yardstick)"})
        print("kernel paged_attention C=%d %s: max_abs_err %.3g (limit %g), "
              "%.4f ms (plain %.4f ms, library %.4f ms, bound %.4f ms by %s)"
              % (C, rows[-1]["shape"], err, ATOL, ms, plain_ms, library_ms,
                 bound_ms, bound_by), flush=True)
        del k, v, q, k_ctx, v_ctx
    return rows


def tree_inputs(torch, W, D, B, H, Dh, bs, Mb, seed, edges=()):
    """A tree window's inputs on the card: pos0 drawn so the window fits
    the table (positions up to Mb*bs - 1), the first rows set to
    ``edges`` (a pos0 of 0 is an inactive row with an all-null table;
    one past Mb*bs - C runs the window past the table), pages scattered
    over the pool, null tails."""
    from paddle_tpu_torch.serving import tree_topology

    C = 1 + W * D
    T = Mb * bs
    rng = np.random.RandomState(seed)
    pos0 = rng.randint(1, T - C + 1, size=B)
    pos0[:len(edges)] = edges
    tables = np.zeros((B, Mb), np.int32)      # page 0: the null page
    perm = rng.permutation(B * Mb) + 1
    for b in range(B):
        if pos0[b]:
            n = min((pos0[b] + C - 1) // bs + 1, Mb)
            tables[b, :n] = perm[b * Mb:b * Mb + n]
    pos = (pos0[:, None] + np.arange(C)[None, :]).astype(np.int32)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn(B * Mb + 1, bs, H, Dh, device="cuda", generator=gen)
    v = torch.randn(B * Mb + 1, bs, H, Dh, device="cuda", generator=gen)
    q = torch.randn(B, C, H, Dh, device="cuda", generator=gen)
    anc = torch.from_numpy(tree_topology(W, D)[2]).cuda()
    return (k, v, q, torch.from_numpy(tables).cuda(),
            torch.from_numpy(pos).cuda(), anc)


def tree_mask(torch, pos, anc, T):
    """[B, C, T] visibility of the tree window: t < pos0, or t - pos0 a
    window slot that is the query's slot or one of its ancestors."""
    C = anc.shape[0]
    rel = (torch.arange(T, device=pos.device)[None, None, :]
           - pos[:, :1, None].long())
    in_win = (rel >= 0) & (rel < C)
    anc_t = anc[torch.arange(C, device=pos.device)[None, :, None],
                rel.clamp(0, C - 1)]
    return (rel < 0) | (in_win & anc_t)


def tree_check(torch, pat_mod, inputs, label):
    got = pat_mod.paged_attention_tree(*inputs)
    want = pat_mod.paged_attention_tree_reference(*inputs)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail("paged_attention_tree %s: non-finite output" % label)
    err = float((got - want).abs().max())
    if err > ATOL:
        fail("paged_attention_tree %s disagrees with its plain version: "
             "max abs err %.3g > %g" % (label, err, ATOL))
    print("kernel paged_attention_tree %s: max_abs_err %.3g (limit %g)"
          % (label, err, ATOL), flush=True)
    return got, err


# K3's edge matrix: (W, D, Dh, bs, edge rows' pos0)
TREE_EDGES = ((1, 6, 64, 16, (0, 125, 1)), (2, 6, 32, 16, (0, 120, 16)),
              (2, 6, 128, 16, (3, 127)), (3, 8, 64, 16, (0, 110, 5)),
              (1, 31, 128, 16, (97, 1)), (4, 4, 64, 5, (0, 37, 10)))


def tree_kernel_phase(torch, pa_mod, pat_mod):
    """K3 against its plain version on the edge matrix (width 1 also
    against K2) and at the tree leg's shape (B=8, C=13, H=8, Dh=64, bs
    16, 32 table slots, positions up to 511), where it is timed."""
    import torch.nn.functional as F

    for W, D, Dh, bs, edges in TREE_EDGES:
        inputs = tree_inputs(torch, W, D, B=6, H=4, Dh=Dh, bs=bs, Mb=8,
                             seed=W * 100 + D, edges=edges)
        got, _ = tree_check(torch, pat_mod, inputs,
                            "%dx%d Dh=%d bs=%d C=%d" % (W, D, Dh, bs,
                                                        1 + W * D))
        if W == 1 and 1 + D <= pa_mod.MAX_WINDOW:
            lin = pa_mod.paged_attention(*inputs[:5])
            torch.cuda.synchronize()
            err = float((got - lin).abs().max())
            if err > ATOL:
                fail("paged_attention_tree at width 1 disagrees with "
                     "paged_attention: %.3g" % err)
            print("kernel paged_attention_tree %dx%d vs paged_attention: "
                  "max_abs_err %.3g" % (W, D, err), flush=True)
    B, H, Dh, bs, Mb = 8, 8, 64, 16, 32
    inputs = tree_inputs(torch, 2, 6, B, H, Dh, bs, Mb, seed=0,
                         edges=(499, 1, 16, 243))
    label = "2x6 B=8 H=8 Dh=64 bs=16 Mb=32 pos<=511 fp32"
    _, err = tree_check(torch, pat_mod, inputs, label)
    k, v, q, tables, pos, anc = inputs
    T = Mb * bs
    mask = tree_mask(torch, pos, anc, T)                 # [B, C, T]
    # library yardstick: SDPA with the boolean tree mask over K/V
    # gathered contiguous outside the timed region
    tl = tables.long()
    k_ctx = k[tl].reshape(B, T, H, Dh).transpose(1, 2).contiguous()
    v_ctx = v[tl].reshape(B, T, H, Dh).transpose(1, 2).contiguous()
    q_l = q.transpose(1, 2).contiguous()
    lib_out = F.scaled_dot_product_attention(q_l, k_ctx, v_ctx,
                                             attn_mask=mask[:, None])
    want = pat_mod.paged_attention_tree_reference(*inputs)
    lib_err = float((lib_out.transpose(1, 2) - want).abs().max())
    if lib_err > ATOL:
        fail("library yardstick (tree) disagrees: %.3g" % lib_err)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(torch, lambda: pat_mod.paged_attention_tree(*inputs),
                 flush)
    plain_ms = time_ms(torch, lambda: pat_mod.paged_attention_tree_reference(
        *inputs), flush)
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q_l, k_ctx, v_ctx, attn_mask=mask[:, None]), flush)
    # bound: K and V of every position some slot of the row sees, read
    # once, q/tables/positions/anc read and the output written once;
    # against QK and PV over the (b, c, t) pairs the mask lets through
    row = H * Dh * 4
    nbytes = (2 * int(mask.any(dim=1).sum()) * row + 2 * q.numel() * 4
              + tables.numel() * 4 + pos.numel() * 4 + anc.numel())
    flops = 4 * int(mask.sum()) * H * Dh
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print("kernel paged_attention_tree %s: %.4f ms (plain %.4f ms, library "
          "%.4f ms, bound %.4f ms by %s)" % (label, ms, plain_ms, library_ms,
                                            bound_ms, bound_by), flush=True)
    del k, v, q, k_ctx, v_ctx, inputs
    return [{
        "name": "paged_attention_tree", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention_tree.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:475",
        "C": 13, "shape": label, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "library": "F.scaled_dot_product_attention with the boolean tree "
                   "mask over K/V gathered contiguous outside the timed "
                   "region (yardstick)"}]


def device_us(event):
    """A profiler event's own device time in microseconds."""
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def kernel_times(prof, steps, top=8):
    """(device busy seconds, the kernels with the most device time, per
    step) from a torch.profiler run over `steps` steps."""
    rows = []
    for e in prof.key_averages():
        us = device_us(e)
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
        pa_mod.paged_attention.window_launches.clear()   # main path starts
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
        by_c = dict(pa_mod.paged_attention.window_launches)  # main path ends
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
    launches = by_c.get(1, 0)
    if launches < 1 or by_c != {1: cfg.n_layers * steps}:
        fail("paged_attention launched %r times by window over %d decode "
             "steps (expected C=1: %d x %d)"
             % (by_c, steps, cfg.n_layers, steps))
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


# the speculative serving phase: the flagship decoder on bench.py's
# speculative traffic (bench_serving_spec, bench.py:774-776)
SPEC = dict(cfg=dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
                     d_ff=2048, max_seq_len=512),
            max_batch=8, block_size=16, n_requests=16, pattern_len=4,
            reps=3, max_new_tokens=48,
            legs=(("legacy", {"spec_k": 0}), ("linear", {"spec_k": 6}),
                  ("tree", {"spec_tree": "2x6"})))


def spec_prompts(vocab_size):
    """bench_serving_spec's generation set: RandomState(11), each prompt a
    random ``pattern_len``-token pattern repeated ``reps`` times —
    templated, repetitive traffic, what n-gram drafting serves."""
    rng = np.random.RandomState(11)
    return [rng.randint(0, vocab_size, size=SPEC["pattern_len"]).tolist()
            * SPEC["reps"] for _ in range(SPEC["n_requests"])]


def spec_serving_phase(torch, pa_mod, pat_mod, device=None):
    """The three speculative legs on one model (device None: cuda:0;
    the tests pass "cpu", where no kernel launches and none is counted).
    Returns (model, {leg: summary})."""
    from paddle_tpu_torch.serving import (GenerationConfig, GenerationModel,
                                          reference_decode)

    cfg = GenerationConfig(**SPEC["cfg"])
    model = GenerationModel.random(cfg, seed=0, device=device)
    prompts = spec_prompts(cfg.vocab_size)
    t0 = time.perf_counter()
    refs, margins = [], []
    for p in prompts:
        m = []
        refs.append(reference_decode(model, p, SPEC["max_new_tokens"],
                                     margins=m))
        margins.append(m)
    print("spec reference_decode: %d prompts x %d tokens in %.1f s, "
          "smallest top-2 logit margin %.3g"
          % (len(prompts), SPEC["max_new_tokens"], time.perf_counter() - t0,
             min(min(m) for m in margins)), flush=True)
    legs = {}
    for name, kw in SPEC["legs"]:
        legs[name] = spec_leg(torch, pa_mod, pat_mod, model, prompts, refs,
                              margins, name, kw)
    return model, legs


def spec_leg(torch, pa_mod, pat_mod, model, prompts, refs, margins, name,
             kw):
    """One leg: every request submitted at once, each checked against
    its reference, the drained pool audited and the launch counts held
    to the steps the leg took."""
    from paddle_tpu_torch.serving import ServingEngine

    cfg = model.config
    on_card = model.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with ServingEngine(model, max_batch=SPEC["max_batch"],
                       max_seq_len=cfg.max_seq_len,
                       block_size=SPEC["block_size"], device=model.device,
                       **kw) as engine:
        warm = engine.generate(prompts[0][:3], max_new_tokens=2, timeout=600)
        if len(warm) != 2:
            fail("spec %s: warm-up request returned %r" % (name, warm))
        base = engine.stats()
        sync()
        pa_mod.paged_attention.window_launches.clear()   # main path starts
        pat_mod.paged_attention_tree.launches = 0
        t0 = time.perf_counter()
        reqs = [engine.submit(p, max_new_tokens=SPEC["max_new_tokens"])
                for p in prompts]
        errors = []
        for r in reqs:
            try:
                r.wait(900)
            except Exception as e:  # every request's result is checked
                errors.append("request %d: %r" % (r.id, e))
        sync()
        wall = time.perf_counter() - t0
        k2 = dict(pa_mod.paged_attention.window_launches)
        k3 = pat_mod.paged_attention_tree.launches      # main path ends
        stats = engine.stats()
    pool = engine._worker.pool
    if errors:
        fail("spec %s: %d requests ended with an error: %s"
             % (name, len(errors), "; ".join(errors[:3])))
    for i, (r, ref) in enumerate(zip(reqs, refs)):
        if r.tokens != ref:
            at = next((j for j, (a, b) in enumerate(zip(r.tokens, ref))
                       if a != b), min(len(r.tokens), len(ref)))
            fail("spec %s: request %d differs from reference_decode at "
                 "generated token %d (got %r, reference %r; the reference's "
                 "top-2 logit margin there is %.3g)"
                 % (name, i, at, r.tokens[at:at + 1], ref[at:at + 1],
                    margins[i][at] if at < len(margins[i]) else float("nan")))
    problems = pool.check_invariants()
    pst = pool.stats()
    if problems or pst["blocks_in_use"] or pst["blocks_free"] != \
            pst["blocks_total"]:
        fail("spec %s: the pool did not drain clean: %r %r"
             % (name, problems[:3], pst))
    steps = stats["steps"] - base["steps"]
    spec_steps = stats["spec_steps"] - base["spec_steps"]
    tokens = sum(len(r.tokens) for r in reqs)
    if stats["spec_k"] and spec_steps < 1:
        fail("spec %s: no verify window ran" % name)
    if stats["spec_tree"] and stats["spec_tree_slots"] == \
            base["spec_tree_slots"]:
        fail("spec %s: no tree slot was verified" % name)
    if on_card:
        # one launch a layer: K2 at C=1 each one-token step, K2 at C=k+1
        # each linear window, K3 each tree window
        L = cfg.n_layers
        want_k2 = {1: L * (steps - spec_steps)}
        want_k3 = L * spec_steps if stats["spec_tree"] else 0
        if stats["spec_k"] and not stats["spec_tree"]:
            want_k2[stats["spec_k"] + 1] = L * spec_steps
        want_k2 = {c: n for c, n in want_k2.items() if n}
        if k2 != want_k2 or k3 != want_k3:
            fail("spec %s: over %d steps (%d verify windows) paged_attention "
                 "launched %r times by window and paged_attention_tree %d; "
                 "expected %r and %d"
                 % (name, steps, spec_steps, k2, k3, want_k2, want_k3))
    lat = np.array([r.latency for r in reqs])
    summary = {
        "leg": name, **kw,
        "requests": len(reqs), "generated_tokens": tokens,
        "reference_identical": len(reqs), "wall_s": wall,
        "tokens_per_s": tokens / wall, "target_steps": steps,
        "tokens_per_target_step": tokens / max(steps, 1),
        "verify_windows": spec_steps,
        "accept_rate": stats["spec_accept_rate"],
        "tree_slots": stats["spec_tree_slots"] - base["spec_tree_slots"],
        "tree_commits": stats["spec_tree_commits"]
        - base["spec_tree_commits"],
        "blocks_rolled_back": stats["spec_blocks_rolled_back"]
        - base["spec_blocks_rolled_back"],
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "paged_attention_launches_by_window": k2,
        "paged_attention_tree_launches": k3}
    print("spec_serving " + json.dumps(summary), flush=True)
    return summary


def spec_tree_profile(torch, model, tree=(2, 6)):
    """Where the time of one tree verify window goes: ``spec_tree_step``
    at the tree leg's shape (8 rows, C=13, positions 12..54, as the
    spec traffic's rows sit) under torch.profiler, tracing the card
    only: the host's wall time of the window, the device's busy time and
    share, and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import KVBlockPool, blocks_needed

    cfg = model.config
    B, bs = SPEC["max_batch"], SPEC["block_size"]
    C = 1 + tree[0] * tree[1]
    Mb = blocks_needed(cfg.max_seq_len, bs)
    pool = KVBlockPool(cfg.n_layers, cfg.n_heads, cfg.head_dim, bs, B * Mb,
                       device=model.device)
    dev = model.device
    rng = np.random.RandomState(3)
    pos = torch.tensor(12 + 6 * np.arange(B), dtype=torch.int32, device=dev)
    tables = torch.arange(1, B * Mb + 1, dtype=torch.int32,
                          device=dev).view(B, Mb)
    feed = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, C))
                            .astype(np.int32)).to(dev)
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    lengths = torch.full((B,), C, dtype=torch.int32, device=dev)
    prev = torch.zeros(B, dtype=torch.int32, device=dev)

    def window():
        return model.spec_tree_step(pool.k, pool.v, feed, ones, prev, pos,
                                    lengths, tables, ones, tree)

    window()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = window()
        out.cpu()
        wall = time.perf_counter() - t0
    busy_s, top = kernel_times(prof, 1, top=10)
    report = {"window": "%dx%d" % tree, "rows": B, "C": C,
              "wall_ms": wall * 1e3, "device_busy_ms": busy_s * 1e3,
              "device_busy_share": busy_s / wall, "top_kernels": top}
    print("spec_tree_profile " + json.dumps(report), flush=True)
    del pool
    return report


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


def lm_feed(torch, batch, device, seed=0):
    """bench.py's fixed batch: RandomState(0) tokens, labels shifted
    (another seed: another batch of the same kind)."""
    rng = np.random.RandomState(seed)
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


# full-int8 inference (phase 8): the fp32 LM's inference clone under
# quant.decorate(mode="full_int8") at bench.py's width, batch 32
INT8 = dict(batch=32, calib_batches=4, warmup=3, steps=10)
# K4's edge matrix: every (M, K, N) of these
INT8_EDGES = dict(M=(1, 7, 33), K=(1, 5, 129, 2048), N=(1, 3, 129, 32000))


def int8_path_shapes():
    """K4's (M, K, N) on the int8 LM path a step, with its launches a
    step: the two FFN layers of each layer and the lm_head's chunks."""
    B, T = INT8["batch"], TRAIN["seq_len"]
    D, F, V = TRAIN["d_model"], TRAIN["d_ff"], TRAIN["vocab_size"]
    chunk = min(T, 256)              # transformer_fluid's head chunk
    L = TRAIN["n_layers"]
    return {"ffn1": ((B * T, D, F), L), "ffn2": ((B * T, F, D), L),
            "lm_head": ((B * chunk, D, V), T // chunk)}


def int8_inputs(torch, M, K, N, seed, x=None):
    """K4's inputs on the card: x ~ 1.5 N(0, 1) (a few past the int8
    range at act_scale 127/3), w over the whole int8 range with -128 at
    every 7th element, a positive per-channel dq."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if x is None:
        x = 1.5 * torch.randn(M, K, device="cuda", generator=gen)
    w = torch.randint(-128, 128, (K, N), dtype=torch.int8, device="cuda",
                      generator=gen)
    w.view(-1)[::7] = -128
    dq = (torch.rand(N, device="cuda", generator=gen) + 0.1) * (3 / 127 ** 2)
    return x, w, dq, 127.0 / 3.0


def int8_check(torch, im, x, w, dq, s, label):
    """K4 against its plain version, bitwise (fp32 bit patterns)."""
    got = im.int8_matmul(x, w, dq, s)
    want = im.int8_matmul_reference(x, w, dq, s)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(
            got.view(torch.int32), want.view(torch.int32)):
        diff = (got - want).abs()
        fail("int8_matmul %s differs from its plain version: max |diff| "
             "%.3g, %d elements" % (label, float(diff.max()),
                                    int((diff > 0).sum())))
    return got


def int8_kernel_phase(torch, im):
    """K4 against its plain version on the card, bitwise: the edge
    matrix, ties and saturation, strided and unaligned x, then the
    path's three shapes, where kernel, plain version, torch._int_mm
    (the product alone, on pre-quantized operands: the library
    yardstick) and the fp32 torch.matmul the fp32 program pays are
    timed."""
    n = 0
    for M in INT8_EDGES["M"]:
        for K in INT8_EDGES["K"]:
            for N in INT8_EDGES["N"]:
                int8_check(torch, im, *int8_inputs(torch, M, K, N, seed=n),
                           label="M=%d K=%d N=%d" % (M, K, N))
                n += 1
    # ties: x * 2 lands on k + 0.5; saturation past +-127.5 and +-inf
    k = torch.arange(-300, 300, device="cuda", dtype=torch.float32)
    _, w, dq, _ = int8_inputs(torch, 6, 100, 40, seed=100)
    int8_check(torch, im, (k / 2 + 0.25).view(6, 100), w, dq, 2.0, "ties")
    sat = torch.tensor([127.49, 127.5, 127.51, 300.0, 1e30, float("inf"),
                        -127.5, -128.49, -128.5, -128.51, -300.0,
                        -float("inf")], device="cuda")
    _, w, dq, _ = int8_inputs(torch, 2, 12, 40, seed=101)
    int8_check(torch, im, torch.stack([sat, sat.flip(0)]), w, dq, 1.0,
               "saturation")
    # strided: a sequence slice of [B, T, K] (16-byte rows), and a 2-D
    # view with odd row stride and a 4-byte offset (the scalar loads)
    base = 1.5 * torch.randn(4, 64, 132, device="cuda")
    _, w, dq, s = int8_inputs(torch, 4 * 32, 132, 72, seed=102)
    int8_check(torch, im, base[:, 32:], w, dq, s, "3-D sequence slice")
    base = 1.5 * torch.randn(33, 131, device="cuda")
    _, w, dq, s = int8_inputs(torch, 33, 129, 129, seed=103)
    int8_check(torch, im, base[:, 1:130], w, dq, s, "unaligned 2-D view")
    print("kernel int8_matmul: %d edge shapes (M %s, K %s, N %s), ties, "
          "saturation, strided and unaligned x: bitwise its plain version"
          % (n, INT8_EDGES["M"], INT8_EDGES["K"], INT8_EDGES["N"]),
          flush=True)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    B, T = INT8["batch"], TRAIN["seq_len"]
    for i, (name, ((M, K, N), _)) in enumerate(int8_path_shapes().items()):
        if name == "lm_head":   # chunk 0's rows of h, read in place
            h = 1.5 * torch.randn(B, T, K, device="cuda")
            x = h[:, :M // B]
        else:
            x = 1.5 * torch.randn(B, T, K, device="cuda")
        _, w, dq, s = int8_inputs(torch, M, K, N, seed=200 + i, x=x)
        got = int8_check(torch, im, x, w, dq, s, "%s M=%d K=%d N=%d"
                         % (name, M, K, N))
        x2 = x.reshape(M, K)
        qa = torch.clamp(torch.round(x2 * float(np.float32(s))), -128,
                         127).to(torch.int8)
        w32 = w.float()
        ms = time_ms(torch, lambda: im.int8_matmul(x, w, dq, s), flush)
        plain_ms = time_ms(torch, lambda: im.int8_matmul_reference(
            x, w, dq, s), flush, iters=5)
        fp32_ms = time_ms(torch, lambda: torch.matmul(x2, w32), flush)
        # library yardstick: the int8 product alone, int32 out
        if not torch.equal((torch._int_mm(qa, w).float() * dq)
                           .view(torch.int32),
                           got.reshape(M, N).view(torch.int32)):
            fail("library yardstick torch._int_mm disagrees at %s" % name)
        library_ms = time_ms(torch, lambda: torch._int_mm(qa, w), flush)
        nbytes = M * K * 4 + K * N + N * 4 + M * N * 4
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 2 * M * K * N / \
            H100_INT8_OPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        shape = "%s M=%d K=%d N=%d%s" % (
            name, M, K, N, " (x a strided view)" if name == "lm_head" else "")
        print("kernel int8_matmul %s: bitwise, %.4f ms (plain %.4f ms, "
              "library %.4f ms, fp32 matmul %.4f ms, bound %.4f ms by %s)"
              % (shape, ms, plain_ms, library_ms, fp32_ms, bound_ms,
                 bound_by), flush=True)
        rows.append({
            "name": "int8_matmul", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "paddle_tpu/ops/pallas_kernels.py:598",
            "path_shape": name, "mkn": [M, K, N], "shape": shape,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "torch._int_mm on pre-quantized int8 operands: the "
                       "product alone (yardstick)",
            "fp32_matmul_ms": fp32_ms})
        del x, w, dq, x2, qa, w32, got
    torch.cuda.empty_cache()
    return rows


def dense_sites(program):
    """[(activation, weight, output)] of every mul of the program: the
    dense layers quant_rewrite turns into fused int8 matmuls; the
    lm_head chunks' read the weight lm_head_w and output the logits."""
    return [(op.input_names("X")[0], op.input_names("Y")[0],
             op.output_names("Out")[0])
            for op in program.global_block().ops if op.type == "mul"]


def baked(scope, suffix):
    """The one value quant_rewrite baked into `scope` for `suffix`
    ("<weight>.int8", "<output>.qdq")."""
    names = [n for n in scope.local_var_names()
             if n.startswith("__quant__.") and n.endswith("." + suffix)]
    if len(names) != 1:
        fail("int8: %d baked scope entries end in %r" % (len(names), suffix))
    return scope.get(names[0])


def int8_phase(torch, fluid, im, program):
    """The fp32 LM's inference clone at batch 32, calibrated on 4 batches
    and decorated full_int8, against the same clone in fp32: 3 warm-up
    and 10 timed steps each on bench.py's batch. Every loss finite, K4
    launched exactly once a dense layer a step at the path's shapes (none
    by the fp32 program), the int8 loss within 1% of the fp32 loss; then
    the logits of both, the quant/* counters and a profiled int8 step.
    Returns K4's launches by (M, K, N) in the int8 run."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import quant
    from paddle_tpu_torch.observability import metrics

    main, startup, loss = program
    B, warmup, steps = INT8["batch"], INT8["warmup"], INT8["steps"]
    metrics.enable()
    exe = fluid.Executor()                     # place None: cuda:0
    if exe.device.type != "cuda":
        fail("the executor resolved to %s, not the card" % exe.device)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.reset_peak_memory_stats()
    infer = main.clone(for_test=True)
    calib = [lm_feed(torch, B, exe.device, seed=s)
             for s in range(1, 1 + INT8["calib_batches"])]
    t0 = time.perf_counter()
    table = quant.calibrate(infer, calib, scope=scope)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    del calib
    int8 = quant.decorate(main.clone(for_test=True), "full_int8", table)
    feed = lm_feed(torch, B, exe.device)
    n = warmup + steps
    want = {mkn: per_step * n
            for mkn, per_step in int8_path_shapes().values()}
    runs = {}
    for name, prog in (("fp32", infer), ("int8", int8)):
        torch.cuda.synchronize()
        im.int8_matmul.launches.clear()            # main path starts
        losses = []
        for i in range(n):
            if i == warmup:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            out, = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)
            losses.append(out)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = dict(im.int8_matmul.launches)   # main path ends
        losses = [float(x.cpu()[0]) for x in losses]
        if not all(np.isfinite(losses)):
            fail("int8 inference: non-finite %s loss %r" % (name, losses))
        if launches != (want if name == "int8" else {}):
            fail("int8 inference: the %s program launched int8_matmul %r "
                 "times by (M, K, N) over %d steps; expected %r"
                 % (name, launches, n, want if name == "int8" else {}))
        step_s = (t2 - t1) / steps
        runs[name] = {"losses": losses, "ms_per_step": step_s * 1e3,
                      "tokens_per_s": B * TRAIN["seq_len"] / step_s,
                      "launches": launches}
    l32, l8 = runs["fp32"]["losses"][-1], runs["int8"]["losses"][-1]
    logits = [out for _, w, out in dense_sites(infer) if w == "lm_head_w"]
    lo32 = exe.run(infer, feed=feed, fetch_list=logits, scope=scope,
                   return_numpy=False)
    lo8 = exe.run(int8, feed=feed, fetch_list=logits, scope=scope,
                  return_numpy=False)
    err = max(float((a - b).abs().max()) for a, b in zip(lo8, lo32))
    top1 = float(sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                     for a, b in zip(lo8, lo32))
                 / sum(a[..., 0].numel() for a in lo8))
    del lo32, lo8
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tp = time.perf_counter()
        for _ in range(2):
            exe.run(int8, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tp
    busy_s, top = kernel_times(prof, 2, top=10)
    k4_s = sum(device_us(e) for e in prof.key_averages()
               if "int8_mm" in e.key) / 1e6
    counters = {k: v for k, v in metrics.registry().to_dict()["counters"]
                .items() if k.startswith("quant/")}
    summary = {
        "model": "Fluid-API Transformer LM, fp32 inference clone: vocab "
                 "32000, d_model 512, 8 heads, 6 layers, d_ff 2048, seq 512",
        "batch": B, "calib_batches": INT8["calib_batches"],
        "calib_s": calib_s, "warmup_steps": warmup, "timed_steps": steps,
        "loss_rel_diff": abs(l8 - l32) / abs(l32),
        "logits_max_abs_err": err, "top1_agreement": top1,
        "quant_counters": counters,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    for name in runs:   # JSON keys: "MxKxN"
        summary[name] = dict(runs[name], launches={
            "x".join(map(str, k)): v
            for k, v in runs[name]["launches"].items()})
    print("int8_inference " + json.dumps(summary), flush=True)
    print("int8_profile " + json.dumps({
        "steps": 2, "wall_ms_per_step": wall * 1e3 / 2,
        "device_busy_ms_per_step": busy_s * 1e3 / 2,
        "device_busy_share": busy_s / wall,
        "int8_matmul_ms_per_step": k4_s * 1e3 / 2,
        "int8_matmul_share_of_busy": k4_s / busy_s,
        "top_kernels": top}), flush=True)
    if not abs(l8 - l32) <= 0.01 * abs(l32):
        fail("int8 inference: loss %r is not within 1%% of the fp32 loss %r"
             % (l8, l32))
    return runs["int8"]["launches"]


def int8_logits_excess(lo_got, lo_want, dq):
    """(largest |diff| over its limit, share of rows that differ) of one
    lm_head chunk's logits [B, T, V], against the bound
    tests/test_torch_quant.py holds the port to the JAX package with: at
    most 1 in 32 rows may differ, and those by at most 1e-5 + 16 * 127 *
    dq[n]. The two sides run the
    fp32 parts of the network (layer norms, attention, gelu, the GEMMs)
    in other summation orders; quantizing turns that into an int8 step
    only where x * act_scale lies that close to a rounding tie; one step
    moves each of the row's outputs by at most 127 dq[n], and a step in
    an FFN layer moves the rows after it, so a differing row may hold
    several. A wrong quantization scale moves almost every row."""
    diff = np.abs(lo_got - lo_want).reshape(-1, lo_got.shape[-1])
    limit = 1e-5 + 16 * 127 * np.asarray(dq, np.float32)[None, :]
    return (float((diff / limit).max()),
            float((diff > 0).any(axis=1).mean()))


def int8_card_vs_cpu_phase(torch, fluid, im, program,
                           devices=("cuda:0", "cpu")):
    """The int8 program from one set of weights and one table (made on
    the card from its own batch), at batch 2, on cuda:0 (K4) and on the
    CPU (the plain version). Every dense layer's output on the card must
    be bitwise the plain version's on the card's own input, with the
    weights, scales and dequantize vectors the CPU run baked; the loss to
    rtol 1e-4; and both lm_head chunks' logits are read against
    `int8_logits_excess`'s bound. A run on the card with every activation
    range 1% too large must fail the layer check at every layer, or the
    check could not see a wrong scale. `devices` is (card, reference);
    the tests pass two CPUs."""
    from paddle_tpu_torch import quant

    main, startup, loss = program
    exe_c, exe_h = fluid.Executor(devices[0]), fluid.Executor(devices[1])
    scope_c, scope_h = fluid.Scope(), fluid.Scope()
    exe_c.run(startup, scope=scope_c)
    for name in scope_c.local_var_names():
        if name != "__step_counter__":
            scope_h.set(name, scope_c.get(name).to("cpu", copy=True))
    infer = main.clone(for_test=True)
    sites = dense_sites(infer)
    heads = [out for _, w, out in sites if w == "lm_head_w"]
    n = len(sites)
    fetch = [loss] + [a for a, _, _ in sites] + [o for _, _, o in sites]
    feed = lm_feed(torch, 2, exe_c.device)
    table = quant.calibrate(infer, [feed], scope=scope_c, place=devices[0])
    t0 = time.perf_counter()
    card = exe_c.run(quant.decorate(main.clone(for_test=True), "full_int8",
                                    table),
                     feed=feed, fetch_list=fetch, scope=scope_c)
    host = exe_h.run(quant.decorate(main.clone(for_test=True), "full_int8",
                                    table),
                     feed=lm_feed(torch, 2, exe_h.device), fetch_list=fetch,
                     scope=scope_h)
    seconds = time.perf_counter() - t0
    wrong = quant.CalibrationTable.from_dict(table.to_dict())
    wrong.acts = {k: v * 1.01 for k, v in wrong.acts.items()}
    fault = exe_c.run(quant.decorate(main.clone(for_test=True), "full_int8",
                                     wrong),
                      feed=feed, fetch_list=fetch, scope=scope_c)

    def layers_differing(run):
        """Sites whose output is not bitwise the plain version's on the
        run's own input, with the right table."""
        bad = []
        for i, (act, w, out) in enumerate(sites):
            want = im.int8_matmul_reference(
                torch.from_numpy(run[1 + i]), baked(scope_h, w + ".int8"),
                baked(scope_h, out + ".qdq"),
                127.0 / max(table.acts[act], 1e-8)).numpy()
            if not np.array_equal(run[1 + n + i].view(np.int32),
                                  want.view(np.int32)):
                bad.append(out)
        return bad

    bad, fault_caught = layers_differing(card), layers_differing(fault)
    loss_rel = abs(float(card[0][0]) - float(host[0][0])) / abs(
        float(host[0][0]))
    chunks = [int8_logits_excess(card[1 + n + i], host[1 + n + i],
                                 baked(scope_h, out + ".qdq").numpy())
              for i, (_, _, out) in enumerate(sites) if out in heads]
    report = {"batch": 2, "dense_layers": n, "layers_not_bitwise": bad,
              "loss_cuda": float(card[0][0]), "loss_cpu": float(host[0][0]),
              "loss_rel_diff": loss_rel,
              "logits_excess_and_rows_differing": chunks,
              "act_scale_1pct_fault_layers_caught": len(fault_caught),
              "seconds": seconds}
    print("int8_card_vs_cpu " + json.dumps(report), flush=True)
    if bad:
        fail("int8 card vs CPU: %d of %d dense layers are not bitwise the "
             "plain version on their own input: %s" % (len(bad), n, bad))
    if not loss_rel <= 1e-4:
        fail("int8 card vs CPU: losses %r vs %r (rel %.3g > 1e-4)"
             % (float(card[0][0]), float(host[0][0]), loss_rel))
    if len(fault_caught) != n:
        fail("int8 card vs CPU: a 1%% act-scale fault passes the layer check "
             "at %d of %d layers" % (n - len(fault_caught), n))


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
    from paddle_tpu_torch.ops import int8_matmul as im_mod
    from paddle_tpu_torch.ops import paged_attention as pa_mod
    from paddle_tpu_torch.ops import paged_attention_tree as pat_mod

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
    tree_rows = tree_kernel_phase(torch, pa_mod, pat_mod)
    flash_rows = flash_phase(torch, fa_mod)
    launches = serving_phase(torch, pa_mod)
    spec_model, legs = spec_serving_phase(torch, pa_mod, pat_mod)
    spec_tree_profile(torch, spec_model)
    del spec_model
    # each row's launches are its own main path's: the serving phase for
    # the one-token decode (C=1), the linear leg for C=7, the tree leg
    # for the tree window
    for row in rows:
        row["launches"] = (launches if row["C"] == 1 else
                           legs["linear"]["paged_attention_launches_by_window"]
                           .get(row["C"], 0))
    tree_rows[0]["launches"] = legs["tree"]["paged_attention_tree_launches"]
    program = build_lm(fluid)
    fwd, bwd = training_phase(torch, fa_mod, fluid, program)
    flash_rows[0]["launches"], flash_rows[1]["launches"] = fwd, bwd
    card_vs_cpu_phase(torch, fluid, program, "bfloat16")
    del program
    program = build_lm(fluid, "float32")
    card_vs_cpu_phase(torch, fluid, program, "float32")
    int8_rows = int8_kernel_phase(torch, im_mod)
    int8_launches = int8_phase(torch, fluid, im_mod, program)
    for row in int8_rows:
        row["launches"] = int8_launches.get(tuple(row["mkn"]), 0)
    int8_card_vs_cpu_phase(torch, fluid, im_mod, program)
    print(json.dumps({"kernels": rows + tree_rows + flash_rows + int8_rows}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
