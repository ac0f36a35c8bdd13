"""The port's bench: bench.py's native flagship (`bench_transformer`
:24-106), its headline training legs
(`bench_transformer_fluid` :109-225, `TINY` :229), its serving legs
(`bench_serving` :553, `bench_serving_fastpath` :659,
`bench_serving_spec` :731, `bench_serving_quant` :1242), its predictor
leg (`bench_quant_predictor` :1146), its fleet
and online legs (`bench_serving_fleet` :836, `bench_serving_online`
:906), its resilience and ingestion legs (`bench_resilience_overhead`
:250, `bench_data_ingestion` :314), its ZeRO ladder receipt
(`bench_zero` :1020), with its `main`'s leg selection (:1735-1903).

    python -m paddle_tpu_torch.bench [--steps N] [--warmup N] [--tiny]
                                     [--sync-only] [--amp-only]
                                     [--serving-only] [--spec-only]
                                     [--quant-only] [--fleet-only]
                                     [--online-only] [--resilience]
                                     [--data-only] [--zero-only]
                                     [--place cpu]

trains the flagship Fluid-API Transformer LM (vocab 32000, d_model 512, 8
heads, 6 layers, d_ff 2048, seq 512, batch 160, ``remat=False``) through
the port's entry points on the card, in bench.py's legs:

    async     bf16 under the legacy AMP decorator, every run() async: the
              executor's in-flight window (12 steps) is the only
              backpressure, one sync at the end
    sync      the same, every step's loss copied to the host
    noopt     sync under PTPU_NO_PROGRAM_OPT=1 (the pass pipeline off)
    fp32      the model stored and computed in fp32, plain SGD
    amp       the fp32-stored model under ``amp.decorate`` (bf16)
    amp_fp16  the same under ``amp.decorate(dtype="float16")``: dynamic
              loss scaling from 2**15 (a port leg: bench.py has none)

then serves bench.py's serving receipts at bench.py's own sizes through
the port's ``ServingEngine``:

    serving_batched / serving_serial    a Poisson stream through a
              16-slot engine and one request at a time (bench_serving)
    serving_fastpath / serving_legacy_prefill   shared-system-prompt
              traffic with chunked prefill and the prefix cache, and
              without (bench_serving_fastpath)
    serving_spec / _baseline / _tree / _int8    repetitive traffic with
              linear speculation, without, as a 2x6 tree drafted by a
              ModelDrafter, and that tree over the int8 weight store
              (bench_serving_spec)
    quant_fp32_predictor / quant_int8_predictor     an MLP classifier
              saved and served by the fp32 and the full-int8
              AnalysisPredictor (bench_quant_predictor)
    serving_fp32_ref / serving_int8     one request set over fp32 weights
              and the weight-only int8 store (bench_serving_quant)
    serving_fleet_1r / serving_fleet_2r     one request set through a
              1-replica and a 2-replica ServingRouter (bench_serving_fleet)
    online_steady / online_rollout      a 2-replica fleet steady and while
              an OnlineUpdater rolls a new weight version across it
              (bench_serving_online; only with --online-only, as in
              bench.py)

and prints one JSON line with bench.py's keys for them, the card's name
and power limit, and each training leg's device and host ms a step. With
metrics on (``PTPU_METRICS=1``) the async, sync, fp32, amp, amp_fp16 and
serving_batched legs carry bench.py's MFU receipt: ``step_flops`` (the
step's count, ``observability/cost.py``) and ``mfu_pct`` against the
card's peak. It
prints no ``vs_baseline``: bench.py's baseline is a TPU-era figure.
``--resilience`` (on under ``--tiny``, as in bench.py) adds the
``resilience_unguarded`` / ``resilience_guarded`` legs: a small fc
program's step time with and without ``ResilientTrainer``'s guard at one
sync cadence, and bench.py's ``step_time_guarded_s``,
``step_time_unguarded_s`` and ``guard_overhead_pct``. ``--data-only``
runs only the ingestion pair (records/s through a 2-thread QueueDataset
onto the card, healthy and with one shard quarantined) and prints
bench.py's ``data_degraded_throughput_ratio`` line with its
``records_lost``. ``--zero-only`` runs only the ZeRO ladder receipt
(``bench_zero``: one MLP through per-leaf and bucketed ZeRO-1, ZeRO-2
with overlap, ZeRO-3 and offload on the process's data group, world 1
unless the fleet's env contract says more) and prints bench.py's
``zero_overlap_speedup`` line. ``--tiny`` is bench.py's CI configuration (TINY, host
feeds through the prefetcher); ``--sync-only`` skips the async leg,
``--amp-only`` runs only fp32, amp and amp_fp16; ``--serving-only`` the
serving, fast-path and speculative pairs, ``--spec-only`` the
speculative legs, ``--quant-only`` the int8 predictor and serving pairs,
``--fleet-only`` the fleet pair and ``--online-only`` the online pair;
the flags combine
as bench.py's do, except that ``--online-only`` joins the others instead
of replacing them. With ``--online-only`` alone the line's metric is
bench.py's ``online_rollout_throughput_ratio``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch.async_engine import as_numpy
from paddle_tpu_torch.models import transformer_fluid

__all__ = ["NATIVE_ADAM", "TINY", "bench_data_ingestion",
           "bench_quant_predictor", "bench_resilience_overhead",
           "bench_serving",
           "bench_serving_fastpath",
           "bench_serving_fleet", "bench_serving_online",
           "bench_serving_quant", "bench_serving_spec", "bench_transformer",
           "bench_transformer_fluid", "bench_zero", "build_program",
           "last_leg",
           "last_native", "main", "native_adam", "native_config",
           "native_grads", "native_state", "native_train_step",
           "zero_line"]

# bench_transformer's Adam (bench.py:53)
NATIVE_ADAM = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8)
# the loss is copied to the host every this many steps (bench.py:84)
SYNC_EVERY = 12

# what the last bench_transformer call saw, beside its return value (read
# by chip_smoke.py): "losses" every step's loss, "batch", "seq", "remat",
# "config" (the TransformerConfig), "warmup", "steps",
# "step_ms" each timed step's device time and "host_ms" the host's time
# to enqueue it (step_ms None on the CPU), "peak_bytes" the card's peak
# allocation over the timed steps (None on the CPU), "step_flops" the
# first step's count with metrics on (else None)
last_native = {}


def native_config(batch=192, seq=512, remat=None, dtype="bfloat16",
                  **overrides):
    """bench.py's native configuration: vocab 32000, d_model 512, 8
    heads, 6 layers, d_ff 2048, max_seq_len `seq`, bf16, ``remat =
    batch >= 64`` unless given; `overrides` replace any field."""
    from paddle_tpu_torch.models.transformer import TransformerConfig

    if remat is None:
        remat = batch >= 64
    kw = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
              d_ff=2048, max_seq_len=seq, dtype=dtype, remat=remat)
    kw.update(overrides)
    return TransformerConfig(**kw)


def native_state(cfg, device=None):
    """bench.py's starting state: ``init_params`` (a generator seeded 0,
    bench.py's ``PRNGKey(0)``) with every fp32 leaf of two or more dims stored in the
    config's dtype (bench.py's rule for its bf16 config: the [L, D]
    layer-norm leaves and b1 / b2 too, final_ln_* stay fp32), fp32
    moments at zero, the int32 step counter at 0. Returns (params, m, v,
    t)."""
    import torch

    from paddle_tpu_torch.models import transformer

    params = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device=device)
    params = transformer.tree_map(
        lambda x: x.to(cfg.dtype)
        if x.dtype == torch.float32 and x.ndim >= 2 else x, params)
    m = transformer.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    v = transformer.tree_map(torch.zeros_like, m)
    t = torch.zeros((), dtype=torch.int32,
                    device=transformer.tree_leaves(params)[0].device)
    return params, m, v, t


def native_grads(params, tokens, labels, cfg):
    """The loss (``single_chip_loss``) and the grad of every leaf, in
    ``tree_leaves`` order; a leaf the loss never reads (b2) gets a zero
    grad. Returns (loss, grads)."""
    import torch

    from paddle_tpu_torch.models import transformer

    with torch.enable_grad():
        leaves = [p.detach().requires_grad_()
                  for p in transformer.tree_leaves(params)]
        it = iter(leaves)
        loss = transformer.single_chip_loss(
            transformer.tree_map(lambda _: next(it), params), tokens,
            labels, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if g is None else g
                           for g, x in zip(grads, leaves)]


def native_adam(params, grads, m, v, t):
    """bench.py's Adam (:61-70) over every leaf, in place: bias
    correction from the int32 step counter, each element in bench.py's
    order of operations (``b1 ** tf`` an fp32 power of the fp32 step),
    the new parameter rounded to its leaf's dtype. Returns t + 1."""
    import torch

    from paddle_tpu_torch.models import transformer

    lr, b1, b2, eps = (NATIVE_ADAM[k] for k in ("lr", "b1", "b2", "eps"))
    t = t + 1
    tf = t.to(torch.float32)
    with torch.no_grad():
        c1 = 1 - b1 ** tf
        c2 = 1 - b2 ** tf
        for p, g, mm, vv in zip(transformer.tree_leaves(params), grads,
                                transformer.tree_leaves(m),
                                transformer.tree_leaves(v)):
            gf = g.float()
            mm.mul_(b1).add_((1 - b1) * gf)
            vv.mul_(b2).add_((1 - b2) * gf * gf)
            p.copy_(p.float() - lr * (mm / c1) / (torch.sqrt(vv / c2) + eps))
    return t


def native_train_step(params, m, v, t, tokens, labels, cfg):
    """bench.py's ``train_step`` (:55-73): ``native_grads``, then
    ``native_adam``. The leaves of `params`, `m` and `v` are updated in
    place (bench.py donates them). Returns (params, m, v, t + 1,
    loss)."""
    loss, grads = native_grads(params, tokens, labels, cfg)
    t = native_adam(params, grads, m, v, t)
    return params, m, v, t, loss


def bench_transformer(steps=24, warmup=3, batch=192, seq=512, remat=None,
                      device=None):
    """bench.py's native flagship training throughput (:24-106) on
    `device` (None: the card): ``native_config(batch, seq, remat)``,
    ``native_state``, and `warmup` + `steps` ``native_train_step``s on
    bench.py's batch (RandomState(0) tokens, labels rolled by one), fixed
    on the device; the loss copied to the host every ``SYNC_EVERY``
    steps and after the last. With metrics on, the first warm-up step is
    counted (``observability/cost.py``) and published. Returns
    (tokens_per_sec, last_loss); ``last_native`` keeps the rest."""
    import torch

    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.observability import cost as obs_cost

    device = resolve_device(device)
    cuda = device.type == "cuda"
    cfg = native_config(batch, seq, remat)
    state = native_state(cfg, device)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    labs = np.roll(toks, -1, axis=1).astype(np.int32)
    tokens = torch.from_numpy(toks).to(device)
    labels = torch.from_numpy(labs).to(device)
    losses, step_flops = [], None
    for i in range(warmup):
        with obs_cost.first_step(i == 0, device) as count:
            *state, loss = native_train_step(*state, tokens, labels, cfg)
        if count is not None:
            step_flops = count.flops
        losses.append(loss)
        float(loss)
    marks, host_ms = [], []
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for i in range(steps):
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        th = time.perf_counter()
        *state, loss = native_train_step(*state, tokens, labels, cfg)
        host_ms.append((time.perf_counter() - th) * 1e3)
        losses.append(loss)
        if (i + 1) % SYNC_EVERY == 0:
            float(loss)
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    last = float(loss)
    dt = time.perf_counter() - t0
    last_native.clear()
    last_native.update(
        losses=[float(x) for x in losses], batch=batch, seq=seq,
        remat=cfg.remat, config=cfg, warmup=warmup, steps=steps,
        step_ms=[a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        if cuda else None,
        host_ms=host_ms,
        peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else None,
        step_flops=step_flops)
    return steps * batch * seq / dt, last

# bench.py's CI configuration: the whole async pipeline (window,
# prefetched host feeds) in seconds
TINY = dict(
    model_kwargs=dict(vocab_size=512, d_model=64, n_heads=2, n_layers=2,
                      d_ff=128),
    batch=8, seq=32, steps=6, warmup=1,
)

# what the last bench_transformer_fluid call saw, beside its return value
# (read by chip_smoke.py and main): "losses" every step's loss, "batch",
# "step_ms" each timed step's device time and "host_ms" the host's time
# to enqueue it (both None on the CPU), "peak_bytes" the card's peak
# allocation over the leg (None on the CPU), "window_peak" the deepest
# the in-flight window got, and for a dynamically scaled leg
# "found_inf" each step's overflow flag and "scaling" the final loss
# scale and good / bad step counts
last_leg = {}


def build_program(seq=512, dtype="bfloat16", amp="legacy",
                  model_kwargs=None):
    """bench.py's program (bench.py:152-178): the LM, SGD(0.01) under the
    precision scheme `amp` names, and the compile-pipeline receipt (a
    foldable constant chain, a CSE-able pair, a fetch-dead branch).
    `amp`: "legacy" the contrib decorator at a static scale of 1; True
    ``amp.decorate`` (bf16); "float16" ``amp.decorate(dtype="float16")``;
    False plain SGD. Returns (main, startup, loss, optimizer)."""
    prog, sprog = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, sprog):
        _t, _l, loss = transformer_fluid.build(
            seq_len=seq, remat=False, dtype=dtype, **(model_kwargs or {}))
        if amp == "legacy":
            opt = fluid.contrib.mixed_precision.decorate(
                fluid.optimizer.SGD(0.01), init_loss_scaling=1.0,
                use_dynamic_loss_scaling=False)
        elif amp == "float16":
            opt = fluid.amp.decorate(fluid.optimizer.SGD(0.01),
                                     dtype="float16")
        elif amp:
            opt = fluid.amp.decorate(fluid.optimizer.SGD(0.01))
        else:
            opt = fluid.optimizer.SGD(0.01)
        opt.minimize(loss)
        _c = fluid.layers.scale(
            fluid.layers.fill_constant([1], "float32", 1.5), scale=0.5)
        _d1 = fluid.layers.scale(loss, scale=3.0)
        _d2 = fluid.layers.scale(loss, scale=3.0)
        fluid.layers.elementwise_add(
            fluid.layers.elementwise_add(_d1, _d2), _c)
    return prog, sprog, loss, opt


def bench_transformer_fluid(steps=24, warmup=3, batch=160, seq=512,
                            async_exec=True, feed_mode="device",
                            model_kwargs=None, program_opt=True,
                            dtype="bfloat16", amp="legacy", place=None):
    """The flagship trained through the port's Fluid API: bench.py's
    function of the same name, on `place` (None: the card; "cpu" for the
    tests). Returns (tokens_per_sec, last_loss, step_s, compile_time_s):
    compile_time_s is the first warmup step's time (program optimization
    and the first run), None with warmup=0.

    async_exec: every run() returns lazy fetches and the executor's
    in-flight window (async_steps=12) is the only backpressure; False
    copies each step's loss to the host. feed_mode "device" keeps the
    fixed batch on the device; "host" feeds numpy each step through
    ``Executor.prefetch``. program_opt=False runs under
    PTPU_NO_PROGRAM_OPT=1. dtype and amp choose the precision scheme
    (`build_program`)."""
    import torch

    prog, sprog, loss, opt = build_program(seq, dtype, amp, model_kwargs)
    exe = fluid.Executor(place, async_steps=12)
    scope = fluid.Scope()
    cuda = exe.device.type == "cuda"
    prev_opt = os.environ.get("PTPU_NO_PROGRAM_OPT")
    if not program_opt:
        os.environ["PTPU_NO_PROGRAM_OPT"] = "1"
    # dynamic loss scaling's overflow counter, read back once a step on
    # the device (a copy, no sync) to recover each step's overflow flag
    ovf = getattr(opt, "_overflow_steps", None) \
        if getattr(opt, "_use_dynamic", False) else None
    try:
        exe.run(sprog, scope=scope)
        vocab = (model_kwargs or {}).get("vocab_size", 32000)
        rng = np.random.RandomState(0)
        toks = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
        labs = np.roll(toks, -1, axis=1).astype(np.int32)
        if feed_mode == "device":
            feed = {"tokens": torch.from_numpy(toks).to(exe.device),
                    "labels": torch.from_numpy(labs).to(exe.device)}
        else:
            feed = {"tokens": toks, "labels": labs}
        outs, marks, host_ms, ovf_trace = [], [], [], []
        if cuda:
            torch.cuda.synchronize(exe.device)
            torch.cuda.reset_peak_memory_stats(exe.device)

        def one_step(timed):
            if timed and cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            th = time.perf_counter()
            if feed_mode != "device":
                exe.prefetch(feed)
            out, = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=not async_exec)
            if timed:
                host_ms.append((time.perf_counter() - th) * 1e3)
            if ovf is not None:
                ovf_trace.append(scope.get(ovf.name).clone())
            outs.append(out)
            return out

        def value(out):
            return float(as_numpy(out).ravel()[0])

        compile_time_s = None
        for i in range(warmup):
            t0 = time.perf_counter()
            value(one_step(False))
            if i == 0:
                compile_time_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(steps):
            out = one_step(True)
            if not async_exec:
                value(out)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        last = value(out)  # the one sync point
        dt = time.perf_counter() - t0
        window_peak = exe._window.peak
        exe.close()
    finally:
        if not program_opt:
            if prev_opt is None:
                os.environ.pop("PTPU_NO_PROGRAM_OPT", None)
            else:
                os.environ["PTPU_NO_PROGRAM_OPT"] = prev_opt
    last_leg.clear()
    last_leg.update(
        losses=[value(o) for o in outs], batch=batch,
        step_ms=[a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        if cuda else None,
        host_ms=host_ms,
        peak_bytes=torch.cuda.max_memory_allocated(exe.device)
        if cuda else None,
        window_peak=window_peak)
    if ovf is not None:
        counts = [int(as_numpy(t).ravel()[0]) for t in ovf_trace]
        last_leg["found_inf"] = [b - a for a, b in zip([0] + counts,
                                                      counts)]
        last_leg["scaling"] = {
            k: float(as_numpy(scope.get(v.name)).ravel()[0])
            for k, v in (("loss_scale", opt._loss_scaling),
                         ("good_steps", opt._good_steps),
                         ("bad_steps", opt._bad_steps))}
    return steps * batch * seq / dt, last, dt / steps, compile_time_s


# what each engine of the last serving bench call saw, beside the
# function's return value (read by chip_smoke.py): {leg: {"stats" the
# engine's final stats, {model name: {...}} (warm-up and priming
# requests included),
# "drafter_chunk" its ModelDrafter's catch-up chunk or None, "model" the
# model it served, and over the timed request set "prompts", "outputs",
# "requests", "generated_tokens", "wall_s", "latency_p50_s",
# "latency_p99_s", "ttft_p50_s", "ttft_p99_s"}}
last_serving = {}


def _record(leg, eng, reqs, wall):
    """Close ``eng`` and record its leg, the timed requests ``reqs``
    served in ``wall`` seconds, in ``last_serving``; returns the default
    model's final stats (read once its worker settled)."""
    stats = _settled_stats(eng)
    eng.close()
    lat = [r.latency for r in reqs]
    ttft = [r.ttft for r in reqs]
    w = eng._workers[eng._default]
    last_serving[leg] = {
        "stats": stats,
        "drafter_chunk": getattr(w.drafter, "_chunk", None),
        "model": w.model,
        "prompts": [list(r.prompt) for r in reqs],
        "outputs": [list(r.tokens) for r in reqs],
        "requests": len(reqs),
        "generated_tokens": sum(len(r.tokens) for r in reqs),
        "wall_s": wall,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p99_s": float(np.percentile(ttft, 99))}
    return stats[eng._default]


def _settled_stats(eng):
    """``eng.stats()`` once the worker has finished the round that
    completed the last request: a round counts a request's tokens after
    the request completes, so a read right after ``wait`` may miss the
    last round's (bench.py reads racing it)."""
    w = eng._workers[eng._default]
    with w._cv:
        while len(w.queue) or w.scheduler.has_work() or w._inflight:
            w._cv.wait(timeout=0.005)
        return eng.stats()


def _serving_model(place, vocab, d_model, n_heads, n_layers, d_ff,
                   max_seq_len):
    from paddle_tpu_torch import serving

    cfg = serving.GenerationConfig(
        vocab_size=vocab, d_model=d_model, n_heads=n_heads,
        n_layers=n_layers, d_ff=d_ff, max_seq_len=max_seq_len)
    return serving.GenerationModel.random(cfg, seed=0, device=place)


def bench_serving(n_requests=32, max_new_tokens=24, rate=100000.0,
                  max_batch=16, vocab=256, d_model=64, n_heads=2,
                  n_layers=2, d_ff=128, max_seq_len=128, place=None):
    """Continuous-batching serving throughput, bench.py's function on
    `place` (None: the card): one deterministic Poisson request stream
    (seed 0) served through a ``max_batch``-slot engine, then one
    request at a time through a 1-slot engine; both legs must be
    token-identical. Each engine serves one warm-up request first.

    Returns (batched_tps, serial_tps, outputs_match, p50_s, p99_s,
    total_tokens, batched_steps_per_sec, batched_step_flops);
    batched_step_flops is the batched engine's counted step
    (``exec/step_flops``, read before the serial engine counts its own),
    None with metrics off."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.observability import metrics as obs_metrics

    last_serving.clear()
    model = _serving_model(place, vocab, d_model, n_heads, n_layers, d_ff,
                           max_seq_len)
    gen = serving.PoissonLoadGenerator(
        rate, n_requests, prompt_len=(4, 12),
        max_new_tokens=max_new_tokens, vocab_size=vocab, seed=0)

    eng = serving.ServingEngine(model, max_batch=max_batch,
                                max_seq_len=max_seq_len, block_size=16,
                                device=place)
    t0 = time.perf_counter()
    eng.generate([1, 2], max_new_tokens=2, timeout=600)
    compile_batched_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    accepted, rejected = gen.run(eng)
    batched_outs = [r.wait(600) for r in accepted]
    dt_batched = time.perf_counter() - t0
    lats = sorted(r.latency for r in accepted)
    steps_batched = _record("batched", eng, accepted, dt_batched)["steps"]
    total_tokens = sum(len(o) for o in batched_outs)
    batched_step_flops = _current_step_flops()

    eng1 = serving.ServingEngine(model, max_batch=1,
                                 max_seq_len=max_seq_len, block_size=16,
                                 device=place)
    eng1.generate([1, 2], max_new_tokens=2, timeout=600)
    t0 = time.perf_counter()
    serial = []
    for spec in gen.make_requests():   # eng1.generate, the request kept
        serial.append(eng1.submit(spec["prompt"],
                                  max_new_tokens=spec["max_new_tokens"]))
        serial[-1].wait(600)
    serial_outs = [r.tokens for r in serial]
    dt_serial = time.perf_counter() - t0
    _record("serial", eng1, serial, dt_serial)
    obs_metrics.registry().gauge(
        "bench/serving_compile_time_s").set(compile_batched_s)

    if rejected:
        raise RuntimeError("serving bench rejected %d requests — grow "
                           "max_queue" % len(rejected))

    def pct(q):
        return lats[min(len(lats) - 1, int(round(q * (len(lats) - 1))))]

    return (total_tokens / dt_batched,
            sum(len(o) for o in serial_outs) / dt_serial,
            batched_outs == serial_outs, pct(0.5), pct(0.99),
            total_tokens, steps_batched / dt_batched, batched_step_flops)


def _current_step_flops():
    """The last counted step's FLOPs (``exec/step_flops``, published at a
    plan's or a window shape's first step when metrics are on; None with
    metrics off: nothing was counted)."""
    from paddle_tpu_torch.observability import metrics as obs_metrics

    if not obs_metrics.enabled():
        return None
    return obs_metrics.registry().to_dict().get(
        "gauges", {}).get("exec/step_flops")


def _mfu_extra(step_flops, steps_per_sec, place=None):
    """bench.py's MFU receipt for one leg: the step's FLOPs against the
    peak of the card the leg ran on (`place`; None: the card,
    ``observability.cost``). Returns the leg's fields and publishes
    ``bench/mfu_pct``; {} when metrics are off or the leg has no step
    cadence."""
    if not step_flops or not steps_per_sec:
        return {}
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.observability import cost as obs_cost
    from paddle_tpu_torch.observability import metrics as obs_metrics

    pct = obs_cost.mfu_pct(step_flops, steps_per_sec, resolve_device(place))
    obs_metrics.registry().gauge("bench/mfu_pct").set(pct)
    return {"step_flops": step_flops, "mfu_pct": round(pct, 4)}


def bench_serving_fastpath(n_requests=10, max_new_tokens=8,
                           prefix_len=64, max_batch=8, vocab=256,
                           d_model=64, n_heads=2, n_layers=2, d_ff=128,
                           max_seq_len=160, block_size=16, chunk=16,
                           place=None):
    """The serving fast-path receipt, bench.py's function on `place`:
    shared-system-prompt traffic (RandomState(11): a ``prefix_len``-token
    prefix, then a 2-8-token tail a prompt) through the legacy engine
    and through chunked prefill (``chunk``) with the prefix cache, each
    after a priming request that seals the shared blocks; both legs
    held to ``reference_decode``.

    Returns {"legacy": leg, "fast": leg, "ttft_speedup",
    "prefix_hit_rate", "outputs_match"}, each leg {"outputs_match",
    "ttft_p50", "tokens_per_sec", "prefix_blocks_reused"}."""
    from paddle_tpu_torch import serving

    last_serving.clear()
    model = _serving_model(place, vocab, d_model, n_heads, n_layers, d_ff,
                           max_seq_len)
    rng = np.random.RandomState(11)
    shared = rng.randint(0, vocab, size=prefix_len).tolist()
    prompts = [shared + rng.randint(
        0, vocab, size=int(rng.randint(2, 9))).tolist()
        for _ in range(n_requests)]
    refs = [serving.reference_decode(model, p, max_new_tokens)
            for p in prompts]
    shared_blocks = prefix_len // block_size

    def run_leg(leg, **kw):
        eng = serving.ServingEngine(model, max_batch=max_batch,
                                    max_seq_len=max_seq_len,
                                    block_size=block_size, device=place,
                                    **kw)
        eng.generate(shared + [7], max_new_tokens=2, timeout=600)
        primed_reuse = _settled_stats(eng)["default"][
            "prefix_blocks_reused"]
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=max_new_tokens)
                for p in prompts]
        outs = [r.wait(600) for r in reqs]
        wall = time.perf_counter() - t0
        ttfts = sorted(r.ttft for r in reqs)
        stats = _record(leg, eng, reqs, wall)
        return {
            "outputs_match": outs == refs,
            "ttft_p50": ttfts[len(ttfts) // 2],
            "tokens_per_sec": sum(len(o) for o in outs) / wall,
            "prefix_blocks_reused":
                stats["prefix_blocks_reused"] - primed_reuse,
        }

    legacy = run_leg("legacy")
    fast = run_leg("fast", prefill_chunk=chunk, prefix_cache=True)
    possible = n_requests * shared_blocks
    return {
        "legacy": legacy,
        "fast": fast,
        "ttft_speedup": legacy["ttft_p50"] / fast["ttft_p50"],
        "prefix_hit_rate": fast["prefix_blocks_reused"] / possible,
        "outputs_match": legacy["outputs_match"]
            and fast["outputs_match"],
    }


def bench_serving_spec(n_requests=6, max_new_tokens=48, spec_k=6,
                       max_batch=2, vocab=64, d_model=64, n_heads=2,
                       n_layers=2, d_ff=128, max_seq_len=256,
                       block_size=16, chunk=8, pattern_len=4, reps=3,
                       place=None):
    """The speculative-decoding receipt, bench.py's function on `place`:
    repetitive prompts (RandomState(11): a ``pattern_len``-token pattern
    repeated ``reps`` times) served one at a time over chunked prefill
    (``chunk``) in four legs: legacy (no speculation), spec (linear
    window of ``spec_k``), tree (a 2 x ``spec_k`` tree drafted by a
    ``ModelDrafter`` over the target) and int8 (the tree over the int8
    weight store for both the drafter and the target, held to
    ``reference_decode`` over the dequantized weights). Each leg serves
    a priming request first. ``tokens_per_step`` counts target steps;
    draft-side dispatches are ``draft_steps``.

    Returns {"legacy", "spec", "tree", "int8": leg, "tree_shape",
    "tokens_per_step_speedup", "tree_speedup_vs_linear", "accept_rate",
    "outputs_match"}, each leg {"outputs_match", "tokens_per_sec",
    "tokens_per_step", "steps", "draft_steps", "accept_rate"}."""
    from paddle_tpu_torch import serving

    last_serving.clear()
    model = _serving_model(place, vocab, d_model, n_heads, n_layers, d_ff,
                           max_seq_len)
    rng = np.random.RandomState(11)
    prompts = [(rng.randint(0, vocab, size=pattern_len).tolist()) * reps
               for _ in range(n_requests)]
    refs = [serving.reference_decode(model, p, max_new_tokens)
            for p in prompts]

    def run_leg(leg, k, tree=None, mdl=model, rf=refs, drafter=None):
        eng = serving.ServingEngine(mdl, max_batch=max_batch,
                                    max_seq_len=max_seq_len,
                                    block_size=block_size,
                                    prefill_chunk=chunk, spec_k=k,
                                    spec_tree=tree, drafter=drafter,
                                    device=place)
        eng.generate(prompts[0][:3], max_new_tokens=2, timeout=600)
        base = _settled_stats(eng)["default"]
        t0 = time.perf_counter()
        reqs = []
        for p in prompts:               # eng.generate, the request kept
            reqs.append(eng.submit(p, max_new_tokens=max_new_tokens))
            reqs[-1].wait(600)
        outs = [r.tokens for r in reqs]
        wall = time.perf_counter() - t0
        st = _record(leg, eng, reqs, wall)
        gen = st["generated_tokens"] - base["generated_tokens"]
        steps = st["steps"] - base["steps"]
        return {
            "outputs_match": outs == rf,
            "tokens_per_sec": sum(len(o) for o in outs) / wall,
            "tokens_per_step": gen / max(1, steps),
            "steps": steps,
            "draft_steps": (st["spec_draft_steps"]
                            - base["spec_draft_steps"]),
            "accept_rate": st["spec_accept_rate"],
        }

    legacy = run_leg("legacy", 0)
    spec = run_leg("spec", spec_k)
    tree_shape = "2x%d" % spec_k
    tree = run_leg("tree", 0, tree=tree_shape,
                   drafter=serving.ModelDrafter(model))
    qmodel = model.quantized()
    qrefs = [serving.reference_decode(qmodel, p, max_new_tokens)
             for p in prompts]
    int8 = run_leg("int8", 0, tree=tree_shape, mdl=qmodel, rf=qrefs,
                   drafter=serving.ModelDrafter(qmodel))
    return {
        "legacy": legacy,
        "spec": spec,
        "tree": tree,
        "int8": int8,
        "tree_shape": tree_shape,
        "tokens_per_step_speedup": (spec["tokens_per_step"]
                                    / legacy["tokens_per_step"]),
        "tree_speedup_vs_linear": (tree["tokens_per_step"]
                                   / spec["tokens_per_step"]),
        "accept_rate": spec["accept_rate"],
        "outputs_match": (legacy["outputs_match"]
                          and spec["outputs_match"]
                          and tree["outputs_match"]
                          and int8["outputs_match"]),
    }


def bench_serving_quant(n_requests=16, max_new_tokens=16, max_batch=8,
                        vocab=256, d_model=64, n_heads=2, n_layers=2,
                        d_ff=128, max_seq_len=128, place=None):
    """The quantized serving receipt, bench.py's function on `place`:
    one request set (a Poisson generator's, seed 0) decoded through a
    continuously-batched engine over fp32 weights and over the
    weight-only int8 store (``GenerationModel.quantized()``), each after
    a warm-up request. The int8 leg must be token-identical to
    ``reference_decode`` over its dequantized weights; its per-token
    agreement with the fp32 leg is the quantization-noise receipt.

    Returns (int8_tps, fp32_tps, int8_matches_reference,
    token_agreement_vs_fp32, total_tokens)."""
    from paddle_tpu_torch import serving

    last_serving.clear()
    model = _serving_model(place, vocab, d_model, n_heads, n_layers, d_ff,
                           max_seq_len)
    qmodel = model.quantized()
    specs = serving.PoissonLoadGenerator(
        1e9, n_requests, prompt_len=(4, 12),
        max_new_tokens=max_new_tokens, vocab_size=vocab,
        seed=0).make_requests()

    def run_leg(leg, m):
        eng = serving.ServingEngine(m, max_batch=max_batch,
                                    max_seq_len=max_seq_len,
                                    block_size=16, device=place)
        eng.generate([1, 2], max_new_tokens=2, timeout=600)
        t0 = time.perf_counter()
        reqs = [eng.submit(s["prompt"],
                           max_new_tokens=s["max_new_tokens"])
                for s in specs]
        outs = [r.wait(600) for r in reqs]
        dt = time.perf_counter() - t0
        _record(leg, eng, reqs, dt)
        return sum(len(o) for o in outs) / dt, outs

    fp32_tps, fp32_outs = run_leg("fp32", model)
    int8_tps, int8_outs = run_leg("int8", qmodel)
    refs = [serving.reference_decode(qmodel, s["prompt"],
                                     s["max_new_tokens"])
            for s in specs]
    matches_ref = int8_outs == refs
    agree_n = agree_d = 0
    for a, b in zip(int8_outs, fp32_outs):
        for ta, tb in zip(a, b):
            agree_n += int(ta == tb)
            agree_d += 1
    agreement = agree_n / max(agree_d, 1)
    return (int8_tps, fp32_tps, matches_ref, agreement,
            sum(len(o) for o in int8_outs))


def bench_quant_predictor(batches=24, batch=64, in_dim=64, hidden=256,
                          n_classes=16, warmup=3, place=None):
    """The fp32-vs-int8 predictor receipt, bench.py's function on
    `place`: an MLP classifier (in_dim -> hidden -> hidden -> n_classes,
    relu) saved with ``io.save_inference_model`` and served three ways —
    a plain fp32 ``AnalysisPredictor``, ``full_int8`` (calibrated on the
    first 4 of `batches` RandomState(0) batches; each fc one fused int8
    matmul, K4) and ``weight_only`` (``convert_to_int8``'s int8 store).
    Each leg runs `warmup` batches, then all `batches` timed, the host
    feeds copied in each run. Returns bench.py's dict: examples/s of the
    fp32 and int8 legs, their ratio, the logits' max abs error and top-1
    agreement of int8 against fp32, and the weight store's bytes saved
    over its fp32 bytes."""
    import shutil
    import tempfile

    from paddle_tpu_torch import inference, quant

    prog, sprog = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, sprog):
        x = fluid.layers.data(name="qb_x", shape=[in_dim], dtype="float32")
        h = fluid.layers.fc(input=x, size=hidden, act="relu")
        h = fluid.layers.fc(input=h, size=hidden, act="relu")
        logits = fluid.layers.fc(input=h, size=n_classes)
    exe = fluid.Executor(place)
    outdir = tempfile.mkdtemp(prefix="ptpu_quant_bench_")
    try:
        with fluid.scope_guard(fluid.Scope()):
            exe.run(sprog)
            fluid.io.save_inference_model(outdir, ["qb_x"], [logits], exe,
                                          main_program=prog)
        exe.close()
        rng = np.random.RandomState(0)
        eval_feeds = [rng.uniform(-1, 1, (batch, in_dim))
                      .astype(np.float32) for _ in range(batches)]

        def config(mode=None, table=None):
            cfg = inference.AnalysisConfig(outdir)
            if exe.device.type == "cpu":
                cfg.disable_gpu()
            else:
                cfg.enable_use_gpu(device_id=exe.device.index)
            if mode:
                cfg.enable_quantize(mode, calibration_table=table)
            return cfg

        p_fp32 = inference.AnalysisPredictor(config())
        table = quant.calibrate(
            p_fp32._program, ({"qb_x": f} for f in eval_feeds[:4]),
            scope=p_fp32._scope, place=exe.device)
        p_int8 = inference.AnalysisPredictor(config("full_int8", table))
        # the weight store of the weight_only predictor: its scope holds
        # the int8 twins instead of the fp32 weights
        p_wo = inference.AnalysisPredictor(config("weight_only"))
        fp32_bytes = saved_bytes = 0
        for name in table.weights:
            q = p_wo._scope.get(name + ".int8")
            if q is None:
                continue
            w = p_fp32._scope.get(name)
            fp32_bytes += w.numel() * w.element_size()
            saved_bytes += (w.numel() * w.element_size()
                            - q.numel() * q.element_size())
        saved_ratio = saved_bytes / fp32_bytes if fp32_bytes else 0.0

        def run_leg(pred):
            for f in eval_feeds[:warmup]:
                pred.run_dict({"qb_x": f})
            outs = []
            t0 = time.perf_counter()
            for f in eval_feeds:
                out, = pred.run_dict({"qb_x": f})
                outs.append(np.asarray(out))
            dt = time.perf_counter() - t0
            return batches * batch / dt, outs

        fp32_eps, fp32_outs = run_leg(p_fp32)
        int8_eps, int8_outs = run_leg(p_int8)
        max_err = max(float(np.abs(a - b).max())
                      for a, b in zip(fp32_outs, int8_outs))
        agree = float(np.mean([
            np.argmax(a, axis=1) == np.argmax(b, axis=1)
            for a, b in zip(fp32_outs, int8_outs)]))
        return {
            "fp32_examples_per_sec": fp32_eps,
            "int8_examples_per_sec": int8_eps,
            "speedup_vs_fp32": int8_eps / fp32_eps,
            "max_abs_err": max_err,
            "top1_agreement": agree,
            "weight_bytes_saved_ratio": saved_ratio,
        }
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def bench_serving_fleet(n_requests=16, max_new_tokens=16, max_batch=4,
                        vocab=256, d_model=64, n_heads=2, n_layers=2,
                        d_ff=128, max_seq_len=128, block_size=16,
                        place=None):
    """The fleet scaling receipt, bench.py's function on `place`: one
    request set (RandomState(23): 16 prompts of 4-12 tokens) through a
    1-replica and a 2-replica ``ServingRouter`` over one model (random
    weights, seed 0). ``max_batch`` makes one replica batch-bound: the
    fleet's win is the second replica's slots and worker thread (on the
    card, its own stream). Each leg first serves one primer a replica,
    submitted together so least-loaded dispatch lands one on each.
    Outputs must equal ``reference_decode`` on both legs.

    Returns {"one": leg, "two": leg, "scaling", "outputs_match"}, each
    leg {"tokens_per_sec", "outputs_match", "replicas_used",
    "failovers", "shed_requests"}. ``last_serving`` keeps each leg's
    router stats ("router"), prompts, outputs and model."""
    from paddle_tpu_torch import serving

    last_serving.clear()
    model = _serving_model(place, vocab, d_model, n_heads, n_layers, d_ff,
                           max_seq_len)
    rng = np.random.RandomState(23)
    prompts = [rng.randint(0, vocab, size=int(rng.randint(4, 12))).tolist()
               for _ in range(n_requests)]
    refs = [serving.reference_decode(model, p, max_new_tokens)
            for p in prompts]

    def run_leg(n_replicas):
        router = serving.ServingRouter(
            model, replicas=n_replicas, max_batch=max_batch,
            max_seq_len=max_seq_len, block_size=block_size, device=place)
        primers = [router.submit([1, 2], max_new_tokens=2)
                   for _ in range(n_replicas)]
        for p in primers:
            p.wait(600)
        t0 = time.perf_counter()
        reqs = [router.submit(p, max_new_tokens=max_new_tokens)
                for p in prompts]
        outs = [r.wait(600) for r in reqs]
        wall = time.perf_counter() - t0
        st = _settled_router_stats(router)
        router.close()
        last_serving["%dr" % n_replicas] = {
            "router": st, "prompts": prompts, "outputs": outs,
            "model": model, "wall_s": wall}
        return {
            "tokens_per_sec": sum(len(o) for o in outs) / wall,
            "outputs_match": outs == refs,
            "replicas_used": sum(1 for r in st["replicas"]
                                 if r["model:default"]["steps"] > 0),
            "failovers": st["failovers"],
            "shed_requests": st["shed_requests"],
        }

    one = run_leg(1)
    two = run_leg(2)
    return {
        "one": one,
        "two": two,
        "scaling": two["tokens_per_sec"] / one["tokens_per_sec"],
        "outputs_match": one["outputs_match"] and two["outputs_match"],
    }


def _settled_router_stats(router):
    """``router.stats()`` once every live replica's worker has finished
    its rounds (``_settled_stats``: a read right after ``wait`` may miss
    a replica's last round)."""
    for i in range(router.num_replicas):
        eng = router.replica_engine(i)
        for w in eng._workers.values():
            with w._cv:
                while w.error is None and w._thread.is_alive() and (
                        len(w.queue) or w.scheduler.has_work()
                        or w._inflight):
                    w._cv.wait(timeout=0.005)
    return router.stats()


# bench.py's online leg builds a one-layer toy program
ONLINE_MODEL = dict(d_model=16, n_heads=2, n_layers=1, d_ff=32, seq_len=8)


def bench_serving_online(n_requests=24, max_new_tokens=12, vocab=64,
                         max_seq_len=32, max_batch=4, block_size=4,
                         model_kwargs=None, place=None, workdir=None):
    """The online hot-swap receipt, bench.py's function on `place`: one
    request set (RandomState(31): 24 prompts of 3-8 tokens) through a
    2-replica fleet twice, once steady and once while an
    ``OnlineUpdater`` publishes and rolls a new weight version across it
    mid-stream (drain -> swap -> undrain, one replica at a time;
    ``canary_pct=None``). The program is ``transformer_fluid.build(
    vocab_size=vocab, remat=False, **model_kwargs)`` (bench.py's toy
    ``ONLINE_MODEL`` by default; ``{}`` is the flagship); its startup
    program runs on `place`, v0 is exported from it, and the startup
    state perturbed (N(0, 0.02) from the same RandomState) is checkpoint
    1, saved between the legs. Every output must equal
    ``reference_decode`` under the weight version that served it, and no
    request may be lost. Artifacts and checkpoints go to `workdir` (kept)
    or a temporary directory (removed).

    Returns {"steady_tokens_per_sec", "rollout_tokens_per_sec",
    "rollout_throughput_ratio", "outputs_match", "requests_lost",
    "versions_published", "swaps", "final_versions"}. ``last_serving``
    keeps the router's stats ("router"), the updater's ("updater"), the
    artifact directories ("v0_dir", "v1_dir"), and each leg's prompts,
    outputs and serving versions."""
    import shutil
    import tempfile
    import threading

    from paddle_tpu_torch import checkpoint as _ckpt
    from paddle_tpu_torch import inference, serving

    last_serving.clear()
    base = workdir or tempfile.mkdtemp(prefix="ptpu_bench_online_")
    try:
        prog, sprog = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, sprog):
            transformer_fluid.build(
                vocab_size=vocab, remat=False,
                **(ONLINE_MODEL if model_kwargs is None else model_kwargs))
        scope = fluid.Scope()
        fluid.Executor(place).run(sprog, scope=scope)
        v0_dir = os.path.join(base, "v0")
        inference.export_generation_model(v0_dir, prog, scope,
                                          max_seq_len=max_seq_len)
        ckpt_dir = os.path.join(base, "ckpts")
        pub_dir = os.path.join(base, "pub")
        os.makedirs(ckpt_dir)
        rng = np.random.RandomState(31)
        prompts = [rng.randint(0, vocab, size=int(rng.randint(3, 8))).tolist()
                   for _ in range(n_requests)]
        state = {}
        for name in scope.local_var_names():
            v = as_numpy(scope.get(name))
            if np.issubdtype(v.dtype, np.floating):
                v = v + rng.normal(0, 0.02, v.shape).astype(v.dtype)
            state[name] = v
        with serving.ServingRouter(v0_dir, replicas=2, max_batch=max_batch,
                                   max_seq_len=max_seq_len,
                                   block_size=block_size, backoff_base=0.0,
                                   health_interval_s=0.02,
                                   device=place) as router:
            upd = serving.OnlineUpdater(router, ckpt_dir, pub_dir, prog,
                                        max_seq_len=max_seq_len,
                                        canary_pct=None)
            for p in [router.submit([1, 2], max_new_tokens=2)
                      for _ in range(2)]:
                p.wait(600)

            def run_leg(rollout_mid_stream):
                t0 = time.perf_counter()
                reqs = [router.submit(p, max_new_tokens=max_new_tokens)
                        for p in prompts]
                roll = None
                if rollout_mid_stream:
                    roll = threading.Thread(target=upd.poll_once,
                                            name="bench-online-rollout")
                    roll.start()
                outs = [r.wait(600) for r in reqs]
                wall = time.perf_counter() - t0
                if roll is not None:
                    roll.join()
                return outs, [r.weight_version for r in reqs], wall

            steady_outs, steady_vers, steady_wall = run_leg(False)
            _ckpt.save_checkpoint(ckpt_dir, state, 1)
            roll_outs, roll_vers, roll_wall = run_leg(True)
            st = _settled_router_stats(router)
        v1_dir = os.path.join(pub_dir, "v1")
        models = {0: inference.load_generation_model(v0_dir, device=place)}
        if os.path.isdir(v1_dir):
            models[1] = inference.load_generation_model(v1_dir,
                                                        device=place)
        refs = {}
        match = True
        for o, v, p in zip(steady_outs + roll_outs,
                           steady_vers + roll_vers, prompts + prompts):
            key = (v, tuple(p))
            if key not in refs:
                refs[key] = (serving.reference_decode(
                    models[v], p, max_new_tokens) if v in models else None)
            match = match and o == refs[key]
        last_serving["online"] = {
            "router": st, "updater": upd.stats(), "v0_dir": v0_dir,
            "v1_dir": v1_dir, "models": models, "prompts": prompts,
            "outputs": {"steady": steady_outs, "rollout": roll_outs},
            "versions": {"steady": steady_vers, "rollout": roll_vers},
            "wall_s": {"steady": steady_wall, "rollout": roll_wall}}
        steady_tps = sum(len(o) for o in steady_outs) / steady_wall
        roll_tps = sum(len(o) for o in roll_outs) / roll_wall
        return {
            "steady_tokens_per_sec": steady_tps,
            "rollout_tokens_per_sec": roll_tps,
            "rollout_throughput_ratio": roll_tps / steady_tps,
            "outputs_match": match,
            "requests_lost": (st["requests_submitted"]
                              - st["requests_completed"]
                              - st["requests_failed"]),
            "versions_published": upd.versions_published,
            "swaps": upd.swaps,
            "final_versions": sorted(r["weight_version"]
                                     for r in st["replicas"]),
        }
    finally:
        if workdir is None:
            shutil.rmtree(base, ignore_errors=True)


def bench_resilience_overhead(steps=48, warmup=8, batch=64, guard_every=8,
                              place=None):
    """Guarded vs unguarded steady-state step time on a small train
    program (bench.py's function, on `place`): fc 64 -> relu -> fc 1,
    square error, SGD 0.01, one RandomState(0) batch of `batch` rows.
    Both legs share ONE program, executor and private scope and the SAME
    sync cadence — the unguarded loop also copies every `guard_every`
    steps' losses to the host — so the difference is what the guard
    adds: the host-side isfinite/EMA scan and one scope snapshot per
    validated boundary. Returns (unguarded_step_s, guarded_step_s)."""
    from paddle_tpu_torch.resilience import ResilientTrainer

    prog, sprog = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, sprog):
        x = fluid.layers.data(name="rx", shape=[64], dtype="float32")
        y = fluid.layers.data(name="ry", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=64, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(0.01).minimize(loss)
    # private scope: the guard snapshots the whole training scope
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(sprog, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"rx": rng.uniform(-1, 1, (batch, 64)).astype(np.float32),
            "ry": rng.uniform(-1, 1, (batch, 1)).astype(np.float32)}

    def unguarded(n):
        pending = []
        for _ in range(n):
            out, = exe.run(prog, feed=feed, fetch_list=[loss],
                           scope=scope, return_numpy=False)
            pending.append(out)
            if len(pending) >= guard_every:
                as_numpy(pending)
                pending = []
        as_numpy(pending)

    trainer = ResilientTrainer(exe, prog, fetch_list=[loss], scope=scope,
                               guard_every=guard_every)

    def guarded(n):
        trainer.run({"rx": feed["rx"], "ry": feed["ry"]}
                    for _ in range(n))

    unguarded(warmup)
    guarded(warmup)
    t0 = time.perf_counter()
    unguarded(steps)
    t1 = time.perf_counter()
    guarded(steps)
    t2 = time.perf_counter()
    exe.close()
    return (t1 - t0) / steps, (t2 - t1) / steps


def bench_data_ingestion(n_shards=8, records_per_shard=2048, width=32,
                         batch_size=256, repeats=3, place=None):
    """Streaming-ingestion receipt (bench.py's function): records/s
    through the fault-tolerant QueueDataset reader (2 threads, the batch
    prefetcher), each batch staged onto `place` by the feed prefetcher as
    ``Executor.train_from_dataset`` stages it, healthy vs degraded (one
    mid-list shard with a flipped byte, QUARANTINED by the containment
    policy). The degraded leg reads fewer records, so its receipt is
    throughput on the surviving stream: degraded / healthy records/s.
    Best of `repeats` each. Returns bench.py's dict."""
    import shutil
    import tempfile
    import warnings

    from paddle_tpu_torch import data_plane
    from paddle_tpu_torch.async_engine import FeedPrefetcher, prefetch_iter
    from paddle_tpu_torch.core.place import resolve_device

    device = resolve_device(place)

    class _Var:
        def __init__(self, name):
            self.name = name

    tmp = tempfile.mkdtemp(prefix="ptpu_bench_data_")
    try:
        paths = []
        payload = np.arange(width, dtype=np.float32)
        for i in range(n_shards):
            p = "%s/shard%02d.rec" % (tmp, i)

            def gen(i=i):
                for j in range(records_per_shard):
                    yield (payload + i * records_per_shard + j,
                           np.int64(i * records_per_shard + j))

            fluid.convert_reader_to_recordio_file(p, gen)
            paths.append(p)

        def make_ds():
            ds = fluid.DatasetFactory().create_dataset("QueueDataset")
            ds.set_filelist(paths)
            ds.set_batch_size(batch_size)
            ds.set_use_var([_Var("x"), _Var("y")])
            ds.set_thread(2)
            return ds

        def run_leg():
            best = None
            n_records = 0
            for _ in range(repeats):
                t0 = time.perf_counter()
                n_records = 0
                feeder = FeedPrefetcher(device)
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        for staged in prefetch_iter(
                                make_ds()._batches_prefetched(), feeder):
                            n_records += staged.consume(device)[
                                "y"].shape[0]
                finally:
                    feeder.close()
                if device.type == "cuda":
                    import torch

                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
                data_plane.reset_quarantine()  # re-detect per repeat
            return n_records / best, n_records

        healthy_rps, healthy_records = run_leg()

        # damage one mid-list shard on disk (a real torn byte, not an
        # injector hook — the bench measures the production path)
        path = paths[n_shards // 2]
        with open(path, "rb") as f:
            raw = bytearray(f.read())
        raw[len(raw) // 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(raw))
        os.environ["PTPU_DATA_ANOMALY_POLICY"] = "quarantine_shard"
        try:
            degraded_rps, degraded_records = run_leg()
        finally:
            os.environ.pop("PTPU_DATA_ANOMALY_POLICY", None)
            data_plane.reset_quarantine()
        return {
            "healthy_records_per_sec": healthy_rps,
            "degraded_records_per_sec": degraded_rps,
            "degraded_throughput_ratio": degraded_rps / healthy_rps,
            "healthy_records": healthy_records,
            "degraded_records": degraded_records,
            "records_lost": healthy_records - degraded_records,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_zero(steps=16, warmup=4, repeats=3, depth=4, width=256,
               batch=64, bucket_mb=0.5, place=None):
    """bench.py's ZeRO ladder and overlap receipt (:1020-1142) on the
    process's data group (``init_data_group(place)``: the card unless
    `place` is "cpu"; world 1 unless the fleet's env contract says
    more): ONE 4-layer tanh MLP (RandomState(0) weights, batch 64 global)
    trained through every rung: per-leaf ZeRO-1 (the trajectory
    anchor), bucketed ZeRO-1 without overlap, ZeRO-2 with overlap,
    ZeRO-3 (overlap on) and host-offloaded m/v. The legs run
    INTERLEAVED, `repeats` rounds of `steps` steps after `warmup`, the
    best round kept per leg, so a load spike hits every leg. Every
    rung's parameters are held to the bucketed ZeRO-1 leg's (rtol 5e-2,
    atol 5e-3: the `*_close` flags) and every leg's loss must fall.
    Returns bench.py's receipt (step times in seconds) and the world."""
    import torch

    from paddle_tpu_torch.parallel import ShardedAdam
    from paddle_tpu_torch.parallel.mesh import Mesh, init_data_group

    group = init_data_group(place)
    mesh = Mesh(group)
    dev = group.device
    rng = np.random.RandomState(0)
    layers = [((rng.normal(size=(width, width)) * 0.05).astype(np.float32),
               np.zeros((width,), np.float32)) for _ in range(depth)]
    x = torch.from_numpy(np.asarray(rng.normal(size=(batch, width)),
                                    np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(rng.normal(size=(batch, width)),
                                    np.float32)).to(dev)

    def fresh():
        # copies: stages 1/2 update the leaves in place
        return [(torch.tensor(w, device=dev), torch.tensor(b, device=dev))
                for w, b in layers]

    def loss_fn(p, x, y):
        h = x
        for w, b in p:
            h = torch.tanh(h @ w + b)
        return ((h - y) ** 2).mean()

    class Leg:
        def __init__(self, opt):
            self.opt = opt
            self.p = fresh()
            self.st = opt.init_state(self.p, mesh)
            if opt._plan["stage"] == 3:
                self.p = opt.shard_params(self.p, mesh)
            self.step = opt.make_step(mesh, loss_fn)
            self.losses = []
            self.times = []

        def run(self, n, timed=True):
            t0 = time.perf_counter()
            for _ in range(n):
                self.p, self.st, loss = self.step(self.p, self.st, x, y)
            self.losses.append(float(loss))   # the leg's one sync point
            if timed:
                self.times.append((time.perf_counter() - t0) / n)

        def params(self):
            if self.opt._plan["stage"] == 3:
                return self.opt.gather_params(self.p)
            return self.p

    kw = dict(learning_rate=1e-3, bucket_mb=bucket_mb)
    legs = {
        "zero1_per_leaf": Leg(ShardedAdam(learning_rate=1e-3)),
        "zero1_bucketed": Leg(ShardedAdam(**kw)),
        "zero2_overlap": Leg(ShardedAdam(zero_stage=2, overlap=True, **kw)),
        "zero3": Leg(ShardedAdam(zero_stage=3, overlap=True, **kw)),
        "zero_offload": Leg(ShardedAdam(offload=True, **kw)),
    }
    for leg in legs.values():
        leg.run(warmup, timed=False)
    for _ in range(repeats):
        for leg in legs.values():
            leg.run(steps)

    def flat(leg):
        return np.concatenate([a.detach().float().cpu().numpy().ravel()
                               for pair in leg.params() for a in pair])

    anchor = flat(legs["zero1_bucketed"])

    def close(name):
        return bool(np.allclose(flat(legs[name]), anchor, rtol=5e-2,
                                atol=5e-3))

    legs["zero_offload"].step.close()   # release the stager's worker
    t_no = min(legs["zero1_bucketed"].times)
    t_ov = min(legs["zero2_overlap"].times)
    return {
        "step_time_no_overlap_s": t_no,
        "step_time_overlap_s": t_ov,
        "overlap_speedup": t_no / t_ov,
        "step_time_per_leaf_s": min(legs["zero1_per_leaf"].times),
        "step_time_zero3_s": min(legs["zero3"].times),
        "step_time_offload_s": min(legs["zero_offload"].times),
        "zero2_close": close("zero2_overlap"),
        "zero3_close": close("zero3"),
        "offload_close": close("zero_offload"),
        "losses": {name: leg.losses[-1] for name, leg in legs.items()},
        "loss_decreasing": all(leg.losses[-1] < leg.losses[0]
                               for leg in legs.values()),
        "world": group.world,
    }


def zero_line(res):
    """bench.py's ``--zero-only`` line from a `bench_zero` receipt, with
    the receipt's other step times, its losses, the world and the card;
    sets bench.py's ``bench/zero_*`` gauges (:1642-1680)."""
    from paddle_tpu_torch.observability import metrics as obs_metrics

    reg = obs_metrics.registry()
    for key, name in (("step_time_no_overlap_s", "zero_step_time_no_overlap"),
                      ("step_time_overlap_s", "zero_step_time_overlap"),
                      ("overlap_speedup", "zero_overlap_speedup"),
                      ("step_time_per_leaf_s", "zero_step_time_per_leaf"),
                      ("step_time_zero3_s", "zero_step_time_zero3"),
                      ("step_time_offload_s", "zero_step_time_offload")):
        reg.gauge("bench/" + name).set(res[key])
    for key, name in (("zero2_close", "zero2_close"),
                      ("zero3_close", "zero3_close"),
                      ("offload_close", "zero_offload_close"),
                      ("loss_decreasing", "zero_losses_decreasing")):
        reg.gauge("bench/" + name).set(1.0 if res[key] else 0.0)
    for name, loss in res["losses"].items():
        reg.gauge("bench/%s_last_loss" % name).set(loss)
    return {
        "metric": "zero_overlap_speedup",
        "value": round(res["overlap_speedup"], 4),
        "unit": "x (non-overlapped / overlapped step time)",
        "step_time_overlap_s": round(res["step_time_overlap_s"], 6),
        "step_time_no_overlap_s": round(res["step_time_no_overlap_s"], 6),
        "step_time_per_leaf_s": round(res["step_time_per_leaf_s"], 6),
        "step_time_zero3_s": round(res["step_time_zero3_s"], 6),
        "step_time_offload_s": round(res["step_time_offload_s"], 6),
        "zero2_close": res["zero2_close"],
        "zero3_close": res["zero3_close"],
        "offload_close": res["offload_close"],
        "loss_decreasing": res["loss_decreasing"],
        "losses": res["losses"], "world": res["world"],
        "card": card_line()}


def card_line():
    """(name, power limit) of card 0 as nvidia-smi prints them, or None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _leg_entry(name, tps, step_s, loss=None, **extra):
    entry = {"leg": name, "tokens_per_sec": round(tps, 1),
             "step_time_s": round(step_s, 6)}
    if loss is not None:
        entry["last_loss"] = float(loss)
    step_ms, host_ms = last_leg.get("step_ms"), last_leg.get("host_ms")
    if step_ms:
        entry["device_ms_per_step"] = round(float(np.mean(step_ms)), 4)
    if host_ms:
        entry["host_ms_per_step"] = round(float(np.mean(host_ms)), 4)
    if last_leg.get("peak_bytes") is not None:
        entry["peak_gib"] = round(last_leg["peak_bytes"] / 2 ** 30, 3)
    entry.update(extra)
    return entry


def _train_mfu(step_s, place):
    """A training leg's MFU receipt from the last counted step (the leg's
    main program: the executor counts each plan's first run)."""
    return _mfu_extra(_current_step_flops(), 1.0 / step_s if step_s else 0,
                      place)


def _serving_leg(name, tps, **extra):
    """A serving leg's entry, bench.py's ``_leg`` (no step time)."""
    entry = {"leg": name, "tokens_per_sec": round(tps, 1),
             "step_time_s": 0.0}
    entry.update(extra)
    return entry


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--tiny", action="store_true",
                    help="toy model + host feeds through the background "
                         "prefetcher (bench.py's CI configuration)")
    ap.add_argument("--sync-only", action="store_true",
                    help="skip the async leg")
    ap.add_argument("--amp-only", action="store_true",
                    help="run only the fp32, amp and amp_fp16 legs")
    ap.add_argument("--serving-only", action="store_true",
                    help="run only the serving, fast-path and "
                         "speculative serving legs")
    ap.add_argument("--spec-only", action="store_true",
                    help="run only the speculative serving legs")
    ap.add_argument("--quant-only", action="store_true",
                    help="run only the int8 predictor pair and the int8 "
                         "serving pair")
    ap.add_argument("--fleet-only", action="store_true",
                    help="run only the serving-fleet scaling pair "
                         "(1-replica vs 2-replica ServingRouter)")
    ap.add_argument("--online-only", action="store_true",
                    help="run the online weight-hot-swap pair (steady "
                         "vs mid-stream rollout through an "
                         "OnlineUpdater); with other -only flags, beside "
                         "their legs")
    ap.add_argument("--data-only", action="store_true",
                    help="run only the streaming-ingestion leg pair "
                         "(healthy vs one-quarantined-shard records/s)")
    ap.add_argument("--zero-only", action="store_true",
                    help="run only the ZeRO ladder and overlap receipt "
                         "(one MLP through every ShardedAdam rung on the "
                         "process's data group)")
    ap.add_argument("--resilience", action="store_true",
                    help="also measure guarded vs unguarded step time "
                         "(always on under --tiny)")
    ap.add_argument("--place", default=None,
                    help="device (default: the card; 'cpu' to try it "
                         "without one)")
    args = ap.parse_args(argv)
    if args.zero_only:
        result = zero_line(bench_zero(place=args.place))
        print(json.dumps(result), flush=True)
        return result
    if args.data_only:
        res = bench_data_ingestion(place=args.place)
        result = {
            "metric": "data_degraded_throughput_ratio",
            "value": round(res["degraded_throughput_ratio"], 4),
            "unit": "x (degraded / healthy records-per-sec)",
            "records_per_sec_healthy": round(
                res["healthy_records_per_sec"], 1),
            "records_per_sec_degraded": round(
                res["degraded_records_per_sec"], 1),
            "records_lost": res["records_lost"],
            "card": card_line(),
            "legs": [
                {"leg": "data_healthy",
                 "records_per_sec": round(res["healthy_records_per_sec"],
                                          1),
                 "records": res["healthy_records"]},
                {"leg": "data_degraded",
                 "records_per_sec": round(res["degraded_records_per_sec"],
                                          1),
                 "records": res["degraded_records"],
                 "data_degraded_throughput_ratio": round(
                     res["degraded_throughput_ratio"], 4)}]}
        print(json.dumps(result), flush=True)
        return result
    if args.tiny:
        kw = dict(TINY, feed_mode="host")
    else:
        kw = dict(steps=args.steps, warmup=args.warmup)
    kw["place"] = args.place
    place = args.place
    dedicated = (args.serving_only or args.quant_only or args.spec_only
                 or args.fleet_only or args.online_only)
    if dedicated:
        args.amp_only = False  # a dedicated leg: skip everything else

    legs = []
    result = {"metric": "transformer_base_tokens_per_sec_per_chip",
              "unit": "tokens/s/chip"}
    async_tps = sync_tps = amp_tps = None
    if not args.amp_only and not dedicated:
        if not args.sync_only:
            async_tps, loss, step_s, _ = bench_transformer_fluid(
                async_exec=True, **kw)
            legs.append(_leg_entry("async", async_tps, step_s, loss,
                                   window_peak=last_leg["window_peak"],
                                   **_train_mfu(step_s, place)))
            result["async_tokens_per_sec"] = round(async_tps, 1)
            result["step_time_async_s"] = round(step_s, 6)
        sync_tps, loss, step_s, compile_opt = bench_transformer_fluid(
            async_exec=False, **kw)
        legs.append(_leg_entry("sync", sync_tps, step_s, loss,
                               **_train_mfu(step_s, place)))
        result["sync_tokens_per_sec"] = round(sync_tps, 1)
        result["step_time_sync_s"] = round(step_s, 6)
        noopt_tps, _, step_s, compile_noopt = bench_transformer_fluid(
            async_exec=False, program_opt=False, **kw)
        legs.append(_leg_entry("noopt", noopt_tps, step_s))
        result["noopt_tokens_per_sec"] = round(noopt_tps, 1)
        if compile_opt is not None:
            result["compile_time_s_opt"] = round(compile_opt, 3)
        if compile_noopt is not None:
            result["compile_time_s_noopt"] = round(compile_noopt, 3)
    if args.amp_only or not (args.tiny or dedicated):
        fp32_tps, loss, step_s, _ = bench_transformer_fluid(
            async_exec=False, dtype="float32", amp=False, **kw)
        legs.append(_leg_entry("fp32", fp32_tps, step_s, loss,
                               batch=last_leg["batch"],
                               **_train_mfu(step_s, place)))
        amp_tps, loss, step_s, _ = bench_transformer_fluid(
            async_exec=False, dtype="float32", amp=True, **kw)
        legs.append(_leg_entry("amp", amp_tps, step_s, loss,
                               speedup_vs_fp32=round(amp_tps / fp32_tps,
                                                     4),
                               **_train_mfu(step_s, place)))
        f16_tps, loss, step_s, _ = bench_transformer_fluid(
            async_exec=False, dtype="float32", amp="float16", **kw)
        legs.append(_leg_entry("amp_fp16", f16_tps, step_s, loss,
                               speedup_vs_fp32=round(f16_tps / fp32_tps,
                                                     4),
                               **last_leg["scaling"],
                               **_train_mfu(step_s, place)))
        result["fp32_tokens_per_sec"] = round(fp32_tps, 1)
        result["amp_tokens_per_sec"] = round(amp_tps, 1)
        result["amp_speedup_vs_fp32"] = round(amp_tps / fp32_tps, 4)
        result["amp_fp16_tokens_per_sec"] = round(f16_tps, 1)
        result["amp_fp16_speedup_vs_fp32"] = round(f16_tps / fp32_tps, 4)

    serve_batched = qserve_int8 = spec_res = None
    rest = args.tiny or args.amp_only
    if args.serving_only or not (rest or dedicated):
        (serve_batched, serve_serial, serve_match, serve_p50, serve_p99,
         _tokens, serve_sps, serve_flops) = bench_serving(place=place)
        legs.append(_serving_leg(
            "serving_batched", serve_batched,
            p50_latency_s=round(serve_p50, 4),
            p99_latency_s=round(serve_p99, 4),
            outputs_match=bool(serve_match),
            **_mfu_extra(serve_flops, serve_sps, place)))
        legs.append(_serving_leg(
            "serving_serial", serve_serial,
            speedup_batched_vs_serial=round(serve_batched / serve_serial,
                                            4)))
        result["serving_tokens_per_sec_batched"] = round(serve_batched, 1)
        result["serving_tokens_per_sec_serial"] = round(serve_serial, 1)
        result["serving_speedup_vs_serial"] = round(
            serve_batched / serve_serial, 4)
        result["serving_p99_latency_s"] = round(serve_p99, 4)
        result["serving_outputs_match"] = bool(serve_match)

        fp = bench_serving_fastpath(place=place)
        legs.append(_serving_leg(
            "serving_fastpath", fp["fast"]["tokens_per_sec"],
            ttft_p50_s=round(fp["fast"]["ttft_p50"], 4),
            prefix_hit_rate=round(fp["prefix_hit_rate"], 4),
            outputs_match=bool(fp["outputs_match"])))
        legs.append(_serving_leg(
            "serving_legacy_prefill", fp["legacy"]["tokens_per_sec"],
            ttft_p50_s=round(fp["legacy"]["ttft_p50"], 4),
            chunked_ttft_speedup=round(fp["ttft_speedup"], 4)))
        result["serving_ttft_chunked_s"] = round(fp["fast"]["ttft_p50"], 4)
        result["serving_ttft_legacy_s"] = round(fp["legacy"]["ttft_p50"],
                                                4)
        result["serving_chunked_speedup"] = round(fp["ttft_speedup"], 4)
        result["serving_prefix_hit_rate"] = round(fp["prefix_hit_rate"], 4)
        result["serving_fastpath_outputs_match"] = bool(fp["outputs_match"])

    if args.spec_only or args.serving_only or not (rest or dedicated):
        spec_res = sp = bench_serving_spec(place=place)
        legs.append(_serving_leg(
            "serving_spec", sp["spec"]["tokens_per_sec"],
            tokens_per_step=round(sp["spec"]["tokens_per_step"], 4),
            accept_rate=round(sp["accept_rate"], 4),
            outputs_match=bool(sp["outputs_match"])))
        legs.append(_serving_leg(
            "serving_spec_baseline", sp["legacy"]["tokens_per_sec"],
            tokens_per_step=round(sp["legacy"]["tokens_per_step"], 4),
            spec_tokens_per_step_speedup=round(
                sp["tokens_per_step_speedup"], 4)))
        legs.append(_serving_leg(
            "serving_spec_tree", sp["tree"]["tokens_per_sec"],
            tokens_per_step=round(sp["tree"]["tokens_per_step"], 4),
            draft_steps=sp["tree"]["draft_steps"],
            accept_rate=round(sp["tree"]["accept_rate"], 4),
            tree_shape=sp["tree_shape"],
            tree_speedup_vs_linear=round(sp["tree_speedup_vs_linear"], 4),
            outputs_match=bool(sp["tree"]["outputs_match"])))
        legs.append(_serving_leg(
            "serving_spec_int8", sp["int8"]["tokens_per_sec"],
            tokens_per_step=round(sp["int8"]["tokens_per_step"], 4),
            draft_steps=sp["int8"]["draft_steps"],
            accept_rate=round(sp["int8"]["accept_rate"], 4),
            outputs_match=bool(sp["int8"]["outputs_match"])))
        result["serving_spec_tokens_per_step"] = round(
            sp["spec"]["tokens_per_step"], 4)
        result["serving_spec_speedup"] = round(
            sp["tokens_per_step_speedup"], 4)
        result["serving_spec_accept_rate"] = round(sp["accept_rate"], 4)
        result["serving_spec_outputs_match"] = bool(sp["outputs_match"])
        result["serving_spec_tree_tokens_per_step"] = round(
            sp["tree"]["tokens_per_step"], 4)
        result["serving_spec_tree_speedup"] = round(
            sp["tree_speedup_vs_linear"], 4)
        result["serving_spec_tree_draft_steps"] = int(
            sp["tree"]["draft_steps"])
        result["serving_spec_int8_outputs_match"] = bool(
            sp["int8"]["outputs_match"])

    if args.quant_only or not (rest or dedicated):
        qp = bench_quant_predictor(place=place)
        legs.append(_serving_leg("quant_fp32_predictor",
                                 qp["fp32_examples_per_sec"]))
        legs.append(_serving_leg(
            "quant_int8_predictor", qp["int8_examples_per_sec"],
            speedup_vs_fp32=round(qp["speedup_vs_fp32"], 4),
            max_abs_err=round(qp["max_abs_err"], 6),
            top1_agreement=round(qp["top1_agreement"], 4),
            weight_bytes_saved_ratio=round(
                qp["weight_bytes_saved_ratio"], 4)))
        result["quant_int8_examples_per_sec"] = round(
            qp["int8_examples_per_sec"], 1)
        result["quant_speedup_vs_fp32"] = round(qp["speedup_vs_fp32"], 4)
        result["quant_max_abs_err"] = round(qp["max_abs_err"], 6)
        result["quant_top1_agreement"] = round(qp["top1_agreement"], 4)
        result["quant_weight_bytes_saved_ratio"] = round(
            qp["weight_bytes_saved_ratio"], 4)
        (qserve_int8, qserve_fp32, qserve_match, qserve_agree,
         _tokens) = bench_serving_quant(place=place)
        legs.append(_serving_leg("serving_fp32_ref", qserve_fp32))
        legs.append(_serving_leg(
            "serving_int8", qserve_int8,
            speedup_vs_fp32=round(qserve_int8 / qserve_fp32, 4),
            outputs_match=bool(qserve_match),
            token_agreement=round(qserve_agree, 4)))
        result["serving_tokens_per_sec_int8"] = round(qserve_int8, 1)
        result["serving_int8_speedup_vs_fp32"] = round(
            qserve_int8 / qserve_fp32, 4)
        result["serving_int8_outputs_match"] = bool(qserve_match)
    fleet_res = online_res = None
    if args.fleet_only or not (rest or dedicated):
        fleet_res = fl = bench_serving_fleet(place=place)
        legs.append(_serving_leg(
            "serving_fleet_1r", fl["one"]["tokens_per_sec"],
            outputs_match=bool(fl["one"]["outputs_match"]),
            replicas_used=fl["one"]["replicas_used"]))
        legs.append(_serving_leg(
            "serving_fleet_2r", fl["two"]["tokens_per_sec"],
            outputs_match=bool(fl["two"]["outputs_match"]),
            replicas_used=fl["two"]["replicas_used"],
            fleet_scaling=round(fl["scaling"], 4)))
        result["serving_fleet_tokens_per_sec_1r"] = round(
            fl["one"]["tokens_per_sec"], 1)
        result["serving_fleet_tokens_per_sec_2r"] = round(
            fl["two"]["tokens_per_sec"], 1)
        result["serving_fleet_scaling"] = round(fl["scaling"], 4)
        result["serving_fleet_outputs_match"] = bool(fl["outputs_match"])
    if args.online_only:
        online_res = on = bench_serving_online(place=place)
        legs.append(_serving_leg(
            "online_steady", on["steady_tokens_per_sec"],
            outputs_match=bool(on["outputs_match"])))
        legs.append(_serving_leg(
            "online_rollout", on["rollout_tokens_per_sec"],
            outputs_match=bool(on["outputs_match"]),
            online_rollout_throughput_ratio=round(
                on["rollout_throughput_ratio"], 4),
            requests_lost=on["requests_lost"], swaps=on["swaps"],
            final_versions=on["final_versions"]))
        for key in ("steady_tokens_per_sec", "rollout_tokens_per_sec"):
            result["serving_online_" + key] = round(on[key], 1)
        result["serving_online_rollout_throughput_ratio"] = round(
            on["rollout_throughput_ratio"], 4)
        result["serving_online_outputs_match"] = bool(on["outputs_match"])
        for key in ("requests_lost", "versions_published", "swaps",
                    "final_versions"):
            result["serving_online_" + key] = on[key]
    # the resilience guard's cost, measured, not assumed (bench.py runs
    # it under --resilience and --tiny, beside the training legs)
    if (args.resilience or args.tiny) and not (args.amp_only
                                               or args.serving_only
                                               or args.quant_only
                                               or args.spec_only
                                               or args.fleet_only):
        unguarded, guarded = bench_resilience_overhead(place=place)
        overhead_pct = 100.0 * (guarded - unguarded) / unguarded
        legs.append({"leg": "resilience_unguarded",
                     "step_time_s": round(unguarded, 6)})
        legs.append({"leg": "resilience_guarded",
                     "step_time_s": round(guarded, 6),
                     "guard_overhead_pct": round(overhead_pct, 2)})
        result["step_time_guarded_s"] = round(guarded, 6)
        result["step_time_unguarded_s"] = round(unguarded, 6)
        result["guard_overhead_pct"] = round(overhead_pct, 2)

    headline = next((v for v in (
        async_tps, sync_tps, amp_tps, serve_batched, qserve_int8,
        spec_res and spec_res["spec"]["tokens_per_sec"],
        fleet_res and fleet_res["two"]["tokens_per_sec"]) if v is not None),
        None)
    if headline is None:
        # the online pair alone: bench.py's --online-only metric
        result.update(metric="online_rollout_throughput_ratio",
                      unit="x (mid-rollout / steady-state serving "
                           "tokens/s)")
        headline = online_res["rollout_throughput_ratio"]
        result["value"] = round(headline, 4)
    else:
        result["value"] = round(headline, 1)
    result["card"] = card_line()
    result["legs"] = legs
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
