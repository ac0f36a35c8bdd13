"""The headline training bench of the port (parity: ``bench.py``
`bench_transformer_fluid` :109-225, `TINY` :229 and the training legs of
its `main`, :1740-1793 and :2060-2080).

    python -m paddle_tpu_torch.bench [--steps N] [--warmup N] [--tiny]
                                     [--sync-only] [--amp-only]

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

and prints one JSON line with bench.py's keys for them, the card's name
and power limit, and each leg's device and host ms a step. It prints no
``vs_baseline``: bench.py's baseline is a TPU-era figure. ``--tiny`` is
bench.py's CI configuration (TINY, host feeds through the prefetcher);
``--sync-only`` skips the async leg, ``--amp-only`` runs only fp32, amp
and amp_fp16.
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

__all__ = ["TINY", "bench_transformer_fluid", "build_program", "last_leg",
           "main"]

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
    ap.add_argument("--place", default=None,
                    help="device (default: the card; 'cpu' to try it "
                         "without one)")
    args = ap.parse_args(argv)
    if args.tiny:
        kw = dict(TINY, feed_mode="host")
    else:
        kw = dict(steps=args.steps, warmup=args.warmup)
    kw["place"] = args.place

    legs = []
    result = {"metric": "transformer_base_tokens_per_sec_per_chip",
              "unit": "tokens/s/chip"}
    async_tps = sync_tps = amp_tps = None
    if not args.amp_only:
        if not args.sync_only:
            async_tps, loss, step_s, _ = bench_transformer_fluid(
                async_exec=True, **kw)
            legs.append(_leg_entry("async", async_tps, step_s, loss,
                                   window_peak=last_leg["window_peak"]))
            result["async_tokens_per_sec"] = round(async_tps, 1)
            result["step_time_async_s"] = round(step_s, 6)
        sync_tps, loss, step_s, compile_opt = bench_transformer_fluid(
            async_exec=False, **kw)
        legs.append(_leg_entry("sync", sync_tps, step_s, loss))
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
    if args.amp_only or not args.tiny:
        fp32_tps, loss, step_s, _ = bench_transformer_fluid(
            async_exec=False, dtype="float32", amp=False, **kw)
        legs.append(_leg_entry("fp32", fp32_tps, step_s, loss,
                               batch=last_leg["batch"]))
        amp_tps, loss, step_s, _ = bench_transformer_fluid(
            async_exec=False, dtype="float32", amp=True, **kw)
        legs.append(_leg_entry("amp", amp_tps, step_s, loss,
                               speedup_vs_fp32=round(amp_tps / fp32_tps,
                                                     4)))
        f16_tps, loss, step_s, _ = bench_transformer_fluid(
            async_exec=False, dtype="float32", amp="float16", **kw)
        legs.append(_leg_entry("amp_fp16", f16_tps, step_s, loss,
                               speedup_vs_fp32=round(f16_tps / fp32_tps,
                                                     4),
                               **last_leg["scaling"]))
        result["fp32_tokens_per_sec"] = round(fp32_tps, 1)
        result["amp_tokens_per_sec"] = round(amp_tps, 1)
        result["amp_speedup_vs_fp32"] = round(amp_tps / fp32_tps, 4)
        result["amp_fp16_tokens_per_sec"] = round(f16_tps, 1)
        result["amp_fp16_speedup_vs_fp32"] = round(f16_tps / fp32_tps, 4)
    headline = async_tps if async_tps is not None else (
        sync_tps if sync_tps is not None else amp_tps)
    result["value"] = round(headline, 1)
    result["card"] = card_line()
    result["legs"] = legs
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
