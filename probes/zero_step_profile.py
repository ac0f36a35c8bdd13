"""Where a ZeRO step's time goes (chip_smoke.py phase 18's legs), on
every visible card (four for 18b's dp = 4; one for 18a's world 1).

The kernels are built once first; then each rank (one child process a
card, the fleet's env contract, NCCL) trains phase 18's flagship
(batch 192 global, seq 512, fp32 leaves, bf16 compute, remat) through
the legs bucketed, zero2_overlap, zero3_overlap and offload: 2 warm-up
steps, 2 steps under ``torch.profiler`` and 3 timed without it. Around
the ladder's own work the probe opens ``record_function`` ranges (by
wrapping `ShardedAdam._local_update`, `amp.flatten_bucket` and the ZeRO
collectives), so the trace gives the card's time in each. It prints one
``zero_profile`` line a rank a leg: ms a step (host clock, synchronized),
the card's kernel time a step by group (NCCL, K1, GEMMs, copies, the
rest) and in each range, its busy share (the union of the kernel
intervals over the window), and the launches a step.

Run from the repository's root on a machine with CUDA cards:
``python3 probes/zero_step_profile.py``.
"""
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
RANK_FLAG = "--rank"
LEGS = ("bucketed", "zero2_overlap", "zero3_overlap", "offload")
WARMUP, PROFILED, TIMED = 2, 2, 3
RANGES = ("zero/update_math", "zero/flatten", "zero/reduce_scatter",
          "zero/gather", "zero/param_gather")


def _group(name):
    n = name.lower()
    if "nccl" in n:
        return "nccl"
    if "flash" in n:
        return "k1"
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "sm90_" in n \
            or "xmma" in n:
        return "gemm"
    if "memcpy" in n or "copy" in n:
        return "copies"
    return "other"


def _busy_ms(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def _ranged(fn, name):
    import torch

    def wrapped(*a, **k):
        label = name
        if name == "zero/gather" and k.get("kind") == "zero_param_gather":
            label = "zero/param_gather"
        with torch.profiler.record_function(label):
            return fn(*a, **k)

    return wrapped


def rank_main():
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import ShardedAdam
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel import zero
    from paddle_tpu_torch.parallel.mesh import (Mesh, destroy_data_group,
                                                init_data_group)

    zero.ShardedAdam._local_update = _ranged(
        zero.ShardedAdam._local_update, "zero/update_math")
    zero.amp.flatten_bucket = _ranged(zero.amp.flatten_bucket,
                                      "zero/flatten")
    C.zero_reduce_scatter = _ranged(C.zero_reduce_scatter,
                                    "zero/reduce_scatter")
    C.zero_all_gather = _ranged(C.zero_all_gather, "zero/gather")
    g = init_data_group(None)
    mesh = Mesh(g)
    dev = g.device
    cfg = bench.native_config(cs.ZERO["batch"], cs.ZERO["seq"], remat=True)
    init = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device=dev)
    tokens, labels = cs.spmd_batch(torch, cfg, cs.ZERO["batch"],
                                   cs.ZERO["seq"], dev)
    out = []
    for name, kw in cs.ZERO_LEGS:
        if name not in LEGS:
            continue
        opt = ShardedAdam(learning_rate=cs.ZERO["lr"],
                          bucket_mb=cs.ZERO["bucket_mb"], **kw)
        p = T.tree_map(torch.clone, init)
        st = opt.init_state(p, mesh)
        if opt._plan["stage"] == 3:
            p = opt.shard_params(p, mesh)
        step = opt.make_step(mesh, lambda q, x, y: T.single_chip_loss(
            q, x, y, cfg))
        for _ in range(WARMUP):
            p, st, loss = step(p, st, tokens, labels)
        torch.cuda.synchronize(dev)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILED):
                p, st, loss = step(p, st, tokens, labels)
            torch.cuda.synchronize(dev)
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by = {}
        for e in kernels:
            us = e.time_range.end - e.time_range.start
            by[_group(e.name)] = by.get(_group(e.name), 0.0) \
                + us / 1e3 / PROFILED
        ranges = {}
        for e in prof.key_averages():
            if e.key in RANGES:
                ranges[e.key] = {
                    "device_ms": e.device_time_total / 1e3 / PROFILED,
                    "host_ms": e.cpu_time_total / 1e3 / PROFILED,
                    "calls": e.count / PROFILED}
        busy = _busy_ms([(e.time_range.start, e.time_range.end)
                         for e in kernels])
        launches = sum(1 for e in prof.events()
                       if e.name in cs.LAUNCH_NAMES) / PROFILED
        t0 = time.perf_counter()
        for _ in range(TIMED):
            p, st, loss = step(p, st, tokens, labels)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / TIMED
        if getattr(step, "close", None):
            step.close()
        out.append({"leg": name, "rank": g.rank, "world": g.world,
                    "ms_per_step": ms, "kernel_ms_per_step": by,
                    "ranges": ranges,
                    "busy_ms_per_step": busy / PROFILED,
                    "launches_per_step": launches, "loss": float(loss)})
        del p, st, step, opt
        torch.cuda.empty_cache()
    destroy_data_group()
    print("zero_profile " + json.dumps(out), flush=True)


def main():
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build

    _build.build()  # once, before the ranks load the kernels
    print(cs.card_line(), flush=True)
    world = min(torch.cuda.device_count(), cs.ZERO["world"])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(world):
        env = dict(os.environ, PADDLE_TRAINER_ID=str(rank),
                   PADDLE_TRAINERS_NUM=str(world),
                   PADDLE_TRAINER_ENDPOINTS="127.0.0.1:%d" % port)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), RANK_FLAG],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    bad = 0
    for rank, p in enumerate(procs):
        try:
            o, e = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            print("rank %d timed out" % rank)
            sys.exit(1)
        lines = [x for x in o.splitlines() if x.startswith("zero_profile ")]
        if p.returncode or not lines:
            print("rank %d exited %d: %s" % (rank, p.returncode, e[-3000:]))
            bad += 1
        else:
            print(lines[-1], flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] == RANK_FLAG:
        rank_main()
    else:
        main()
