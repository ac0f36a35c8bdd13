"""Where a Fluid tensor-parallel step's time goes (chip_smoke.py phase
17b's legs), on four cards.

The kernels are built once first; then each rank (one child process a
card, the fleet's env contract, NCCL)
builds phase 17's headline program (``chip_smoke.build_tp_lm``), runs it
through ``CompiledProgram.with_data_parallel`` at (2, 2) and at (1, 4),
3 warm-up steps, then 3 steps under ``torch.profiler`` and 3 timed
without it. It prints one ``tp_profile`` line a rank a mesh: ms a step
(host clock, synchronized), the card's kernel time a step by group
(NCCL, K1, GEMMs, the rest) and its busy share (the union of the kernel
intervals over the window), the host's time inside the tp collectives'
calls (``collective.host_seconds``), and the launches a step.

Run from the repository's root on a machine with four CUDA cards:
``python3 probes/tp_step_profile.py``.
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
MESHES = ((2, 2), (1, 4))
WARMUP, PROFILED, TIMED = 3, 3, 3


def _group(name):
    n = name.lower()
    if "nccl" in n:
        return "nccl"
    if "flash" in n:
        return "k1"
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "sm90_" in n \
            or "xmma" in n:
        return "gemm"
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


def rank_main():
    import numpy as np
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.compiler import BuildStrategy
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.mesh import (destroy_data_group,
                                                init_data_group)

    g = init_data_group(None)
    dev = g.device
    feed = cs.tp_feed(torch, cs.TRAIN, cs.TP["batch"], dev, cs.TP["tokens"])
    main, startup, loss = cs.build_tp_lm(fluid, cs.TRAIN, "sgd")
    exe = fluid.Executor(dev)
    scope0 = fluid.Scope()
    exe.run(startup, scope=scope0)
    init = cs._snapshot(scope0)
    del scope0
    out = []
    for mesh in MESHES:
        scope = cs._restore(fluid, init)
        bs = BuildStrategy()
        bs.tensor_parallel_degree = mesh[1]
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)

        def step():
            return exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)

        for _ in range(WARMUP):
            step()
        torch.cuda.synchronize(dev)
        host0 = dict(C.host_seconds)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILED):
                step()
            torch.cuda.synchronize(dev)
        host = {k: (C.host_seconds[k] - host0[k]) * 1e3 / PROFILED
                for k in ("enter_tp", "reduce_tp", "gather_tp")}
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by = {}
        for e in kernels:
            us = e.time_range.end - e.time_range.start
            by[_group(e.name)] = by.get(_group(e.name), 0.0) \
                + us / 1e3 / PROFILED
        busy = _busy_ms([(e.time_range.start, e.time_range.end)
                         for e in kernels])
        launches = sum(1 for e in prof.events()
                       if e.name in cs.LAUNCH_NAMES) / PROFILED
        t0 = time.perf_counter()
        for _ in range(TIMED):
            step()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / TIMED
        out.append({"mesh": list(mesh), "rank": g.rank, "ms_per_step": ms,
                    "kernel_ms_per_step": by,
                    "busy_ms_per_step": busy / PROFILED,
                    "host_ms_in_tp_calls_per_step": host,
                    "launches_per_step": launches,
                    "loss": float(np.asarray(step()[0]).ravel()[0])})
        del scope, prog
        torch.cuda.empty_cache()
    destroy_data_group()
    print("tp_profile " + json.dumps(out), flush=True)


def main():
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build

    _build.build()  # once, before the ranks load the kernels
    print(cs.card_line(), flush=True)
    world = torch.cuda.device_count()
    if world < 4:
        print("four cards needed, %d visible" % world)
        sys.exit(1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(4):
        env = dict(os.environ, PADDLE_TRAINER_ID=str(rank),
                   PADDLE_TRAINERS_NUM="4",
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
        lines = [x for x in o.splitlines() if x.startswith("tp_profile ")]
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
