"""Where a data-parallel step's extra time goes on the card.

Default: the harness's ResNet-50 (ImageNet, batch 64, fp32, Adam 0.01;
``fluid_benchmark.run_static_model``, 3 warm-up and 8 timed steps)
with ``--update_method local`` and ``nccl2`` in turns, two rounds, one
rank; each prints the device and host ms a step, the port's all-reduce
calls a step and the host ms spent inside them. Then one nccl2 step
under ``torch.profiler``: device and host time by name.

``--phase14``: ``chip_smoke.py``'s phase 14 alone (its kernels built
first), one rank a visible card: run with four cards for a world of 4.

Run from the repository's root on a machine with CUDA cards:
``python3 probes/data_parallel_cost.py [--phase14]``.
"""
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def phase14():
    import chip_smoke
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    print(chip_smoke.card_line(), flush=True)
    print("cards", torch.cuda.device_count(), flush=True)
    t0 = time.perf_counter()
    _build.build()
    print("build %.1f s" % (time.perf_counter() - t0), flush=True)
    fwd, bwd = chip_smoke.parallel_phase(torch, fa)
    print("K1 on 14a", fwd, bwd, flush=True)


def collective_cost(rounds=2, skip=3, iters=8):
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import fluid_benchmark
    from paddle_tpu_torch.parallel import collective

    spent = {"s": 0.0, "n": 0}
    plain = collective.all_reduce

    def timed(t, group, op="sum"):
        t0 = time.perf_counter()
        out = plain(t, group, op)
        spent["s"] += time.perf_counter() - t0
        spent["n"] += 1
        return out

    collective.all_reduce = timed
    rec = {}
    for rnd in range(rounds):
        for method in ("local", "nccl2"):
            argv = ["--model", "resnet", "--data_set", "imagenet",
                    "--batch_size", "64", "--skip_batch_num", str(skip),
                    "--iterations", str(iters), "--update_method", method]
            rec = {}
            spent.update(s=0.0, n=0)
            fluid_benchmark.run_static_model(
                fluid_benchmark.parse_args(argv), rec)
            n = skip + iters
            print("dp_cost " + json.dumps({
                "round": rnd, "update_method": method,
                "device_ms": sum(rec["step_ms"]) / len(rec["step_ms"]),
                "host_ms": sum(rec["host_ms"]) / len(rec["host_ms"]),
                "all_reduce_calls_per_step": spent["n"] / n,
                "all_reduce_host_ms_per_step": spent["s"] * 1e3 / n}),
                flush=True)
    pe, feed, loss = rec["pe"], rec["feed"], rec["loss"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pe.run([loss.name], feed=feed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    print("profiled nccl2 step: wall %.2f ms" % (wall * 1e3))
    for e in sorted(events, key=lambda e: -device_us(e))[:12]:
        print("  device %-56s %.2f ms  count %d"
              % (e.key[:56], device_us(e) / 1e3, e.count))
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]:
        print("  host   %-56s %.2f ms  count %d"
              % (e.key[:56], e.self_cpu_time_total / 1e3, e.count))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("probes/data_parallel_cost.py needs a CUDA card")
    if "--phase14" in sys.argv[1:]:
        phase14()
    else:
        collective_cost()
