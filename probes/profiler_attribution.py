"""How well the device table by Fluid op holds a profiled step, session by
session, and why a kernel falls outside every op.

Runs ``chip_smoke.profiled_lm_leg`` (the headline LM at batch 160, 2 steps
inside a ``profiler.profiler()`` session) `sessions` times in each of
`procs` fresh processes, built once beforehand. Prints one JSON line a
session: the share of kernel time ``profiler.kernel_attribution`` gives
to Fluid ops; the same share when a kernel is placed by its runtime
call's CUPTI timestamp alone and only a launch issued before the
kernel's start counts (``launch_clock_pct``); for the kernels no op
holds, the reason (no launch of their correlation id, every launch after
the kernel's start, or a launch no range holds) with their time and the
top kernel names; and the five least gaps between a kernel's start and
its latest launch (negative: the card's clock behind the host's).

Run from the repository's root on a machine with one CUDA card:
``python3 probes/profiler_attribution.py [procs] [sessions]``.
"""
import collections
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = "--child"


def diagnose(events, P):
    ranges, hosts, launches, kernels = {}, {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        name = str(e.get("name", ""))
        args = e.get("args") or {}
        where = (e.get("pid"), e.get("tid"))
        if cat in ("user_annotation", "cpu_op"):
            ts = float(e["ts"])
            if args.get("External id"):
                hosts[args["External id"]] = (where, ts)
            if cat == "user_annotation" and name.startswith("fluid/"):
                ranges.setdefault(where, []).append(
                    (ts, ts + float(e.get("dur", 0)), name[6:]))
        elif cat in P._LAUNCH_CATS and "correlation" in args:
            launches.setdefault(args["correlation"], []).append(
                (float(e["ts"]), where))
        elif cat == "kernel":
            kernels.append((name, args.get("correlation"),
                            float(e.get("dur", 0)), float(e["ts"])))
    segs = {t: P._segments(list(rs)) for t, rs in ranges.items()}
    records = P.kernel_attribution({"traceEvents": events})
    total = sum(k[2] for k in kernels) or 1.0
    gaps, by_clock = [], 0.0
    reasons, reason_us = collections.Counter(), collections.Counter()
    names = collections.Counter()
    for (name, corr, dur, start), rec in zip(kernels, records):
        la = launches.get(corr, [])
        if la:
            gaps.append(start - max(t for t, _ in la))
        before = [l for l in la if l[0] <= start]
        if before:
            ts, tid = max(before)
            if P._place(segs, tid, ts) is not None:
                by_clock += dur
        if rec["op"] is not None:
            continue
        names[name[:60]] += dur
        why = ("no_launch" if not la else "launch_after_start"
               if not before else "launch_outside_ranges")
        reasons[why] += 1
        reason_us[why] += dur
    gaps.sort()
    return {"kernels": len(kernels), "kernel_us": total,
            "attributed_pct": 100.0 * sum(
                r["us"] for r in records if r["op"] is not None) / total,
            "launch_clock_pct": 100.0 * by_clock / total,
            "unattributed": dict(reasons), "unattributed_us": dict(reason_us),
            "top_unattributed": names.most_common(5),
            "least_gaps_us": gaps[:5]}


def child(proc, sessions):
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import profiler as P
    from paddle_tpu_torch.ops import flash_attention as fa

    program = cs.build_lm(fluid)
    for s in range(sessions):
        cs.profiled_lm_leg(torch, fa, fluid, program, 160, 2,
                           overhead_steps=3 if s == 0 else 1)
        got = diagnose(P.trace_events(None), P)
        print(json.dumps(dict(got, proc=proc, session=s,
                              card=cs.card_line())), flush=True)


def main(procs=3, sessions=3):
    sys.path.insert(0, ROOT)
    from paddle_tpu_torch.ops import _build

    _build.build()
    for p in range(procs):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              CHILD, str(p), str(sessions)],
                             capture_output=True, text=True, timeout=900)
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            raise SystemExit("process %d exited %d: %s"
                             % (p, out.returncode, out.stderr[-3000:]))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == CHILD:
        child(int(sys.argv[2]), int(sys.argv[3]))
    else:
        main(*[int(a) for a in sys.argv[1:3]])
