"""A fresh process's first program on a card, by CUDA module loading.

Runs ``chip_smoke.py --phase15-first-program`` (the headline LM at batch
160: startup, then 3 steps, the first inside a profiler session, each
step's optimize / lower / compile / execute / fetch spans) in fresh
processes, in turns, with ``CUDA_MODULE_LOADING`` left as the driver's
default (lazy: a kernel's module loads at its first launch) and set to
EAGER (every module of a library loads when the library does), `rounds`
times each. Prints one JSON line a run: the mode, the import and startup
seconds, each step's spans and the first step's launches that blocked
(longer than 100 us) with their total.

Run from the repository's root on a machine with one CUDA card:
``python3 probes/first_program_split.py [rounds]``.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(mode):
    env = dict(os.environ)
    env.pop("CUDA_MODULE_LOADING", None)
    if mode != "default":
        env["CUDA_MODULE_LOADING"] = mode
    args = {"batch": 160, "steps": 3}
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--phase15-first-program", json.dumps(args)],
        capture_output=True, text=True, env=env, timeout=600)
    lines = [x for x in out.stdout.splitlines()
             if x.startswith("phase15_first ")]
    if out.returncode != 0 or not lines:
        raise SystemExit("the child (%s) exited %d: %s"
                         % (mode, out.returncode, out.stderr[-3000:]))
    got = json.loads(lines[-1].split(" ", 1)[1])
    host = got.pop("first_step_host")
    got.update(mode=mode, process_s=time.perf_counter() - t0,
               first_step_blocked_launches=host["blocked_launches"],
               first_step_blocked_launch_ms=host["blocked_launch_ms"],
               first_step_runtime_ms_by_name=host["runtime_ms_by_name"])
    return got


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    for _ in range(rounds):
        for mode in ("default", "EAGER"):
            print(json.dumps(run(mode)), flush=True)


if __name__ == "__main__":
    main()
