"""chip_smoke.py's phase 17 (Fluid tensor parallelism and ZeRO-1) alone.

Builds the port's kernels, prints the card's name and power limit, then
runs ``chip_smoke.tp_phase``: 17a on cuda:0 (the headline program's plan
against the JAX planner's table, its predicted collectives, K1 checked
and timed at the tp-local shapes) and, with four cards visible, 17b and
17c over four child processes (one ``tp_multi`` line a leg); with fewer,
one line saying they need four.

Run from the repository's root on a machine with CUDA cards:
``python3 probes/tp_phase17.py`` (four cards for 17b and 17c).
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

import paddle_tpu_torch as fluid  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402


def main():
    t0 = time.perf_counter()
    _build.build()
    print("build %.1f s" % (time.perf_counter() - t0), flush=True)
    print(cs.card_line(), flush=True)
    launches = cs.tp_phase(torch, fa, fluid)
    print("phase 17 passed, K1 launches %r" % launches, flush=True)


if __name__ == "__main__":
    main()
