"""chip_smoke.py's phase 19 (the Fluid pipeline) alone.

Builds the port's kernels, prints the card's name and power limit, then
runs ``chip_smoke.pp_phase``: 19a on cuda:0 (the headline program's
stage split, crossings and schedules against the JAX package's table;
K1 checked and timed at a microbatch's shape) and, with four cards
visible, 19b and 19c over four child processes (one ``pp_multi`` line a
leg); with fewer, one line saying they need four.

Run from the repository's root on a machine with CUDA cards:
``python3 probes/pp_phase19.py`` (four cards for 19b and 19c).
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
    launches = cs.pp_phase(torch, fa, fluid)
    print("phase 19 passed, K1 launches %r" % launches, flush=True)


if __name__ == "__main__":
    main()
