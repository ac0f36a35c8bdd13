"""chip_smoke.py's phase 18 (the ZeRO ladder: ShardedAdam training the
native flagship at full width) alone.

Builds the port's kernels, prints the card's name and power limit, then
runs ``chip_smoke.zero_phase``: K1 checked and timed at 18b's rank shape,
18a on cuda:0 (every leg, one ``zero_train`` line each), 18c (bench.py's
bench_zero receipt, one ``bench_zero`` line) and, with four cards
visible, 18b over four child processes (one ``zero_multi`` line a leg);
with fewer, one line saying it needs four.

Run from the repository's root on a machine with CUDA cards:
``python3 probes/zero_phase18.py`` (four cards for 18b).
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402


def main():
    t0 = time.perf_counter()
    _build.build()
    print("build %.1f s" % (time.perf_counter() - t0), flush=True)
    print(cs.card_line(), flush=True)
    launches = cs.zero_phase(torch, fa)
    print("phase 18 passed, K1 launches %r in %.1f s"
          % (launches, time.perf_counter() - t0), flush=True)


if __name__ == "__main__":
    main()
