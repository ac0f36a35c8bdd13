"""chip_smoke.py's phase 16 (the SPMD Transformer trainer) alone.

Builds the port's kernels, prints the card's name and power limit, then
runs ``one``: 16a-b on cuda:0 and 16c over the visible cards
(``chip_smoke.spmd_phase``), or ``multi``: 16c alone, one child process
a visible card, its ``spmd_multi`` lines and its gates' failures.

Run from the repository's root on a machine with CUDA cards:
``python3 probes/spmd_phase16.py one|multi`` (four cards for 16c's
world-4 meshes).
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402


def main(mode):
    t0 = time.perf_counter()
    _build.build()
    print("build %.1f s" % (time.perf_counter() - t0), flush=True)
    print(cs.card_line(), flush=True)
    if mode == "one":
        cs.spmd_phase(torch, fa)
        return
    world = torch.cuda.device_count()
    t = time.perf_counter()
    results = cs.run_ranks(cs.SPMD_RANK_FLAG, "phase16_rank", world, 900)
    for name in results[0]["legs"]:
        print("spmd_multi " + json.dumps({
            "leg": name, "world": world,
            "ranks": [dict(r["legs"][name], rank=r["rank"])
                      for r in results]}), flush=True)
    bad = cs.check_spmd_ranks(results, on_card=True)
    print("16c %.1f s, failures: %r" % (time.perf_counter() - t, bad))
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main(sys.argv[1])
