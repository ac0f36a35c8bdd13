"""`paddle_tpu_torch.serving` — continuous-batching generation serving
on a CUDA device: iteration-level scheduling over one fixed-shape
decode step, a blocked KV-cache pool, speculative verify windows
(linear and tree), and paged attention by hand-written CUDA kernels.

    from paddle_tpu_torch import serving
    model = serving.GenerationModel.random(cfg)          # on cuda:0
    with serving.ServingEngine(model, spec_tree="2x6") as engine:
        tokens = engine.generate([1, 2, 3], max_new_tokens=16)

This slice serves the one-token-prefill decode path and speculative
decoding with the n-gram drafter. Chunked prefill, the model drafter,
prefix caching, the int8 weight store, weight swaps, the router,
tracing and the flight recorder of the JAX package are not ported yet.
"""

from .engine import ServingEngine  # noqa: F401
from .kv_cache import KVBlockPool, blocks_needed  # noqa: F401
from .loadgen import PoissonLoadGenerator  # noqa: F401
from .model import (GenerationConfig, GenerationModel,  # noqa: F401
                    NGramDrafter, parse_tree_shape, random_weights,
                    reference_decode, tree_topology, weight_names)
from .scheduler import (AdmissionError, GenerationRequest,  # noqa: F401
                        RequestQueue, StepScheduler, spec_tree_acceptance)

__all__ = ["ServingEngine", "KVBlockPool", "blocks_needed",
           "PoissonLoadGenerator", "GenerationConfig", "GenerationModel",
           "NGramDrafter", "parse_tree_shape", "random_weights",
           "reference_decode", "tree_topology", "weight_names",
           "AdmissionError", "GenerationRequest", "RequestQueue",
           "StepScheduler", "spec_tree_acceptance"]
