"""`paddle_tpu_torch.serving` — continuous-batching generation serving
on a CUDA device: iteration-level scheduling over one fixed-shape
decode step, a blocked KV-cache pool, speculative verify windows
(linear and tree), and paged attention by hand-written CUDA kernels.

    from paddle_tpu_torch import serving
    model = serving.GenerationModel.random(cfg)          # on cuda:0
    with serving.ServingEngine(model, spec_tree="2x6") as engine:
        tokens = engine.generate([1, 2, 3], max_new_tokens=16)

It serves one-token and chunked prefill, radix prefix caching,
speculative decoding with the n-gram drafter or a model drafter, and
the weight-only int8 store (``GenerationModel.quantized``), and reads
and writes the JAX package's generation artifact. Weight swaps,
deadlines, the router, fault injection, tracing and the flight recorder
of the JAX package are not ported yet.
"""

from .engine import ServingEngine  # noqa: F401
from .kv_cache import (KVBlockPool, blocks_needed,  # noqa: F401
                       prefix_chain_keys)
from .loadgen import PoissonLoadGenerator  # noqa: F401
from .model import (GenerationArtifactError,  # noqa: F401
                    GenerationConfig, GenerationModel, ModelDrafter,
                    NGramDrafter, load_generation_artifact,
                    parse_tree_shape, random_weights, reference_decode,
                    save_generation_artifact, tree_topology,
                    verify_generation_artifact, weight_names)
from .scheduler import (AdmissionError, GenerationRequest,  # noqa: F401
                        RequestQueue, StepScheduler, spec_tree_acceptance)

__all__ = ["ServingEngine", "KVBlockPool", "blocks_needed",
           "prefix_chain_keys", "PoissonLoadGenerator",
           "GenerationArtifactError", "GenerationConfig", "GenerationModel",
           "ModelDrafter", "NGramDrafter", "load_generation_artifact",
           "parse_tree_shape", "random_weights", "reference_decode",
           "save_generation_artifact", "tree_topology",
           "verify_generation_artifact", "weight_names",
           "AdmissionError", "GenerationRequest", "RequestQueue",
           "StepScheduler", "spec_tree_acceptance"]
