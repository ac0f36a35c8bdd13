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
and writes the JAX package's generation artifact. One engine serves
several models (``ServingEngine({"a": m_a, "b": m_b})``), with
per-request deadlines, health, kill and atomic weight hot swaps
(``swap_weights``); ``ServingRouter`` fronts engine replicas with
least-loaded dispatch, a health machine and failover; ``OnlineUpdater``
rolls new checkpoints across a router's fleet behind a ``CanaryGate``.
"""

from .engine import ServingEngine  # noqa: F401
from .kv_cache import (KVBlockPool, blocks_needed,  # noqa: F401
                       prefix_chain_keys)
from .loadgen import PoissonLoadGenerator  # noqa: F401
from .model import (GenerationArtifactError,  # noqa: F401
                    GenerationConfig, GenerationModel, ModelDrafter,
                    NGramDrafter, extract_decoder_weights,
                    load_generation_artifact,
                    parse_tree_shape, random_weights, reference_decode,
                    save_generation_artifact, tree_topology,
                    verify_generation_artifact, weight_names)
from .online import CanaryGate, OnlineUpdater  # noqa: F401
from .router import ServingRouter  # noqa: F401
from .scheduler import (AdmissionError, DeadlineExceededError,  # noqa: F401
                        GenerationRequest, RequestQueue, StepScheduler,
                        spec_tree_acceptance)

__all__ = ["ServingEngine", "ServingRouter", "OnlineUpdater", "CanaryGate",
           "KVBlockPool", "blocks_needed",
           "prefix_chain_keys", "PoissonLoadGenerator",
           "GenerationArtifactError", "GenerationConfig", "GenerationModel",
           "ModelDrafter", "NGramDrafter", "extract_decoder_weights",
           "load_generation_artifact",
           "parse_tree_shape", "random_weights", "reference_decode",
           "save_generation_artifact", "tree_topology",
           "verify_generation_artifact", "weight_names",
           "AdmissionError", "DeadlineExceededError", "GenerationRequest",
           "RequestQueue",
           "StepScheduler", "spec_tree_acceptance"]
