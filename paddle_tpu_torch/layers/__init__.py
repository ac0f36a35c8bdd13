"""Layers DSL (parity: the JAX package's ``layers/``): the layers of the
Fluid-API Transformer LM and of a Fluid training script's front end —
dropout, the clip and math layers, ``recompute``, the learning-rate
schedules and control flow — of the image classifiers (conv2d, pool2d,
batch_norm, cross_entropy, accuracy) and of the benchmark models (the
tensor and sequence layers, the recurrences, auc and beam search)."""

from . import (control_flow, extras, io, learning_rate_scheduler, metric_op,
               nn, sequence, tensor)
from .extras import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403

__all__ = sorted(set(control_flow.__all__) | set(extras.__all__)
                 | set(io.__all__) | set(learning_rate_scheduler.__all__)
                 | set(metric_op.__all__) | set(nn.__all__)
                 | set(sequence.__all__) | set(tensor.__all__))
