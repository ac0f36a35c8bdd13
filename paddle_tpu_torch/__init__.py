"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for an NVIDIA
H100.

It imports torch and numpy, never jax and nothing of ``paddle_tpu``.
Entry points run on the card (``cuda:0``) unless the caller passes
``"cpu"``; kernels are hand-written for Hopper and built from ``csrc/``
at first use. Ported so far: the serving decode path
(``paddle_tpu_torch.serving``, loaded on demand), the Fluid API's
training path of the flagship Transformer LM, and its full-int8
inference (``quant.calibrate`` -> ``quant.decorate(program,
"full_int8", table)`` -> ``Executor.run``, each dense layer one fused
int8 matmul):

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer_fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        tokens, labels, loss = transformer_fluid.build(
            seq_len=512, remat=False, dtype="bfloat16")
        fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.SGD(0.01), init_loss_scaling=1.0,
            use_dynamic_loss_scaling=False).minimize(loss)
    exe = fluid.Executor()              # cuda:0
    exe.run(startup)
    loss_value, = exe.run(main, feed={...}, fetch_list=[loss])
"""

from . import (contrib, flags, initializer, io, layers, nets,  # noqa: F401
               optimizer, quant, unique_name)
from .backward import append_backward  # noqa: F401
from .core.scope import Scope, global_scope  # noqa: F401
from .executor import Executor  # noqa: F401
from .framework import (Program, Variable, default_main_program,  # noqa: F401
                        default_startup_program, program_guard)
from .param_attr import ParamAttr  # noqa: F401

__all__ = ["Executor", "ParamAttr", "Program", "Scope", "Variable",
           "append_backward", "contrib", "default_main_program",
           "default_startup_program", "flags", "global_scope",
           "initializer", "io", "layers", "nets", "optimizer",
           "program_guard", "quant", "unique_name"]
