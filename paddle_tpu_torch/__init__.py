"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for an NVIDIA
H100.

It imports torch and numpy, never jax and nothing of ``paddle_tpu``.
Entry points run on the card (``cuda:0``) unless the caller passes
``"cpu"``; kernels are hand-written for Hopper and built from ``csrc/``
at first use. Ported so far: the serving decode path
(``paddle_tpu_torch.serving``, loaded on demand), the Fluid API's
training path of the flagship Transformer LM with its pass pipeline
(``ir_passes``), mixed precision (``amp.decorate`` and the contrib
decorator, dynamic loss scaling) and asynchronous executor (the
in-flight window and feed prefetcher, ``async_engine``), the headline
training bench (``python -m paddle_tpu_torch.bench``), full-int8
inference (``quant.calibrate`` -> ``quant.decorate(program,
"full_int8", table)`` -> ``Executor.run``, each dense layer one fused
int8 matmul), and the serving fleet and online hot swap
(``serving.ServingRouter``, ``serving.OnlineUpdater``, with
``checkpoint``, ``inference.export_generation_model`` and the serving
subset of ``resilience``), and training as Fluid users configure it
(the optimizer family, ``clip``, ``regularizer``, the learning-rate
schedules, dropout and ``layers.recompute``, the flagship's default),
and control flow (``While``, ``cond``, ``Switch``, ``IfElse``,
``StaticRNN``, ``DynamicRNN``, tensor arrays) with what is built on it
(``piecewise_decay``, ``ExponentialMovingAverage``,
``GradientMergeOptimizer``, ``ModelAverage`` and
``transformer_fluid.build_stacked``), and image classification
(``conv2d`` and ``depthwise_conv2d``: fp32 as GEMMs over the unfolded
input, bf16 on cuDNN; ``pool2d``, ``batch_norm``
with its moving statistics, ``cross_entropy``, ``top_k`` and
``accuracy``; ``nets.simple_img_conv_pool`` and ``nets.img_conv_group``;
the builders ``models.mnist``, ``models.resnet``, ``models.vgg`` and
``models.se_resnext``), and the inference predictor
(``io.save_inference_model`` / ``load_inference_model``,
``inference.AnalysisConfig`` -> ``create_paddle_predictor``: the
load-time passes ``conv_bn_fold``, ``dropout_remove`` and
``conv_elementwise_add_fuse``, and ``enable_quantize("full_int8" |
"weight_only")``), and the rest of benchmark/fluid's model set
(``models.deepfm``, ``models.word2vec``, ``models.stacked_lstm``,
``models.machine_translation`` with its beam decoder, over the tensor,
sequence and recurrent ops, ``auc`` and beam search) with the port's
harness (``python -m paddle_tpu_torch.fluid_benchmark``), and the native
flagship (``models.transformer``: plain functions over a stacked
parameter tree, trained by ``bench.bench_transformer``, the harness's
``--model transformer_native``) with the step cost accounting
(``observability.cost``: a step's FLOPs and MFU):

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer_fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        tokens, labels, loss = transformer_fluid.build(dtype="bfloat16")
        fluid.clip.set_gradient_clip(fluid.clip.GradientClipByGlobalNorm(1.0))
        fluid.contrib.mixed_precision.decorate(fluid.optimizer.Adam(
            learning_rate=fluid.layers.noam_decay(512, 4000),
            regularization=fluid.regularizer.L2Decay(1e-4))).minimize(loss)
    exe = fluid.Executor()              # cuda:0
    exe.run(startup)
    loss_value, = exe.run(main, feed={...}, fetch_list=[loss])
"""

from . import (amp, async_engine, checkpoint, clip, contrib,  # noqa: F401
               flags, inference, initializer, io, ir, layers, nets,
               optimizer, quant, regularizer, resilience, transpiler,
               unique_name)
from .backward import append_backward  # noqa: F401
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .executor import Executor  # noqa: F401
from .framework import (Program, Variable, default_main_program,  # noqa: F401
                        default_startup_program, program_guard)
from .param_attr import ParamAttr  # noqa: F401

__all__ = ["Executor", "ParamAttr", "Program", "Scope", "Variable",
           "amp", "append_backward", "async_engine", "checkpoint", "clip",
           "contrib", "default_main_program", "default_startup_program",
           "flags", "global_scope", "inference", "initializer", "io", "ir",
           "layers", "nets", "optimizer", "program_guard", "quant",
           "regularizer", "resilience", "scope_guard", "transpiler",
           "unique_name"]
