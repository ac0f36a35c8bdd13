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
(``observability.cost``: a step's FLOPs and MFU), and training fed from
recordio shards and kept alive (``convert_reader_to_recordio_file``,
``recordio_writer``, ``reader`` and ``batch``, ``DataFeeder``,
``data_plane`` with ``DatasetCursor``, ``DatasetFactory`` ->
``QueueDataset`` / ``InMemoryDataset``, ``Executor.train_from_dataset``,
``checkpoint.CheckpointManager`` and ``ResilientTrainer``), and
data-parallel training (``CompiledProgram(main).with_data_parallel(
loss_name=...)``, ``ParallelExecutor`` and
``incubate.fleet.collective.fleet``: one process a rank over
``torch.distributed``, NCCL on the card and gloo on the CPU, each step
what one device gives on the global batch), and the telemetry plane
(``observability``: metrics with JSON and Prometheus exposition, spans
forwarded to ``torch.profiler`` and NVTX, the flight recorder, the
``/metrics`` / ``/varz`` / ``/healthz`` endpoint; ``profiler``: the
Fluid profiler API and the device time by Fluid op;
``analysis.concurrency``: the lock-order detector under
``PTPU_LOCK_CHECK=1``):

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

    dataset = fluid.DatasetFactory().create_dataset("QueueDataset")
    dataset.set_filelist(shards)        # convert_reader_to_recordio_file
    dataset.set_batch_size(160)
    dataset.set_use_var([tokens, labels])
    trainer = fluid.ResilientTrainer(exe, main, fetch_list=[loss],
                                     checkpoint_dir="ckpt",
                                     checkpoint_every=100)
    trainer.restore()                   # None on a fresh run
    cursor = (fluid.DatasetCursor.from_scope(fluid.global_scope())
              or fluid.DatasetCursor(seed=3))
    result = trainer.run(dataset.resumable_batches(
        cursor, epochs=2, scope=fluid.global_scope()))
"""

from . import (amp, async_engine, checkpoint, clip, compiler,  # noqa: F401
               contrib, data_plane, flags, incubate, inference,
               initializer, io, ir, layers, nets, observability,
               optimizer, parallel, profiler, quant, reader,
               recordio_writer, regularizer, resilience, transpiler,
               unique_name)
from .backward import append_backward  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy)
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .data_feeder import DataFeedDesc, DataFeeder  # noqa: F401
from .data_plane import DatasetCursor  # noqa: F401
from .dataset_api import (DatasetFactory, InMemoryDataset,  # noqa: F401
                          QueueDataset)
from .executor import Executor  # noqa: F401
from .framework import (Program, Variable, default_main_program,  # noqa: F401
                        default_startup_program, pipeline_stage,
                        program_guard)
from .param_attr import ParamAttr  # noqa: F401
from .parallel import ParallelExecutor  # noqa: F401
from .reader import batch  # noqa: F401
from .recordio_writer import convert_reader_to_recordio_file  # noqa: F401
from .resilience import ResilientTrainer  # noqa: F401

__all__ = ["BuildStrategy", "CompiledProgram", "DataFeedDesc", "DataFeeder",
           "DatasetCursor", "DatasetFactory", "ExecutionStrategy",
           "Executor", "InMemoryDataset", "ParallelExecutor", "ParamAttr",
           "Program", "QueueDataset", "ResilientTrainer", "Scope",
           "Variable", "amp", "append_backward", "async_engine", "batch",
           "checkpoint", "clip", "compiler", "contrib",
           "convert_reader_to_recordio_file", "data_plane",
           "default_main_program", "default_startup_program", "flags",
           "global_scope", "incubate", "inference", "initializer", "io",
           "ir", "layers", "nets", "observability", "optimizer",
           "parallel", "pipeline_stage", "profiler", "program_guard", "quant", "reader", "recordio_writer",
           "regularizer", "resilience", "scope_guard", "transpiler",
           "unique_name"]
