"""The inference predictor and the generation-serving artifacts (parity:
the JAX package's ``inference.py``: `PaddleTensor`, `AnalysisConfig`,
`_resolve_feed`, `AnalysisPredictor` and `create_paddle_predictor`
:29-200, `export_generation_model` and `load_generation_model`).

The predictor loads a model directory that ``io.save_inference_model``
wrote (by either package) into a scope of its own, runs the load-time
passes ``conv_bn_fold``, ``dropout_remove`` and
``conv_elementwise_add_fuse`` once (``switch_ir_optim(False)`` skips
them), quantizes when ``enable_quantize`` asked for it
(``quant.quantize_predictor_program``), and runs the program through an
``Executor``:

    config = inference.AnalysisConfig(model_dir)       # cuda:0
    config.enable_quantize("full_int8", calibration_table=table)
    predictor = inference.create_paddle_predictor(config)
    probs, = predictor.run_dict({"img": batch})

A config runs on ``cuda:0`` (``enable_use_gpu(device_id=n)``:
``cuda:n``) and creating its predictor raises without CUDA; only
``disable_gpu()`` selects the CPU. Nothing falls back to another device.

``export_generation_model`` lifts the decoder of a Program built by
``models.transformer_fluid.build(remat=False)`` out of a scope into the
serving layout and publishes it atomically as the JAX package's
generation artifact (``__generation__.npz``, the config JSON and the
sha256 manifest, written last); ``load_generation_model`` serves one.
The one-shot serving exports of the JAX module (``export_serving_model``,
``load_serving_model``, ``ServingPredictor``) write ``jax.export``
artifacts and are not ported (ROADMAP.md Queue 1 item 12).
"""

import numpy as np
import torch

from . import framework, io
from .core.scope import Scope, global_scope, scope_guard
from .executor import Executor

__all__ = ["AnalysisConfig", "AnalysisPredictor", "create_paddle_predictor",
           "PaddleTensor", "export_generation_model",
           "load_generation_model"]

class PaddleTensor:
    """A named input or output array."""

    def __init__(self, data=None, name=None, lod=None):
        self.name = name
        self.data = np.asarray(data) if data is not None else None
        self.lod = lod or []
        self.shape = tuple(self.data.shape) if data is not None else None

    def as_ndarray(self):
        return self.data


class AnalysisConfig:
    """A predictor's configuration: the model directory, the device
    (``cuda:0`` unless ``disable_gpu()``), whether the load-time passes
    run, pinned feed shapes to warm up at creation, and quantization.
    The TensorRT and MKLDNN switches are accepted and do nothing."""

    def __init__(self, model_dir=None, params_file=None):
        self.model_dir = model_dir
        self.prog_file = None
        self.params_file = params_file
        self._device = None  # cuda:0
        self._ir_optim = True
        self._aot_shapes = None
        self._quant_mode = None
        self._quant_table = None
        self._quant_blacklist = None

    def set_model(self, model_dir, params_file=None):
        self.model_dir = model_dir
        self.params_file = params_file

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = "cuda:%d" % device_id

    def disable_gpu(self):
        self._device = "cpu"

    def switch_ir_optim(self, x=True):
        self._ir_optim = x

    def enable_tensorrt_engine(self, *a, **k):
        pass

    def enable_mkldnn(self):
        pass

    def set_aot_shapes(self, feed_shapes):
        """Pin feed shapes {name: shape}: the predictor runs once on
        zeros of those shapes at creation, so the first real run finds
        its step planned."""
        self._aot_shapes = dict(feed_shapes)

    def enable_quantize(self, mode="weight_only", calibration_table=None,
                        blacklist=None):
        """Quantize the loaded model at predictor creation:
        ``weight_only`` stores the quantizable ops' weights int8 in the
        predictor's scope (``QuantizeTranspiler.convert_to_int8``),
        dequantized on use; ``full_int8`` also runs each dense layer as
        one int8 matmul (K4) and each convolution without a folded bias
        on int8 operands, and needs `calibration_table` (a
        ``quant.CalibrationTable``, a dict or a saved table's path).
        With ``switch_ir_optim(False)`` the model loads as saved,
        unquantized."""
        self._quant_mode = mode
        self._quant_table = calibration_table
        self._quant_blacklist = blacklist


def _resolve_feed(inputs, feed_names):
    """A positional or named PaddleTensor list -> {name: array}."""
    feed = {}
    for i, t in enumerate(inputs):
        name = t.name if getattr(t, "name", None) else feed_names[i]
        feed[name] = t.data if isinstance(t, PaddleTensor) else t
    return feed


class AnalysisPredictor:
    """Load, optimize and run a saved inference program, in a scope of
    its own: the user's scope and the model directory are never
    changed."""

    def __init__(self, config: AnalysisConfig):
        self._config = config
        self._scope = Scope()
        self._exe = Executor(config._device)   # raises without the device
        with scope_guard(self._scope):
            self._program, self._feed_names, self._fetch_vars = \
                io.load_inference_model(config.model_dir, self._exe,
                                        model_filename=config.prog_file,
                                        params_filename=config.params_file)
        if config._ir_optim:
            from . import ir

            # pin the fetch targets: no rewrite may orphan an output the
            # predictor fetches
            self._program._opt_fetch_targets = tuple(
                v.name for v in self._fetch_vars)
            ir.apply_passes(self._program,
                            ["conv_bn_fold", "dropout_remove",
                             "conv_elementwise_add_fuse"], self._scope)
        if config._quant_mode and config._ir_optim:
            from . import quant

            quant.quantize_predictor_program(
                self._program, self._scope, mode=config._quant_mode,
                table=config._quant_table,
                blacklist=config._quant_blacklist)
        if config._aot_shapes:
            self._warmup(config._aot_shapes)

    def _warmup(self, shapes):
        block = self._program.global_block()
        self.run_dict({name: torch.zeros(
            tuple(shapes[name]),
            dtype=framework.torch_dtype(block.var(name).dtype))
            for name in self._feed_names})

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return [v.name for v in self._fetch_vars]

    def run_dict(self, feed):
        """{feed name: array or tensor} -> the fetches as numpy arrays."""
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_vars, scope=self._scope)

    def run(self, inputs):
        """inputs: a list of PaddleTensor (positional or named); returns
        a list of PaddleTensor."""
        outs = self.run_dict(_resolve_feed(inputs, self._feed_names))
        return [PaddleTensor(o, name=v.name)
                for o, v in zip(outs, self._fetch_vars)]


def create_paddle_predictor(config):
    return AnalysisPredictor(config)


def export_generation_model(dirname, program, scope=None, max_seq_len=None):
    """Export a Program built by ``models.transformer_fluid.build``
    (``remat=False``, no dropout) as a generation artifact in
    ``dirname``: fp32 decoder weights in the serving layout, the
    ``GenerationConfig`` and a per-weight digest manifest. The publish is
    atomic (a temp dir and a rename, the manifest last), so a reader sees
    the complete artifact or the previous one, and a torn write is caught
    by ``verify_generation_artifact``. ``scope`` defaults to the global
    scope. Returns the ``GenerationConfig``."""
    from .serving import model as _serving_model

    scope = scope if scope is not None else global_scope()
    config, weights = _serving_model.extract_decoder_weights(
        program, scope, max_seq_len=max_seq_len)
    _serving_model.save_generation_artifact(dirname, config, weights)
    return config


def load_generation_model(dirname, name=None, quantize=None, device=None):
    """The ``GenerationModel`` of an exported artifact, on ``device``
    (None: ``cuda:0``), ready for ``ServingEngine``.
    ``quantize="weight_only"`` serves it from the int8 weight store."""
    from .serving import model as _serving_model

    return _serving_model.load_generation_artifact(
        dirname, name=name, quantize=quantize, device=device)
