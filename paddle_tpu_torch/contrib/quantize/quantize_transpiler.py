"""The int8 weight store of a saved model (parity: the JAX package's
``contrib/quantize/quantize_transpiler.py`` `QuantizeTranspiler`
:146-230, `convert_to_int8`). The predictor's ``weight_only`` mode runs
it on its own program and scope.

`training_transpile` and `freeze_program` need the fake-quant ops, which
are not ported (ROADMAP.md Queue 1 item 7): they raise.
"""

import numpy as np
import torch

from ...core.scope import global_scope

__all__ = ["QuantizeTranspiler"]

_QUANTIZABLE = ("conv2d", "depthwise_conv2d", "mul", "matmul")
_FAKE_QUANT = ("the fake-quant ops of quantization-aware training are not "
               "ported to paddle_tpu_torch: ROADMAP.md Queue 1 item 7")


class QuantizeTranspiler:
    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000,
                 moving_rate=0.9):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.activation_quantize_type = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.window_size = window_size
        self.moving_rate = moving_rate

    def training_transpile(self, program=None, startup_program=None):
        raise NotImplementedError(_FAKE_QUANT)

    def freeze_program(self, program, place=None, scope=None):
        raise NotImplementedError(_FAKE_QUANT)

    def convert_to_int8(self, program, place=None, scope=None, skip=()):
        """Store the quantizable ops' weights as int8: each persistable
        input of a conv2d / depthwise_conv2d / mul / matmul is REPLACED
        in `scope` by an int8 twin ``<name>.int8`` holding round(w /
        scale * 127) (scale: the tensor's abs max); the fp32 var stops
        being persistable, loses its scope entry, and a ``dequantize``
        op put first in the block makes it from the twin at run time. The
        twin keeps the scale as ``quant_scale``. Ops that name a var of
        `skip` (an input or an output), and every persistable they read,
        keep fp32."""
        from ... import quant as _quant

        scope = scope or global_scope()
        bnt = (1 << (self.weight_bits - 1)) - 1
        skip = frozenset(skip or ())
        # a weight a skipped op reads stays fp32 even where another op
        # shares it
        protected = set()
        if skip:
            for block in program.blocks:
                for op in block.ops:
                    if op.type in _QUANTIZABLE and (
                            (set(op.input_names())
                             | set(op.output_names())) & skip):
                        protected.update(
                            v.name for vs in op.inputs.values()
                            for v in vs
                            if getattr(v, "persistable", False))
        converted = set()
        saved_bytes = fp32_bytes = 0
        pending = []  # (var, int8 var, scale), prepended after the scan
        for block in program.blocks:
            for op in list(block.ops):
                if op.type not in _QUANTIZABLE:
                    continue
                if skip and ((set(op.input_names())
                              | set(op.output_names())) & skip):
                    continue
                for vs in op.inputs.values():
                    for v in vs:
                        if not getattr(v, "persistable", False) \
                                or v.name in converted \
                                or v.name in protected:
                            continue
                        val = scope.get(v.name)
                        if val is None:
                            continue
                        device = val.device if isinstance(
                            val, torch.Tensor) else "cpu"
                        w = val.detach().cpu().numpy() if isinstance(
                            val, torch.Tensor) else np.asarray(val)
                        scale = max(float(np.abs(w).max()), 1e-8)
                        q = _quant.quantize_to_int8(w, scale, qmax=bnt)
                        iv = program.global_block().create_var(
                            name=v.name + ".int8", shape=v.shape,
                            dtype="int8", persistable=True)
                        iv.quant_scale = scale / bnt
                        scope.set(iv.name, torch.from_numpy(q).to(device))
                        v.persistable = False
                        scope.erase(v.name)
                        pending.append((v, iv, scale))
                        converted.add(v.name)
                        saved_bytes += max(w.nbytes - q.nbytes, 0)
                        fp32_bytes += w.nbytes
        for v, iv, scale in pending:
            program.global_block().prepend_op(
                type="dequantize", inputs={"Input": [iv]},
                outputs={"Output": [v]},
                attrs={"Scale": bnt / scale, "out_dtype": v.dtype})
        if pending:
            _quant.record_weight_store(len(pending), saved_bytes,
                                       fp32_bytes)
        program._bump_version()
        return program
