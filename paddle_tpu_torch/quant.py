"""Post-training int8 quantized inference (parity: the JAX package's
``quant.py`` :1-760).

Workflow, the same entry points as the JAX package's:

  1. **Calibrate** — ``calibrate(program, sample_feeds,
     strategy='abs_max'|'percentile')`` runs the fp32 program over a few
     representative feeds and collects per-tensor activation ranges
     (per-CHANNEL ranges for the persistable weights, read from the
     scope) into a :class:`CalibrationTable`, whose JSON the two
     packages share.
  2. **Decorate** — ``decorate(infer_program, mode="full_int8",
     table=table)`` pins a :class:`QuantConfig` on the program.
  3. **Run** — ``Executor.run`` runs the ``quant_rewrite`` pass on a
     clone of the program at each compile-cache miss
     (``ir_passes.optimize_for_execution``):

       full_int8    each eligible ``mul`` (and plain ``matmul``) becomes
                    one ``fused_int8_matmul`` op — the activation
                    quantized in the kernel, an int8 x int8 -> int32
                    product, the per-channel dequantize at the end: the
                    hand-written kernel K4 (``ops/int8_matmul.py``). An op
                    whose activation has no table entry falls back to
                    weight_only.
       weight_only  the weight is stored int8 (a baked scope entry) and a
                    ``dequantize_linear`` op rebuilds the fp32 weight on
                    use; the product stays fp32.

     Grad-referenced ops, optimizer ops, structural ops, non-fp32
     operands and black-listed names are never rewritten. The user's
     program and its scope entries are left as they were: int8 weights
     and scales bake as fresh content-addressed scope entries
     (``__quant__.<sha1>.<name>``), identical in name and content to the
     JAX package's.

The JAX package emits the fused op only where its Pallas kernel's
dispatch policy has it on (a TPU, or ``PTPU_KERNELS=1``), and the
quantize -> int32 mul -> dequantize_linear chain elsewhere; the port has
no ``PTPU_KERNELS`` and always emits the fused op.

``PTPU_QUANT=1`` activates a process-wide default (``PTPU_QUANT_MODE``,
``PTPU_QUANT_TABLE``, ``PTPU_QUANT_BLACKLIST``). Telemetry:
``quant/{ops_rewritten,weights_quantized,calib_tensors,
weight_bytes_saved,weight_fp32_bytes}`` through the metrics registry.

Not ported yet: ``quantize_predictor_program`` (waits for the
predictor), and the ``conv2d`` and ``matmul`` sites run no op of the
port yet.
"""

import hashlib
import json
import os

import numpy as np
import torch

from .flags import env as _env
from .ir import Pass, register_pass
from .observability import metrics as _metrics

__all__ = [
    "CalibrationTable", "QuantConfig", "calibrate", "decorate",
    "active_config", "quant_env_enabled", "weight_channel_scales",
    "quantize_to_int8", "quantize_symmetric", "weight_store_bytes",
    "DEFAULT_QUANT_OPS",
]

# white list: dot ops whose persistable weight operand can store int8
DEFAULT_QUANT_OPS = frozenset({
    "mul", "matmul", "conv2d", "depthwise_conv2d",
})

# per-op-type slot layout: (activation slot, weight slot)
_SLOTS = {
    "mul": ("X", "Y"),
    "matmul": ("X", "Y"),
    "conv2d": ("Input", "Filter"),
    "depthwise_conv2d": ("Input", "Filter"),
}

_QMAX = 127.0        # symmetric int8 grid
_EPS = 1e-8

MODES = ("weight_only", "full_int8")


def _check_ops(ops):
    """Validate a user-supplied quantizable-op set against the known slot
    layouts: an unknown op type raises with the supported list."""
    ops = frozenset(ops)
    unknown = ops - frozenset(_SLOTS)
    if unknown:
        raise ValueError(
            "unsupported quantizable op type(s) %s — supported: %s"
            % (sorted(unknown), sorted(_SLOTS)))
    return ops


def _host(value):
    """A scope value (a tensor on any device) as an fp32 numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).numpy()
    return np.asarray(value, np.float32)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


class CalibrationTable:
    """Serializable per-tensor ranges: ``acts`` maps an activation var
    name to its scalar range (abs-max or percentile of |x| over the
    calibration feeds — the value `s` such that the int8 grid spans
    [-s, s]); ``weights`` maps a weight var name to its per-output-
    channel ranges plus the channel axis. JSON round-trips via
    save/load, in the JAX package's format."""

    def __init__(self, acts=None, weights=None, strategy="abs_max",
                 percentile=None):
        self.acts = {str(k): float(v) for k, v in (acts or {}).items()}
        self.weights = {str(k): {"scales": [float(s) for s in v["scales"]],
                                 "axis": int(v["axis"])}
                        for k, v in (weights or {}).items()}
        self.strategy = strategy
        self.percentile = percentile
        self._digest = None

    def act_scale(self, name):
        return self.acts.get(name)

    def weight_scales(self, name):
        w = self.weights.get(name)
        return None if w is None else (np.asarray(w["scales"], np.float32),
                                       w["axis"])

    def to_dict(self):
        return {"strategy": self.strategy, "percentile": self.percentile,
                "acts": self.acts, "weights": self.weights}

    @classmethod
    def from_dict(cls, d):
        return cls(acts=d.get("acts"), weights=d.get("weights"),
                   strategy=d.get("strategy", "abs_max"),
                   percentile=d.get("percentile"))

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, path):
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def digest(self):
        # memoized: it sits on the per-run cache-key path, and a table is
        # not changed once handed to a QuantConfig
        if self._digest is None:
            h = hashlib.sha1()
            h.update(repr((
                self.strategy, self.percentile,
                sorted(self.acts.items()),
                sorted((k, tuple(v["scales"]), v["axis"])
                       for k, v in self.weights.items()))).encode())
            self._digest = h.hexdigest()[:10]
        return self._digest


def record_weight_store(n_weights, saved_bytes, fp32_bytes):
    """The one emitter of the weight-store telemetry triple."""
    _metrics.counter("quant/weights_quantized").inc(n_weights)
    _metrics.counter("quant/weight_bytes_saved").inc(saved_bytes)
    _metrics.counter("quant/weight_fp32_bytes").inc(fp32_bytes)


def weight_store_bytes(weights):
    """Byte accounting for a (possibly int8) weight dict of arrays or
    tensors: ``n_int8`` int8-stored entries, ``int8_bytes`` they occupy
    (int8 payload plus their fp32 ``@qscale`` companions) and
    ``fp32_bytes`` the same entries would occupy dequantized. Shapes and
    dtypes only."""
    n_int8 = 0
    int8_bytes = 0
    fp32_bytes = 0
    for key, v in weights.items():
        size = (int(v.numel()) if isinstance(v, torch.Tensor)
                else int(getattr(v, "size", np.asarray(v).size)))
        if str(getattr(v, "dtype", "")).replace("torch.", "") == "int8":
            n_int8 += 1
            int8_bytes += size
            fp32_bytes += size * 4
        elif key.endswith("@qscale"):
            int8_bytes += size * 4
    return {"n_int8": n_int8, "int8_bytes": int8_bytes,
            "fp32_bytes": fp32_bytes}


def quantize_to_int8(w, scale_broadcast, qmax=_QMAX):
    """THE symmetric int8 grid: round(w / s * qmax) clipped to
    [-qmax, qmax], with `scale_broadcast` already shaped to broadcast
    onto `w`."""
    return np.clip(np.round(np.asarray(w, np.float32) / scale_broadcast
                            * qmax), -qmax, qmax).astype(np.int8)


def quantize_symmetric(w, channel_axis=-1):
    """Per-channel symmetric int8 quantization along one axis: returns
    ``(q, scales)`` with ``w ≈ q * (scales / 127)`` broadcast along
    `channel_axis` (abs-max ranges reduced over every other axis)."""
    w = np.asarray(w, np.float32)
    ax = channel_axis % w.ndim
    reduce_axes = tuple(i for i in range(w.ndim) if i != ax)
    s = np.maximum(np.abs(w).max(axis=reduce_axes) if reduce_axes
                   else np.abs(w), _EPS).astype(np.float32)
    shape = [1] * w.ndim
    shape[ax] = s.size
    return quantize_to_int8(w, s.reshape(shape)), s


def weight_channel_scales(w, op_type, attrs=None):
    """Per-output-channel abs-max ranges of one weight array plus the
    channel axis: conv filters over C_out (axis 0); mul/matmul weights
    over the output-feature axis (the trailing dims past y_num_col_dims
    for `mul`, rows under transpose_Y for `matmul`)."""
    attrs = attrs or {}
    w = np.asarray(w)
    if op_type in ("conv2d", "depthwise_conv2d"):
        axis = 0
        s = np.abs(w.reshape(w.shape[0], -1)).max(axis=1)
    elif op_type == "matmul" and attrs.get("transpose_Y"):
        axis = 0
        s = np.abs(w.reshape(w.shape[0], -1)).max(axis=1)
    else:
        yn = int(attrs.get("y_num_col_dims", 1)) if op_type == "mul" \
            else w.ndim - 1
        axis = yn
        s = np.abs(w.reshape(int(np.prod(w.shape[:yn])), -1)).max(axis=0)
    return np.maximum(s, _EPS).astype(np.float32), axis


def _quantizable_sites(program, white):
    """[(op, act var, weight var)] for every global-block white op with a
    persistable, never-in-block-written fp32 weight operand — skipping
    grad, optimizer and structural ops."""
    from .core.lowering import _SPECIAL, _STRUCTURAL
    from .framework import (_AMP_STATE_OP_TYPES, _OPTIMIZER_OP_TYPES,
                            Block, Operator, convert_dtype)
    from .ir_passes import _grad_referenced_ids, _write_indices

    block = program.global_block()
    writes = _write_indices(block)
    grad_refed = _grad_referenced_ids(program)
    sites = []
    for op in block.ops:
        if op.type not in white or id(op) in grad_refed:
            continue
        if ("__fwd_op__" in op.attrs or op.type in _OPTIMIZER_OP_TYPES
                or op.type in _AMP_STATE_OP_TYPES
                or op.type in _STRUCTURAL or op.type in _SPECIAL
                or any(isinstance(a, (Block, Operator))
                       for a in op.attrs.values())):
            continue
        aslot, wslot = _SLOTS[op.type]
        avs = op.inputs.get(aslot, [])
        wvs = op.inputs.get(wslot, [])
        if len(avs) != 1 or len(wvs) != 1:
            continue
        a, w = avs[0], wvs[0]
        if not getattr(w, "persistable", False) or writes.get(w.name):
            continue
        if convert_dtype(w.dtype) != "float32" \
                or convert_dtype(a.dtype) != "float32":
            continue
        sites.append((op, a, w))
    return sites


def calibrate(program, sample_feeds, strategy="abs_max", percentile=99.9,
              scope=None, place=None, ops=None,
              max_samples_per_tensor=1 << 19):
    """Run the fp32 `program` over `sample_feeds` (an iterable of feed
    dicts) and collect a :class:`CalibrationTable`: per-tensor activation
    ranges for every quantizable op's activation input (``abs_max`` keeps
    the running max of |x|; ``percentile`` keeps a bounded subsample of
    |x| and takes its `percentile`), plus per-channel weight ranges read
    from `scope`. `place` None runs on ``cuda:0`` (``"cpu"`` the plain
    path). The reductions run on the device and give the JAX package's
    values: a max is exact, and the subsample holds the same elements.
    The calibration run is pinned un-quantized (a process-wide
    ``PTPU_QUANT=1`` cannot recurse into it)."""
    from .core.scope import global_scope
    from .executor import Executor

    if strategy not in ("abs_max", "percentile"):
        raise ValueError("calibrate: unknown strategy %r "
                         "(use 'abs_max' or 'percentile')" % (strategy,))
    scope = scope if scope is not None else global_scope()
    white = _check_ops(ops) if ops else DEFAULT_QUANT_OPS

    sites = _quantizable_sites(program, white)
    weights = {}
    for op, _a, w in sites:
        if w.name in weights:
            continue
        val = scope.get(w.name)
        if val is None:
            continue
        s, axis = weight_channel_scales(_host(val), op.type, op.attrs)
        weights[w.name] = {"scales": [float(x) for x in s], "axis": axis}
    act_names = sorted({a.name for _op, a, _w in sites
                        if not getattr(a, "persistable", False)})

    acts = {}
    if act_names:
        calib = program.clone(for_test=True)
        calib._quant_disable = True
        exe = Executor(place)
        maxima = {n: 0.0 for n in act_names}
        samples = {n: [] for n in act_names}
        # every batch contributes to the percentile distribution: each
        # one is strided down to a bounded slice, and the concatenation
        # is strided to the cap at the end
        per_batch = max(1, max_samples_per_tensor // 16)
        batches = 0
        for feed in sample_feeds:
            outs = exe.run(calib, feed=feed, fetch_list=list(act_names),
                           scope=scope, return_numpy=False)
            batches += 1
            for name, val in zip(act_names, outs):
                a = val.detach().to(torch.float32).abs().reshape(-1)
                if strategy == "abs_max":
                    maxima[name] = max(maxima[name], float(a.max()))
                else:
                    stride = max(1, -(-a.numel() // per_batch))
                    samples[name].append(a[::stride].cpu().numpy())
            del outs
        exe.close()
        if batches == 0:
            raise ValueError("calibrate: sample_feeds yielded no batches")
        for name in act_names:
            if strategy == "abs_max":
                acts[name] = max(maxima[name], _EPS)
            else:
                allv = np.concatenate(samples[name])
                if allv.size > max_samples_per_tensor:
                    allv = allv[::max(
                        1, -(-allv.size // max_samples_per_tensor))]
                acts[name] = max(
                    float(np.percentile(allv, percentile)), _EPS)

    _metrics.counter("quant/calib_tensors").inc(len(acts) + len(weights))
    return CalibrationTable(acts=acts, weights=weights, strategy=strategy,
                            percentile=percentile
                            if strategy == "percentile" else None)


# ---------------------------------------------------------------------------
# config + activation
# ---------------------------------------------------------------------------


class QuantConfig:
    """Resolved quantization policy consumed by the `quant_rewrite`
    pass. mode ``weight_only``: int8 weight store, dequantize-on-use,
    fp32 compute (no table needed). mode ``full_int8``: activations
    quantize per-tensor against the calibration table and the product
    runs int8 x int8 -> int32; an op whose activation has no table entry
    degrades to weight_only for that op. `blacklist` names (any input or
    output var) pin their ops fp32."""

    def __init__(self, mode="weight_only", table=None, ops=None,
                 blacklist=None):
        mode = str(mode)
        if mode not in MODES:
            raise ValueError("quant mode must be one of %s, got %r"
                             % (MODES, mode))
        if table is not None and not isinstance(table, CalibrationTable):
            table = coerce_table(table)
        self.mode = mode
        self.table = table
        self.ops = _check_ops(ops or DEFAULT_QUANT_OPS)
        self.blacklist = frozenset(blacklist or ())

    def cache_key(self):
        """Short stable digest for the compile-cache key."""
        h = hashlib.sha1()
        h.update(repr((self.mode, sorted(self.ops),
                       sorted(self.blacklist),
                       self.table.digest() if self.table is not None
                       else None)).encode())
        return "%s:%s" % (self.mode, h.hexdigest()[:8])


# tables resolved from PTPU_QUANT_TABLE sit on the per-run cache-key
# path: cache the parsed table per (mtime, size)
_TABLE_CACHE = {}


def _load_table_cached(path):
    path = str(path)
    try:
        st = os.stat(path)
        sig = (st.st_mtime_ns, st.st_size)
    except OSError:
        # the file moved mid-run: keep serving the table already loaded
        hit = _TABLE_CACHE.get(path)
        if hit is not None:
            return hit[1]
        raise
    hit = _TABLE_CACHE.get(path)
    if hit is not None and hit[0] == sig:
        return hit[1]
    table = CalibrationTable.load(path)
    _TABLE_CACHE[path] = (sig, table)
    return table


def coerce_table(table):
    """CalibrationTable from a table object, a dict, or a JSON path
    (paths are cached by mtime and size)."""
    if table is None or isinstance(table, CalibrationTable):
        return table
    if isinstance(table, dict):
        return CalibrationTable.from_dict(table)
    return _load_table_cached(table)


def quant_env_enabled():
    return bool(_env("PTPU_QUANT"))


def _env_config():
    blk = _env("PTPU_QUANT_BLACKLIST")
    return QuantConfig(
        mode=_env("PTPU_QUANT_MODE"),
        table=coerce_table(_env("PTPU_QUANT_TABLE")),
        blacklist=[s.strip() for s in blk.split(",") if s.strip()]
        if blk else None)


def active_config(program=None):
    """The quantization config in effect for one compile, or None.
    Precedence: program decoration (`decorate`) > PTPU_QUANT=1. A
    program carrying ``_quant_disable`` (the calibration clone) is
    always un-quantized."""
    if program is not None and getattr(program, "_quant_disable", False):
        return None
    cfg = getattr(program, "_quant_config", None) if program is not None \
        else None
    if cfg is not None:
        return cfg
    if quant_env_enabled():
        return _env_config()
    return None


def decorate(program, mode="weight_only", table=None, ops=None,
             blacklist=None):
    """Pin a quantization policy on `program`: every later compile of it
    by an Executor schedules the `quant_rewrite` pass with this config.
    Returns the program."""
    program._quant_config = QuantConfig(mode=mode, table=table, ops=ops,
                                        blacklist=blacklist)
    return program


# ---------------------------------------------------------------------------
# the rewrite pass
# ---------------------------------------------------------------------------


@register_pass("quant_rewrite")
class QuantRewritePass(Pass):
    """Rewrite white-list ops to int8 execution on the compile clone.
    Soundness:

      - only forward, non-grad-referenced ops with a persistable,
        never-written fp32 weight operand are touched;
      - the op's ORIGINAL output var keeps its name, dtype and write
        position: consumers and fetches are untouched; only fresh vars
        (int8 activation, int32 accumulator, baked constants) appear;
      - int8 weights and their fp32 scales bake as fresh
        content-addressed persistable scope entries (`bake_value` +
        `state_fallback`), so cached steps stay scope-portable and the
        original fp32 parameters are never overwritten;
      - activation quantize ops are deduped per (source, reaching
        definition), weight dequantize ops per weight layout.
    """

    def apply(self, program, scope=None):
        cfg = active_config(program)
        if cfg is None or scope is None:
            return program
        from . import unique_name
        from .framework import Operator, convert_dtype
        from .ir_passes import _fetch_targets, _write_indices, bake_value

        targets = _fetch_targets(program)
        if targets is None:
            # fetch set unknown (standalone apply): pin
            # program._opt_fetch_targets to run this pass standalone
            return program
        device = getattr(program, "_opt_device", None) or "cpu"
        block = program.global_block()
        writes = _write_indices(block)

        def rdef(name, i):
            last = -1
            for w in writes.get(name, ()):
                if w < i:
                    last = w
                else:
                    break
            return last

        sites = {id(op): (a, w)
                 for op, a, w in _quantizable_sites(program, cfg.ops)}
        table = cfg.table
        quant_cache = {}   # (act name, reaching def) -> int8 Variable
        deq_cache = {}     # weight layout key -> dequantized fp32 Var
        baked_w = {}       # weight layout key -> (int8 var, scales, sb,
        #                    fp32 value): keyed per LAYOUT, so a weight
        #                    shared by consumers with different channel
        #                    axes does not reuse the other's scales
        new_ops = []
        rewritten = 0
        stats = {"saved": 0, "fp32": 0}
        counted = set()  # weight NAMES in the byte stats (one fp32
        # original however many layouts bake)

        def wkey(op, w):
            if op.type == "mul":
                return (w.name, "mul",
                        int(op.attrs.get("y_num_col_dims", 1)))
            if op.type == "matmul":
                return (w.name, "matmul",
                        bool(op.attrs.get("transpose_Y")))
            return (w.name, "conv")

        def bake_const(name, arr, dtype):
            """Fresh content-addressed persistable scope entry (existing
            names are never overwritten with other content): a tensor on
            the executor's device."""
            digest = hashlib.sha1(
                arr.tobytes() + repr((name, arr.shape,
                                      str(arr.dtype))).encode()
            ).hexdigest()[:12]
            fname = "__quant__.%s.%s" % (digest, name)
            if not block.has_var(fname):
                block.create_var(name=fname, shape=arr.shape, dtype=dtype,
                                 persistable=True)
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
            scope.set(fname, t)
            bake_value(program, fname, t)
            return block.var(fname)

        def quantized_weight(op, w):
            key = wkey(op, w)
            hit = baked_w.get(key)
            if hit is not None:
                return hit
            val = _host(scope.get(w.name))
            scales, axis = weight_channel_scales(val, op.type, op.attrs)
            if table is not None and table.weight_scales(w.name) \
                    is not None:
                ts, taxis = table.weight_scales(w.name)
                if taxis == axis and ts.size == scales.size:
                    scales = ts
            # scale broadcast shape along the channel axis; the trailing
            # output-feature axes of `mul` may span several dims
            if op.type == "mul":
                yn = int(op.attrs.get("y_num_col_dims", 1))
                sb = scales.reshape((1,) * yn + val.shape[yn:])
            else:
                bshape = [1] * val.ndim
                bshape[axis] = scales.size
                sb = scales.reshape(bshape)
            q = quantize_to_int8(val, sb)
            qv = bake_const(w.name + ".int8", q, "int8")
            if w.name not in counted:
                counted.add(w.name)
                stats["saved"] += max(val.nbytes - (q.nbytes
                                                    + scales.size * 4),
                                      0)
                stats["fp32"] += val.nbytes
            out = (qv, scales, sb, val)
            baked_w[key] = out
            return out

        for i, op in enumerate(block.ops):
            site = sites.get(id(op))
            if site is None:
                new_ops.append(op)
                continue
            a, w = site
            names = (set(op.input_names()) | set(op.output_names()))
            if names & cfg.blacklist:
                new_ops.append(op)
                continue
            aslot, wslot = _SLOTS[op.type]
            out_slot = "Output" if op.type.startswith(
                ("conv", "depthwise")) else "Out"
            outs = op.outputs.get(out_slot, [])
            if len(outs) != 1 \
                    or convert_dtype(outs[0].dtype) != "float32":
                new_ops.append(op)
                continue
            if scope.get(w.name) is None:
                new_ops.append(op)
                continue

            full = (cfg.mode == "full_int8" and table is not None
                    and table.act_scale(a.name) is not None
                    and not getattr(a, "persistable", False)
                    # int8 matmul constraints: plain 2-D product, no alpha
                    and (op.type != "matmul"
                         or (op.attrs.get("alpha", 1.0) == 1.0
                             and w.shape is not None
                             and len(w.shape) == 2))
                    # a folded conv bias lands on the fp32 output; an
                    # int32 accumulator cannot absorb it
                    and not op.inputs.get("FoldedBias"))

            qv, scales, sb, val = quantized_weight(op, w)

            # full-int8 dense layers (mul / plain matmul) fuse the whole
            # quantize -> int8 product -> dequantize chain into ONE op,
            # run by the kernel K4
            fuse = full and op.type in ("matmul", "mul") \
                and not op.attrs.get("transpose_X", False) \
                and not op.attrs.get("transpose_Y", False)

            if fuse:
                s_a = float(table.act_scale(a.name))
                out = outs[0]
                # flat per-output-channel combined scale: the op flattens
                # mul's operands to 2-D as the mul op does, so the kernel
                # always sees an [N] vector
                dq = (np.asarray(scales).reshape(-1) / _QMAX) \
                    * (s_a / _QMAX)
                dqv = bake_const(out.name + ".qdq",
                                 np.asarray(dq, np.float32), "float32")
                fattrs = {"act_scale": _QMAX / max(s_a, _EPS),
                          "__quant__": True}
                if op.type == "mul":
                    fattrs["x_num_col_dims"] = int(
                        op.attrs.get("x_num_col_dims", 1))
                    fattrs["y_num_col_dims"] = int(
                        op.attrs.get("y_num_col_dims", 1))
                new_ops.append(Operator(
                    block, "fused_int8_matmul",
                    inputs={"X": [a], "Y": [qv], "Scale": [dqv]},
                    outputs={"Out": [out]},
                    attrs=fattrs))
            elif full:
                s_a = float(table.act_scale(a.name))
                qa_key = (a.name, rdef(a.name, i))
                qa = quant_cache.get(qa_key)
                if qa is None:
                    qa = block.create_var(
                        name=unique_name.generate(a.name + "@quant.int8"),
                        shape=a.shape, dtype="int8", persistable=False)
                    new_ops.append(Operator(
                        block, "quantize", inputs={"Input": [a]},
                        outputs={"Output": [qa]},
                        attrs={"Scale": _QMAX / max(s_a, _EPS),
                               "__quant__": True}))
                    quant_cache[qa_key] = qa
                out = outs[0]
                acc = block.create_var(
                    name=unique_name.generate(out.name + "@quant.acc"),
                    shape=out.shape, dtype="int32", persistable=False)
                # combined dequant scale, shaped to broadcast onto the
                # op's OUTPUT: trailing feature dims for mul/matmul, the
                # (C_out, 1, 1) channel axis for NCHW conv
                if op.type in ("conv2d", "depthwise_conv2d"):
                    dq = (scales.reshape((-1, 1, 1)) / _QMAX) \
                        * (s_a / _QMAX)
                elif op.type == "mul":
                    yn = int(op.attrs.get("y_num_col_dims", 1))
                    dq = (scales.reshape(val.shape[yn:]) / _QMAX) \
                        * (s_a / _QMAX)
                else:  # matmul
                    dq = (scales / _QMAX) * (s_a / _QMAX)
                dqv = bake_const(out.name + ".qdq",
                                 np.asarray(dq, np.float32), "float32")
                op.inputs[aslot] = [qa]
                op.inputs[wslot] = [qv]
                op.outputs[out_slot] = [acc]
                op.attrs["__quant_int8__"] = True
                new_ops.append(op)
                new_ops.append(Operator(
                    block, "dequantize_linear",
                    inputs={"Input": [acc], "Scale": [dqv]},
                    outputs={"Output": [out]},
                    attrs={"out_dtype": "float32", "__quant__": True}))
            else:
                dqw = deq_cache.get(wkey(op, w))
                if dqw is None:
                    sv = bake_const(w.name + ".qscale",
                                    np.asarray(sb / _QMAX, np.float32),
                                    "float32")
                    dqw = block.create_var(
                        name=unique_name.generate(w.name + "@quant.deq"),
                        shape=w.shape, dtype="float32",
                        persistable=False)
                    new_ops.append(Operator(
                        block, "dequantize_linear",
                        inputs={"Input": [qv], "Scale": [sv]},
                        outputs={"Output": [dqw]},
                        attrs={"out_dtype": "float32",
                               "__quant__": True}))
                    deq_cache[wkey(op, w)] = dqw
                op.inputs[wslot] = [dqw]
                new_ops.append(op)
            rewritten += 1

        if not rewritten:
            return program
        block.ops = new_ops
        _metrics.counter("quant/ops_rewritten").inc(rewritten)
        record_weight_store(len(counted), stats["saved"], stats["fp32"])
        program._bump_version()
        return program
