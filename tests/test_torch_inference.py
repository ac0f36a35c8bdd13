"""The inference predictor: the PyTorch port's ``inference.AnalysisConfig``
/ ``create_paddle_predictor`` with its load-time passes (``ir.py``
``conv_bn_fold``, ``dropout_remove``, ``conv_elementwise_add_fuse``; the
``conv2d_fusion`` op) and ``enable_quantize`` (``quant.
quantize_predictor_program``, ``contrib.quantize.QuantizeTranspiler.
convert_to_int8``), held against the JAX package's predictor on the CPU
on model dirs the JAX package saved, with the same feeds.

Models (batch 4): the cifar ResNet-8 with a bottleneck stage
(``chip_smoke.resnet8_bottleneck``: conv -> batch_norm chains, residual
adds with projection shortcuts), a conv with a bias -> batch_norm ->
dropout net (the fold's conv -> add -> bn pattern, dropout_remove) and
the mnist cnn (convolutions with a bias add and no batch norm: the int8
convolution). Each dir's batch norms moved: scales, shifts and moving
statistics drawn from RandomState(0).

The JAX side runs with ``PTPU_KERNELS=1`` so that its full-int8 rewrite
emits ``fused_int8_matmul`` (its Pallas kernel in interpret mode), as the
port always does."""

import hashlib
import importlib.util
import os
import pathlib
import re

import numpy as np
import pytest
import torch

import bench as jbench
import paddle_tpu as jfluid
from paddle_tpu import inference as j_inference
from paddle_tpu import models as j_models
from paddle_tpu import quant as j_quant
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.core.scope import scope_guard as j_scope_guard

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import bench as pbench
from paddle_tpu_torch import inference as p_inference
from paddle_tpu_torch import quant as p_quant
from paddle_tpu_torch.transpiler import inference_transpiler

from torch_parity import assert_programs_equal, set_jax_init_counters

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke_for_inference",
                                               ROOT / "chip_smoke.py")
_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_smoke)

BATCH = 4
# fp32 outputs (softmax probabilities) of the two packages: the JAX
# package's XLA convolutions and the port's GEMMs over the unfolded input
# sum in other orders, a few fp32 roundings a layer (measured over these
# models and modes: 7.5e-8 at most, on probabilities up to 1.0); the
# limit is 16 ulps of 1.0
FP32_ATOL = 16 * 2.0 ** -23


def conv_bn_dropout(models):
    """A conv with a bias, a batch norm, dropout and a softmax head: the
    conv -> elementwise_add -> batch_norm chain the fold merges into the
    bias, and a dropout dropout_remove turns into a scale."""
    layers = models.resnet.layers
    img = layers.data(name="img", shape=[3, 12, 12], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    x = layers.conv2d(input=img, num_filters=6, filter_size=3, padding=1)
    x = layers.batch_norm(input=x, act="relu")
    x = layers.dropout(x, dropout_prob=0.25)
    x = layers.pool2d(input=x, pool_size=2, pool_type="max", pool_stride=2)
    predict = layers.fc(input=x, size=10, act="softmax")
    cost = layers.mean(layers.cross_entropy(input=predict, label=label))
    return img, label, predict, cost, layers.accuracy(predict, label)


MODELS = {"resnet8_bottleneck": (_smoke.resnet8_bottleneck, (3, 32, 32)),
          "conv_bn_dropout": (conv_bn_dropout, (3, 12, 12)),
          "mnist_cnn": (lambda m: m.mnist.build(arch="cnn"), (1, 28, 28))}


def save_jax_model(name, dirname):
    """Builder `name` in the JAX package from its startup's weights, each
    batch norm's scale U(0.5, 1.5), shift 0.1 N(0, 1), moving mean 0.1
    N(0, 1) and variance U(0.5, 1.5) (RandomState(0)), saved by
    save_inference_model (target: the softmax output)."""
    main, startup = jfluid.Program(), jfluid.Program()
    with j_unique.guard(), jfluid.program_guard(main, startup):
        _, _, predict, _, _ = MODELS[name][0](j_models)
        test = main.clone(for_test=True)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    draws = {"Scale": lambda c: rng.uniform(0.5, 1.5, c),
             "Bias": lambda c: 0.1 * rng.randn(c),
             "Mean": lambda c: 0.1 * rng.randn(c),
             "Variance": lambda c: rng.uniform(0.5, 1.5, c)}
    for op in test.global_block().ops:
        if op.type == "batch_norm":
            for slot, draw in draws.items():
                n = op.input_names(slot)[0]
                c = np.asarray(scope.get(n)).shape[0]
                scope.set(n, draw(c).astype(np.float32))
    with j_scope_guard(scope):
        jfluid.io.save_inference_model(dirname, ["img"], [predict], exe,
                                       main_program=test)


def feeds(name, n, seed=1):
    shape = MODELS[name][1]
    return [{"img": np.random.RandomState(seed + i).rand(
        BATCH, *shape).astype(np.float32)} for i in range(n)]


def configs(dirname, mode=None, table=None, ir_optim=True):
    """(JAX config, port config) of `dirname`, on the CPU."""
    out = []
    for inf, tab in ((j_inference, table),
                     (p_inference, table and p_quant.CalibrationTable
                      .from_dict(table.to_dict()))):
        cfg = inf.AnalysisConfig(dirname)
        cfg.disable_gpu()
        cfg.switch_ir_optim(ir_optim)
        if mode:
            cfg.enable_quantize(mode, calibration_table=tab)
        out.append(cfg)
    return out


class Dirs:
    """Each model saved by the JAX package, and its calibration table
    (the JAX package's, from its fp32 predictor over two feeds)."""

    def __init__(self, root):
        self.dirs, self.tables = {}, {}
        for name in MODELS:
            d = str(root / name)
            save_jax_model(name, d)
            self.dirs[name] = d
        for name in ("resnet8_bottleneck", "mnist_cnn"):
            jc, _ = configs(self.dirs[name])
            jp = j_inference.create_paddle_predictor(jc)
            self.tables[name] = j_quant.calibrate(
                jp._program, feeds(name, 2, seed=10), scope=jp._scope)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Built once for the file with the JAX package's init counters at 0
    (restored afterwards) and its kernels forced on (interpret mode)."""
    from paddle_tpu import initializer, layer_helper

    saved = (initializer._global_seed_counter[0],
             layer_helper._op_seed_counter[0])
    set_jax_init_counters(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PTPU_KERNELS", "1")
        yield Dirs(tmp_path_factory.mktemp("predictor"))
    (initializer._global_seed_counter[0],
     layer_helper._op_seed_counter[0]) = saved


def host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def persistables_differing(jp, pp):
    """Names of the persistables the port's predictor program reads whose
    value in its scope is not bitwise the JAX predictor's."""
    bad = []
    for v in pp._program.global_block().vars.values():
        if not v.persistable:
            continue
        p, j = pp._scope.get(v.name), jp._scope.get(v.name)
        if p is None and j is None:
            continue
        if p is None or j is None:
            bad.append(v.name)
            continue
        p, j = host(p), host(j)
        if p.dtype != j.dtype or p.shape != j.shape \
                or not np.array_equal(p.view(np.uint8), j.view(np.uint8)):
            bad.append(v.name)
    return bad


def predictors(dirs, name, **kw):
    jc, pc = configs(dirs.dirs[name], **kw)
    return (j_inference.create_paddle_predictor(jc),
            p_inference.create_paddle_predictor(pc))


@pytest.mark.parametrize("name", ["resnet8_bottleneck", "conv_bn_dropout"])
def test_passes_match_jax(dirs, name):
    """After the load-time passes the port's program is the JAX
    predictor's op for op (types, slots, attrs) and var for var (the
    folded biases among them): no batch_norm or dropout left, the
    residual adds fused; every folded weight and bias bitwise JAX's."""
    jp, pp = predictors(dirs, name)
    assert_programs_equal(jp._program, pp._program, name)
    types = [op.type for op in pp._program.global_block().ops]
    assert "batch_norm" not in types and "dropout" not in types
    want = {"resnet8_bottleneck": "conv2d_fusion", "conv_bn_dropout": "scale"}
    assert want[name] in types
    assert persistables_differing(jp, pp) == []
    assert any(n.endswith(".bn_folded_bias")
               for n in pp._scope.local_var_names()) == (
        name == "resnet8_bottleneck")


def test_a_fold_without_epsilon_fails_the_check(dirs, monkeypatch):
    """The fold planted without the batch norm's epsilon: the folded
    weights are no longer bitwise JAX's, and the check names them."""
    fold = inference_transpiler._fold_bn_weights

    def no_epsilon(conv_op, bn_op, scope, bias_name):
        bn_op.attrs["epsilon"] = 0.0
        return fold(conv_op, bn_op, scope, bias_name)

    monkeypatch.setattr(inference_transpiler, "_fold_bn_weights", no_epsilon)
    jp, pp = predictors(dirs, "resnet8_bottleneck")
    bad = persistables_differing(jp, pp)
    assert len(bad) == 26   # 13 folded filters and their biases


def _name(n):
    # names the rewrite generates carry a per-process counter
    return re.sub(r"(@quant\.\w+)_\d+$", r"\1", n)


def compiled_ops(pred):
    """(type, inputs, outputs, attrs) of every op of the executor's
    compiled clone, and its baked values."""
    prog, = [st.program for st in pred._exe._cache.values()]
    ops = [(op.type,
            {s: [_name(v.name) for v in vs] for s, vs in op.inputs.items()},
            {s: [_name(v.name) for v in vs] for s, vs in op.outputs.items()},
            {k: v for k, v in op.attrs.items() if k != "__op_seed__"})
           for op in prog.global_block().ops]
    return ops, {n: host(v) for n, v in getattr(prog, "_baked_values",
                                                {}).items()}


@pytest.mark.parametrize("name,mode", [
    ("resnet8_bottleneck", None), ("conv_bn_dropout", None),
    ("resnet8_bottleneck", "full_int8"), ("mnist_cnn", "full_int8"),
    ("resnet8_bottleneck", "weight_only")])
def test_predictor_matches_jax(dirs, name, mode):
    """The two predictors on the same dir and feeds. fp32 and weight_only:
    the outputs within FP32_ATOL. full_int8: the compiled clones hold the
    same ops (every fused int8 matmul, quantize, int8 conv and dequantize
    with its attrs; a folded conv stays weight-only) and bitwise the same
    baked ``__quant__.*`` arrays; the outputs within FP32_ATOL too, as
    every int8 product is exact and no activation lies within the two
    packages' fp32 difference of a quantization tie here. weight_only:
    the program and every ``.int8`` twin bitwise JAX's."""
    jp, pp = predictors(dirs, name, mode=mode,
                        table=dirs.tables.get(name))
    for f in feeds(name, 2):
        want, = jp.run_dict(f)
        got, = pp.run_dict(f)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=FP32_ATOL)
    if mode == "full_int8":
        (j_ops, jb), (p_ops, pb) = compiled_ops(jp), compiled_ops(pp)
        assert p_ops == j_ops
        types = [o[0] for o in p_ops]
        assert types.count("fused_int8_matmul") == 1
        assert "mul" not in types
        if name == "mnist_cnn":    # both convolutions on int8 operands
            assert types.count("quantize") == 2 and sum(
                o[3].get("__quant_int8__", False) for o in p_ops) == 2
        else:                      # every conv has a folded bias
            assert "quantize" not in types
        assert sorted(pb) == sorted(jb) and all(
            n.startswith("__quant__.") for n in pb)
        for n in jb:
            assert pb[n].dtype == jb[n].dtype, n
            assert np.array_equal(pb[n].view(np.uint8),
                                  jb[n].view(np.uint8)), n
    if mode == "weight_only":
        assert_programs_equal(jp._program, pp._program)
        twins = [n for n in pp._scope.local_var_names()
                 if n.endswith(".int8")]
        # 10 conv filters and their folded biases (the 3 convs fused into
        # conv2d_fusion keep fp32) and the fc's weight
        assert len(twins) == 21
        assert persistables_differing(jp, pp) == []


def test_config_runs_on_the_card_or_raises(dirs):
    """A config that did not call disable_gpu() runs on cuda:0; without
    CUDA creating its predictor raises, and nothing falls back to the
    CPU."""
    cfg = p_inference.AnalysisConfig(dirs.dirs["mnist_cnn"])
    if torch.cuda.is_available():
        pred = p_inference.create_paddle_predictor(cfg)
        assert pred._exe.device == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        p_inference.create_paddle_predictor(cfg)


def tree_digest(dirname):
    h = hashlib.sha256()
    for f in sorted(os.listdir(dirname)):
        with open(os.path.join(dirname, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_predictor_scope_is_isolated(dirs):
    """The predictors fold and quantize weights in scopes of their own:
    the model dir keeps its bytes, the global scope and the user's scope
    open at creation gain nothing and keep their values, and two
    predictors of one dir see each other's edits nowhere."""
    d = dirs.dirs["resnet8_bottleneck"]
    before = tree_digest(d)
    user = pfluid.Scope()
    user.set("conv2d_0.w_0", torch.zeros(1))
    with pfluid.scope_guard(user):
        plain = p_inference.create_paddle_predictor(configs(
            d, ir_optim=False)[1])
        folded = p_inference.create_paddle_predictor(configs(
            d, mode="weight_only")[1])
        out, = plain.run_dict(feeds("resnet8_bottleneck", 1)[0])
    assert np.isfinite(out).all()
    assert tree_digest(d) == before
    assert user.local_var_names() == ["conv2d_0.w_0"]
    assert torch.equal(user.get("conv2d_0.w_0"), torch.zeros(1))
    assert pfluid.global_scope().get("conv2d_0.w_0") is None
    w = plain._scope.get("conv2d_0.w_0")
    with np.load(os.path.join(d, "__params__.npz")) as data:
        assert np.array_equal(w.numpy(), data["conv2d_0.w_0"])
    assert folded._scope.get("conv2d_0.w_0") is None
    assert folded._scope.get("conv2d_0.w_0.int8").dtype == torch.int8


def test_bench_quant_predictor_keys(monkeypatch):
    """The port's bench_quant_predictor returns bench.py's keys (both at a
    reduced size), and the port's bench runs it in bench.py's leg
    selection: --quant-only gives the quant_fp32_predictor and
    quant_int8_predictor legs with bench.py's keys, and not_ported no
    longer names it."""
    small = dict(batches=4, batch=8, in_dim=8, hidden=16, n_classes=4,
                 warmup=1)
    want = jbench.bench_quant_predictor(**small)
    got = pbench.bench_quant_predictor(place="cpu", **small)
    assert sorted(got) == sorted(want)
    assert all(np.isfinite(v) for v in got.values())
    assert got["weight_bytes_saved_ratio"] == pytest.approx(
        want["weight_bytes_saved_ratio"])
    monkeypatch.setattr(pbench, "bench_serving_quant",
                        lambda place=None: (2.0, 1.0, True, 1.0, 10))
    monkeypatch.setattr(pbench, "card_line", lambda: None)
    result = pbench.main(["--quant-only", "--place", "cpu"])
    legs = {leg["leg"]: leg for leg in result["legs"]}
    assert set(legs["quant_int8_predictor"]) >= {
        "speedup_vs_fp32", "max_abs_err", "top1_agreement",
        "weight_bytes_saved_ratio"}
    assert "quant_fp32_predictor" in legs
    assert "not_ported" not in result
