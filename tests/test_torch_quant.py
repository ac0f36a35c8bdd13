"""Full-int8 inference of the Fluid-API Transformer LM: the PyTorch
port's ``quant`` (calibrate, decorate, the quant_rewrite pass run by
``Executor.run``) held against the JAX package's on the CPU, at a small
width (vocab 256, d_model 128, 2 heads of 64, 2 layers, d_ff 256, seq
128 in two lm_head chunks of 64, batch 2, fp32).

Both packages build the program, the JAX startup program makes the
weights (from init counters pinned at 0) and
``paddle_tpu_torch.io.scope_from_numpy`` carries them into the port's
scope. The JAX side runs with ``PTPU_KERNELS=1``, so its quant_rewrite
emits the fused op and runs its Pallas int8 kernel in interpret mode;
the port always emits the fused op, whose kernel takes its plain version
for CPU tensors."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import quant as j_quant
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer_fluid as j_tf

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import ir_passes as p_ir_passes
from paddle_tpu_torch import quant as p_quant
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.io import scope_from_numpy
from paddle_tpu_torch.models import transformer_fluid as p_tf

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_bounds",
    pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_smoke)
logits_excess = _smoke.int8_logits_excess

CFG = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256,
           seq_len=128, head_chunk=64)
# the two lm_head chunks' logits: the outputs of the head's mul ops
LOGITS = ("fc_4.tmp_0", "fc_5.tmp_0")


def build(fluid, tf, unique_name):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        _, _, loss = tf.build(remat=False, dtype="float32", **CFG)
    return main, startup, loss


def feed(seed, batch=2):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, CFG["vocab_size"],
                       (batch, CFG["seq_len"])).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


class LM:
    """Both packages' LM from one set of weights, and the JAX package's
    calibration table over three feeds."""

    def __init__(self):
        self.jm, js, self.jl = build(jfluid, j_tf, j_unique)
        self.pm, ps, self.pl = build(pfluid, p_tf, p_unique)
        self.jexe, self.jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
        self.pexe, self.pscope = pfluid.Executor("cpu"), pfluid.Scope()
        self.jexe.run(js, scope=self.jscope)
        self.pexe.run(ps, scope=self.pscope)
        names = [v.name for v in self.pm.global_block().vars.values()
                 if v.persistable]
        scope_from_numpy(self.pscope, {n: np.array(self.jscope.get(n))
                                       for n in names})
        self.feeds = [feed(s) for s in range(3)]
        self.jtable = j_quant.calibrate(self.jm, self.feeds,
                                        scope=self.jscope)

    def ptable(self, act_factor=1.0):
        table = p_quant.CalibrationTable.from_dict(self.jtable.to_dict())
        table.acts = {k: v * act_factor for k, v in table.acts.items()}
        return table

    def infer(self, mode="full_int8", table=None, blacklist=None):
        """(JAX infer clone, port infer clone), decorated alike."""
        ji, pi = self.jm.clone(for_test=True), self.pm.clone(for_test=True)
        j_quant.decorate(ji, mode, table, blacklist=blacklist)
        p_quant.decorate(pi, mode, table and self.ptable(),
                         blacklist=blacklist)
        return ji, pi


@pytest.fixture(scope="module")
def lm():
    """Built once for the file, with the JAX package's init counters at
    0 (restored afterwards, whichever JAX test files ran before in this
    process: the weights of a draw the bounds below were set at) and
    its kernels forced on (interpret mode)."""
    from paddle_tpu import initializer, layer_helper

    saved = (initializer._global_seed_counter[0],
             layer_helper._op_seed_counter[0])
    initializer._global_seed_counter[0] = 0
    layer_helper._op_seed_counter[0] = 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PTPU_KERNELS", "1")
        yield LM()
    (initializer._global_seed_counter[0],
     layer_helper._op_seed_counter[0]) = saved


def compiled(exe, has):
    """The compiled programs an executor cached that hold an op of type
    `has`."""
    return [s.program for s in exe._cache.values()
            if any(o.type == has for o in s.program.global_block().ops)]


def _name(n):
    # generated names carry a per-process counter suffix
    return re.sub(r"(@quant\.\w+)_\d+$", r"\1", n)


def quant_ops(program):
    """(type, inputs, outputs, attrs) of every op the rewrite emitted or
    rewired, in order."""
    out = []
    for op in program.global_block().ops:
        names = op.input_names() + op.output_names()
        if op.attrs.get("__quant__") or any("@quant." in n for n in names):
            out.append((op.type,
                        {s: [_name(v.name) for v in vs]
                         for s, vs in sorted(op.inputs.items())},
                        {s: [_name(v.name) for v in vs]
                         for s, vs in sorted(op.outputs.items())},
                        dict(op.attrs)))
    return out


def baked(program):
    return {n: np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor)
                          else v)
            for n, v in getattr(program, "_baked_values", {}).items()}


def test_calibration_table_crosses_packages(lm, tmp_path):
    """A table saved by either package loads in the other with the same
    digest, and both write the same bytes."""
    j_path = lm.jtable.save(str(tmp_path / "jax.json"))
    p_table = p_quant.CalibrationTable.load(j_path)
    assert p_table.digest() == lm.jtable.digest()
    assert (p_table.acts, p_table.weights) == (lm.jtable.acts,
                                               lm.jtable.weights)
    p_path = p_table.save(str(tmp_path / "port.json"))
    assert j_quant.CalibrationTable.load(p_path).digest() == \
        lm.jtable.digest()
    with open(j_path, "rb") as a, open(p_path, "rb") as b:
        assert a.read() == b.read()
    assert p_quant.coerce_table(p_path).digest() == lm.jtable.digest()


@pytest.mark.parametrize("strategy", ["abs_max", "percentile"])
def test_calibrate_matches_jax(lm, strategy):
    """The same activation and weight names (the 4 FFN fc inputs and the
    2 lm_head chunks' inputs; the 5 weights); activation ranges to rtol
    1e-5 (the fp32 network upstream sums in other orders), weight ranges
    exact (the same weights)."""
    want = lm.jtable if strategy == "abs_max" else j_quant.calibrate(
        lm.jm, lm.feeds, strategy="percentile", percentile=99.0,
        scope=lm.jscope)
    got = p_quant.calibrate(lm.pm, lm.feeds, strategy=strategy,
                            percentile=99.0, scope=lm.pscope, place="cpu")
    assert len(got.acts) == 6 and len(got.weights) == 5
    assert sorted(got.acts) == sorted(want.acts)
    assert got.weights == want.weights
    assert (got.strategy, got.percentile) == (want.strategy, want.percentile)
    for name, s in want.acts.items():
        assert got.acts[name] == pytest.approx(s, rel=1e-5), name


@pytest.fixture(scope="module")
def full_int8(lm):
    """Both packages' full-int8 programs run on the three feeds, fetching
    the loss and both chunks' logits; the port also with every
    activation range 1% too large (a planted fault)."""
    ji, pi = lm.infer(table=lm.jtable)
    _, fault = lm.infer(table=lm.jtable)
    p_quant.decorate(fault, "full_int8", lm.ptable(act_factor=1.01))
    fetch = [lm.jl.name, *LOGITS]
    runs = {"jax": [], "port": [], "fault": []}
    for f in lm.feeds:
        runs["jax"].append([np.asarray(v) for v in lm.jexe.run(
            ji, feed=f, fetch_list=fetch, scope=lm.jscope)])
        runs["port"].append(lm.pexe.run(pi, feed=f, fetch_list=fetch,
                                        scope=lm.pscope))
        runs["fault"].append(lm.pexe.run(fault, feed=f, fetch_list=fetch,
                                         scope=lm.pscope))
    jp, = compiled(lm.jexe, "fused_int8_matmul")
    pp = [p for p in compiled(lm.pexe, "fused_int8_matmul")
          if p._quant_config is pi._quant_config]
    assert len(pp) == 1
    return ji, pi, jp, pp[0], runs


def test_full_int8_rewrite_matches_jax(full_int8):
    """The compiled clones hold the same fused_int8_matmul ops (2 a layer
    and one a chunk) in order, with the same inputs, outputs and attrs,
    no fp32 mul left, and bitwise the same baked int8 weights and
    dequantize vectors under the same content-addressed names."""
    _, _, jp, pp, _ = full_int8
    j_ops, p_ops = quant_ops(jp), quant_ops(pp)
    assert [o[0] for o in p_ops] == ["fused_int8_matmul"] * 6
    assert p_ops == j_ops
    assert "mul" not in [o.type for o in pp.global_block().ops]
    jb, pb = baked(jp), baked(pp)
    assert sorted(pb) == sorted(jb) and len(pb) == 11   # 5 weights, 6 dq
    assert all(n.startswith("__quant__.") for n in pb)
    for n in jb:
        assert pb[n].dtype == jb[n].dtype and pb[n].shape == jb[n].shape, n
        assert np.array_equal(pb[n].view(np.uint8), jb[n].view(np.uint8)), n


def test_full_int8_numerics_match_jax(full_int8):
    """The loss to rtol 1e-4 and both chunks' logits within the bound of
    chip_smoke.py's `int8_logits_excess` on three feeds (the two
    packages' fp32 parts sum in other orders, 1e-7 apart: at most 1 in 32
    rows may cross a quantization tie and differ, by a few int8 steps);
    the planted 1% act-scale fault fails the logits bound on every
    feed."""
    _, _, _, pp, runs = full_int8
    dqs = {o.output_names()[0]: pp._baked_values[o.input_names("Scale")[0]]
           .numpy() for o in pp.global_block().ops
           if o.type == "fused_int8_matmul"}
    for f in range(len(runs["jax"])):
        want, got, fault = runs["jax"][f], runs["port"][f], runs["fault"][f]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        faulty = []
        for i, name in enumerate(LOGITS, 1):
            assert got[i].dtype == np.float32 and got[i].shape == (2, 64, 256)
            ratio, rows = logits_excess(got[i], want[i], dqs[name])
            assert ratio <= 1 and rows <= 1 / 32, (f, name, ratio, rows)
            ratio, rows = logits_excess(fault[i], want[i], dqs[name])
            faulty.append(ratio > 1 or rows > 1 / 32)
        assert all(faulty), f


def test_int8_run_leaves_the_user_program_and_scope(lm):
    """Running the decorated program rewrites a clone: the user's program
    keeps its ops and version, and its fp32 scope entries their values;
    the scope only gains the baked __quant__ entries."""
    _, pi = lm.infer(table=lm.jtable)
    ops = repr(pi)
    version = pi.version
    scope = pfluid.Scope()
    before = {}
    for n in lm.pscope.local_var_names():
        if not n.startswith("__quant__.") and n != "__step_counter__":
            before[n] = lm.pscope.get(n).clone()
            scope.set(n, lm.pscope.get(n))
    pexe = pfluid.Executor("cpu")
    loss, = pexe.run(pi, feed=lm.feeds[0], fetch_list=[lm.pl], scope=scope)
    assert np.isfinite(loss).all()
    assert repr(pi) == ops and pi.version == version
    assert "fused_int8_matmul" not in ops
    for n, t in before.items():
        assert torch.equal(scope.get(n), t), n
    added = set(scope.local_var_names()) - set(before) - {
        "__step_counter__"}
    assert len(added) == 11 and all(n.startswith("__quant__.")
                                    for n in added)


def test_baked_values_heal_into_a_fresh_scope(lm):
    """A cached int8 step run against a scope without the baked entries
    (they were made in another scope) reads them back from the step."""
    _, pi = lm.infer(table=lm.jtable)
    pexe = pfluid.Executor("cpu")
    want, = pexe.run(pi, feed=lm.feeds[1], fetch_list=[lm.pl],
                     scope=lm.pscope)
    other = pfluid.Scope()
    for n in lm.pscope.local_var_names():
        if not n.startswith("__quant__."):
            other.set(n, lm.pscope.get(n))
    got, = pexe.run(pi, feed=lm.feeds[1], fetch_list=[lm.pl], scope=other)
    assert np.array_equal(got, want)
    assert any(n.startswith("__quant__.") for n in other.local_var_names())


def test_decorate_after_a_cached_run_compiles_a_new_step(lm):
    """decorate changes no program version; the quant key in the cache
    key keeps a step cached before decoration from serving after it."""
    pi = lm.pm.clone(for_test=True)
    pexe = pfluid.Executor("cpu")
    fp32, = pexe.run(pi, feed=lm.feeds[0], fetch_list=[lm.pl],
                     scope=lm.pscope)
    assert compiled(pexe, "fused_int8_matmul") == []
    version = pi.version
    p_quant.decorate(pi, "full_int8", lm.ptable())
    assert pi.version == version
    int8, = pexe.run(pi, feed=lm.feeds[0], fetch_list=[lm.pl],
                     scope=lm.pscope)
    assert len(pexe._cache) == 2 and len(compiled(pexe,
                                                  "fused_int8_matmul")) == 1
    assert int8 != fp32 and abs(int8 - fp32) <= 1e-3 * abs(fp32)


def test_undecorated_program_never_runs_the_pass(lm, monkeypatch):
    """With no decoration and PTPU_QUANT unset the executor runs the
    user's program itself: the pass is never called and the cache key
    gains nothing."""
    monkeypatch.delenv("PTPU_QUANT", raising=False)
    calls = []
    monkeypatch.setattr(p_quant.QuantRewritePass, "apply",
                        lambda self, program, scope=None: calls.append(1))
    pi = lm.pm.clone(for_test=True)
    pexe = pfluid.Executor("cpu")
    pexe.run(pi, feed=lm.feeds[0], fetch_list=[lm.pl], scope=lm.pscope)
    assert calls == []
    assert [s.program for s in pexe._cache.values()] == [pi]
    assert p_ir_passes.pipeline_key(pi) == ()


def test_env_activation_runs_the_pass(lm, monkeypatch, tmp_path):
    """PTPU_QUANT=1 with PTPU_QUANT_MODE / PTPU_QUANT_TABLE decorates
    every program the same way; the calibration clone stays fp32."""
    path = lm.jtable.save(str(tmp_path / "t.json"))
    monkeypatch.setenv("PTPU_QUANT", "1")
    monkeypatch.setenv("PTPU_QUANT_MODE", "full_int8")
    monkeypatch.setenv("PTPU_QUANT_TABLE", path)
    pi = lm.pm.clone(for_test=True)
    assert p_ir_passes.pipeline_key(pi) == (
        "quant:" + p_quant.QuantConfig("full_int8", lm.ptable())
        .cache_key(),)
    pexe = pfluid.Executor("cpu")
    pexe.run(pi, feed=lm.feeds[0], fetch_list=[lm.pl], scope=lm.pscope)
    assert len(compiled(pexe, "fused_int8_matmul")) == 1
    pi._quant_disable = True
    assert p_quant.active_config(pi) is None


@pytest.mark.parametrize("mode,blacklist", [
    ("weight_only", None), ("full_int8", ("fc_1.w_0",))])
def test_weight_only_and_blacklist_match_jax(lm, mode, blacklist):
    """weight-only (no table): every weight stored int8 and dequantized
    on use by the fp32 mul; full-int8 with one FFN fc black-listed: that
    mul stays fp32, the others fuse. The rewritten ops, the baked arrays
    and the loss (to rtol 1e-4) match the JAX package's."""
    table = lm.jtable if mode == "full_int8" else None
    ji, pi = lm.infer(mode, table, blacklist=blacklist)
    fetch = [lm.jl.name]
    want, = lm.jexe.run(ji, feed=lm.feeds[0], fetch_list=fetch,
                        scope=lm.jscope)
    pexe = pfluid.Executor("cpu")
    got, = pexe.run(pi, feed=lm.feeds[0], fetch_list=fetch,
                    scope=lm.pscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4)
    jp = [s.program for s in lm.jexe._cache.values()
          if getattr(s.program, "_quant_config", None) is ji._quant_config]
    pp = [s.program for s in pexe._cache.values() if s.program is not pi]
    assert len(jp) == len(pp) == 1
    j_ops, p_ops = quant_ops(jp[0]), quant_ops(pp[0])
    assert p_ops == j_ops
    types = [o[0] for o in p_ops]
    if mode == "weight_only":
        assert types.count("dequantize_linear") == 5 \
            and types.count("mul") == 6
    else:
        assert types.count("fused_int8_matmul") == 5
        assert [op for op in pp[0].global_block().ops
                if op.type == "mul"][0].input_names("Y") == ["fc_1.w_0"]
    jb, pb = baked(jp[0]), baked(pp[0])
    assert sorted(pb) == sorted(jb)
    for n in jb:
        assert np.array_equal(pb[n].view(np.uint8), jb[n].view(np.uint8)), n
