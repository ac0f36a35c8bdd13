"""Saving and loading models: the PyTorch port's ``Program.to_json`` /
``from_json`` (``core/serde.py``), the sealed ``__model__`` frame
(``core/native.py``), ``io.save_inference_model`` /
``load_inference_model`` and ``save_vars`` / ``load_vars``, held
against the JAX package's on the CPU.

Models: the mnist MLP (its inference clone and its SGD and Adam training
programs, whose grad ops carry their forward op), the cifar ResNet-8
with a bottleneck stage (``chip_smoke.resnet8_bottleneck``) and the
flagship LM at a toy width under recompute (its segments are
sub-blocks). Every
comparison is exact: the JSON key for key (the op seeds, drawn from
process-wide counters, aside), ``__model__`` bytes equal for the same
Program, every saved array bitwise with its dtype."""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import models as j_models
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core import native as j_native
from paddle_tpu.core import serde as j_serde
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.core.scope import scope_guard as j_scope_guard
from paddle_tpu.models import transformer_fluid as _j_tf  # noqa: F401

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import models as p_models
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.core import native as p_native
from paddle_tpu_torch.models import transformer_fluid as _p_tf  # noqa: F401

from torch_parity import (SEED_ATTRS, assert_programs_equal,  # noqa: F401
                          pin_jax_init_draw)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke_for_io",
                                               ROOT / "chip_smoke.py")
_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_smoke)


def _transformer_remat(models):
    """The flagship LM at a toy width under its default recompute: two
    sub-blocks, which ops name by a block attr."""
    _, _, loss = models.transformer_fluid.build(
        vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
        seq_len=16, dtype="float32", remat=True)
    return None, None, loss, loss, None


BUILDERS = {"mnist_mlp": lambda m: m.mnist.build(arch="mlp"),
            "resnet8_bottleneck": _smoke.resnet8_bottleneck,
            "transformer_remat": _transformer_remat}


def build(fluid, models, unique_name, name, opt=None):
    """(main, startup, test clone, prediction) of builder `name`, with
    `opt` (an optimizer class name) minimizing the loss."""
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        _, _, predict, loss, _ = BUILDERS[name](models)
        test = main.clone(for_test=True)
        if opt:
            getattr(fluid.optimizer, opt)(0.01).minimize(loss)
    return main, startup, test, predict


def unseeded(desc):
    """A program's JSON descriptor without the op-seed attrs."""
    for blk in desc["blocks"]:
        for op in blk["ops"]:
            for k in SEED_ATTRS:
                op["attrs"].pop(k, None)
    return desc


@pytest.mark.parametrize("name,opt", [("mnist_mlp", None),
                                      ("mnist_mlp", "SGD"),
                                      ("mnist_mlp", "Adam"),
                                      ("resnet8_bottleneck", None),
                                      ("transformer_remat", "SGD")])
def test_program_json_crosses_packages(name, opt):
    """Each program (main, startup, test clone) of both packages: the
    port's JSON is the JAX package's key for key (grad ops' forward ops as
    ``__op_index__``, the recompute segments as ``__block__``); JAX's JSON
    loaded by the port and the port's loaded by JAX's program_from_desc
    are the program JAX loads from its own, op for op and var for var;
    the port writes back the bytes it read."""
    jp = build(jfluid, j_models, j_unique, name, opt)
    pp = build(pfluid, p_models, p_unique, name, opt)
    for label, j, p in zip(("main", "startup", "test"), jp, pp):
        js, ps = j.to_json(), p.to_json()
        assert unseeded(json.loads(ps)) == unseeded(json.loads(js)), label
        want = jfluid.Program.from_json(js)
        assert_programs_equal(want, pfluid.Program.from_json(js), label)
        assert_programs_equal(want, j_serde.program_from_json(ps), label)
        assert pfluid.Program.from_json(js).to_json() == js, label


def test_sealed_frame_matches_jax():
    """The port's frame is the JAX package's byte for byte, each unseals
    the other's, and a truncated frame, a wrong magic or a flipped
    payload byte raise."""
    payload = json.dumps({"k": list(range(50))}).encode()
    sealed = p_native.program_seal(payload)
    assert sealed == j_native.program_seal(payload)
    assert p_native.program_unseal(j_native.program_seal(payload)) == payload
    assert j_native.program_unseal(sealed) == payload
    for bad, what in ((sealed[:10], "truncated"),
                      (b"XXXX" + sealed[4:], "magic"),
                      (sealed[:-1] + bytes([sealed[-1] ^ 1]), "CRC")):
        with pytest.raises(ValueError, match=what):
            p_native.program_unseal(bad)


class Saved:
    """ResNet-8 + a bottleneck stage from the JAX startup's weights (its
    moving statistics moved), saved by the JAX package into `jdir`; the
    port's own build of the same network, carrying those weights, saved
    into `pdir`."""

    def __init__(self, root):
        self.jdir, self.pdir = str(root / "jax"), str(root / "port")
        _, jstart, self.jtest, jpred = build(jfluid, j_models, j_unique,
                                             "resnet8_bottleneck")
        _, pstart, self.ptest, ppred = build(pfluid, p_models, p_unique,
                                             "resnet8_bottleneck")
        jexe, self.jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
        jexe.run(jstart, scope=self.jscope)
        rng = np.random.RandomState(0)
        for n in sorted(self.jscope.local_var_names()):
            if n.endswith((".w_1", ".w_2")):       # moving mean, variance
                v = np.asarray(self.jscope.get(n))
                self.jscope.set(n, rng.uniform(0.5, 1.5, v.shape).astype(
                    v.dtype))
        with j_scope_guard(self.jscope):
            jfluid.io.save_inference_model(self.jdir, ["img"], [jpred], jexe,
                                           main_program=self.jtest)
        self.pexe, self.pscope = pfluid.Executor("cpu"), pfluid.Scope()
        self.pexe.run(pstart, scope=self.pscope)
        names = [v.name for v in self.ptest.global_block().vars.values()
                 if v.persistable]
        pfluid.io.scope_from_numpy(
            self.pscope, {n: np.asarray(self.jscope.get(n)) for n in names})
        with pfluid.scope_guard(self.pscope):
            pfluid.io.save_inference_model(self.pdir, ["img"], [ppred],
                                           self.pexe, main_program=self.ptest)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    return Saved(tmp_path_factory.mktemp("models"))


def read(path):
    with open(path, "rb") as f:
        return f.read()


def params(dirname):
    with np.load(os.path.join(dirname, "__params__.npz")) as data:
        return {n: data[n] for n in data.files}


def assert_arrays_equal(got, want):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        g = np.asarray(got[n])
        assert g.dtype == w.dtype and g.shape == w.shape, n
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), n


def test_the_two_packages_write_the_same_model_dir(saved):
    """The same network from the same weights: the port's __model__
    holds the JAX package's program, feeds and fetches (the op seeds
    aside), and its __params__ the same arrays, bitwise."""
    jm = json.loads(j_native.program_unseal(read(saved.jdir + "/__model__")))
    pm = json.loads(p_native.program_unseal(read(saved.pdir + "/__model__")))
    assert (pm["feed_names"], pm["fetch_names"]) == (jm["feed_names"],
                                                     jm["fetch_names"])
    assert unseeded(pm["program"]) == unseeded(jm["program"])
    assert_arrays_equal(params(saved.pdir), params(saved.jdir))


def test_port_loads_a_jax_model_dir(saved, tmp_path):
    """load_inference_model on the JAX package's dir: its program, feeds
    and fetches, and every array in the scope as a CPU tensor bitwise the
    saved one; saved again by the port, __model__ is the same bytes and
    __params__ the same arrays."""
    exe, scope = pfluid.Executor("cpu"), pfluid.Scope()
    with pfluid.scope_guard(scope):
        prog, feeds, fetch = pfluid.io.load_inference_model(saved.jdir, exe)
    jprog, jfeeds, jfetch = jfluid.io.load_inference_model(
        saved.jdir, jfluid.Executor(jfluid.CPUPlace()))
    assert_programs_equal(jprog, prog)
    assert feeds == jfeeds == ["img"]
    assert [v.name for v in fetch] == [v.name for v in jfetch]
    want = params(saved.jdir)
    assert sorted(scope.local_var_names()) == sorted(want)
    assert all(scope.get(n).device.type == "cpu" for n in want)
    assert_arrays_equal({n: scope.get(n).numpy() for n in want}, want)
    assert pfluid.global_scope().get(next(iter(want))) is None
    with pfluid.scope_guard(scope):
        pfluid.io.save_inference_model(str(tmp_path), feeds, fetch, exe,
                                       main_program=prog)
    assert read(str(tmp_path / "__model__")) == read(saved.jdir + "/__model__")
    assert_arrays_equal(params(str(tmp_path)), want)


def test_jax_loads_a_port_model_dir(saved):
    """The JAX package's load_inference_model on the port's dir: the
    program the JAX package saved for the same network, and every array
    bitwise the weights it was given."""
    jscope = JScope()
    with j_scope_guard(jscope):
        prog, feeds, fetch = jfluid.io.load_inference_model(
            saved.pdir, jfluid.Executor(jfluid.CPUPlace()))
    want, _, _ = jfluid.io.load_inference_model(
        saved.jdir, jfluid.Executor(jfluid.CPUPlace()))
    assert_programs_equal(want, prog)
    assert feeds == ["img"]
    got = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    assert_arrays_equal(got, params(saved.jdir))


def test_reference_format_raises(saved, tmp_path):
    """A __model__ that is neither the sealed frame nor JSON (the
    reference framework's protobuf) is not read, nor is
    reference_format=True: both raise naming reference_format.py."""
    (tmp_path / "__model__").write_bytes(b"\n\x8a\x01\x12\x05feed\x1a")
    with pytest.raises(NotImplementedError, match="reference_format.py"):
        pfluid.io.load_inference_model(str(tmp_path),
                                       pfluid.Executor("cpu"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        pfluid.io.load_inference_model(saved.jdir, pfluid.Executor("cpu"),
                                       reference_format=True)


@pytest.mark.parametrize("filename", [None, "combined"])
def test_save_and_load_vars_cross_packages(saved, tmp_path, filename):
    """save_persistables by the port (one .npy a var, or one combined
    savez) read by the JAX package's load_persistables, and the JAX
    package's read back by the port's: every var bitwise."""
    names = sorted(v.name for v in saved.ptest.global_block().vars.values()
                   if v.persistable and not v.is_data)
    want = {n: saved.pscope.get(n).numpy() for n in names}
    with pfluid.scope_guard(saved.pscope):
        pfluid.io.save_persistables(saved.pexe, str(tmp_path / "port"),
                                    saved.ptest, filename=filename)
    jscope = JScope()
    with j_scope_guard(jscope):
        jfluid.io.load_persistables(None, str(tmp_path / "port"),
                                    saved.jtest, filename=filename)
        jfluid.io.save_persistables(None, str(tmp_path / "jax"),
                                    saved.jtest, filename=filename)
    assert_arrays_equal({n: np.asarray(jscope.get(n)) for n in names}, want)
    scope = pfluid.Scope()
    with pfluid.scope_guard(scope):
        pfluid.io.load_persistables(saved.pexe, str(tmp_path / "jax"),
                                    saved.ptest, filename=filename)
    assert_arrays_equal({n: scope.get(n).numpy() for n in names}, want)


def test_bf16_params_cross_as_raw_words(tmp_path):
    """A bf16 var is saved as the JAX package saves one (its 2-byte words
    as numpy's void |V2) and loads back as the same bf16 tensor."""
    prog = pfluid.Program()
    v = prog.global_block().create_var(name="w", shape=(3, 5),
                                       dtype="bfloat16", persistable=True)
    t = torch.randn(3, 5).to(torch.bfloat16)
    scope = pfluid.Scope()
    scope.set("w", t)
    with pfluid.scope_guard(scope):
        pfluid.io.save_vars(None, str(tmp_path), prog, vars=[v],
                            filename="p.npz")
    with np.load(str(tmp_path / "p.npz")) as data:
        raw = data["w"]
    assert raw.dtype == np.dtype("V2")
    import ml_dtypes

    jaxish = np.asarray(t.float().numpy(), ml_dtypes.bfloat16)
    np.savez(str(tmp_path / "j.npz"), w=jaxish)
    with np.load(str(tmp_path / "j.npz")) as data:
        assert data["w"].tobytes() == raw.tobytes()
    back = pfluid.Scope()
    with pfluid.scope_guard(back):
        pfluid.io.load_vars(pfluid.Executor("cpu"), str(tmp_path), prog,
                            vars=[v], filename="p.npz")
    assert back.get("w").dtype == torch.bfloat16
    assert torch.equal(back.get("w").view(torch.int16), t.view(torch.int16))
