"""The port's benchmark harness (``paddle_tpu_torch/fluid_benchmark.py``)
against benchmark/fluid_benchmark.py: the same arguments and defaults
(but --device: GPU or CPU, GPU by default, where the JAX harness's
default is JAX's backend), the same default batches, the same
RandomState(0) feeds for every model, the same programs from `_build`
for every model the JAX harness builds, the same examples/sec line and
JSON keys from `run_static_model` on the CPU (and `run_transformer`'s
keys at seq 16, `run_transformer_native`'s line and record at batch 2),
and the options whose modules the port lacks raising with their
ROADMAP.md item."""

import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import fluid_benchmark as pbench
from paddle_tpu_torch import unique_name as p_unique

from torch_parity import (assert_programs_equal,  # noqa: F401
                          one_torch_thread, pin_jax_init_draw)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODELS = ("mnist", "resnet", "vgg", "se_resnext", "stacked_dynamic_lstm",
          "machine_translation", "deepfm")


@pytest.fixture
def jbench():
    spec = importlib.util.spec_from_file_location(
        "fluid_benchmark_reference", ROOT / "benchmark" / "fluid_benchmark.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_args(jbench, monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["fluid_benchmark.py"] + argv)
    return jbench.parse_args()


def test_arguments_and_defaults_match(jbench, monkeypatch):
    j = vars(_jax_args(jbench, monkeypatch, []))
    p = vars(pbench.parse_args([]))
    assert sorted(p) == sorted(j)
    assert {k: v for k, v in p.items() if k != "device"} == \
        {k: v for k, v in j.items() if k != "device"}
    assert p["device"] == "GPU"
    argv = ["--model", "deepfm", "--batch_size", "8", "--iterations", "3",
            "--skip_batch_num", "2", "--use_amp", "--json",
            "--blocking_fetch", "--learning_rate", "0.5",
            "--data_set", "imagenet"]
    assert vars(pbench.parse_args(argv + ["--device", "CPU"])) == dict(
        vars(_jax_args(jbench, monkeypatch, argv + ["--device", "CPU"])))
    assert pbench._DEFAULT_BATCH == jbench._DEFAULT_BATCH


@pytest.mark.parametrize("model,data_set", [(m, None) for m in MODELS]
                         + [("resnet", "imagenet")])
def test_feeds_match(jbench, model, data_set):
    batch = 3
    j = jbench._feeds(model, batch, np.random.RandomState(0), data_set)
    p = pbench._feeds(model, batch, np.random.RandomState(0), data_set)
    assert sorted(p) == sorted(j)
    for k in j:
        assert p[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)


@pytest.mark.parametrize("model,data_set", [(m, None) for m in MODELS]
                         + [("vgg", "imagenet"), ("se_resnext", "imagenet")])
def test_build_makes_the_jax_harness_programs(jbench, model, data_set):
    progs = []
    for fluid, unique_name, build in ((jfluid, j_unique, jbench._build),
                                      (pfluid, p_unique, pbench._build)):
        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, startup):
            loss = build(model, data_set)
        progs.append((main, startup, loss.name))
    (jm, js, jl), (pm, ps, pl) = progs
    assert pl == jl
    assert_programs_equal(jm, pm, model + " main")
    assert_programs_equal(js, ps, model + " startup")


def test_run_static_model_prints_the_jax_harness_line_and_keys(
        jbench, monkeypatch, capsys):
    argv = ["--model", "mnist", "--device", "CPU", "--iterations", "3",
            "--skip_batch_num", "2", "--batch_size", "16", "--json",
            "--learning_rate", "0.001"]
    j_rec = jbench.run_static_model(_jax_args(jbench, monkeypatch, argv))
    j_out = capsys.readouterr().out
    record = {}
    p_rec = pbench.run_static_model(pbench.parse_args(argv), record)
    p_out = capsys.readouterr().out
    assert sorted(p_rec) == sorted(j_rec) == [
        "first_loss", "last_loss", "metric", "n_chips", "unit", "value"]
    for k in ("metric", "unit", "n_chips"):
        assert p_rec[k] == j_rec[k], k
    for out in (j_out, p_out):
        line = [x for x in out.splitlines() if x.startswith("Total ")][0]
        assert "total time" in line and "examples/sec/chip" in line
        assert "Total examples: 48," in line   # the timed steps only
    assert len(record["losses"]) == 5 and np.isfinite(record["losses"]).all()
    assert record["losses"][-1] < record["losses"][0]
    assert len(record["host_ms"]) == 3 and record["step_ms"] is None


def test_main_json_line_on_the_cpu(capsys):
    rec = pbench.main(["--model", "deepfm", "--device", "CPU",
                       "--iterations", "2", "--skip_batch_num", "1",
                       "--batch_size", "32", "--json"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == rec
    assert rec["metric"] == "deepfm_examples_per_sec_per_chip"
    assert rec["value"] > 0 and np.isfinite(rec["last_loss"])


@pytest.mark.parametrize("argv,item", [
    (["--update_method", "spmd"], None),
    (["--update_method", "nccl2"], None),
    (["--profile"], "item 10")])
def test_options_not_ported_raise_naming_their_item(argv, item, capsys):
    """The options that once raised, naming their item of ROADMAP.md's
    Queue 1, are ported: --update_method spmd / nccl2 parse (they train
    over gloo ranks in tests/test_torch_fleet_collective.py) and
    --profile (item 10) runs the timed loop in a profiler session and
    prints the event table, one ``iteration`` row a step, and the device
    table (no CUDA kernels on the CPU)."""
    args = pbench.parse_args(argv + ["--device", "CPU"])
    if item is None:
        assert args.update_method == argv[1]
        return
    assert args.profile
    pbench.main(argv + ["--device", "CPU", "--model", "mnist",
                        "--batch_size", "4", "--skip_batch_num", "1",
                        "--iterations", "2"])
    out = capsys.readouterr().out
    row = [ln.split() for ln in out.splitlines()
           if ln.startswith("iteration ")]
    assert len(row) == 1 and row[0][1] == "3", out
    assert "no CUDA kernels in the trace" in out


def test_transformer_native_on_the_cpu(capsys):
    """``--model transformer_native``: the JAX harness's line and record
    through ``bench.bench_transformer`` (full width, seq 512, batch 2,
    one warm-up and two timed steps)."""
    from paddle_tpu_torch import bench

    rec = pbench.main(["--model", "transformer_native", "--device", "CPU",
                       "--iterations", "2", "--skip_batch_num", "1",
                       "--batch_size", "2", "--json"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == rec
    assert rec["metric"] == "transformer_native_tokens_per_sec_per_chip"
    assert rec["unit"] == "tokens/s/chip" and rec["value"] > 0
    assert any(x.startswith("Transformer-base (native): ") for x in out)
    native = bench.last_native
    assert (native["batch"], native["seq"], native["warmup"],
            native["steps"]) == (2, 512, 1, 2)
    assert np.isfinite(native["losses"]).all()
    assert "not_ported" not in rec


def test_the_card_is_the_default_device(monkeypatch):
    """Without --device the harness asks for cuda:0, which raises where
    there is no card instead of running on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pbench.main(["--model", "mnist", "--iterations", "1"])


def test_run_transformer_on_the_cpu(capsys):
    """The JAX harness's run_transformer recipe (the flagship in bf16
    under the contrib decorator, SGD) at seq 16 and batch 2: its line and
    the JAX harness's keys."""
    rec = pbench.run_transformer(pbench.parse_args(
        ["--model", "transformer", "--device", "CPU", "--batch_size", "2",
         "--iterations", "2", "--skip_batch_num", "1"]), seq_len=16)
    assert sorted(rec) == ["last_loss", "metric", "unit", "value"]
    assert rec["metric"] == "transformer_fluid_api_tokens_per_sec_per_chip"
    assert rec["unit"] == "tokens/s/chip" and np.isfinite(rec["last_loss"])
    assert "tokens/sec/chip" in capsys.readouterr().out
