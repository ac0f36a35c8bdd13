"""paddle_tpu_torch stands alone: importing it pulls in no jax and
nothing of paddle_tpu, none of its modules (nor chip_smoke.py) imports
either, and its entry points never fall back to the CPU quietly."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_seq_len=64)


def _port_modules():
    """Every module of the port, by its dotted name."""
    root = os.path.join(REPO, "paddle_tpu_torch")
    names = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), REPO)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            names.append(".".join(parts))
    return sorted(names)


def test_import_pulls_in_no_jax():
    """In a fresh interpreter (this one has jax loaded by conftest),
    importing every module of the port loads no jax and nothing of the
    JAX package."""
    mods = _port_modules()
    assert {"paddle_tpu_torch.executor", "paddle_tpu_torch.core.lowering",
            "paddle_tpu_torch.ops.flash_attention",
            "paddle_tpu_torch.models.transformer_fluid",
            "paddle_tpu_torch.contrib.mixed_precision.decorator"} <= set(mods)
    code = ("import importlib, sys\n"
            "for m in %r: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu')\n"
            "       or m.startswith(('jax.', 'paddle_tpu.'))]\n"
            "assert not bad, bad\n" % (mods,))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    """Lazy imports inside functions count too."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO,
                                                   "paddle_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    bad = [(os.path.relpath(p, REPO), m) for p in paths
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad


def test_entry_points_refuse_to_run_without_cuda():
    """No CUDA and no explicit device: the model, the engine and the
    kernel route raise; they never quietly run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA path; this machine has a card")
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import (GenerationConfig,
                                          GenerationModel, KVBlockPool,
                                          ServingEngine, random_weights)

    cfg = GenerationConfig(**CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationModel(cfg, random_weights(cfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        KVBlockPool(n_layers=1, n_heads=1, head_dim=4, block_size=4,
                    num_blocks=2)
    cpu_model = GenerationModel(cfg, random_weights(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cpu_model)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cpu_model, device="cuda")
    args = [torch.zeros(5, 4, 2, 32), torch.zeros(5, 4, 2, 32),
            torch.zeros(1, 1, 2, 32), torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(1, 1, dtype=torch.int32)]
    with pytest.raises(RuntimeError, match="CUDA"):
        pa._paged_attention_cuda(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        pa.load()
    launches = dict(pa.paged_attention.window_launches)
    out = pa.paged_attention(*args)  # CPU tensors: the plain version
    assert out.shape == (1, 1, 2, 32) and torch.isfinite(out).all()
    assert pa.paged_attention.window_launches == launches
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_training_entry_points_refuse_to_run_without_cuda():
    """`Executor()` with no place is cuda:0 and raises without CUDA; the
    flash-attention kernels raise on CPU tensors (the plain version is
    reached only through `flash_attention` on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA path; this machine has a card")
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import flash_attention as fa

    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.Executor()
    assert fluid.Executor("cpu").device == torch.device("cpu")
    q = torch.zeros(1, 1, 128, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.flash_attention_fwd(q, q, q, True, 0.125)
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.flash_attention_bwd(q, q, q, q, torch.zeros(1, 1, 128), q, True,
                               0.125)
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.load()


def test_int8_entry_points_refuse_to_run_without_cuda():
    """A decorated full-int8 program given `Executor()` (cuda:0) raises
    before it runs anything; the K4 loader raises instead of building or
    loading a library, and the kernel route raises on CPU tensors. None
    of them runs the plain version quietly: its launch count stays."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA path; this machine has a card")
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import int8_matmul as im

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        out = fluid.layers.fc(x, 4)
    table = quant.CalibrationTable(acts={"x": 1.0})
    infer = quant.decorate(main.clone(for_test=True), "full_int8", table)
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.Executor().run(infer, feed={"x": np.zeros((2, 8), np.float32)},
                             fetch_list=[out])
    launches = dict(im.int8_matmul.launches)
    loaded = dict(_build._loaded)
    with pytest.raises(RuntimeError, match="CUDA"):
        im.load()
    assert _build._loaded == loaded and "int8_matmul" not in loaded
    args = (torch.zeros(2, 8), torch.zeros(8, 4, dtype=torch.int8),
            torch.ones(4), 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        im._int8_matmul_cuda(*args)
    assert im.int8_matmul(*args).shape == (2, 4)   # CPU: the plain version
    assert im.int8_matmul.launches == launches
