"""The port's step cost accounting (``paddle_tpu_torch/observability/
cost.py``) on the CPU: ``mfu_pct`` equal to the JAX package's on the
CPU; the peak table's H100 row and an unknown card raising; a matmul
counted as 2·M·N·K; the card's peak read without resetting the
caller's; ``first_step`` counting and publishing only a fresh step with
metrics on; each kernel's plain version counted by its kernel's
formula once (K1 both ways, K2, K3 and K4); a native step's count equal
to its closed form (remat's recompute stops before each layer's last
FFN GEMM, whose output no backward reads); ``exec/step_flops``
published once a plan by the executor and once a window shape by the
serving model with metrics on, and never with metrics off; the bench
legs carrying ``step_flops`` and ``mfu_pct`` with metrics on."""

import numpy as np
import pytest
import torch

from paddle_tpu.observability import cost as jcost
from paddle_tpu_torch import bench as pbench
from paddle_tpu_torch.models import transformer as P
from paddle_tpu_torch.observability import cost
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import int8_matmul as im
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import paged_attention_tree as pat

from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def metrics_on():
    was = metrics.enabled()
    metrics.enable()
    metrics.reset()
    yield metrics.registry()
    metrics.reset()
    if not was:
        metrics.disable()


def gauges():
    return metrics.registry().to_dict()["gauges"]


def test_mfu_pct_equals_jax_on_the_cpu():
    for flops, sps in ((1.5e9, 12.0), (3e11, 0.25), (0, 5.0), (1e9, 0)):
        assert cost.mfu_pct(flops, sps, "cpu") == jcost.mfu_pct(
            flops, sps, "cpu")
        assert cost.mfu_pct(flops, sps) == jcost.mfu_pct(flops, sps)
    assert cost.peak_flops("cpu") == jcost.peak_flops("cpu") == 1e11
    assert cost.peak_flops(torch.device("cpu")) == 1e11


def test_peak_table_h100_row_and_unknown_cards():
    assert cost.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert cost.mfu_pct(989.4e12, 0.5, "NVIDIA H100 80GB HBM3") == 50.0
    for card in ("NVIDIA A100-SXM4-80GB", "gpu", "tpu"):
        with pytest.raises(KeyError, match="PLATFORM_PEAK_FLOPS"):
            cost.peak_flops(card)
        with pytest.raises(KeyError):
            cost.mfu_pct(1e12, 1.0, card)


def test_a_matmul_counts_2mnk_and_nothing_else():
    a, b = torch.randn(6, 5), torch.randn(5, 7)
    with cost.count_flops("cpu") as c:
        (a @ b).relu().sum()
    assert c.flops == 2 * 6 * 5 * 7 and c.peak_bytes is None
    assert cost.analyze(c) == {"step_flops": 2 * 6 * 5 * 7}
    assert not cost.counting()
    with cost.count_flops() as c:
        pass
    assert c.flops == 0


def test_count_reads_the_card_peak_without_resetting_it(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the caller's peak statistics were reset")

    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", refuse)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: 12345)
    with cost.count_flops("cuda:0") as c:
        torch.randn(2, 3) @ torch.randn(3, 4)
    assert cost.analyze(c) == {"step_flops": 2 * 2 * 3 * 4,
                               "peak_hbm_bytes": 12345}


@pytest.mark.parametrize("on,fresh", [(True, True), (True, False),
                                      (False, True)])
def test_first_step_counts_and_publishes_a_fresh_step_with_metrics_on(
        on, fresh):
    was = metrics.enabled()
    (metrics.enable if on else metrics.disable)()
    metrics.reset()
    try:
        with cost.first_step(fresh, "cpu") as c:
            torch.randn(3, 4) @ torch.randn(4, 5)
        if on and fresh:
            assert c.flops == 2 * 3 * 4 * 5
            assert gauges()["exec/step_flops"] == c.flops
        else:
            assert c is None and "exec/step_flops" not in gauges()
        assert not cost.counting()
    finally:
        metrics.reset()
        (metrics.enable if was else metrics.disable)()


@pytest.mark.parametrize("causal,Tq,Tk", [(True, 8, 8), (False, 4, 12)])
def test_flash_attention_plain_version_counts_k1s_formula_once(
        causal, Tq, Tk):
    B, H, Dh = 2, 3, 16
    q = torch.randn(B, H, Tq, Dh, requires_grad=True)
    k = torch.randn(B, H, Tk, Dh, requires_grad=True)
    v = torch.randn(B, H, Tk, Dh, requires_grad=True)
    with cost.count_flops() as fwd:
        o = fa.flash_attention(q, k, v, causal)
    assert fwd.flops == 4 * B * H * Tq * Tk * Dh
    with cost.count_flops() as bwd:
        o.sum().backward()
    assert bwd.flops == 8 * B * H * Tq * Tk * Dh


def test_kernel_flops_travels_to_the_count_and_only_there():
    with cost.count_flops() as c:
        cost.kernel_flops(12345)
    assert c.flops == 12345
    cost.kernel_flops(7)          # no count: nothing happens
    with cost.count_flops() as c:
        with cost.uncounted():
            torch.randn(4, 4) @ torch.randn(4, 4)
        cost.kernel_flops(5)
    assert c.flops == 5


def _paged(C, positions, tree=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    B, H, Dh, bs, Mb = positions.shape[0], 2, 8, 4, 8
    kp = torch.randn(B * Mb + 1, bs, H, Dh, generator=g)
    vp = torch.randn(B * Mb + 1, bs, H, Dh, generator=g)
    q = torch.randn(B, C, H, Dh, generator=g)
    tables = (torch.arange(B * Mb, dtype=torch.int32) + 1).view(B, Mb)
    return kp, vp, q, tables, positions.to(torch.int32), H, Dh


def test_paged_attention_plain_versions_count_the_kernels_formula():
    """K2 and K3: 4·H·Dh·Σ over rows of C × the keys the row attends,
    not the plain version's products over the whole block table."""
    pos = torch.tensor([[5, 6, 7], [0, 1, 2]])
    kp, vp, q, tables, pos, H, Dh = _paged(3, pos)
    with cost.count_flops() as c:
        pa.paged_attention(kp, vp, q, tables, pos)
    assert c.flops == 4 * H * Dh * 3 * ((7 + 1) + (2 + 1))
    anc = torch.tril(torch.ones(3, 3, dtype=torch.bool))
    with cost.count_flops() as c:
        pat.paged_attention_tree(kp, vp, q, tables, pos, anc)
    assert c.flops == 4 * H * Dh * 3 * ((5 + 3) + (0 + 3))


def test_int8_matmul_plain_version_counts_2mnk():
    x = torch.randn(3, 4, 16)
    w = torch.randint(-127, 128, (16, 10), dtype=torch.int8)
    with cost.count_flops() as c:
        im.int8_matmul(x, w, torch.rand(10), 10.0)
    assert c.flops == 2 * 12 * 10 * 16


def native_step_flops(B, T, V, D, H, L, Fd, remat):
    """One native training step's products: the forward (the QKV, output
    and FFN GEMMs and attention's two products a layer, the head), the
    backward (twice each GEMM, twice attention's, twice the head), and
    under remat each layer's forward again but its last FFN GEMM (the
    recompute stops once every residual the backward reads is back)."""
    Dh = D // H
    w2 = 2 * B * T * Fd * D
    layer = 2 * B * T * D * 3 * D + 2 * B * T * D * D + 2 * B * T * D * Fd \
        + w2 + 4 * B * H * T * T * Dh
    head = 2 * B * T * D * V
    return (L * layer + head + 2 * (L * layer + head)
            + (L * (layer - w2) if remat else 0))


@pytest.mark.parametrize("remat", [False, True])
def test_native_step_count_equals_its_closed_form(remat):
    cfg = P.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                              n_layers=2, d_ff=64, max_seq_len=64,
                              dtype="float32", remat=remat)
    state = pbench.native_state(cfg, device="cpu")
    toks = torch.randint(0, 64, (2, 16), generator=torch.Generator()
                         .manual_seed(0))
    with cost.count_flops("cpu") as c:
        pbench.native_train_step(*state, toks, toks.roll(-1, 1), cfg)
    assert c.flops == native_step_flops(2, 16, 64, 32, 2, 2, 64, remat)


def _program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, 16, act="relu")
        loss = fluid.layers.mean(fluid.layers.fc(h, 4))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _spy(monkeypatch, module):
    calls = []
    real = module._cost.publish

    def spy(count):
        calls.append(count.flops)
        return real(count)

    monkeypatch.setattr(module._cost, "publish", spy)
    return calls


@pytest.mark.parametrize("on", [True, False])
def test_executor_publishes_step_flops_once_a_plan(monkeypatch, on):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import executor

    was = metrics.enabled()
    (metrics.enable if on else metrics.disable)()
    metrics.reset()
    try:
        calls = _spy(monkeypatch, executor)
        main, startup, loss = _program(fluid)
        exe, scope = fluid.Executor("cpu"), fluid.Scope()
        exe.run(startup, scope=scope)
        feed = {"x": np.ones((4, 8), np.float32)}
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        exe.run(main, feed={"x": np.ones((2, 8), np.float32)},
                fetch_list=[loss], scope=scope)
        if on:
            # the startup plan, the batch-4 plan, the batch-2 plan: each
            # fc's forward GEMM and its weight's grad GEMM, and the
            # second fc's input grad (x is data: no grad)
            def step(B):
                return 2 * 2 * B * (8 * 16 + 16 * 4) + 2 * B * 16 * 4

            assert calls == [0, step(4), step(2)]
            assert gauges()["exec/step_flops"] == step(2)
        else:
            assert calls == []
            assert "exec/step_flops" not in gauges()
    finally:
        metrics.reset()
        (metrics.enable if was else metrics.disable)()


def test_serving_model_publishes_once_a_window_shape(monkeypatch,
                                                     metrics_on):
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving import model as smodel

    calls = _spy(monkeypatch, smodel)
    cfg = serving.GenerationConfig(vocab_size=32, d_model=16, n_heads=2,
                                   n_layers=1, d_ff=32, max_seq_len=32)
    m = serving.GenerationModel.random(cfg, seed=0, device="cpu")
    eng = serving.ServingEngine(m, max_batch=2, max_seq_len=32,
                                block_size=4, device="cpu")
    try:
        for _ in range(2):
            eng.generate([1, 2, 3], max_new_tokens=4, timeout=120)
    finally:
        eng.close()
    # one decode shape ([2, 1] windows), counted once
    assert len(calls) == 1 and calls[0] > 0
    assert gauges()["exec/step_flops"] == calls[0]


def test_bench_training_legs_carry_mfu(metrics_on, capsys):
    """``main --tiny`` (async, sync, noopt) and ``--tiny --amp-only``
    (fp32, amp, amp_fp16): the legs bench.py receipts carry step_flops
    and an MFU in (0, 100); noopt does not, as in bench.py."""
    legs = {}
    for flags in (["--tiny"], ["--tiny", "--amp-only"]):
        out = pbench.main(flags + ["--place", "cpu"])
        legs.update({g["leg"]: g for g in out["legs"]})
    capsys.readouterr()
    for name in ("async", "sync", "fp32", "amp", "amp_fp16"):
        leg = legs[name]
        assert leg["step_flops"] > 0, name
        assert 0 < leg["mfu_pct"] < 100, name
        # step_time_s is printed rounded to the microsecond
        want = cost.mfu_pct(leg["step_flops"], 1.0 / leg["step_time_s"],
                            "cpu")
        assert abs(leg["mfu_pct"] - want) <= 1e-3 * want + 1e-4, name
    assert "mfu_pct" not in legs["noopt"]
    assert legs["sync"]["step_flops"] == legs["async"]["step_flops"]
    assert gauges()["bench/mfu_pct"] > 0


def test_bench_serving_batched_leg_carries_mfu(monkeypatch, metrics_on,
                                               capsys):
    small = dict(d_model=32, n_heads=2, n_layers=2, d_ff=64, vocab=64,
                 max_seq_len=64)
    for name, kw in (("bench_serving", dict(small, n_requests=4,
                                            max_new_tokens=4, max_batch=4)),
                     ("bench_serving_fastpath", dict(
                         small, n_requests=2, max_new_tokens=2,
                         prefix_len=32, max_batch=2)),
                     ("bench_serving_spec", dict(
                         small, n_requests=1, max_new_tokens=8,
                         max_seq_len=96))):
        fn = getattr(pbench, name)
        monkeypatch.setattr(pbench, name,
                            lambda _fn=fn, _kw=kw, **k: _fn(**_kw, **k))
    out = pbench.main(["--serving-only", "--place", "cpu"])
    capsys.readouterr()
    leg = next(g for g in out["legs"] if g["leg"] == "serving_batched")
    assert leg["step_flops"] > 0 and 0 < leg["mfu_pct"] < 100
    assert "mfu_pct" not in next(g for g in out["legs"]
                                 if g["leg"] == "serving_serial")
