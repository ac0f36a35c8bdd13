"""The fleet's collective mode on the port (``parallel/fleet.py``,
``incubate.fleet``), the counterparts of ``tests/test_distributed.py``'s
two fleet tests, and ``fluid_benchmark --update_method nccl2`` over a
gloo group of 2 CPU ranks (``torch_dp_workers``)."""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.incubate.fleet.collective import fleet as jfleet

import paddle_tpu_torch as pfluid

import torch_dp_workers as W
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import (  # noqa: F401 (the autouse fixture)
    pin_jax_init_draw as _pin_jax_init_draw)


def test_fleet_facade_roles(monkeypatch):
    """tests/test_distributed.py:147 on the port: the role maker reads
    the env contract and the collective optimizer marks the program (no
    rendezvous is named, so no group is brought up)."""
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
    monkeypatch.delenv("PADDLE_TRAINER_ENDPOINTS", raising=False)
    monkeypatch.delenv("PADDLE_COORDINATOR_ADDR", raising=False)
    f = pfluid.parallel.Fleet().init(
        pfluid.parallel.PaddleCloudRoleMaker(is_collective=True))
    assert f.worker_index() == 2
    assert f.worker_num() == 4
    assert not f.is_first_worker()
    assert f.device is None
    opt = f.distributed_optimizer(
        pfluid.optimizer.SGD(learning_rate=0.1),
        strategy=pfluid.parallel.DistributedStrategy())
    main, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(main, startup):
        x = pfluid.layers.data(name="x", shape=[4], dtype="float32")
        y = pfluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = pfluid.layers.fc(input=x, size=1)
        loss = pfluid.layers.mean(pfluid.layers.square_error_cost(pred, y))
        opt.minimize(loss)
    assert main._fleet_opt["mode"] == "collective"
    from paddle_tpu_torch.incubate.fleet.base import role_maker

    assert role_maker.Role.WORKER == 1 and role_maker.Role.SERVER == 2


def test_use_dgc_raises_naming_item_9():
    strategy = pfluid.parallel.DistributedStrategy()
    strategy.use_dgc = True
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        pfluid.parallel.Fleet().distributed_optimizer(
            pfluid.optimizer.SGD(0.1), strategy)


def test_collective_optimizer_trains_via_fleet():
    """tests/test_distributed.py:168 on the port at world 2: the JAX
    test's losses (its plain executor on one device) from the same init,
    to rtol 1e-4, atol 1e-6, and the last below half the first."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(main, startup):
        loss = W.build_fleet_regression(jfluid, jfleet)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    exe.run(startup, scope=scope)
    init = {n: np.array(scope.get(n), copy=True)
            for n in ("fc_0.w_0", "fc_0.b_0")}
    want = [float(np.asarray(exe.run(main, feed=W.fleet_feed(),
                                     fetch_list=[loss], scope=scope)[0])
                  .reshape(-1)[0]) for _ in range(10)]
    res = W.pool(2).run("fleet_regression", init=W.pack(init))
    for r in res:
        assert "error" not in r, r["error"]
    assert [r["worker"] for r in res] == [(0, 2), (1, 2)]
    assert res[0]["backend"] == "gloo"
    assert res[0]["fleet_opt"]["mode"] == "collective"
    np.testing.assert_allclose(res[0]["losses"], want, rtol=1e-4, atol=1e-6)
    assert res[0]["losses"] == res[1]["losses"]
    assert res[0]["losses"][-1] < res[0]["losses"][0] * 0.5


def test_fluid_benchmark_nccl2_trains_mnist_over_two_ranks():
    """--update_method nccl2 --device CPU: ParallelExecutor over the two
    gloo ranks, examples/sec/chip over 2 chips, and the losses of the
    local run from the same init."""
    argv = ["--model", "mnist", "--device", "CPU", "--batch_size", "16",
            "--iterations", "3", "--skip_batch_num", "1"]
    dp = W.pool(2).run("benchmark", argv=argv + ["--update_method",
                                                  "nccl2"])
    local = W.pool(2).run("benchmark", argv=argv)
    for r in dp + local:
        assert "error" not in r, r["error"]
    assert dp[0]["out"]["n_chips"] == 2 and local[0]["out"]["n_chips"] == 1
    np.testing.assert_allclose(dp[0]["losses"], local[0]["losses"],
                               rtol=1e-4, atol=1e-6)
    assert dp[0]["losses"] == dp[1]["losses"]
