"""The port's trainer side of ``resilience.py``, ``CheckpointManager``,
``Executor.train_from_dataset`` and the bench's resilience and ingestion
legs, against the JAX package on the CPU.

The programs are fit-a-line (fc 13 -> 1, square error, SGD 0.05) built by
both packages; the JAX startup draws the weights and ``carry_scope``
carries them into the port's scope, so both start from the same state.

  * the port's fault paths — a NaN rolled back (``nan_at_step``), a
    transient step failure and a transient compile retried, SIGTERM
    drained into an emergency checkpoint and resumed, a kill then resume
    of a dataset stream mid-epoch, a rollback whose checkpoint must keep
    the data cursor — end bitwise on the port's own fault-free run, and
    their losses within fp32's tolerance of the JAX package's over the
    same carried weights (LOSS_RTOL);
  * the policies' ledgers (anomalies, rollbacks, retries, skipped steps,
    final step) equal JAX's for the same faults;
  * snapshots copy: a tensor snapshot does not follow the scope's next
    in-place update, and a restore puts fresh copies back on the
    tensor's device in its dtype;
  * ``CheckpointManager``: retention, an async failure raised again by
    ``wait``, the three ``_reap_stale_tmp`` cases, ``ckpt_torn_write``
    falling back to an older intact step;
  * ``bench_resilience_overhead`` and ``bench_data_ingestion`` return
    bench.py's keys, and ``records_lost`` equals bench.py's for the same
    damage."""

import os
import signal
import warnings

import numpy as np
import pytest
import torch

import bench as jbench
import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import checkpoint as jckpt
from paddle_tpu import data_plane as jdp
from paddle_tpu import resilience as jres
from paddle_tpu import unique_name as j_unique
from paddle_tpu.core import native as jnative
from paddle_tpu_torch import bench as pbench
from paddle_tpu_torch import checkpoint as pckpt
from paddle_tpu_torch import data_plane as pdp
from paddle_tpu_torch import resilience as pres
from paddle_tpu_torch import unique_name as p_unique
from paddle_tpu_torch.observability import metrics as pmetrics

from torch_parity import carry_scope, persistable_names
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import pin_jax_init_draw  # noqa: F401 (autouse)

# fit-a-line's losses, port vs JAX over the same carried weights: both
# sum 13-term dot products and a 64-row mean in fp32 in other orders; 16
# SGD steps keep the difference within a few ulps of each loss
LOSS_RTOL = 1e-5


def _fit_a_line(mod, unique_name):
    prog, sprog = mod.Program(), mod.Program()
    with unique_name.guard(), mod.program_guard(prog, sprog):
        x = mod.layers.data(name="x", shape=[13], dtype="float32")
        y = mod.layers.data(name="y", shape=[1], dtype="float32")
        pred = mod.layers.fc(input=x, size=1)
        loss = mod.layers.mean(
            mod.layers.square_error_cost(input=pred, label=y))
        mod.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return prog, sprog, loss, x, y


def _data(n=256):
    rng = np.random.RandomState(0)
    xs = rng.uniform(-1, 1, (n, 13)).astype(np.float32)
    w = rng.uniform(-2, 2, (13, 1)).astype(np.float32)
    return xs, (xs @ w + 0.5).astype(np.float32)


def _batches(xs, ys, epochs, batch=64):
    for _ in range(epochs):
        for i in range(0, len(xs), batch):
            yield {"x": xs[i:i + batch], "y": ys[i:i + batch]}


class _Pair:
    """fit-a-line in both packages, the port's start the JAX draw."""

    def __init__(self):
        self.j = _fit_a_line(jf, j_unique)
        self.p = _fit_a_line(pf, p_unique)
        self.pname = self.p[0].global_block().all_parameters()[0].name
        jscope = jf.Scope()
        jf.Executor(jf.CPUPlace()).run(self.j[1], scope=jscope)
        self.start = {n: np.array(jscope.get(n), copy=True)
                      for n in persistable_names(self.j[0])}
        self.xs, self.ys = _data()

    def scope(self, mod):
        """A fresh scope of `mod` after its startup run, holding the
        carried start state (the startup run takes counter slot 0)."""
        prog, sprog = (self.j if mod is jf else self.p)[:2]
        sc = mod.Scope()
        exe = mod.Executor(jf.CPUPlace() if mod is jf else "cpu")
        exe.run(sprog, scope=sc)
        if mod is jf:
            for n, v in self.start.items():
                sc.set(n, v.copy())
        else:
            carry_scope(_Holder(self.start), sc, sorted(self.start))
        return sc, exe

    def train(self, mod, inject="", feeds=None, epochs=4, **kw):
        res = jres if mod is jf else pres
        prog, _, loss = (self.j if mod is jf else self.p)[:3]
        sc, exe = self.scope(mod)
        tr = mod.ResilientTrainer(
            exe, prog, fetch_list=[loss], scope=sc, guard_every=4,
            backoff_base=0.0, fault_injector=res.FaultInjector(inject),
            **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            result = tr.run(feeds if feeds is not None
                            else _batches(self.xs, self.ys, epochs))
        w = sc.get(self.pname)
        w = w.numpy().copy() if isinstance(w, torch.Tensor) \
            else np.array(w)
        return result, w, sc, tr


class _Holder:
    """A read-only scope over a dict (carry_scope reads `get`)."""

    def __init__(self, values):
        self.values = values

    def get(self, name):
        return self.values[name]


def _ledger(r):
    return (r.step, r.preempted, r.anomalies, r.rollbacks, r.retries,
            r.skipped_steps, len(r.losses))


@pytest.fixture(scope="module")
def pair():
    return _Pair()


@pytest.fixture
def clean_injectors():
    prev = (jres.set_global_injector(jres.FaultInjector("")),
            pres.set_global_injector(pres.FaultInjector("")))
    yield
    jres.set_global_injector(prev[0])
    pres.set_global_injector(prev[1])


def test_clean_run_equal_jax(pair):
    pr, pw, _, _ = pair.train(pf)
    jr, jw, _, _ = pair.train(jf)
    assert _ledger(pr) == _ledger(jr)
    np.testing.assert_allclose(pr.losses, jr.losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(pw, jw, rtol=LOSS_RTOL, atol=1e-6)
    assert pr.losses[-1] < pr.losses[0] * 0.5


@pytest.mark.parametrize("inject, kw", [
    ("nan_at_step:10", {"policy": "rollback"}),
    ("transient_at_step:7", {}),
    ("nan_at_step:14,transient_at_step:3", {}),
])
def test_recovered_run_bitwise_own_oracle_near_jax(pair, inject, kw):
    """test_resilience.py :89 (and the transient retry) on the port."""
    clean, w_clean, _, _ = pair.train(pf)
    pr, pw, _, _ = pair.train(pf, inject, **kw)
    jr, _, _, _ = pair.train(jf, inject, **kw)
    assert _ledger(pr) == _ledger(jr)
    assert pr.rollbacks >= 1 and pr.retries >= 1
    np.testing.assert_array_equal(pw, w_clean)
    np.testing.assert_array_equal(pr.losses, clean.losses)
    np.testing.assert_allclose(pr.losses, jr.losses, rtol=LOSS_RTOL)


@pytest.mark.parametrize("inject, kw", [
    ("nan_at_step:10", {"policy": "skip_batch"}),
    ("nan_at_step:1,nan_at_step:2", {"policy": "warn"}),
    ("nan_at_step:6", {"policy": "rollback", "max_step_retries": 0}),
])
def test_policy_ledgers_equal_jax(pair, inject, kw):
    pr, _, _, _ = pair.train(pf, inject, epochs=2, **kw)
    jr, _, _, _ = pair.train(jf, inject, epochs=2, **kw)
    assert _ledger(pr) == _ledger(jr)
    finite = np.isfinite(jr.losses)
    assert (np.isfinite(pr.losses) == finite).all()
    np.testing.assert_allclose(np.asarray(pr.losses)[finite],
                               np.asarray(jr.losses)[finite],
                               rtol=LOSS_RTOL)


def test_abort_and_budget_raise_like_jax(pair):
    with pytest.raises(pres.AnomalousStepError) as ei:
        pair.train(pf, "nan_at_step:2", policy="abort", epochs=1)
    assert (ei.value.step, ei.value.kind) == (2, "nonfinite")
    xs = pair.xs.copy()
    xs[3, 0] = np.nan  # every epoch re-feeds the same poisoned batch
    with pytest.raises(pres.RetryBudgetExceededError):
        pair.train(pf, feeds=_batches(xs, pair.ys, 8), retry_budget=2,
                   max_step_retries=99)
    xs = pair.xs.copy()
    xs[::64, 0] = np.nan  # every batch poisoned: skipping is free
    r, _, _, _ = pair.train(pf, feeds=_batches(xs, pair.ys, 2),
                            policy="skip_batch", retry_budget=2)
    assert (r.skipped_steps, r.retries) == (8, 0)


def test_retry_budget_resets_per_run(pair):
    r, _, _, tr = pair.train(pf, "transient_at_step:3", epochs=2,
                             retry_budget=4)
    assert r.retries == 1 and tr._retries_left == 3
    tr.run(iter([]))
    assert tr._retries_left == 4 and not tr._batch_retries


def test_transient_compile_retried(pair, clean_injectors):
    """The executor's cache-miss hook: occurrence 1 is the startup
    program's plan, occurrence 2 the train step's, inside the loop."""
    _, w_clean, _, _ = pair.train(pf, epochs=2)
    pres.set_global_injector(pres.FaultInjector("transient_compile:2"))
    r, w, _, _ = pair.train(pf, epochs=2)
    assert r.retries == 1
    np.testing.assert_array_equal(w, w_clean)


def test_detector_equal_jax_and_rewinds(pair):
    seq = [1.0, 1.1, 0.9, 1.0, 50.0, np.nan, 1.05, 0.2, 3.0, 40.0]
    for kw in (dict(spike_factor=5.0, warmup=3), dict(spike_factor=2.0,
                                                       spike_window=4,
                                                       warmup=1), {}):
        pd, jd = pres.AnomalyDetector(**kw), jres.AnomalyDetector(**kw)
        assert [pd.check(v) for v in seq] == [jd.check(v) for v in seq]
        assert pd.state() == jd.state()
    r, _, _, tr = pair.train(pf, "nan_at_step:10", policy="rollback",
                             spike_factor=100.0)
    assert r.rollbacks == 1
    assert tr.detector.state()[1] == len(r.losses)


def test_anomaly_policy_env(monkeypatch):
    monkeypatch.setenv("PTPU_ANOMALY_POLICY", "skip_batch")
    assert pres.anomaly_policy() == "skip_batch"
    assert pres.anomaly_policy("abort") == "abort"
    monkeypatch.setenv("PTPU_ANOMALY_POLICY", "bogus")
    with pytest.raises(ValueError):
        pres.anomaly_policy()


def test_int_feed_nan_at_step_is_jax_s(pair):
    """`nan_at_step` as in the JAX package: it poisons a copy of the
    step's first float feed value, and leaves a feed with none (an LM's
    token ids) as it is, so the run is the fault-free one. Here
    fit-a-line is fed int32 rows, which the executor casts to its float
    vars."""
    spec = "nan_at_step:3,nan_at_step:4"
    tr = pres.ResilientTrainer(pf.Executor("cpu"), fetch_list=[1],
                               fault_injector=pres.FaultInjector(spec))
    jtr = jres.ResilientTrainer(jf.Executor(jf.CPUPlace()), fetch_list=[1],
                                fault_injector=jres.FaultInjector(spec))
    only_ints = {"ids": np.arange(4, dtype=np.int64)}
    for got in (tr._maybe_corrupt(only_ints, 3),
                jtr._maybe_corrupt(only_ints, 3)):
        assert list(got) == ["ids"] and np.array_equal(got["ids"],
                                                       only_ints["ids"])
    mixed = {"t": np.ones(3, np.float32), "i": np.arange(2)}
    got, want = tr._maybe_corrupt(mixed, 4), jtr._maybe_corrupt(mixed, 4)
    for k in mixed:
        np.testing.assert_array_equal(got[k], want[k])
    assert np.isnan(got["t"][0]) and not np.isnan(mixed["t"]).any()
    tensor = {"t": torch.ones(3)}
    tr2 = pres.ResilientTrainer(pf.Executor("cpu"), fetch_list=[1],
                                fault_injector=pres.FaultInjector(
                                    "nan_at_step:0"))
    assert torch.isnan(tr2._maybe_corrupt(tensor, 0)["t"][0])
    assert not torch.isnan(tensor["t"]).any()
    rng = np.random.RandomState(3)
    feeds = [{"x": rng.randint(-3, 4, (64, 13)).astype(np.int32),
              "y": rng.randint(-3, 4, (64, 1)).astype(np.int32)}
             for _ in range(8)]
    clean, w_clean, _, _ = pair.train(pf, feeds=iter(feeds))
    r, w, _, _ = pair.train(pf, "nan_at_step:6", policy="rollback",
                            feeds=iter(feeds))
    assert (r.anomalies, r.rollbacks, r.retries) == (0, 0, 0)
    assert np.isfinite(clean.losses).all()
    np.testing.assert_array_equal(w, w_clean)
    np.testing.assert_array_equal(r.losses, clean.losses)


def test_snapshot_copies_and_restores_in_place():
    """F6's pattern: on the CPU ``t.cpu()`` is ``t``; a snapshot must
    not follow the scope's next in-place update. Restore hands out fresh
    copies on the tensor's device, in its dtype."""
    sc = pf.Scope()
    w = torch.arange(6, dtype=torch.bfloat16)
    sc.set("w", w)
    sc.set("meta", [1, 2, 3])
    sc.set("cur", np.arange(3))
    sc.set("__step_counter__", 7)
    snap = pres.snapshot_scope(sc)
    assert snap.step == 7 and snap.nbytes == 12 + 24
    w.add_(1)                       # the next step's in-place update
    sc.get("meta").append(99)
    assert torch.equal(snap.state["w"], torch.arange(6,
                                                     dtype=torch.bfloat16))
    assert pres.restore_scope_snapshot(snap, sc) == 7
    got = sc.get("w")
    assert got.dtype == torch.bfloat16 and got.device == w.device
    assert torch.equal(got, snap.state["w"]) and got is not snap.state["w"]
    sc.get("meta").append(5)
    sc.get("cur")[0] = 9
    assert snap.state["meta"] == [1, 2, 3] and snap.state["cur"][0] == 0


def test_preemption_guard_restores_handlers():
    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))
    with pres.PreemptionGuard() as guard:
        assert signal.getsignal(signal.SIGTERM) == guard._handle
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered == signal.SIGTERM
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before


def test_sigterm_drains_and_emergency_checkpoint_resumes(pair, tmp_path):
    """test_resilience.py :530 on the port."""
    clean, w_clean, _, _ = pair.train(pf, epochs=6)
    feeds = list(_batches(pair.xs, pair.ys, 6))
    ckdir = str(tmp_path / "ck")
    r, _, _, _ = pair.train(pf, "sigterm_at_step:10", epochs=6,
                            checkpoint_dir=ckdir, checkpoint_every=1000)
    assert r.preempted and r.checkpoints_saved >= 1
    assert pckpt.all_checkpoints(ckdir)
    prog, _, loss = pair.p[:3]
    sc, exe = pair.scope(pf)
    tr = pf.ResilientTrainer(exe, prog, fetch_list=[loss], scope=sc,
                             guard_every=4, checkpoint_dir=ckdir)
    step = tr.restore()
    assert step == r.step and isinstance(sc.get("__step_counter__"), int)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r2 = tr.run(iter(feeds[step - 1:]))
    assert not r2.preempted
    np.testing.assert_array_equal(sc.get(pair.pname).numpy(), w_clean)
    np.testing.assert_array_equal(r.losses + r2.losses, clean.losses)


def test_chaos_nan_plus_torn_checkpoint_completes(pair, tmp_path,
                                                  clean_injectors):
    clean, w_clean, _, _ = pair.train(pf, epochs=8)
    ckdir = str(tmp_path / "ck")
    pres.set_global_injector(pres.FaultInjector("ckpt_torn_write:1"))
    r, w, _, _ = pair.train(pf, "nan_at_step:14", epochs=8,
                            policy="rollback", checkpoint_dir=ckdir,
                            checkpoint_every=8)
    assert r.rollbacks >= 1
    np.testing.assert_array_equal(w, w_clean)
    sc, exe = pair.scope(pf)
    tr = pf.ResilientTrainer(exe, pair.p[0], fetch_list=[pair.p[2]],
                             scope=sc, checkpoint_dir=ckdir)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tr.restore() is not None


def test_trainer_metrics_and_argument_errors(pair):
    pmetrics.enable()
    try:
        reg = pmetrics.registry()
        names = ("anomalies", "rollbacks", "retries")
        before = {n: reg.counter("resilience/" + n).value for n in names}
        pair.train(pf, "nan_at_step:5", epochs=2, policy="rollback")
        for n in names:
            assert reg.counter("resilience/" + n).value == before[n] + 1
        assert reg.gauge("resilience/snapshot_bytes").value > 0
    finally:
        pmetrics.disable()
    sc, exe = pair.scope(pf)
    tr = pf.ResilientTrainer(exe, pair.p[0], fetch_list=[pair.p[2]],
                             scope=sc)
    with pytest.raises(ValueError):
        tr.restore()
    with pytest.raises(ValueError):
        pf.ResilientTrainer(exe, pair.p[0], fetch_list=[], scope=sc)


# ---------------------------------------------------------------------------
# the dataset path: train_from_dataset and the trainer over shards
# ---------------------------------------------------------------------------

_needs_native = pytest.mark.skipif(jnative.lib() is None,
                                   reason="no native lib for JAX RecordIO")


class _Var:
    def __init__(self, name):
        self.name = name


def _line_shards(tmp_path, n_shards=4, records=64, seed=100):
    rng = np.random.RandomState(0)
    w_true = rng.uniform(-2, 2, (13, 1)).astype(np.float32)
    paths = []
    for i in range(n_shards):
        p = str(tmp_path / ("t%d.rec" % i))

        def gen(i=i):
            r = np.random.RandomState(seed + i)
            for _ in range(records):
                xv = r.uniform(-1, 1, (13,)).astype(np.float32)
                yield xv, (xv @ w_true + 0.5).astype(np.float32)

        jf.convert_reader_to_recordio_file(p, gen)
        paths.append(p)
    return paths


def _ds(mod, paths, bs, thread=1):
    ds = mod.DatasetFactory().create_dataset("QueueDataset")
    ds.set_filelist(paths)
    ds.set_batch_size(bs)
    ds.set_use_var([_Var("x"), _Var("y")])
    ds.set_thread(thread)
    return ds


@_needs_native
def test_train_from_dataset_equal_jax(pair, tmp_path):
    """Both packages' train_from_dataset over the same shards from the
    same weights, with a cursor: the last loss within LOSS_RTOL, the
    cursor and its scope mirror equal. A restored epoch-1 cursor trains
    the rest of epoch 1; epochs without a cursor raises."""
    paths = _line_shards(tmp_path, n_shards=2, records=64)
    out = {}
    for mod, dp in ((jf, jdp), (pf, pdp)):
        prog, _, loss = (pair.j if mod is jf else pair.p)[:3]
        sc, exe = pair.scope(mod)
        cur = dp.DatasetCursor(seed=3)
        last = exe.train_from_dataset(prog, _ds(mod, paths, 32, thread=2),
                                      fetch_list=[loss], scope=sc,
                                      cursor=cur, epochs=2)
        cur2 = dp.DatasetCursor(epoch=1, shard_idx=1, record_offset=4,
                                seed=3)
        exe.train_from_dataset(prog, _ds(mod, paths, 32), scope=sc,
                               cursor=cur2)
        plain = exe.train_from_dataset(prog, _ds(mod, paths, 32),
                                       fetch_list=[loss], scope=sc)
        with pytest.raises(ValueError):
            exe.train_from_dataset(prog, _ds(mod, paths, 32), scope=sc,
                                   epochs=2)
        out[mod] = (float(np.asarray(last[0]).ravel()[0]), cur.position(),
                    np.asarray(sc.get("__data_cursor__")).tolist(),
                    cur2.position(), float(np.asarray(plain[0]).ravel()[0]))
    got, want = out[pf], out[jf]
    assert got[1:4] == want[1:4] and got[1] == (2, 0, 0)
    np.testing.assert_allclose([got[0], got[4]], [want[0], want[4]],
                               rtol=LOSS_RTOL)


@_needs_native
def test_train_from_dataset_cursor_tracks_consumption(pair, tmp_path,
                                                      monkeypatch):
    """test_data_plane.py :993 on the port: the mirrored cursor names
    each batch's post-consumption position AT ITS STEP, though the H2D
    lookahead has pulled the next batch already."""
    paths = _line_shards(tmp_path, n_shards=2, records=12)
    prog, _, loss = pair.p[:3]
    sc, exe = pair.scope(pf)
    expected = [s for _, s in _ds(pf, paths, 4)._resumable_stream(
        pdp.DatasetCursor(), 1, False)]
    assert len(expected) == 6
    seen = []
    orig = pf.Executor.run

    def spy(self, *a, **k):
        cur = pdp.DatasetCursor.from_scope(sc)
        seen.append(None if cur is None else cur.position())
        return orig(self, *a, **k)

    monkeypatch.setattr(pf.Executor, "run", spy)
    exe.train_from_dataset(prog, _ds(pf, paths, 4), scope=sc,
                           cursor=pdp.DatasetCursor())
    assert seen == expected


def _dataset_trainer(pair, mod, paths, bs, ckdir=None, inject="",
                     steps=None, restore=False, **kw):
    """One trainer over the resumable stream (seed 3, 2 epochs) in a
    fresh scope; with `restore`, from the newest checkpoint and its
    cursor. Returns (result, scope, cursor)."""
    res, dp = (jres, jdp) if mod is jf else (pres, pdp)
    prog, _, loss = (pair.j if mod is jf else pair.p)[:3]
    sc, exe = pair.scope(mod)
    tr = mod.ResilientTrainer(exe, prog, fetch_list=[loss], scope=sc,
                              guard_every=4, checkpoint_dir=ckdir,
                              fault_injector=res.FaultInjector(inject),
                              **kw)
    cur = dp.DatasetCursor(seed=3)
    if restore:
        assert tr.restore() is not None
        cur = dp.DatasetCursor.from_scope(sc)
        assert cur is not None and cur.seed == 3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = tr.run(_ds(mod, paths, bs, thread=2).resumable_batches(
            cur, epochs=2, scope=sc), steps=steps)
    return r, sc, cur


@_needs_native
def test_kill_then_resume_bitwise_own_oracle_near_jax(pair, tmp_path):
    """test_data_plane.py :1130 on the port: SIGTERM mid-epoch -> the
    emergency checkpoint (the cursor rides it in the scope) -> a fresh
    trainer restores and resumes; the loss stream put together is the
    port's unfailed oracle's bitwise, and JAX's within LOSS_RTOL."""
    paths = _line_shards(tmp_path)
    oracle, _, _ = _dataset_trainer(pair, pf, paths, 32)
    jor, _, _ = _dataset_trainer(pair, jf, paths, 32)
    ckdir = str(tmp_path / "ck")
    pre, sc2, cur2 = _dataset_trainer(pair, pf, paths, 32, ckdir=ckdir,
                                      inject="sigterm_at_step:5")
    assert pre.preempted and 0 < len(pre.losses) < len(oracle.losses)
    post, _, _ = _dataset_trainer(pair, pf, paths, 32, ckdir=ckdir,
                                  restore=True)
    total = pre.losses + post.losses
    assert len(total) == len(oracle.losses) == 16
    np.testing.assert_array_equal(total, oracle.losses)
    np.testing.assert_allclose(oracle.losses, jor.losses, rtol=LOSS_RTOL)


@_needs_native
def test_rollback_checkpoint_cursor_not_stale(pair, tmp_path):
    """test_data_plane.py :1213 on the port: a transient rollback on the
    second window's last batch; the boundary checkpoint written from the
    rolled-back scope must keep the pull frontier, so the resumed run
    ends bitwise on the oracle."""
    paths = _line_shards(tmp_path, n_shards=1, records=64, seed=7)
    oracle, _, _ = _dataset_trainer(pair, pf, paths, 8)
    assert len(oracle.losses) == 16
    ckdir = str(tmp_path / "ck")
    pre, _, _ = _dataset_trainer(pair, pf, paths, 8, ckdir=ckdir,
                                 inject="transient_at_step:8", steps=8,
                                 checkpoint_every=4)
    assert pre.rollbacks >= 1 and len(pre.losses) == 8
    post, _, _ = _dataset_trainer(pair, pf, paths, 8, ckdir=ckdir,
                                  restore=True)
    np.testing.assert_array_equal(pre.losses + post.losses, oracle.losses)


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------


def test_manager_async_save_and_retention(tmp_path):
    mgr = pckpt.CheckpointManager(str(tmp_path), max_to_keep=2,
                                  async_save=True)
    t = torch.zeros(3)
    for s in (1, 2, 3, 4):
        t.fill_(float(s))
        mgr.save({"x": t, "step": np.int64(s)}, s)  # copied in the caller
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    got = mgr.restore()
    assert torch.equal(got["x"], torch.full((3,), 4.0))


def test_manager_async_failure_raised_by_wait(tmp_path, monkeypatch):
    mgr = pckpt.CheckpointManager(str(tmp_path), async_save=True)

    def boom(directory, state, step):
        raise OSError("disk full at step %d" % step)

    monkeypatch.setattr(pckpt, "save_checkpoint", boom)
    mgr.save({"x": np.zeros(2)}, 1)
    with pytest.raises(OSError, match="disk full at step 1"):
        mgr.wait()
    mgr.wait()  # raised once


def test_manager_reaps_stale_tmp(tmp_path):
    """The three cases: a complete tmp dir whose step_N is missing is
    published, an `_old` aside whose step_N is missing is restored, and
    any other tmp dir is reclaimed."""
    pckpt.save_checkpoint(str(tmp_path), {"x": np.asarray(4.0)}, 4)
    os.rename(str(tmp_path / "step_4"),
              str(tmp_path / (pckpt._TMP_PREFIX + "step_4")))
    pckpt.save_checkpoint(str(tmp_path), {"x": np.asarray(6.0)}, 6)
    os.rename(str(tmp_path / "step_6"),
              str(tmp_path / (pckpt._TMP_PREFIX + "step_6_old")))
    stale = tmp_path / (pckpt._TMP_PREFIX + "step_7_999")
    os.makedirs(str(stale))
    pckpt.CheckpointManager(str(tmp_path))
    assert pckpt.all_checkpoints(str(tmp_path)) == [4, 6]
    assert not stale.exists()
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith(pckpt._TMP_PREFIX)]
    assert float(pckpt.restore_checkpoint(str(tmp_path))["x"]) == 6.0


def test_torn_write_falls_back_to_intact_step(tmp_path, clean_injectors):
    mgr = pckpt.CheckpointManager(str(tmp_path), max_to_keep=1)
    mgr.save({"x": np.asarray(1.0)}, 1)
    pres.set_global_injector(pres.FaultInjector("ckpt_torn_write:1"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mgr.save({"x": np.asarray(2.0)}, 2)
    assert mgr.all_steps() == [1]
    assert os.path.isdir(str(tmp_path / "step_2"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert float(mgr.restore()["x"]) == 1.0
    mgr.save({"x": np.asarray(3.0)}, 3)
    assert mgr.all_steps() == [3]
    assert not os.path.isdir(str(tmp_path / "step_2"))


def test_manager_steps_equal_jax(tmp_path):
    """The same save sequence under retention 2 leaves the same steps in
    both packages' directories, with the same manifest digests."""
    import json

    for mod, sub in ((jckpt, "jax"), (pckpt, "port")):
        mgr = mod.CheckpointManager(str(tmp_path / sub), max_to_keep=2)
        for s in (3, 5, 8):
            mgr.save({"w": np.arange(4, dtype=np.float32) * s,
                      "n": np.int64(s)}, s)
        mgr.wait()
    assert jckpt.all_checkpoints(str(tmp_path / "jax")) == \
        pckpt.all_checkpoints(str(tmp_path / "port")) == [5, 8]
    for s in (5, 8):
        docs = [json.load(open(str(tmp_path / sub / ("step_%d" % s)
                                   / pckpt.MANIFEST_NAME)))
                for sub in ("jax", "port")]
        assert docs[0]["digests"] == docs[1]["digests"]


# ---------------------------------------------------------------------------
# the bench's legs
# ---------------------------------------------------------------------------


def test_bench_resilience_overhead_on_the_cpu():
    unguarded, guarded = pbench.bench_resilience_overhead(
        steps=8, warmup=2, batch=16, guard_every=4, place="cpu")
    assert unguarded > 0 and guarded > 0


@_needs_native
def test_bench_data_ingestion_records_lost_equal_jax():
    kw = dict(n_shards=4, records_per_shard=96, width=8, batch_size=32,
              repeats=1)
    got = pbench.bench_data_ingestion(place="cpu", **kw)
    want = jbench.bench_data_ingestion(**kw)
    assert sorted(got) == sorted(want)
    for k in ("healthy_records", "degraded_records", "records_lost"):
        assert got[k] == want[k], k
    assert got["records_lost"] > 0
    assert got["healthy_records_per_sec"] > 0


def test_bench_data_only_main_prints_bench_keys(capsys, monkeypatch):
    monkeypatch.setattr(pbench, "bench_data_ingestion", lambda place: {
        "healthy_records_per_sec": 10.0, "degraded_records_per_sec": 8.0,
        "degraded_throughput_ratio": 0.8, "healthy_records": 100,
        "degraded_records": 90, "records_lost": 10})
    out = pbench.main(["--data-only", "--place", "cpu"])
    assert out["metric"] == "data_degraded_throughput_ratio"
    assert (out["value"], out["records_lost"]) == (0.8, 10)
    assert [leg["leg"] for leg in out["legs"]] == ["data_healthy",
                                                   "data_degraded"]
    assert "not_ported" not in out


def test_data_path_and_bench_legs_refuse_to_run_without_cuda():
    """No CUDA and no explicit device: the executor the trainer and
    train_from_dataset drive, and both bench legs, raise; they never
    quietly run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA path; this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        pf.Executor()
    for leg in (pbench.bench_data_ingestion,
                pbench.bench_resilience_overhead):
        with pytest.raises(RuntimeError, match="CUDA"):
            leg()
