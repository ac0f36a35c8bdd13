"""chip_smoke.py's phase 13 (the LM trained from recordio shards and kept
alive) without the card, here on the CPU at a small LM (2 layers,
d_model 32, seq 16; 4 shards of 20 records, batch 10, so 16 steps over 2
epochs, as on the card):

  * 13a-13d run whole: the shards read back record for record, the
    oracle's losses finite and each batch's lower in the second epoch
    than in the first, a run SIGTERM'd at step 5 in a child process and
    resumed in another whose losses put together are the oracle's
    bitwise, and a NaN written into a parameter at step 10 rolled back
    in process to the oracle's losses bitwise; the gates fail a run
    whose state does not move, a flipped loss bit, a resume from another
    cursor, a record short, a run not preempted, and a resumed child
    that restores the initial weights or the checkpoint before the
    kill;
  * 13e on two CPU executors passes in fp32 and bf16 and fails a first
    device that drops its last batch;
  * 13f's costs report its keys."""

import importlib.util
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops import flash_attention as fa

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           seq_len=16)
SMALL = dict(cfg=CFG, shards=4, records=20, batch=10)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_data_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("phase13"))


@pytest.fixture(scope="module")
def phase(smoke, workdir):
    launches, report = smoke.data_train_phase(
        torch, fa, fluid, device="cpu", size=SMALL, on_card=False,
        workdir=workdir)
    return launches, report


def test_train_phase_on_the_cpu(phase):
    launches, report = phase
    assert launches == (0, 0)          # the plain version counts none
    assert report["records"] == 80 and report["steps"] == 16
    oracle, killed, resumed = (report[k] for k in ("oracle", "killed",
                                                   "resumed"))
    assert len(oracle["losses"]) == 16
    assert oracle["losses"][-1] < oracle["losses"][0]
    falls = smoke_falls(oracle)
    assert min(falls) > 0 and report["epoch_fall"]["least"] == min(falls)
    assert killed["preempted"] and len(killed["losses"]) == 4
    assert killed["step"] == 5 and resumed["step"] == 17
    assert resumed["cursor_start"] == killed["cursor_end"]
    assert killed["records"] + resumed["records"] == 160
    assert oracle["cursor_end"] == oracle["scope_cursor"]
    rolled = report["rollback"]
    assert (rolled["anomalies"], rolled["rollbacks"],
            rolled["retries"]) == (1, 1, 1)
    assert rolled["losses"] == oracle["losses"]


def smoke_falls(oracle):
    keys, losses = oracle["batch_keys"], oracle["losses"]
    first = dict(zip(keys[:8], losses[:8]))
    return [first[k] - x for k, x in zip(keys[8:], losses[8:])]


@pytest.mark.parametrize("fault", ["state_frozen", "one_batch_up"])
def test_oracle_gate_fails_a_run_that_does_not_train(smoke, phase, fault):
    """A run whose state does not move gives each batch the loss it had
    in the first epoch; one where a batch's loss rises fails too."""
    _, report = phase
    oracle = dict(report["oracle"])
    assert smoke.check_oracle(oracle, 16, 2) == smoke_falls(oracle)
    keys, losses = oracle["batch_keys"], list(oracle["losses"])
    first = dict(zip(keys[:8], losses[:8]))
    if fault == "state_frozen":
        losses[8:] = [first[k] for k in keys[8:]]
    else:
        losses[12] = first[keys[12]] + 1e-3
    oracle["losses"] = losses
    with pytest.raises(SystemExit):
        smoke.check_oracle(oracle, 16, 2)


def _child(workdir, **kw):
    paths = [os.path.join(workdir, "lm%02d.rec" % i) for i in range(4)]
    return dict(cfg=CFG, paths=paths, init_dir=os.path.join(workdir, "init"),
                device="cpu", batch=10, **kw)


@pytest.fixture(scope="module")
def killed_late(smoke, phase, workdir, tmp_path_factory):
    """13c's killed child, SIGTERM'd at step 7 into a directory of its
    own, so that it leaves the periodic checkpoint of step 5 under its
    emergency one of step 7. Returns (its directory, its result)."""
    ckpt = str(tmp_path_factory.mktemp("killed"))
    killed = smoke.run_child(
        _child(workdir, ckpt_dir=ckpt, name="killed", restore=False),
        {"PTPU_FAULT_INJECT": "sigterm_at_step:7"})
    assert killed["preempted"] and killed["step"] == 7
    oracle = phase[1]["oracle"]["losses"]
    assert smoke.loss_bits(killed["losses"]) == \
        smoke.loss_bits(oracle[:len(killed["losses"])])
    return ckpt, killed


@pytest.mark.parametrize("state", ["init_state", "older_checkpoint"])
def test_kill_resume_gates_fail_a_wrong_resumed_state(smoke, phase, workdir,
                                                      killed_late, tmp_path,
                                                      capsys, state):
    """The resumed child restores the wrong state: the initial weights
    under the killed run's step and cursor (only the losses can tell),
    or the checkpoint before the emergency one."""
    from paddle_tpu_torch import checkpoint

    _, report = phase
    killed_dir, killed = killed_late
    ckpt = str(tmp_path / "ck")
    shutil.copytree(killed_dir, ckpt)
    assert checkpoint.all_checkpoints(ckpt) == [5, 7]
    newest = checkpoint.latest_checkpoint(ckpt)
    assert newest.endswith("step_%d" % killed["step"])
    if state == "init_state":
        saved = checkpoint.restore_checkpoint(newest)
        init = checkpoint.restore_checkpoint(os.path.join(workdir, "init"))
        saved.update({k: v for k, v in init.items()
                      if k != "__step_counter__"})
        shutil.rmtree(newest)
        checkpoint.save_checkpoint(ckpt, saved, killed["step"])
    else:
        shutil.rmtree(newest)
    resumed = smoke.run_child(
        _child(workdir, ckpt_dir=ckpt, name="resumed", restore=True),
        {"PTPU_FAULT_INJECT": ""})
    if state == "init_state":
        assert resumed["cursor_start"] == killed["cursor_end"]
        assert killed["records"] + resumed["records"] == 160
    else:
        assert resumed["step"] == report["oracle"]["step"]
    capsys.readouterr()
    with pytest.raises(SystemExit):
        smoke.check_kill_resume(report["oracle"], killed, resumed, 160)
    said = capsys.readouterr().err
    assert ("not bitwise" if state == "init_state" else "cursor") in said


@pytest.mark.parametrize("fault", ["flipped_bit", "other_cursor",
                                   "records_short", "not_preempted"])
def test_kill_resume_gates_fail_faults(smoke, phase, fault):
    _, report = phase
    oracle = report["oracle"]
    killed, resumed = dict(report["killed"]), dict(report["resumed"])
    smoke.check_kill_resume(oracle, killed, resumed, 160)
    if fault == "flipped_bit":
        bits = np.float32(resumed["losses"][-1]).view(np.uint32) ^ 1
        resumed["losses"] = resumed["losses"][:-1] + [
            float(np.uint32(bits).view(np.float32))]
    elif fault == "other_cursor":
        resumed["cursor_start"] = list(resumed["cursor_start"])
        resumed["cursor_start"][3] += 1
    elif fault == "records_short":
        resumed["records"] -= 1
    else:
        killed["preempted"] = False
    with pytest.raises(SystemExit):
        smoke.check_kill_resume(oracle, killed, resumed, 160)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_card_vs_cpu_on_two_cpus(smoke, dtype):
    size = dict(cfg=dict(CFG, seq_len=32), batch=4, steps=3)
    k1 = smoke.data_card_vs_cpu_phase(torch, fluid, dtype,
                                      devices=("cpu", "cpu"), size=size)
    assert k1 == ({"tc": 0, "fp16": 0, "f32tc": 0},) * 2 + (0,)


def test_card_vs_cpu_fails_a_dropped_batch(smoke, monkeypatch):
    """The first device trains two of the three batches."""
    real = fluid.Executor.train_from_dataset
    calls = []

    def drop_last(self, program=None, dataset=None, **kw):
        calls.append(1)
        if len(calls) == 1:
            stream = dataset._resumable_stream

            def shorter(cursor, epochs, prefetch):
                pairs = list(stream(cursor, epochs, prefetch))
                return pairs[:-2] + pairs[-1:]

            dataset._resumable_stream = shorter
        return real(self, program, dataset, **kw)

    monkeypatch.setattr(fluid.Executor, "train_from_dataset", drop_last)
    with pytest.raises(SystemExit):
        smoke.data_card_vs_cpu_phase(
            torch, fluid, "float32", devices=("cpu", "cpu"),
            size=dict(cfg=dict(CFG, seq_len=32), batch=4, steps=3))


def test_costs_on_the_cpu(smoke):
    costs = smoke.data_costs_phase(
        torch, fluid, device="cpu", size=dict(cfg=CFG, batch=10), steps=4,
        ingestion=dict(n_shards=2, records_per_shard=64, width=8,
                       batch_size=16, repeats=1))
    assert costs["step_ms_guarded"] > 0 and costs["step_ms_unguarded"] > 0
    assert costs["snapshot_bytes"] > 0 and costs["snapshot_ms"] > 0
    assert costs["checkpoint_caller_ms"] > 0
    ing = costs["ingestion"]
    assert ing["healthy_records"] == 128 and ing["records_lost"] > 0
