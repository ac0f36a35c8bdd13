"""The checkpoint subset of paddle_tpu_torch held against the JAX
package's ``checkpoint.py`` on the CPU: the manifest's ``digests`` equal
JAX's ``_write_manifest`` for the same numpy state (the payload differs:
``torch.save`` here, orbax there), the directory scans
(``latest_checkpoint``, ``all_checkpoints``, ``checkpoints_after``)
agree step for step on the same directory history, and the crash-safety
cases of ``tests/test_checkpoint.py`` and ``tests/test_resilience.py``
(round trip, key-path-checked restore, a manifest-less step, digest
rot, a torn payload falling back to the intact step, the
``ckpt_torn_write`` site) hold."""

import json
import os
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import checkpoint as jckpt
from paddle_tpu_torch import checkpoint as pckpt
from paddle_tpu_torch import resilience as pres
from paddle_tpu_torch.observability import metrics as pmetrics


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 6).astype(np.float32),
            "b": np.arange(5, dtype=np.int32),
            "scale": np.float64(0.5),
            "nested": {"step": np.asarray(7, np.int64),
                       "h": rng.randn(3).astype(np.float16)},
            "layers": [rng.randn(2, 2).astype(np.float32),
                       rng.randn(2).astype(np.float32)]}


def _manifest(path):
    with open(os.path.join(path, pckpt.MANIFEST_NAME)) as f:
        return json.load(f)


def _corrupt_payload(step_path):
    for root, _dirs, files in os.walk(step_path):
        for name in files:
            if name == pckpt.MANIFEST_NAME:
                continue
            with open(os.path.join(root, name), "r+b") as f:
                data = f.read()
                f.seek(0)
                f.write(bytes(b ^ 0xFF for b in data))


def test_manifest_digests_equal_jax(tmp_path):
    """The same numpy state (floats, ints, a scalar, nested dicts, a
    list) gives a format-1 manifest whose digests equal the JAX
    package's ``_write_manifest``, key for key; its file inventory names
    the port's payload with its size."""
    state = _state()
    path = pckpt.save_checkpoint(str(tmp_path / "port"), state, 3)
    got = _manifest(path)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    want = jckpt._write_manifest(str(jdir), state, 3)
    assert got["format"] == want["format"] == 1
    assert got["step"] == want["step"] == 3
    assert got["digests"] == want["digests"]
    assert sorted(got["digests"]) == ["b", "layers/0", "layers/1",
                                      "nested/h", "nested/step", "scale",
                                      "w"]
    payload = os.path.join(path, "data", "state.pt")
    assert got["files"] == {"data/state.pt": os.path.getsize(payload)}


def test_tensor_leaves_digest_as_their_arrays(tmp_path):
    """Tensor leaves (fp32, int64, bf16) digest as the JAX package digests
    the same values as numpy arrays (bf16 as ml_dtypes' bfloat16), and
    restore as tensors bit for bit."""
    rng = np.random.RandomState(1)
    f32 = rng.randn(3, 4).astype(np.float32)
    bf = rng.randn(8).astype(ml_dtypes.bfloat16)
    state = {"f": torch.from_numpy(f32), "i": torch.arange(6),
             "bf": torch.from_numpy(bf.view(np.int16)).view(torch.bfloat16)}
    path = pckpt.save_checkpoint(str(tmp_path), state, 1)
    want = {"f": jckpt._leaf_digest(f32),
            "i": jckpt._leaf_digest(np.arange(6, dtype=np.int64)),
            "bf": jckpt._leaf_digest(bf)}
    assert _manifest(path)["digests"] == want
    got = pckpt.restore_checkpoint(path)
    for k, v in state.items():
        assert isinstance(got[k], torch.Tensor) and got[k].dtype == v.dtype
        assert torch.equal(got[k].view(torch.int16)
                           if v.dtype == torch.bfloat16 else got[k],
                           v.view(torch.int16)
                           if v.dtype == torch.bfloat16 else v)


def test_pytree_roundtrip(tmp_path):
    """``test_pytree_roundtrip``: numpy leaves come back as numpy arrays
    of the same dtype and values, in the same structure."""
    state = _state()
    path = pckpt.save_checkpoint(str(tmp_path), state, 3)
    assert path.endswith("step_3")
    got = pckpt.restore_checkpoint(str(tmp_path))
    assert sorted(got) == sorted(state)
    for (k, a), (k2, b) in zip(pckpt._flatten(got), pckpt._flatten(state)):
        assert k == k2 and isinstance(a, np.ndarray)
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    assert isinstance(got["layers"], list)


def test_scans_agree_with_jax(tmp_path):
    """The directory scans on the same history: steps 1, 4 and 9 saved,
    a manifest-less step_12 (a crash mid-save), step 4 overwritten; both
    packages' scans list the same steps, newest intact first."""
    pdir, jdir = tmp_path / "p", tmp_path / "j"
    for step in (1, 4, 9, 4):
        pckpt.save_checkpoint(str(pdir), {"x": np.float32(step)}, step)
        jckpt.save_checkpoint(str(jdir), {"x": np.float32(step)}, step)
    for d in (pdir, jdir):
        os.makedirs(str(d / "step_12"))
    for fn in ("all_checkpoints", "latest_checkpoint"):
        got = getattr(pckpt, fn)(str(pdir))
        want = getattr(jckpt, fn)(str(jdir))
        if fn == "latest_checkpoint":
            got, want = os.path.basename(got), os.path.basename(want)
        assert got == want, fn
    for after in (None, 1, 4, 9):
        assert pckpt.checkpoints_after(str(pdir), after) == \
            jckpt.checkpoints_after(str(jdir), after)
    assert pckpt.all_checkpoints(str(pdir)) == [1, 4, 9]
    assert float(pckpt.restore_checkpoint(str(pdir))["x"]) == 9.0
    assert float(pckpt.restore_checkpoint(
        str(pdir / "step_4"))["x"]) == 4.0


def test_restore_rejects_renamed_keys(tmp_path):
    """``test_restore_rejects_renamed_keys``: key-path-checked placement;
    matching keys restore onto the target's dtypes and devices."""
    state = {"w_q": np.ones((4, 4), np.float32),
             "w_k": np.full((4, 4), 2.0, np.float32)}
    pckpt.save_checkpoint(str(tmp_path), state, step=0)
    with pytest.raises(ValueError):
        pckpt.restore_checkpoint(str(tmp_path), target_state={
            "w_query": np.zeros((4, 4), np.float32),
            "w_key": np.zeros((4, 4), np.float32)})
    ok = pckpt.restore_checkpoint(str(tmp_path), target_state={
        "w_q": torch.zeros(4, 4, dtype=torch.float64),
        "w_k": np.zeros((4, 4), np.float32)})
    assert ok["w_q"].dtype == torch.float64
    assert float(ok["w_k"][0, 0]) == 2.0


def test_digest_mismatch_detected(tmp_path):
    """``test_digest_mismatch_detected``: bit rot the payload hides is
    caught by the digest; ``verify=False`` restores anyway."""
    pckpt.save_checkpoint(str(tmp_path), {"w": np.arange(128.0)}, 1)
    mpath = str(tmp_path / "step_1" / pckpt.MANIFEST_NAME)
    with open(mpath) as f:
        doc = json.load(f)
    doc["digests"]["w"] = "0" * 64
    with open(mpath, "w") as f:
        json.dump(doc, f)
    with pytest.raises(pckpt.CheckpointCorruptionError, match="digest"):
        pckpt.restore_checkpoint(str(tmp_path / "step_1"))
    got = pckpt.restore_checkpoint(str(tmp_path / "step_1"), verify=False)
    np.testing.assert_array_equal(got["w"], np.arange(128.0))


def test_torn_checkpoint_falls_back_to_intact(tmp_path):
    """``test_torn_checkpoint_falls_back_to_intact``: a directory restore
    skips the corrupt newest step, counts it, and restores the older
    intact one; all corrupt raises."""
    pckpt.save_checkpoint(str(tmp_path), {"w": np.arange(64.0)}, 5)
    pckpt.save_checkpoint(str(tmp_path), {"w": np.arange(64.0) * 2}, 10)
    _corrupt_payload(str(tmp_path / "step_10"))
    was = pmetrics.enabled()
    pmetrics.enable()
    try:
        before = pmetrics.registry().counter(
            "resilience/ckpt_corrupt_detected").value
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = pckpt.restore_checkpoint(str(tmp_path))
        after = pmetrics.registry().counter(
            "resilience/ckpt_corrupt_detected").value
    finally:
        if not was:
            pmetrics.disable()
    np.testing.assert_array_equal(got["w"], np.arange(64.0))
    assert after == before + 1
    _corrupt_payload(str(tmp_path / "step_5"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(pckpt.CheckpointCorruptionError):
            pckpt.restore_checkpoint(str(tmp_path))


def test_torn_write_injection_hook(tmp_path):
    """``test_torn_write_injection_hook``: ``ckpt_torn_write:1`` tears the
    first save after it lands: a scan no longer lists it (its size
    disagrees with the manifest) and a restore raises."""
    prev = pres.set_global_injector(pres.FaultInjector("ckpt_torn_write:1"))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pckpt.save_checkpoint(str(tmp_path), {"w": np.arange(64.0)}, 1)
            pckpt.save_checkpoint(str(tmp_path), {"w": np.arange(8.0)}, 2)
    finally:
        pres.set_global_injector(prev)
    assert pckpt.all_checkpoints(str(tmp_path)) == [2]
    assert pckpt.checkpoints_after(str(tmp_path), None) == [2]
    with pytest.raises(pckpt.CheckpointCorruptionError):
        pckpt.restore_checkpoint(str(tmp_path / "step_1"))
    np.testing.assert_array_equal(
        pckpt.restore_checkpoint(str(tmp_path))["w"], np.arange(8.0))
