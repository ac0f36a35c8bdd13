"""Crash-safe training-state checkpoints (parity: the JAX package's
``checkpoint.py``): ``save_checkpoint``, ``restore_checkpoint``,
``checkpoints_after``, ``latest_checkpoint``, ``all_checkpoints``,
``CheckpointCorruptionError`` and ``CheckpointManager`` (:460-657:
retention, async saves, the crashed-writer journal replay).

A state is a dict (nested dicts and lists allowed) whose leaves are
numpy arrays, tensors or Python scalars. Every save is ATOMIC: the
payload and a ``ptpu_manifest.json`` land in a hidden temp dir, fsynced,
and one rename publishes ``step_N``, so a crash mid-save never leaves a
step ``latest_checkpoint`` would hand back. The manifest is the JAX
package's format 1: ``digests`` (sha256 over each leaf's dtype, shape
and bytes, keyed by its ``/``-joined key path, dict keys sorted) and the
``files`` inventory (relative path -> size, stat-checked by directory
scans). Restore verifies the digests and, pointed at a directory, falls
back to the newest INTACT step, counting what it skipped in
``resilience/ckpt_corrupt_detected``. The ``ckpt_torn_write`` fault site
corrupts a checkpoint after it lands.

The payload is torch's, not orbax's: ``data/state.pt``, written with
``torch.save`` and read with ``torch.load(weights_only=True)`` — every
leaf stored as a CPU tensor, with the leaves that were numpy arrays or
scalars given back as numpy arrays. So the same state gives the same
digests here and in the JAX package, while the payload files differ.

Layout (one step):
    directory/step_N/ptpu_manifest.json   digests + file inventory
    directory/step_N/data/state.pt        the payload

Not ported yet (ROADMAP.md Queue 1 item 9): the multi-process save and
``host_embedding_state``.
"""

import hashlib
import json
import os
import shutil
import threading
import warnings

import numpy as np
import torch

from .observability import metrics as _metrics
from .observability import tracing as _tracing

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint",
           "all_checkpoints", "checkpoints_after", "CheckpointManager",
           "CheckpointCorruptionError", "MANIFEST_NAME"]

MANIFEST_NAME = "ptpu_manifest.json"
_DATA_SUBDIR = "data"
_PAYLOAD = "state.pt"
_TMP_PREFIX = ".ptpu_tmp_"
_LEAF = "<leaf>"   # a leaf's place in the saved structure


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed digest verification (torn write, bit rot) or
    its payload cannot be deserialized."""


def _flatten(tree, prefix=()):
    """[(key path, leaf)] in the JAX package's order: dict keys sorted,
    sequence items by index, None an empty subtree."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, prefix + (str(i),)))
        return out
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def _skeleton(tree):
    """The state's structure with every leaf replaced by a marker."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(v) for v in tree]
    return None if tree is None else _LEAF


def _rebuild(skel, leaves, prefix=()):
    if isinstance(skel, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in skel.items()}
    if isinstance(skel, list):
        return [_rebuild(v, leaves, prefix + (str(i),))
                for i, v in enumerate(skel)]
    return None if skel is None else leaves["/".join(prefix)]


def _host_view(leaf):
    """(dtype name, shape, contiguous bytes) of a leaf on the host, the
    three things a digest covers. A bf16 tensor reports "bfloat16" over
    its raw bits, as an ml_dtypes bf16 array does in the JAX package."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return ("bfloat16", tuple(t.shape),
                    t.view(torch.int16).numpy().tobytes())
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return str(arr.dtype), arr.shape, arr.tobytes()


def _leaf_digest(leaf):
    """sha256 over a leaf's dtype, shape and bytes (the JAX package's
    ``_leaf_digest``)."""
    dtype, shape, data = _host_view(leaf)
    h = hashlib.sha256()
    h.update(dtype.encode())
    h.update(repr(tuple(shape)).encode())
    h.update(data)
    return h.hexdigest()


def _write_manifest(path, state, step):
    digests = {key: _leaf_digest(leaf) for key, leaf in _flatten(state)}
    # file inventory (relpath -> size): directory scans detect a
    # truncated payload with a few stat calls
    files = {}
    for root, _dirs, names in os.walk(path):
        for name in names:
            if name == MANIFEST_NAME:
                continue
            p = os.path.join(root, name)
            files[os.path.relpath(p, path)] = os.path.getsize(p)
    doc = {"format": 1, "step": int(step), "digests": digests,
           "files": files}
    with open(os.path.join(path, MANIFEST_NAME), "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    return doc


def _read_manifest(path):
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        return None
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _files_intact(path, manifest):
    """Stat-only truncation check of the manifest's file inventory."""
    for rel, size in (manifest.get("files") or {}).items():
        try:
            if os.path.getsize(os.path.join(path, rel)) != int(size):
                return False
        except OSError:
            return False
    return True


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # fsync on a directory is best effort


def _maybe_tear(step_path):
    """The ``ckpt_torn_write`` fault site: after a save lands, corrupt and
    truncate its payload in place, the torn write the manifest exists to
    catch."""
    from .resilience import global_injector

    if not global_injector().fire_occurrence("ckpt_torn_write"):
        return
    for root, _dirs, files in os.walk(step_path):
        for name in files:
            if name == MANIFEST_NAME:
                continue
            with open(os.path.join(root, name), "r+b") as f:
                data = f.read()
                if not data:
                    continue
                f.seek(0)
                f.write(bytes(b ^ 0xFF
                              for b in data[: max(1, len(data) // 2)]))
                f.truncate(max(1, len(data) // 2))


def _write_payload(data_dir, state):
    leaves, numpy_keys = {}, []
    for key, leaf in _flatten(state):
        if isinstance(leaf, torch.Tensor):
            leaves[key] = leaf.detach().cpu().contiguous()
        else:
            leaves[key] = torch.from_numpy(np.array(leaf, order="C"))
            numpy_keys.append(key)
    os.makedirs(data_dir)
    path = os.path.join(data_dir, _PAYLOAD)
    torch.save({"format": 1, "skeleton": _skeleton(state),
                "leaves": leaves, "numpy": numpy_keys}, path)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(directory, state, step):
    """Atomically write ``state`` under ``directory/step_N``: payload and
    digest manifest land in a temp dir first, then one rename publishes
    the step (an existing step_N is parked aside first, so no instant
    holds no intact step_N). Returns the checkpoint path."""
    directory = os.path.abspath(directory)
    final = os.path.join(directory, "step_%d" % int(step))
    os.makedirs(directory, exist_ok=True)
    with _tracing.span("checkpoint/save", step=int(step)):
        tmp = os.path.join(directory, _TMP_PREFIX + "step_%d" % int(step))
        shutil.rmtree(tmp, ignore_errors=True)
        _write_payload(os.path.join(tmp, _DATA_SUBDIR), state)
        _write_manifest(tmp, state, step)
        aside = None
        if os.path.isdir(final):
            aside = tmp + "_old"
            shutil.rmtree(aside, ignore_errors=True)
            os.rename(final, aside)
        os.rename(tmp, final)
        _fsync_dir(directory)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
    _metrics.counter("resilience/ckpt_saves").inc()
    _maybe_tear(final)
    return final


def _scan_steps(directory, level="intact"):
    """[(step, path)] newest first, filtered by ``level``: "all" every
    step_N dir; "manifest" those with a manifest (restore candidates: a
    size-torn step is tried so its corruption is counted); "intact"
    manifest present and the file inventory passing the stat check."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        try:
            step = int(name.split("_", 1)[1])
        except ValueError:
            continue
        path = os.path.join(directory, name)
        if level != "all":
            manifest = _read_manifest(path)
            if manifest is None:
                continue
            if level == "intact" and not _files_intact(path, manifest):
                continue
        out.append((step, path))
    out.sort(reverse=True)
    return out


def all_checkpoints(directory):
    """Intact step numbers under ``directory``, ascending."""
    return sorted(step for step, _ in _scan_steps(directory))


def checkpoints_after(directory, step):
    """Intact step numbers strictly newer than ``step`` (None: all),
    ascending: the online updater's poll. A save still in flight has no
    manifest yet, so it is never exported torn."""
    steps = all_checkpoints(directory)
    if step is None:
        return steps
    return [s for s in steps if s > int(step)]


def latest_checkpoint(directory):
    """The newest INTACT step_N path under ``directory``, or None."""
    steps = _scan_steps(directory)
    return steps[0][1] if steps else None


def _restore_step(path, verify=True):
    manifest = _read_manifest(path) if verify else None
    if manifest is not None and not _files_intact(path, manifest):
        raise CheckpointCorruptionError(
            "checkpoint %s payload files do not match the manifest "
            "inventory (truncated/torn write)" % path)
    try:
        doc = torch.load(os.path.join(path, _DATA_SUBDIR, _PAYLOAD),
                         weights_only=True)
        leaves = {k: (v.numpy() if k in doc["numpy"] else v)
                  for k, v in doc["leaves"].items()}
        state = _rebuild(doc["skeleton"], leaves)
    except Exception as exc:  # a torn payload fails to deserialize
        raise CheckpointCorruptionError(
            "checkpoint %s failed to deserialize: %s" % (path, exc))
    if manifest is not None:
        want = manifest.get("digests", {})
        got = dict(_flatten(state))
        if set(want) != set(got):
            raise CheckpointCorruptionError(
                "checkpoint %s leaf inventory mismatch: manifest has %d "
                "leaves, payload has %d" % (path, len(want), len(got)))
        for key, digest in want.items():
            if digest is not None and _leaf_digest(got[key]) != digest:
                raise CheckpointCorruptionError(
                    "checkpoint %s leaf %r failed digest verification "
                    "(torn write or corruption)" % (path, key))
    return state


def _place_like(state, target_state):
    """Restored leaves in ``target_state``'s structure, devices and
    dtypes, matched by key path (renamed or reordered weights fail
    loudly). A leaf whose target lies in pinned host memory (ZeRO's
    offloaded m and v) is restored into pinned memory."""
    got = dict(_flatten(state))
    placed = {}
    for key, t in _flatten(target_state):
        if key not in got:
            raise ValueError("target_state leaf %r not found in checkpoint"
                             % key)
        leaf = got[key]
        if tuple(np.shape(leaf)) != tuple(np.shape(t)):
            raise ValueError("leaf %r shape mismatch: checkpoint %s vs "
                             "target %s" % (key, tuple(np.shape(leaf)),
                                            tuple(np.shape(t))))
        if isinstance(t, torch.Tensor):
            placed[key] = torch.as_tensor(leaf).to(device=t.device,
                                                   dtype=t.dtype)
            if t.is_pinned() and not placed[key].is_pinned():
                placed[key] = placed[key].pin_memory()
        else:
            placed[key] = np.asarray(leaf, dtype=np.asarray(t).dtype)
    if len(placed) != len(got):
        raise ValueError("checkpoint has %d leaves but target_state has %d"
                         % (len(got), len(placed)))
    return _rebuild(_skeleton(target_state), placed)


def restore_checkpoint(directory_or_path, target_state=None, verify=True):
    """Restore a checkpoint with digest verification. With
    ``target_state`` (a state of the expected structure) the leaves are
    placed to match it (device and dtype); without, the state comes back
    as saved.

    ``directory_or_path`` is a step path (one attempt; corruption raises
    ``CheckpointCorruptionError``) or the checkpoint directory: there the
    steps are tried newest first and corrupt ones are skipped with a
    warning and ``resilience/ckpt_corrupt_detected``."""
    path = directory_or_path
    if os.path.basename(os.path.normpath(path)).startswith("step_"):
        state = _restore_step(path, verify=verify)
        return state if target_state is None else _place_like(
            state, target_state)
    candidates = _scan_steps(path, level="manifest")
    if not candidates:
        raise FileNotFoundError("no step_N checkpoints under %r" % path)
    last_exc = None
    for step, step_path in candidates:
        try:
            with _tracing.span("checkpoint/restore", step=step):
                state = _restore_step(step_path, verify=verify)
        except CheckpointCorruptionError as exc:
            last_exc = exc
            _metrics.counter("resilience/ckpt_corrupt_detected").inc()
            warnings.warn("skipping corrupt checkpoint %s: %s"
                          % (step_path, exc), RuntimeWarning)
            continue
        return state if target_state is None else _place_like(
            state, target_state)
    raise CheckpointCorruptionError(
        "every checkpoint under %r is corrupt (last: %s)" % (path, last_exc))


def _host_tree(tree):
    """A private host copy of a state: each leaf through
    ``resilience._host_copy`` (a tensor copied to the CPU, a CPU tensor
    too: the next step's in-place update would change it under the
    write)."""
    from .resilience import _host_copy

    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    return _host_copy(tree)


class CheckpointManager:
    """Rolling checkpoint manager: keeps the newest `max_to_keep` intact
    steps under `directory`.

    `async_save=True` moves the filesystem write to a background thread:
    `save` first copies every leaf to host memory IN THE CALLER (that is
    the consistency point — the next step updates the very tensors being
    saved in place), then returns while the payload + manifest + rename
    run behind. At most one save is in flight; `wait()` (or the next
    `save`) joins it and re-raises any background failure."""

    def __init__(self, directory, max_to_keep=3, async_save=False):
        from .analysis.concurrency import make_lock

        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = bool(async_save)
        # `_mu` guards the background-save handoff fields (`_thread`,
        # `_error`); `_save_mu` serializes whole save() calls (the
        # at-most-one-in-flight contract). The writer thread takes only
        # `_mu`, so holding `_save_mu` across its join cannot deadlock.
        self._mu = make_lock("checkpoint.manager")
        self._save_mu = make_lock("checkpoint.manager.save")
        self._thread = None
        self._error = None
        os.makedirs(self.directory, exist_ok=True)
        self._reap_stale_tmp()

    def _reap_stale_tmp(self):
        """Journal replay for a writer that died mid-publish. A complete
        tmp dir (manifest present) whose step_N is missing finishes its
        crashed rename; an `_old` aside whose step_N is missing is the
        pre-overwrite original and is restored; everything else from a
        crashed writer is dead weight and reclaimed."""
        asides = []
        for name in sorted(os.listdir(self.directory)):
            if not name.startswith(_TMP_PREFIX):
                continue
            path = os.path.join(self.directory, name)
            target = name[len(_TMP_PREFIX):]
            if target.endswith("_old"):
                asides.append((path, target[:-len("_old")]))
                continue
            final = os.path.join(self.directory, target)
            if (target.startswith("step_")
                    and not os.path.isdir(final)
                    and _read_manifest(path) is not None):
                os.rename(path, final)  # finish the crashed publish
            else:
                shutil.rmtree(path, ignore_errors=True)
        for path, target in asides:
            final = os.path.join(self.directory, target)
            if target.startswith("step_") and not os.path.isdir(final):
                os.rename(path, final)  # restore the parked original
            else:
                shutil.rmtree(path, ignore_errors=True)

    def save(self, state, step, blocking=None, host_copied=False):
        """Write one checkpoint and GC old steps. Returns the final path
        (async saves return it while the write is still landing —
        `wait()` before depending on it). `host_copied=True` promises
        `state` is already a private host copy (a resilience
        ScopeSnapshot), skipping the per-leaf copy."""
        with self._save_mu:
            self.wait()
            if blocking is None:
                blocking = not self.async_save
            final = os.path.join(self.directory, "step_%d" % int(step))
            if blocking:
                save_checkpoint(self.directory, state, step)
                self._gc()
                return final
            host_state = state if host_copied else _host_tree(state)

            def _write():
                try:
                    save_checkpoint(self.directory, host_state, step)
                    self._gc()
                except BaseException as exc:  # surfaced by wait()
                    with self._mu:
                        self._error = exc

            t = threading.Thread(target=_write, name="ptpu-ckpt-save",
                                 daemon=True)
            # started BEFORE it is published: a concurrent wait() never
            # joins an unstarted thread
            t.start()
            with self._mu:
                self._thread = t
            return final

    def wait(self):
        """Join the in-flight async save (if any); re-raises a background
        write failure here, in the caller's thread."""
        with self._mu:
            t = self._thread
        if t is not None:
            t.join()
            with self._mu:
                if self._thread is t:
                    self._thread = None
        with self._mu:
            exc, self._error = self._error, None
        if exc is not None:
            raise exc

    def restore(self, target_state=None):
        """Newest-intact-first restore with corruption fallback (see
        `restore_checkpoint`)."""
        self.wait()
        return restore_checkpoint(self.directory, target_state)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        return all_checkpoints(self.directory)

    def _gc(self):
        if not self.max_to_keep:
            return
        # retention is counted over INTACT steps only — a torn step must
        # never push an intact fallback out of the quota. A non-intact
        # dir is reclaimed only once a full quota of NEWER intact steps
        # exists to fall back to instead.
        intact = _scan_steps(self.directory)  # newest first
        keep = {path for _s, path in intact[:self.max_to_keep]}
        intact_paths = {path for _s, path in intact}
        intact_steps = [s for s, _p in intact]
        for step, path in _scan_steps(self.directory, level="all"):
            if path in keep:
                continue
            if path not in intact_paths:
                newer_intact = sum(1 for s in intact_steps if s > step)
                if newer_intact < self.max_to_keep:
                    continue
            shutil.rmtree(path, ignore_errors=True)
