"""Crash-safe flight recorder: the fleet's black box (the port of the JAX
package's ``observability/flight_recorder.py``).

A bounded ring of structured events fed by the failure-handling layers
(``resilience.py``, ``serving/engine.py``, ``serving/router.py``,
``serving/online.py``): replica health transitions healthy -> suspect ->
dead, fault-injector firings, re-admissions, weight swaps, rollbacks.
On a fatal condition (worker death, a dead replica, a spent retry
budget) the ring is dumped atomically (tmp file + rename) into
``PTPU_BLACKBOX_DIR``, so a failure leaves its own post-mortem even when
the process dies before exit.

OFF unless ``PTPU_BLACKBOX_DIR`` is set (or ``enable()`` is called):
then ``record_event()`` is one bool check and the ring is never
allocated. One leaf lock guards the ring (the named lock site
``obs.blackbox``, tracked under ``PTPU_LOCK_CHECK=1``); callers may hold
their own locks while recording, so every order edge points into it,
and ``dump()`` touches only the ring lock and the filesystem: it is safe
on failure paths, ``concurrency.assert_clean``'s included (a
``lock_check_failed`` dump before the raise).
"""

import atexit
import collections
import itertools
import json
import os
import threading
import time

from .. import flags as _flags
from ..analysis.concurrency import make_lock

__all__ = ["enabled", "enable", "disable", "record_event", "events",
           "dump", "dropped", "reset"]

_TMP_PREFIX = ".ptpu_tmp_"  # the checkpoint writer's atomic-rename prefix

DEFAULT_CAPACITY = 4096

_ENABLED = False
_DIR = None
_events = None  # deque, allocated on first enable
_dropped = 0
_lock = threading.Lock()  # replaced by the named lock site on enable
_dump_seq = itertools.count(1)


def enabled():
    return _ENABLED


def enable(directory=None, capacity=None):
    """Turn the recorder on. ``directory`` is where dumps land; None
    keeps the previous one (events still ring-buffer without a
    directory; ``dump()`` then returns None)."""
    global _ENABLED, _DIR, _events, _lock
    if capacity is None:
        capacity = _events.maxlen if _events is not None else \
            DEFAULT_CAPACITY
    if directory is not None:
        _DIR = directory
    if _events is None or _events.maxlen != capacity:
        _events = collections.deque(maxlen=capacity)
        _lock = make_lock("obs.blackbox")
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False


def record_event(etype, **fields):
    """Append one structured event to the ring; one bool check when the
    recorder is off."""
    if not _ENABLED:
        return
    ev = dict(fields)
    ev["ts"] = time.time()
    ev["type"] = etype
    ev["thread"] = threading.current_thread().name
    global _dropped
    with _lock:
        if len(_events) == _events.maxlen:
            _dropped += 1  # deque evicts the oldest on append
        _events.append(ev)


def events():
    """Snapshot of the ring (oldest first)."""
    if _events is None:
        return []
    with _lock:
        return list(_events)


def dropped():
    return _dropped


def reset():
    global _dropped
    if _events is not None:
        with _lock:
            _events.clear()
            _dropped = 0


def dump(reason):
    """Atomically write the ring to ``PTPU_BLACKBOX_DIR`` as
    ptpu_blackbox_<pid>_<seq>_<reason>.json (tmp file + rename: a crash
    mid-write leaves only a .ptpu_tmp_ file). Returns the path, or None
    when disabled, without a directory, or when the write fails (dump
    runs on failure paths and must never mask the original error)."""
    if not _ENABLED or not _DIR:
        return None
    with _lock:
        evs = list(_events)
        n_dropped = _dropped
    doc = {"reason": reason, "pid": os.getpid(), "time": time.time(),
           "dropped_events": n_dropped, "events": evs}
    name = "ptpu_blackbox_%d_%03d_%s.json" % (
        os.getpid(), next(_dump_seq), reason)
    tmp = os.path.join(_DIR, _TMP_PREFIX + name)
    try:
        os.makedirs(_DIR, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(_DIR, name)
        os.rename(tmp, final)
    except (OSError, TypeError, ValueError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return final


def _flag_init():
    bdir = _flags.env("PTPU_BLACKBOX_DIR")
    if bdir:
        cap = _flags.env("PTPU_BLACKBOX_EVENTS")
        enable(str(bdir), int(cap) if cap else None)
        # a final dump at a clean exit, so the artifact exists even when
        # no fatal trigger fired
        atexit.register(dump, "exit")


_flag_init()
