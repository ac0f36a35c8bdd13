"""Named lock sites of the runtime. Each factory returns a plain
`threading` primitive; the name documents the site (the lock-order
detector of the JAX package is not ported yet)."""

import threading

__all__ = ["make_condition", "make_lock", "make_rlock"]


def make_lock(name):
    """A mutex for the lock site ``name``."""
    return threading.Lock()


def make_rlock(name):
    """A reentrant mutex for the lock site ``name``."""
    return threading.RLock()


def make_condition(name, lock=None):
    """A condition variable for the lock site ``name``."""
    return threading.Condition(lock)
