"""Runtime analysis of the PyTorch port: ``concurrency`` (the tracked
lock factories, the lock-order detector and the invariant hooks)."""
