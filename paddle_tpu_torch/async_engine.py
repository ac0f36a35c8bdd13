"""The asynchronous execution pipeline (parity: the JAX package's
``async_engine.py``: `as_numpy` :58, `LazyFetchList` :66,
`InflightWindow` :105-147, `FeedPrefetcher` :209-336, `prefetch_iter`
:405).

CUDA launches are asynchronous: a step returns tensors the card has not
finished yet, and the host stalls only where something forces a copy to
the host. These pieces keep up to N steps in flight:

  LazyFetchList    what ``Executor.run(return_numpy=False)`` returns: the
                   fetches as device tensors; `as_numpy` is the sync point.
  InflightWindow   a bounded count of dispatched, unsynced steps, each a
                   CUDA event recorded on the executor's stream after the
                   step. Admitting a step past the limit first waits for
                   the oldest step's event. On the CPU the events are
                   no-ops and only the count moves.
  FeedPrefetcher   a background thread that stages the next feed: a
                   pinned host copy, then a copy to the card on a side
                   stream, with an event the executor's stream waits on
                   before the step reads the feed. Batches come back in
                   put() order.

  HostStateStager  host-offloaded optimizer state (``parallel/zero.py``):
                   the pinned host buffers of m and v copied to the card
                   on the prefetcher's stream while the backward runs,
                   and copied back after the update.

Telemetry (the JAX package's names): ``exec/inflight_steps`` (the
window's depth at each admit), ``exec/window_drains`` and a
``window_drain`` span around each drain, ``feed/h2d_bytes`` (bytes the
prefetcher copied to the card) and ``feed/prefetch_depth`` (batches
staged ahead). The blocking points (a step's event wait, the prefetcher's
slot and queue waits) are declared to ``analysis.concurrency``, so
``PTPU_LOCK_CHECK=1`` flags a tracked lock held across one.

Not ported: `DeferredWarns` and the persistent compile cache, which
serve the NaN checker and XLA.
"""

import queue as _queue
import threading

import numpy as np
import torch

from .analysis.concurrency import check_blocking
from .observability import metrics as _metrics
from .observability import tracing as _tracing

__all__ = ["LazyFetchList", "InflightWindow", "FeedPrefetcher",
           "HostStateStager", "StagedFeed", "StepEvent", "as_numpy",
           "prefetch_iter"]


def _nbytes(vals):
    """Total bytes of feed or fetch values (a tensor's or an array's
    nbytes: shape metadata, no copy): executor/feed_bytes,
    executor/fetch_bytes and feed/h2d_bytes."""
    total = 0
    for v in vals:
        nb = getattr(v, "nbytes", None)
        if nb is not None:
            total += int(nb)
    return total


def _to_numpy(t):
    """One value as numpy: a tensor is copied to the host (bf16, which
    numpy lacks, as float32); anything else through np.asarray. A CPU
    tensor is copied too: a fetched parameter would otherwise share the
    scope's tensor, which the next run's update ops write in place."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def as_numpy(value):
    """The sync point: fetch values as numpy. Accepts one value, a
    list/tuple of them, or a LazyFetchList."""
    if isinstance(value, (list, tuple)):
        return [_to_numpy(v) for v in value]
    return _to_numpy(value)


class LazyFetchList(list):
    """Fetch results not synced to the host: the device tensors
    themselves. `as_numpy` (or the module function) materializes them."""

    def as_numpy(self):
        return [_to_numpy(v) for v in self]


class StepEvent:
    """The completion token of one dispatched step: a CUDA event recorded
    on the device's current stream (None on the CPU, where the step has
    run by the time run() returns). `keep` holds objects (a staged feed's
    pinned host buffers) that must live until the step is done."""

    __slots__ = ("event", "keep")

    def __init__(self, device, keep=()):
        self.event = None
        self.keep = keep
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def synchronize(self):
        check_blocking("device-sync", "async_engine.step_event")
        if self.event is not None:
            self.event.synchronize()


class InflightWindow:
    """Bounded window of dispatched-but-unsynced steps (backpressure).

    `admit` registers one step's token (a `StepEvent`); when the window
    is full it first blocks on the OLDEST step, so at most `limit` steps
    are ever pending. The ``exec/inflight_steps`` gauge records the depth
    at each dispatch; `peak` is the deepest the window has been."""

    def __init__(self, limit=12):
        self.limit = max(1, int(limit))
        self._pending = []
        self.peak = 0

    @property
    def depth(self):
        return len(self._pending)

    def admit(self, token):
        if token is None:
            return
        while len(self._pending) >= self.limit:
            self._pending.pop(0).synchronize()
        self._pending.append(token)
        self.peak = max(self.peak, len(self._pending))
        _metrics.gauge("exec/inflight_steps").set(len(self._pending))

    def drain(self):
        """Block until every admitted step is done: the sync point behind
        ``Executor.sync()`` (``exec/window_drains``)."""
        if not self._pending:
            return
        _metrics.counter("exec/window_drains").inc()
        with _tracing.span("window_drain", depth=len(self._pending)):
            while self._pending:
                self._pending.pop(0).synchronize()

    def reset(self):
        """Forget admitted steps without blocking, for a caller that just
        synced the newest step (one stream runs in order, so the older
        ones are done)."""
        del self._pending[:]


class StagedFeed:
    """A feed the prefetcher staged: `values` (name -> tensor on the
    device, or a host value it leaves to the executor), the copy's
    `event` on the side stream (None on the CPU) and the pinned host
    buffers the copy reads (`pinned`), kept until the step that reads
    the feed is done."""

    __slots__ = ("values", "event", "pinned")

    def __init__(self, values, event=None, pinned=()):
        self.values = values
        self.event = event
        self.pinned = pinned

    def consume(self, device):
        """The values, ready for the step on `device`'s current stream:
        the stream waits on the copy's event, and each staged tensor is
        marked as used there, so the caching allocator keeps it until
        the step has read it."""
        if self.event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(self.event)
            for t in self.values.values():
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(stream)
        return self.values


class FeedPrefetcher:
    """Background host-to-device double buffer for feed dicts.

    `put(feed)` hands a host batch to the worker thread, which stages
    every numpy value for `device` (a pinned copy, then a copy to the
    card on its own stream) while the card runs the current step. `get()`
    returns `StagedFeed`s strictly in put() order; at most `depth` are
    staged ahead (put() blocks past that). `take_if_match(feed)` returns
    the head staged batch only when it was built from exactly these
    value objects (identity match), so ``Executor.prefetch(feed)``
    followed by ``Executor.run(feed=feed)`` picks up the staged copy.
    `stage_fn(prefetcher, feed)`, when given, stages a feed in place of
    the numpy path (it may copy on the prefetcher's `stream()`)."""

    _CLOSE = object()

    def __init__(self, device, depth=2, stage_fn=None):
        self.device = torch.device(device)
        self._stage_fn = stage_fn
        self._in = _queue.Queue()
        self._out = _queue.Queue()
        self._keys = _queue.Queue()
        self._slots = threading.Semaphore(max(1, int(depth)))
        self._thread = None
        self._closed = False
        self._stream = None

    def _ensure_thread(self):
        if self._thread is None:
            t = threading.Thread(target=self._worker,
                                 name="ptpu-feed-prefetch", daemon=True)
            t.start()
            self._thread = t

    def stream(self):
        """The side stream the copies to the card run on (made on first
        use; None on the CPU)."""
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _stage(self, feed):
        """One feed dict as a StagedFeed. Tensors and 64-bit ints stay
        as given (the executor narrows int64 with its range check);
        other arrays are copied to the device."""
        if self._stage_fn is not None:
            return self._stage_fn(self, feed)
        cuda = self.stream() is not None
        values, pinned = {}, []
        for name, v in feed.items():
            if isinstance(v, torch.Tensor) or np.asarray(v).dtype in (
                    np.dtype(np.int64), np.dtype(np.uint64)):
                values[name] = v
                continue
            host = torch.from_numpy(np.ascontiguousarray(v))
            if not cuda:
                values[name] = host
                continue
            host = host.pin_memory()
            pinned.append(host)
            with torch.cuda.stream(self._stream):
                values[name] = host.to(self.device, non_blocking=True)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(self._stream)
        if _metrics.enabled():
            _metrics.counter("feed/h2d_bytes").inc(_nbytes(pinned))
        return StagedFeed(values, event, tuple(pinned))

    def _worker(self):
        while True:
            item = self._in.get()
            if item is self._CLOSE:
                return
            try:
                result = ("ok", self._stage(item))
            except BaseException as e:  # re-raised on the consumer side
                result = ("error", e)
            self._out.put(result)
            if _metrics.enabled():
                _metrics.gauge("feed/prefetch_depth").set(self._out.qsize())

    def put(self, feed):
        """Queue one host feed dict for background staging. Blocks when
        `depth` batches are already staged ahead."""
        if self._closed:
            raise RuntimeError("FeedPrefetcher is closed")
        self._ensure_thread()
        check_blocking("Semaphore.acquire", "feed_prefetcher.slots")
        self._slots.acquire()
        # strong refs to the source objects: an id() match could misfire
        # once a freed array's address is reused
        self._keys.put(dict(feed))
        self._in.put(dict(feed))

    def get(self):
        """The next StagedFeed, in put() order."""
        check_blocking("queue.get", "feed_prefetcher.out")
        self._keys.get()
        kind, payload = self._out.get()
        self._slots.release()
        if kind == "error":
            raise payload
        return payload

    def take_if_match(self, feed):
        """The head staged batch if it was built from exactly `feed`'s
        value objects; None otherwise (the queue is untouched)."""
        try:
            key = self._keys.queue[0]
        except IndexError:
            return None
        if len(key) != len(feed) or any(
                key.get(k) is not v for k, v in feed.items()):
            return None
        return self.get()

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._in.put(self._CLOSE)
            self._thread.join(timeout=5.0)


class HostStateStager:
    """Host-to-device staging of host-offloaded optimizer state
    (``parallel/zero.py``): m and v live in host buffers between steps
    (pinned on the card); each step stages them onto the device for the
    sharded update and copies the updated shards back.

    The H2D leg rides a FeedPrefetcher: `stage_in_begin` hands the host
    tensors to its worker, which copies them on the prefetcher's side
    stream, and returns at once, so the copy runs WHILE the backward
    dispatched right after it runs; `stage_in_end` collects the device
    tensors where the update needs them, the compute stream waiting on
    the copy's event. `stage_out` copies updated device tensors into the
    host buffers on the compute stream and synchronizes: the step's
    optimizer-state sync point. Both directions count into the `counter`
    metric (zero/offload_bytes). On the CPU the device copies are
    clones."""

    def __init__(self, device, counter="zero/offload_bytes"):
        self.device = torch.device(device)
        self._prefetcher = FeedPrefetcher(self.device,
                                          stage_fn=self._place)
        self._counter = counter
        self._pending_n = None

    def _place(self, prefetcher, feed):
        stream = prefetcher.stream()
        if stream is None:
            return StagedFeed({k: t.clone() for k, t in feed.items()})
        with torch.cuda.stream(stream):
            values = {k: t.to(self.device, non_blocking=True)
                      for k, t in feed.items()}
        event = torch.cuda.Event()
        event.record(stream)
        return StagedFeed(values, event, tuple(feed.values()))

    def stage_in_begin(self, tensors):
        """Queue `tensors` (host tensors) for background placement."""
        if self._pending_n is not None:
            raise RuntimeError("stage_in_begin before the previous "
                               "stage_in_end was collected")
        self._pending_n = len(tensors)
        self._prefetcher.put({str(i): t for i, t in enumerate(tensors)})

    def stage_in_end(self):
        """The staged device tensors, in stage_in_begin order, ready for
        the device's current stream."""
        if self._pending_n is None:
            raise RuntimeError("stage_in_end without stage_in_begin")
        n, self._pending_n = self._pending_n, None
        staged = self._prefetcher.get().consume(self.device)
        vals = [staged[str(i)] for i in range(n)]
        _metrics.counter(self._counter).inc(_nbytes(vals))
        return vals

    def abort(self):
        """Drop a begun but uncollected stage: the recovery of a caller
        whose compute failed between begin and end. The staged batch is
        collected and discarded, so the worker's slot frees and the next
        stage_in_begin starts clean. No-op when nothing is pending."""
        if self._pending_n is None:
            return
        self._pending_n = None
        try:
            staged = self._prefetcher.get()
            if staged.event is not None:
                staged.event.synchronize()
        except Exception:
            pass  # a staging error dies with the aborted step

    def stage_out(self, tensors, hosts):
        """Copy each device tensor of `tensors` into its host buffer of
        `hosts` and wait for the copies: the D2H side. Returns
        `hosts`."""
        for t, h in zip(tensors, hosts):
            h.copy_(t, non_blocking=t.device.type == "cuda")
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        _metrics.counter(self._counter).inc(_nbytes(hosts))
        return hosts

    def close(self):
        self._prefetcher.close()


def prefetch_iter(batches, prefetcher):
    """Drive `batches` (host feed dicts) through a FeedPrefetcher with
    one batch of lookahead: while the consumer runs batch k, the worker
    stages batch k+1. Yields StagedFeeds in source order."""
    in_flight = 0
    for feed in batches:
        prefetcher.put(feed)
        in_flight += 1
        if in_flight >= 2:
            yield prefetcher.get()
            in_flight -= 1
    while in_flight:
        yield prefetcher.get()
        in_flight -= 1
