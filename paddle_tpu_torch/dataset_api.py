"""Dataset classes + factory (parity: the JAX package's
``dataset_api.py`` :24-588: `DatasetBase`, `QueueDataset`,
`InMemoryDataset`, `DatasetFactory`).

File lists hold recordio shards (``core/native.py``), read through the
fault-tolerant data plane (``data_plane.py``). `set_thread(N)` parses
shards on a pool of N reader threads while the executor owns the card;
emission stays in filelist order (the JAX package's default,
FLAGS_cpu_deterministic), so a threaded stream is bitwise the serial
one. `Executor.train_from_dataset` drives a dataset; `resumable_batches`
is the checkpoint-resumable stream behind a `data_plane.DatasetCursor`.

Not ported yet: MultiSlot text shards (`set_data_feed_desc` raises,
naming ROADMAP.md Queue 1 item 8) and the multi-worker exchange of
`global_shuffle` (with a fleet it raises, naming item 9).
"""

import random

import numpy as np

__all__ = ["DatasetFactory", "InMemoryDataset", "QueueDataset"]


class DatasetBase:
    def __init__(self):
        self._filelist = []
        self._batch_size = 1
        self._use_var = []
        self._thread = 1

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_data_feed_desc(self, desc):
        """Read the filelist as MultiSlot text files described by a
        DataFeedDesc. Not ported yet: raises."""
        raise NotImplementedError(
            "MultiSlot shards (DataFeedDesc parsing, parse_multislot_*) are "
            "not ported yet: ROADMAP.md Queue 1 item 8; write the samples "
            "as recordio shards (convert_reader_to_recordio_file)")

    def set_batch_size(self, batch_size):
        self._batch_size = batch_size

    def set_thread(self, thread_num):
        self._thread = thread_num

    def set_use_var(self, var_list):
        self._use_var = list(var_list)

    def _file_samples(self, path, shard_index=0):
        """Parse ONE shard file into its sample list — the unit of work a
        reader thread owns. Recordio shards read through the
        fault-tolerant data plane: CRC/framing/truncation damage routes
        through `PTPU_DATA_ANOMALY_POLICY` instead of raising mid-epoch,
        and `shard_index` keys the `data_corrupt_shard`/
        `data_stall_shard` injector sites. Healthy shards yield the
        scanner's stream."""
        from . import data_plane

        reader = data_plane.resilient_sample_reader(
            [path], shard_indices=[shard_index])
        return list(reader())

    def _sample_reader(self):
        def reader():
            for i, path in enumerate(self._filelist):
                yield from self._file_samples(path, shard_index=i)

        return reader

    def _pool_map_items(self, fn, items, ordered):
        """The ONE windowed thread-pool shape every shard-parse path
        shares: worker threads parse on the host while the step owns
        the device. Submission is WINDOWED — at most n_workers+2 items
        outstanding — so a streaming dataset never buffers the whole
        filelist in RAM. `ordered` emits results in item order (bitwise
        the serial run); off = completion order for max overlap."""
        from concurrent.futures import (FIRST_COMPLETED,
                                        ThreadPoolExecutor, wait)

        n = max(1, min(self._thread, len(items)))
        if n == 1:
            for item in items:
                yield fn(item)
            return
        window = n + 2
        with ThreadPoolExecutor(max_workers=n) as ex:
            it = iter(items)
            pending = []
            for item in it:
                pending.append(ex.submit(fn, item))
                if len(pending) >= window:
                    break
            while pending:
                if ordered:
                    done = pending.pop(0)  # item order
                else:
                    wait(pending, return_when=FIRST_COMPLETED)
                    done = next(f for f in pending if f.done())
                    pending.remove(done)
                result = done.result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(ex.submit(fn, nxt))
                yield result

    def _pool_map(self, fn):
        """Thread-pool over file shards, emitting in filelist order so
        losses reproduce the serial run exactly."""
        yield from self._pool_map_items(
            lambda item: fn(item[1], item[0]),
            list(enumerate(self._filelist)), ordered=True)

    def _iter_samples_threaded(self):
        for samples in self._pool_map(self._file_samples):
            yield from samples

    def _batches_prefetched(self, depth=4, source=None):
        """Producer-thread batch prefetch: host parsing/batching overlaps
        the device step. `source` overrides the generator being
        prefetched (the resumable
        path prefetches `(batch, cursor-state)` PAIRS through the same
        queue so cursor application stays on the consumer side)."""
        import queue
        import threading

        if source is None:
            source = self._batches()
        q = queue.Queue(maxsize=depth)
        sentinel = object()
        stop = threading.Event()
        err = []

        def produce():
            try:
                for b in source:
                    # bounded put that notices an abandoned consumer, so
                    # a mid-epoch exception in the training loop doesn't
                    # leave this thread blocked forever holding batches
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:
                err.append(e)
            finally:
                # the sentinel must LAND (a dropped one strands the
                # consumer on q.get forever); keep trying unless the
                # consumer already abandoned us
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=produce, daemon=True,
                             name="ptpu-dataset-prefetch")
        t.start()
        try:
            while True:
                b = q.get()
                if b is sentinel:
                    break
                yield b
        finally:
            stop.set()
            t.join(timeout=10)
        if err:
            raise err[0]

    def _batches(self):
        feed_names = [v.name for v in self._use_var]
        batch = []
        for sample in self._iter_samples():
            batch.append(sample)
            if len(batch) == self._batch_size:
                yield self._to_feed(feed_names, batch)
                batch = []
        if batch:
            yield self._to_feed(feed_names, batch)

    @staticmethod
    def _to_feed(feed_names, batch):
        cols = list(zip(*batch))
        feed = {}
        for name, col in zip(feed_names, cols):
            arrs = [np.asarray(c) for c in col]
            # variable-length 1-D slots batch padded-dense: zeros to the
            # batch max
            if (arrs[0].ndim == 1
                    and len({a.shape[0] for a in arrs}) > 1):
                maxlen = max(a.shape[0] for a in arrs)
                arrs = [np.pad(a, (0, maxlen - a.shape[0]))
                        for a in arrs]
            stacked = np.stack(arrs)
            if stacked.ndim == 1:  # scalar fields batch to [N, 1] (labels)
                stacked = stacked.reshape(-1, 1)
            feed[name] = stacked
        return feed

    def _iter_samples(self):
        raise NotImplementedError

    # -- mid-epoch resumable ingestion --------------------------------------
    def _shard_samples_seq(self, order, start_si):
        """Yield `(si, samples)` for `order[start_si:]` IN ORDER; with
        `set_thread(N)` the shard parses overlap on the shared
        `_pool_map_items` window, FORCE-ordered — the resumable
        stream's order is part of the cursor contract, so results are
        consumed strictly in shard order and the output is bitwise the
        serial parse's."""
        def parse(si):
            real = order[si]
            return si, self._file_samples(self._filelist[real],
                                          shard_index=real)

        yield from self._pool_map_items(parse,
                                        range(start_si, len(order)),
                                        ordered=True)

    def _resumable_pairs(self, start, epochs):
        """Producer for the resumable stream: yields
        `(feed_dict, (epoch, shard_idx, record_offset))` where the
        position names the first record NOT in any batch yielded so
        far. Shard order per epoch comes from the cursor's seed
        (`data_plane.shard_order`); within an epoch batches cross
        shard boundaries exactly like the legacy `_batches` stream, so
        a fresh cursor with no seed reproduces it bitwise — but a
        partial tail batch FLUSHES at each epoch end (matching legacy
        per-epoch iteration); batches never span epochs."""
        feed_names = [v.name for v in self._use_var]
        bs = self._batch_size
        epoch = start.epoch
        shard_idx = start.shard_idx
        offset = start.record_offset
        while epochs is None or epoch < epochs:
            order = start.shard_order(len(self._filelist), epoch=epoch)
            batch = []
            for si, samples in self._shard_samples_seq(order, shard_idx):
                consumed = offset
                for sample in samples[offset:]:
                    batch.append(sample)
                    consumed += 1
                    if len(batch) == bs:
                        # normalize a batch ending exactly on the
                        # epoch's last record to the next epoch's start
                        pos = ((epoch + 1, 0, 0)
                               if (si == len(order) - 1
                                   and consumed == len(samples))
                               else (epoch, si, consumed))
                        yield self._to_feed(feed_names, batch), pos
                        batch = []
                offset = 0
            if batch:
                # epoch tail (the legacy partial batch): the next
                # position is the following epoch's first record
                yield self._to_feed(feed_names, batch), (epoch + 1, 0, 0)
            epoch += 1
            shard_idx = 0

    def _resumable_stream(self, cursor, epochs, prefetch):
        """The raw `(feed, position)` pair stream behind
        `resumable_batches` (host prefetch applied, cursor NOT yet
        attached) — for consumers like `Executor.train_from_dataset`
        whose device-side lookahead pulls batches ahead of their steps:
        they must apply each pair's position at the true consumption
        point themselves, or the mirrored cursor runs a batch ahead."""
        from .observability import metrics as obs_metrics

        if cursor.position() != (0, 0, 0):
            obs_metrics.counter("data/cursor_resumes").inc()
        if prefetch is None:
            prefetch = self._thread > 1
        pairs = self._resumable_pairs(cursor.clone(), epochs)
        if prefetch:
            pairs = self._batches_prefetched(source=pairs)
        return pairs

    def resumable_batches(self, cursor, epochs=None, scope=None,
                          prefetch=None):
        """The checkpoint-resumable batch stream: starts at `cursor`'s
        position and ADVANCES the cursor as each batch is consumed —
        never as it is prefetched — so a scope snapshot/checkpoint taken
        between batches names exactly the first unconsumed record, and
        a restored run resumes the byte-identical stream. `scope`
        mirrors the cursor into ``__data_cursor__`` on every
        consumption (this is how the cursor rides a checkpoint with no
        format change). `epochs` is the ABSOLUTE epoch bound of the
        stream; default = one pass from the cursor's CURRENT epoch, so a
        restored epoch-k cursor resumes the rest of epoch k instead of
        silently yielding nothing against a stale absolute bound. A
        fresh cursor (seed None) yields bitwise the legacy
        `_batches()` stream."""
        from . import data_plane

        if epochs is None:
            epochs = cursor.epoch + 1
        pairs = self._resumable_stream(cursor, epochs, prefetch)
        return data_plane.apply_cursor(pairs, cursor, scope)


class QueueDataset(DatasetBase):
    """Streaming dataset: shards are read on the fly (no in-memory
    shuffle); `set_thread(N)` parses shards on N reader threads."""

    def _iter_samples(self):
        if self._thread > 1 and len(self._filelist) > 1:
            return self._iter_samples_threaded()
        return self._sample_reader()()


class InMemoryDataset(DatasetBase):
    """load_into_memory + local/global shuffle."""

    def __init__(self):
        super().__init__()
        self._samples = None
        self._rank = 0
        self._world = 1

    def load_into_memory(self):
        if self._thread > 1 and len(self._filelist) > 1:
            self._samples = list(self._iter_samples_threaded())
        else:
            self._samples = list(self._sample_reader()())

    def local_shuffle(self, seed=None):
        if self._samples is None:
            raise RuntimeError("call load_into_memory first")
        random.Random(seed).shuffle(self._samples)

    def global_shuffle(self, fleet=None, seed=0):
        """Cross-worker sample redistribution. Single-process (no fleet,
        or a world of one): a seeded full shuffle, the JAX package's
        single-process path. The multi-worker exchange is not ported
        yet: with a fleet of more than one worker this raises, naming
        ROADMAP.md Queue 1 item 9."""
        if self._samples is None:
            raise RuntimeError("call load_into_memory first")
        if fleet is not None:
            self._rank = fleet.worker_index()
            self._world = fleet.worker_num()
        if self._world > 1:
            raise NotImplementedError(
                "global_shuffle across %d workers (the sample exchange of "
                "distributed_runtime) is not ported yet: ROADMAP.md Queue 1 "
                "item 9" % self._world)
        rng = random.Random(seed)
        order = list(range(len(self._samples)))
        rng.shuffle(order)
        self._samples = [self._samples[i] for i in order]

    def release_memory(self):
        self._samples = None

    def _iter_samples(self):
        if self._samples is None:
            raise RuntimeError("call load_into_memory first")
        return iter(self._samples)

    def _resumable_stream(self, cursor, epochs, prefetch):
        """Not supported: the `DatasetCursor` names a position in the
        deterministic ON-DISK shard order, but an InMemoryDataset
        trains from its loaded — usually shuffled — sample list.
        Re-reading the files here would silently resume a DIFFERENT
        stream than the one trained on, so this raises instead
        (covering both `resumable_batches` and
        `Executor.train_from_dataset(cursor=)`, which drive the same
        stream). Use a QueueDataset for mid-epoch resumable ingestion."""
        raise NotImplementedError(
            "InMemoryDataset does not support resumable batch streams: "
            "a DatasetCursor positions the on-disk shard stream, not a "
            "shuffled in-memory sample list. Use a QueueDataset for "
            "resumable ingestion.")


class DatasetFactory:
    """Creates a dataset by class name."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError("unknown dataset class %r" % datafeed_class)
