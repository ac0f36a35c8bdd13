"""Composable reader decorators (parity: the JAX package's
``reader/__init__.py`` :47-232 — map_readers, shuffle, chain, compose,
buffered, firstn, cache, xmap_readers, multiprocess_reader, batch — and
``reader/creator.py``).

A "reader" is a nullary callable returning an iterator of samples.

Not ported yet (ROADMAP.md Queue 1 item 8): `PyReader` and `PipeReader`
(they raise, naming the item), with ``layers/io.py``'s ``py_reader`` and
``double_buffer``.
"""

import itertools
import queue as _queue
import random as _random
import threading

__all__ = ["map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "cache", "batch", "PyReader",
           "multiprocess_reader", "PipeReader", "creator"]

from . import creator  # noqa: F401,E402


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            _random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    def reader():
        rs = [r() for r in readers]
        for e in itertools.chain(*rs):
            yield e

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            sentinel = object()
            import itertools

            for outputs in itertools.zip_longest(*rs, fillvalue=sentinel):
                if sentinel in outputs:
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned — one reader "
                        "ended before the others")
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    """Background-thread prefetch buffer."""

    class EndSignal:
        pass

    end = EndSignal()

    def read_worker(r, q):
        for d in r:
            q.put(d)
        q.put(end)

    def data_reader():
        r = reader()
        q = _queue.Queue(maxsize=size)
        t = threading.Thread(target=read_worker, args=(r, q),
                             name="ptpu-reader-buffered")
        t.daemon = True
        t.start()
        e = q.get()
        while not isinstance(e, EndSignal):
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return data_reader


def cache(reader):
    all_data = tuple(reader())

    def data_reader():
        for d in all_data:
            yield d

    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads."""
    end = object()
    in_q = _queue.Queue(buffer_size)
    out_q = _queue.Queue(buffer_size)

    def data_reader():
        from ..analysis.concurrency import make_lock

        finished = [0]
        lock = make_lock("reader.xmap_finished")

        def read_worker():
            for d in reader():
                in_q.put(d)
            for _ in range(process_num):
                in_q.put(end)

        def map_worker():
            while True:
                d = in_q.get()
                if d is end:
                    break
                out_q.put(mapper(d))
            with lock:
                finished[0] += 1
                if finished[0] == process_num:
                    out_q.put(end)

        t = threading.Thread(target=read_worker, name="ptpu-xmap-read")
        t.daemon = True
        t.start()
        workers = []
        for i in range(process_num):
            w = threading.Thread(target=map_worker,
                                 name="ptpu-xmap-map-%d" % i)
            w.daemon = True
            w.start()
            workers.append(w)
        while True:
            d = out_q.get()
            if d is end:
                break
            yield d

    return data_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Fan-in of several readers, one after the other (the JAX
    package's thread-based stand-in for the reference's fork+pipe)."""
    return chain(*readers)


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of batch_size (``fluid.batch``)."""

    def batch_reader():
        r = reader()
        b = []
        for instance in r:
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


_NOT_PORTED = ("is not ported yet: ROADMAP.md Queue 1 item 8 (PyReader, "
               "PipeReader, layers/io.py py_reader and double_buffer)")


class PyReader:
    """The feed-pipeline object of the JAX package's
    ``reader/__init__.py`` :234. Not ported yet: constructing one raises,
    naming the ROADMAP item."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("PyReader " + _NOT_PORTED)


class PipeReader:
    """The JAX package's ``reader/__init__.py`` :463 (records from a
    shell command's stdout). Not ported yet: constructing one raises,
    naming the ROADMAP item."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("PipeReader " + _NOT_PORTED)
