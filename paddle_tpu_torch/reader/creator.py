"""Simple reader creators (parity: the JAX package's
``reader/creator.py``: np_array, text_file, recordio)."""

__all__ = ["np_array", "text_file", "recordio"]


def np_array(x):
    """Reader over the rows (highest-dimension slices) of a numpy array."""

    def reader():
        if x.ndim < 1:
            yield x
            return
        for e in x:
            yield e

    return reader


def text_file(path):
    """Reader yielding the file's lines with the trailing newline
    stripped."""

    def reader():
        with open(path, "r") as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100):
    """Reader over recordio shard file(s): deserialized samples, in the
    encoding of ``recordio_writer.py``."""
    from ..recordio_writer import recordio_reader_creator

    if isinstance(paths, str):
        paths = paths.split(",")
    return recordio_reader_creator(list(paths))
