"""DataFeeder (parity: the JAX package's ``data_feeder.py`` :12-102):
converts a batch of python rows into the executor feed dict, the same
dict the JAX package's feeder gives for the same rows and feed_list.

`DataFeedDesc` is ported as a description only: a dataset reads
recordio shards, and MultiSlot text shards (the desc's purpose) are not
ported yet (ROADMAP.md Queue 1 item 8; ``DatasetBase.set_data_feed_desc``
raises, naming it)."""

import numpy as np

from .framework import convert_dtype, default_main_program

__all__ = ["DataFeeder", "DataFeedDesc"]


def _feed_np_dtype(dtype):
    """The numpy dtype a var's feed is built in; bf16, which numpy lacks,
    as float32 (the executor casts a feed to its var's dtype)."""
    name = convert_dtype(dtype)
    return np.dtype("float32" if name == "bfloat16" else name)


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_names = []
        self.feed_shapes = []
        self.feed_dtypes = []
        self.feed_lod_level = []
        program = program or default_main_program()
        for v in feed_list:
            if isinstance(v, str):
                v = program.global_block().var(v)
            self.feed_names.append(v.name)
            self.feed_shapes.append(v.shape)
            self.feed_dtypes.append(_feed_np_dtype(v.dtype))
            self.feed_lod_level.append(v.lod_level)
        self.place = place

    def feed(self, iterable):
        """iterable: list of rows, each row a tuple matching feed_list."""
        columns = [[] for _ in self.feed_names]
        for row in iterable:
            for i, cell in enumerate(row):
                columns[i].append(np.asarray(cell))
        out = {}
        for name, col, shape, dt, lod in zip(
            self.feed_names, columns, self.feed_shapes, self.feed_dtypes,
            self.feed_lod_level,
        ):
            if lod > 0:
                # ragged: pad to max length
                maxlen = max(c.shape[0] for c in col)
                padded = np.zeros((len(col), maxlen) + col[0].shape[1:], dt)
                for i, c in enumerate(col):
                    padded[i, : c.shape[0]] = c
                out[name] = padded.astype(dt)
            else:
                arr = np.stack(col).astype(dt)
                # honor declared trailing shape (e.g. [-1, 1] labels)
                if shape is not None:
                    want_rank = len(shape)
                    while arr.ndim < want_rank:
                        arr = arr[..., None]
                    if arr.ndim == want_rank:
                        tgt = [d if d != -1 else arr.shape[i]
                               for i, d in enumerate(shape)]
                        if int(np.prod(tgt)) == arr.size:
                            arr = arr.reshape(tgt)
                out[name] = arr
        return out

    def decorate_reader(self, reader, multi_devices, num_places=None,
                        drop_last=True):
        """Wrap a sample-batch reader into one yielding converted feed
        dicts. With
        multi_devices, consecutive mini-batches group per device — the
        data-parallel executor concatenates them into one sharded feed."""
        def _reader():
            if not multi_devices:
                for batch in reader():
                    yield self.feed(batch)
                return
            n = num_places or 1
            group = []
            for batch in reader():
                group.append(self.feed(batch))
                if len(group) == n:
                    yield group
                    group = []
            if group and not drop_last:
                raise ValueError(
                    "trailing %d mini-batch(es) do not fill all %d "
                    "devices; pass drop_last=True" % (len(group), n))
        return _reader

    def feed_parallel(self, iterable, num_places=None):
        """One mini-batch per device, fed in advance. Yields one converted
        feed dict
        per place; the data-parallel executor splits its global batch over
        the mesh, so equal-size per-place batches concatenate to one
        sharded feed."""
        batches = list(iterable)
        if num_places is not None and len(batches) != num_places:
            raise ValueError(
                "feed_parallel needs as many mini-batches as places "
                "(got %d batches for %d places)"
                % (len(batches), num_places))
        return (self.feed(b) for b in batches)


class DataFeedDesc:
    """Declarative feed description (slot names, types, dense-ness,
    batch size), as the JAX package's. A description only in the port:
    no dataset reads MultiSlot shards yet."""

    def __init__(self, proto_file=None):
        self.name = "MultiSlotDataFeed"
        self.batch_size = 1
        self._batch_size_set = False
        self.slots = []  # dicts: name, type, shape, is_dense, is_used
        self._slot_index = {}
        if proto_file is not None:
            self._parse(proto_file)

    def _parse(self, proto_file):
        import re
        with open(proto_file) as f:
            text = f.read()
        for m in re.finditer(
                r"slots\s*\{([^}]*)\}", text):
            body = m.group(1)
            get = lambda k, d=None: (re.search(k + r':\s*"?([\w.]+)"?', body)
                                     or [None, d])[1]
            self.add_slot(get("name", ""), get("type", "float"),
                          is_dense=get("is_dense", "false") == "true")
        bs = re.search(r"batch_size:\s*(\d+)", text)
        if bs:
            self.batch_size = int(bs.group(1))
            self._batch_size_set = True

    def add_slot(self, name, dtype="float", shape=None, is_dense=False,
                 pad_value=0):
        self._slot_index[name] = len(self.slots)
        self.slots.append({"name": name, "type": dtype,
                           "shape": list(shape or []),
                           "is_dense": is_dense, "is_used": True,
                           "pad_value": pad_value})
        return self

    def set_batch_size(self, batch_size):
        self.batch_size = batch_size
        self._batch_size_set = True

    def set_dense_slots(self, dense_slots_name):
        for n in dense_slots_name:
            self.slots[self._slot_index[n]]["is_dense"] = True

    def set_hash_mod(self, hash_mods):
        """Per-slot host-side id folding, `{slot_name: mod}`: raw uint64
        feature hashes reduced `id % mod` on the host while parsing, so
        no 64-bit id reaches the device. `mod` is normally the embedding
        table's num_rows."""
        for n, v in hash_mods.items():
            self.slots[self._slot_index[n]]["hash_mod"] = int(v)

    def set_pad_value(self, pad_values):
        """Per-slot batch pad value, `{slot_name: value}`. Ragged id slots
        batch padded-dense; padding with the embedding's declared
        padding_idx keeps pad rows out of sum-pooled lookups (the
        reference's LoD batching has no pad contributions at all)."""
        for n, v in pad_values.items():
            self.slots[self._slot_index[n]]["pad_value"] = v

    def set_use_slots(self, use_slots_name):
        for s in self.slots:
            s["is_used"] = False
        for n in use_slots_name:
            self.slots[self._slot_index[n]]["is_used"] = True

    def desc(self):
        lines = ["name: \"%s\"" % self.name,
                 "batch_size: %d" % self.batch_size]
        for s in self.slots:
            lines.append(
                "slots {\n  name: \"%s\"\n  type: \"%s\"\n  is_dense: %s\n"
                "  is_used: %s\n}" % (s["name"], s["type"],
                                      str(s["is_dense"]).lower(),
                                      str(s["is_used"]).lower()))
        return "\n".join(lines)
