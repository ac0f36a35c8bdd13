"""The port's data plane (``data_plane.py``) and datasets
(``dataset_api.py``) against the JAX package's, on shards the JAX
package wrote:

  * streams: ``_batches``, ``_batches_prefetched`` and
    ``resumable_batches`` (seed 3, 2 epochs, 1 and 2 threads) equal
    JAX's batch for batch, with their cursor positions; a stream resumed
    from a cursor at 0, mid-shard, at a shard boundary and at an epoch
    boundary continues bitwise; ``shard_order`` and
    ``DatasetCursor.to_array`` equal JAX's;
  * damage: for each policy (skip_record, quarantine_shard, abort) on
    the same damage — a CRC flip, a torn tail, a fragment shorter than
    the magic, a framing overrun, an undecodable payload, a damaged
    snappy reference-format chunk — the same records, the same
    ``data/*`` counters and the same ``DataAnomalyError`` fields;
  * the injector sites ``data_corrupt_shard`` and ``data_stall_shard``;
  * ``InMemoryDataset``'s load, local and global shuffle equal JAX's;
    the unported paths raise naming their ROADMAP.md item."""

import struct
import threading
import time
import warnings
import zlib

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import data_plane as jdp
from paddle_tpu import resilience as jres
from paddle_tpu.core import native as jnative
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch import data_plane as pdp
from paddle_tpu_torch import resilience as pres
from paddle_tpu_torch.core import native as pnative
from paddle_tpu_torch.observability import metrics as pmetrics

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(jnative.lib() is None,
                                reason="no native lib for the JAX RecordIO")

_COUNTERS = ("data/records_corrupt", "data/records_skipped",
             "data/shards_quarantined", "data/cursor_resumes")


class _Var:
    def __init__(self, name):
        self.name = name


@pytest.fixture(autouse=True)
def _clean_state():
    """No injector armed, empty quarantine registries and both metrics
    registries on, in both packages; restored after."""
    prev = (jres.set_global_injector(jres.FaultInjector("")),
            pres.set_global_injector(pres.FaultInjector("")))
    was = (jmetrics.enabled(), pmetrics.enabled())
    jmetrics.enable()
    pmetrics.enable()
    jdp.reset_quarantine()
    pdp.reset_quarantine()
    yield
    jres.set_global_injector(prev[0])
    pres.set_global_injector(prev[1])
    jdp.reset_quarantine()
    pdp.reset_quarantine()
    if not was[0]:
        jmetrics.disable()
    if not was[1]:
        pmetrics.disable()


def _counts():
    return ({n: jmetrics.registry().counter(n).value for n in _COUNTERS},
            {n: pmetrics.registry().counter(n).value for n in _COUNTERS})


def _deltas(before, after):
    return [{n: a[n] - b[n] for n in _COUNTERS}
            for b, a in zip(before, after)]


def _write_shard(path, n, tag=0, width=4, **writer_kw):
    def gen():
        for j in range(n):
            yield (np.full((width,), tag * 1000 + j, np.float32),
                   np.int64(tag * 1000 + j))
    return jf.convert_reader_to_recordio_file(path, gen, **writer_kw)


def _write_shards(tmp_path, sizes, **writer_kw):
    paths = []
    for i, n in enumerate(sizes):
        p = str(tmp_path / ("shard%02d.rec" % i))
        _write_shard(p, n, tag=i, **writer_kw)
        paths.append(p)
    return paths


def _ds(mod, paths, bs=4, thread=1, kind="QueueDataset"):
    ds = mod.DatasetFactory().create_dataset(kind)
    ds.set_filelist(paths)
    ds.set_batch_size(bs)
    ds.set_use_var([_Var("x"), _Var("y")])
    ds.set_thread(thread)
    return ds


def _assert_feeds_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def _flip_byte(path, offset):
    raw = bytearray(open(path, "rb").read())
    raw[offset] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))


def _chunk0_payload_len(path):
    with open(path, "rb") as f:
        _magic, _num, rawlen = struct.unpack("<IIQ", f.read(16))
    return rawlen


# ---------------------------------------------------------------------------
# the reference's snappy chunks (shared with test_torch_recordio.py)
# ---------------------------------------------------------------------------


def _masked_crc32c(piece):
    crc = pnative._crc32c(piece)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF)
            + 0xA282EAD8) & 0xFFFFFFFF


def _snappy_framed(pieces, compressed=()):
    """A snappy framing-format stream: the stream id, then one data chunk
    a piece — snappy-encoded (a varint length and one literal element)
    for indices in `compressed`, uncompressed otherwise."""
    out = bytearray(b"\xff\x06\x00\x00sNaPpY")
    for i, piece in enumerate(pieces):
        if i in compressed:
            body = (bytes([len(piece)])
                    + bytes([(len(piece) - 1) << 2]) + piece)
            ftype = 0x00
        else:
            body = bytes(piece)
            ftype = 0x01
        chunk = struct.pack("<I", _masked_crc32c(piece)) + body
        out += bytes([ftype]) + len(chunk).to_bytes(3, "little") + chunk
    return bytes(out)


def _write_reference_snappy_shard(path, records, stored=None):
    payload = b"".join(struct.pack("<I", len(r)) + r for r in records)
    if stored is None:
        half = (len(records) // 2) * (4 + len(records[0]))
        stored = _snappy_framed([payload[:half], payload[half:]],
                                compressed={0})
    with open(path, "wb") as f:
        f.write(struct.pack("<IIIII", 0x01020304, len(records),
                            zlib.crc32(stored) & 0xFFFFFFFF, 1,
                            len(stored)))
        f.write(stored)
    return stored


def test_crc32c_and_snappy_equal_jax():
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 300):
        buf = rng.bytes(n)
        assert pnative._crc32c(buf) == jdp._crc32c(buf)
    blk = (b"\x08" + bytes([(4 - 1) << 2]) + b"abcd"
           + bytes([((4 - 1) << 2) | 2]) + struct.pack("<H", 4))
    assert pnative._snappy_block_uncompress(blk) == b"abcdabcd" == \
        jdp._snappy_block_uncompress(blk)
    for bad in (blk[:-1], b"\x80" * 6, b"\x04\x0c", blk + b"\x00"):
        assert pnative._snappy_block_uncompress(bad) == \
            jdp._snappy_block_uncompress(bad)
    framed = _snappy_framed([b"hello", b"world!"], compressed={0})
    assert pnative._snappy_framed_uncompress(framed) == b"helloworld!" == \
        jdp._snappy_framed_uncompress(framed)


# ---------------------------------------------------------------------------
# streams and cursors
# ---------------------------------------------------------------------------


def test_shard_order_and_cursor_encoding_equal_jax():
    for n, seed, epoch in ((5, None, 0), (8, 7, 0), (8, 7, 1), (4, 3, 1),
                           (13, -5, 9)):
        assert pdp.shard_order(n, seed, epoch) == \
            jdp.shard_order(n, seed, epoch)
    for kw in ({}, dict(epoch=2, shard_idx=3, record_offset=41, seed=-5),
               dict(seed=3)):
        np.testing.assert_array_equal(pdp.DatasetCursor(**kw).to_array(),
                                      jdp.DatasetCursor(**kw).to_array())
    c = pdp.DatasetCursor.from_array(
        jdp.DatasetCursor(epoch=1, shard_idx=2, record_offset=7,
                          seed=3).to_array())
    assert c.position() == (1, 2, 7) and c.seed == 3
    sc = pf.Scope()
    assert pdp.DatasetCursor.from_scope(sc) is None
    c.write_to(sc)
    assert pdp.DatasetCursor.from_scope(sc).position() == (1, 2, 7)
    with pytest.raises(ValueError):
        pdp.DatasetCursor.from_array(np.zeros(6, np.int64))


@pytest.mark.parametrize("thread", [1, 2])
def test_streams_equal_jax(tmp_path, thread):
    paths = _write_shards(tmp_path, [17, 18, 19, 6],
                          compressor="deflate", max_num_records=5)
    _assert_feeds_equal(list(_ds(pf, paths, thread=thread)._batches()),
                        list(_ds(jf, paths, thread=thread)._batches()))
    _assert_feeds_equal(
        list(_ds(pf, paths, thread=thread)._batches_prefetched()),
        list(_ds(jf, paths, thread=thread)._batches_prefetched()))
    got = list(_ds(pf, paths, thread=thread)._resumable_stream(
        pdp.DatasetCursor(seed=3), 2, None))
    want = list(_ds(jf, paths, thread=thread)._resumable_stream(
        jdp.DatasetCursor(seed=3), 2, None))
    assert [s for _, s in got] == [s for _, s in want]
    _assert_feeds_equal([f for f, _ in got], [f for f, _ in want])
    pc, jc = pdp.DatasetCursor(seed=3), jdp.DatasetCursor(seed=3)
    psc, jsc = pf.Scope(), jf.Scope()
    pit = _ds(pf, paths, thread=thread).resumable_batches(pc, epochs=2,
                                                          scope=psc)
    jit = _ds(jf, paths, thread=thread).resumable_batches(jc, epochs=2,
                                                          scope=jsc)
    for a, b in zip(pit, jit):
        _assert_feeds_equal([a], [b])
        assert pc.position() == jc.position()
        np.testing.assert_array_equal(psc.get("__data_cursor__"),
                                      np.asarray(jsc.get(
                                          "__data_cursor__")))
    assert pc.position() == (2, 0, 0)


def test_resume_positions_continue_bitwise(tmp_path):
    """Resumed at 0, mid-shard, at a shard boundary and at an epoch
    boundary, the port's stream continues as its own full stream and as
    JAX's resumed one."""
    sizes = [8, 12, 16, 6]
    paths = _write_shards(tmp_path, sizes)
    full = list(_ds(pf, paths)._resumable_stream(pdp.DatasetCursor(seed=3),
                                                 2, False))
    states = [(0, 0, 0)] + [s for _, s in full]
    first = sizes[pdp.shard_order(4, 3, 0)[0]]
    # (position to resume at, the state in the full stream it equals)
    cases = {"start": ((0, 0, 0), (0, 0, 0)),
             "mid_shard": ((0, 0, 4), (0, 0, 4)),
             "shard_boundary": ((0, 1, 0), (0, 0, first)),
             "epoch_boundary": ((1, 0, 0), (1, 0, 0))}
    for name, (pos, same) in cases.items():
        got = list(_ds(pf, paths)._resumable_stream(
            pdp.DatasetCursor(*pos, seed=3), 2, False))
        want = list(_ds(jf, paths)._resumable_stream(
            jdp.DatasetCursor(*pos, seed=3), 2, False))
        assert [s for _, s in got] == [s for _, s in want], name
        _assert_feeds_equal([f for f, _ in got], [f for f, _ in want])
        k = states.index(same)
        assert [s for _, s in got] == [s for _, s in full[k:]], name
        _assert_feeds_equal([f for f, _ in got], [f for f, _ in full[k:]])
    # the default epochs bound of a restored cursor: the rest of ITS epoch
    got = list(_ds(pf, paths).resumable_batches(
        pdp.DatasetCursor(epoch=1, shard_idx=2, record_offset=4, seed=3)))
    want = list(_ds(jf, paths).resumable_batches(
        jdp.DatasetCursor(epoch=1, shard_idx=2, record_offset=4, seed=3)))
    assert got
    _assert_feeds_equal(got, want)


def test_cursor_advances_on_consume_only(tmp_path):
    """test_data_plane.py :941 on the port: queued batches do not move
    the cursor, only consumption does."""
    paths = _write_shards(tmp_path, [16, 16])
    sc = pf.Scope()
    cur = pdp.DatasetCursor()
    it = _ds(pf, paths, thread=2).resumable_batches(cur, epochs=1,
                                                    scope=sc, prefetch=True)
    got = [next(it) for _ in range(2)]
    time.sleep(0.3)  # let the producer run ahead into the queue
    assert cur.position() == (0, 0, 8)
    assert pdp.DatasetCursor.from_scope(sc).position() == (0, 0, 8)
    rest = list(it)
    assert len(got) + len(rest) == 8
    assert cur.position() == (1, 0, 0)


def test_cursor_resume_counter_equal_jax(tmp_path):
    paths = _write_shards(tmp_path, [8])
    before = _counts()
    for mod, dp in ((jf, jdp), (pf, pdp)):
        list(_ds(mod, paths).resumable_batches(dp.DatasetCursor(),
                                               epochs=1))
        list(_ds(mod, paths).resumable_batches(
            dp.DatasetCursor(record_offset=4), epochs=1))
    d = _deltas(before, _counts())
    assert d[0] == d[1] and d[1]["data/cursor_resumes"] == 1


# ---------------------------------------------------------------------------
# damage, for every policy
# ---------------------------------------------------------------------------


def _damage_crc(tmp_path):
    p = str(tmp_path / "crc.rec")
    _write_shard(p, 12, max_num_records=4)
    _flip_byte(p, 20 + _chunk0_payload_len(p) + 30)
    return p


def _damage_torn(tmp_path):
    src = str(tmp_path / "src.rec")
    _write_shard(src, 12, max_num_records=4)
    raw = open(src, "rb").read()
    p = str(tmp_path / "torn.rec")
    with open(p, "wb") as f:
        f.write(raw[:20 + _chunk0_payload_len(src) + 9])
    return p


def _damage_sub_magic(tmp_path):
    src = str(tmp_path / "src2.rec")
    _write_shard(src, 8, max_num_records=4)
    p = str(tmp_path / "frag.rec")
    with open(p, "wb") as f:
        f.write(open(src, "rb").read() + b"\x50\x54")
    return p


def _damage_framing(tmp_path):
    """A chunk whose CRC passes but whose second record's length header
    overruns it."""
    src = str(tmp_path / "src3.rec")
    _write_shard(src, 8, max_num_records=4)
    raw = open(src, "rb").read()
    c1 = 20 + _chunk0_payload_len(src)
    rec = struct.pack("<I", 3) + b"abc" + struct.pack("<I", 99) + b"xy"
    chunk = struct.pack("<IIQI", 0x50545243, 2, len(rec),
                        zlib.crc32(rec) & 0xFFFFFFFF) + rec
    p = str(tmp_path / "framing.rec")
    with open(p, "wb") as f:
        f.write(raw[:c1] + chunk + raw[c1:])
    return p


def _damage_record(tmp_path):
    from paddle_tpu.recordio_writer import serialize_sample

    p = str(tmp_path / "record.rec")
    recs = [serialize_sample((np.full((4,), i, np.float32), np.int64(i)))
            for i in range(5)]
    recs[2] = b"\xde\xad\xbe\xef" * 3
    w = jnative.RecordIOWriter(p)
    for r in recs:
        w.write(r)
    w.close()
    return p


def _damage_snappy(tmp_path):
    from paddle_tpu.recordio_writer import serialize_sample

    # 24-byte samples: a literal element holds up to 60 bytes
    records = [serialize_sample((np.int8(i),)) for i in range(4)]
    stored = bytearray(_write_reference_snappy_shard(
        str(tmp_path / "tmp.rec"), records))
    stored[14] ^= 0x40  # inside the first frame's masked CRC
    p = str(tmp_path / "snappy_bad.rec")
    _write_reference_snappy_shard(p, records, stored=bytes(stored))
    return p


_DAMAGES = {"crc_flip": _damage_crc, "torn_tail": _damage_torn,
            "sub_magic_fragment": _damage_sub_magic,
            "framing_overrun": _damage_framing,
            "undecodable_payload": _damage_record,
            "snappy_reference": _damage_snappy}


def _run_policy(mod, dp, paths, policy):
    """(sample stream as lists, error fields or None, warnings)."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        try:
            got = list(dp.resilient_sample_reader(paths, policy=policy)())
            err = None
        except dp.DataAnomalyError as e:
            got = None
            err = (e.shard, e.kind, e.chunk_index, e.record_index,
                   e.detail, str(e))
    if got is not None:
        got = [tuple(np.asarray(x).tolist() for x in s) for s in got]
    return got, err, sorted(str(x.message) for x in w)


@pytest.mark.parametrize("policy", ["skip_record", "quarantine_shard",
                                    "abort"])
@pytest.mark.parametrize("damage", sorted(_DAMAGES))
def test_damage_policy_equal_jax(tmp_path, damage, policy):
    bad = _DAMAGES[damage](tmp_path)
    healthy = str(tmp_path / "healthy.rec")
    _write_shard(healthy, 5, tag=7)
    paths = [healthy, bad, healthy]
    before = _counts()
    want = _run_policy(jf, jdp, paths, policy)
    mid = _counts()
    got = _run_policy(pf, pdp, paths, policy)
    after = _counts()
    assert got == want
    assert _deltas(before, mid)[0] == _deltas(mid, after)[1]
    assert pdp.quarantined_shards() == jdp.quarantined_shards()
    if policy == "abort":
        assert got[1] is not None and got[1][0] == bad
    else:
        assert got[1] is None


def test_healthy_streams_through_either_reader(tmp_path):
    """On healthy shards every policy's containment reader yields the
    native scanner's records, as does the port's scanner (the two share
    one chunk decoder)."""
    for comp in (None, "deflate"):
        p = str(tmp_path / ("h_%s.rec" % comp))
        _write_shard(p, 23, max_num_records=7, compressor=comp)
        want = list(jnative.RecordIOScanner(p))
        assert list(pnative.RecordIOScanner(p)) == want
        for policy in pdp.DATA_POLICIES:
            assert list(pdp.iter_shard_records(p, policy=policy)) == want


def test_default_policy_is_skip_record(monkeypatch):
    monkeypatch.delenv("PTPU_DATA_ANOMALY_POLICY", raising=False)
    assert pdp.data_anomaly_policy() == "skip_record"
    monkeypatch.setenv("PTPU_DATA_ANOMALY_POLICY", "quarantine_shard")
    assert pdp.data_anomaly_policy() == "quarantine_shard"
    assert pdp.data_anomaly_policy("abort") == "abort"
    monkeypatch.setenv("PTPU_DATA_ANOMALY_POLICY", "bogus")
    with pytest.raises(ValueError, match="bogus"):
        pdp.data_anomaly_policy()


def test_dataset_stream_through_corrupt_shard_equal_jax(tmp_path):
    paths = _write_shards(tmp_path, [12, 12, 12], max_num_records=4)
    _flip_byte(paths[1], 25)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = list(_ds(pf, paths, thread=2)._batches())
        want = list(_ds(jf, paths, thread=2)._batches())
        _assert_feeds_equal(got, want)
        # test_data_plane.py :1300 on the port: the degraded stream
        # resumes bitwise too
        full = list(_ds(pf, paths).resumable_batches(pdp.DatasetCursor(),
                                                     epochs=1))
        cur = pdp.DatasetCursor()
        it = _ds(pf, paths).resumable_batches(cur, epochs=1)
        head = [next(it) for _ in range(3)]
        resumed = list(_ds(pf, paths).resumable_batches(cur.clone(),
                                                        epochs=1))
    _assert_feeds_equal(head + resumed, full)


# ---------------------------------------------------------------------------
# injector sites
# ---------------------------------------------------------------------------


def test_injected_corrupt_shard_equal_jax(tmp_path):
    paths = _write_shards(tmp_path, [6, 6, 6])
    streams, before = [], _counts()
    for mod, res in ((jf, jres), (pf, pres)):
        res.set_global_injector(res.FaultInjector("data_corrupt_shard:1"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            first = list(_ds(mod, paths, bs=3)._batches())
        second = list(_ds(mod, paths, bs=3)._batches())  # one-shot
        streams.append((first, second))
    d = _deltas(before, _counts())
    assert d[0] == d[1] and d[1]["data/records_corrupt"] == 6
    _assert_feeds_equal(streams[1][0], streams[0][0])
    _assert_feeds_equal(streams[1][1], streams[0][1])
    ys = [int(v) for b in streams[1][0] for v in b["y"].ravel()]
    assert ys == [0, 1, 2, 3, 4, 5, 2000, 2001, 2002, 2003, 2004, 2005]


def test_injected_stall_shard_preserves_stream(tmp_path):
    paths = _write_shards(tmp_path, [5, 5])
    oracle = list(_ds(pf, paths, bs=5)._batches())
    pres.set_global_injector(pres.FaultInjector("data_stall_shard:0"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.monotonic()
        stalled = list(_ds(pf, paths, bs=5)._batches())
        took = time.monotonic() - t0
    assert took >= 0.2
    _assert_feeds_equal(stalled, oracle)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


def test_in_memory_dataset_equal_jax(tmp_path):
    paths = _write_shards(tmp_path, [9, 7, 8])
    feeds = []
    for mod in (jf, pf):
        ds = _ds(mod, paths, bs=5, thread=2, kind="InMemoryDataset")
        ds.load_into_memory()
        loaded = list(ds._batches())
        ds.local_shuffle(seed=4)
        local = list(ds._batches())
        ds.global_shuffle(seed=6)
        glob = list(ds._batches())
        feeds.append((loaded, local, glob))
        with pytest.raises(NotImplementedError, match="QueueDataset"):
            ds.resumable_batches(
                (jdp if mod is jf else pdp).DatasetCursor())
    for got, want in zip(feeds[1], feeds[0]):
        _assert_feeds_equal(got, want)


def test_unported_dataset_paths_raise(tmp_path):
    class _Fleet:
        def worker_index(self):
            return 0

        def worker_num(self):
            return 2

    ds = _ds(pf, _write_shards(tmp_path, [4]), kind="InMemoryDataset")
    with pytest.raises(RuntimeError, match="load_into_memory"):
        ds.local_shuffle()
    ds.load_into_memory()
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        ds.global_shuffle(fleet=_Fleet())
    with pytest.raises(ValueError, match="unknown dataset class"):
        pf.DatasetFactory().create_dataset("BoxPSDataset")
    exe = pf.Executor("cpu")
    with pytest.raises(NotImplementedError, match="QueueDataset"):
        exe.train_from_dataset(pf.Program(), ds,
                               cursor=pdp.DatasetCursor())
    with pytest.raises(ValueError, match="needs a dataset"):
        exe.train_from_dataset(pf.Program())


def test_threaded_parse_forwards_worker_error(tmp_path, monkeypatch):
    """A shard failure on a pool thread surfaces at the consumer with the
    original exception, through the prefetcher too."""
    paths = _write_shards(tmp_path, [4, 4, 4])
    real = pf.dataset_api.DatasetBase._file_samples

    def boom(self, path, shard_index=0):
        if shard_index == 1:
            raise OSError("disk gone: %s" % path)
        return real(self, path, shard_index)

    monkeypatch.setattr(pf.dataset_api.DatasetBase, "_file_samples", boom)
    for make in (lambda: _ds(pf, paths, thread=3)._batches(),
                 lambda: _ds(pf, paths, thread=3)._batches_prefetched()):
        with pytest.raises(OSError, match="disk gone"):
            list(make())
    assert not [t for t in threading.enumerate()
                if t.name == "ptpu-dataset-prefetch" and t.is_alive()]
