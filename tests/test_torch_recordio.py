"""The port's RecordIO layer against the JAX package's: the chunk writer
and scanner (``core/native.py``: the port's Python against the JAX
package's ``native/recordio.cc`` through ctypes), ``recordio_writer``'s
sample encoding with its bounds checks, the reader decorators
(``reader/``) and ``DataFeeder.feed``.

  * for the same samples, chunk size and compressor the port's writer
    gives the JAX writer's bytes, plain and deflate, with a short last
    chunk, through both ``convert_reader_to_recordio_file(s)``; each
    package's scanner reads the other's files record for record;
  * on damaged files the port's scanner yields the same records as the
    native one before the same verdict (the native -2 as ``IOError``);
  * ``deserialize_sample`` rejects the same malformed payloads with the
    same ``RecordFormatError``;
  * the decorators and ``fluid.batch`` give JAX's streams; ``PyReader``
    and ``PipeReader`` raise, naming their ROADMAP.md item;
  * ``DataFeeder.feed`` gives JAX's feed dict for the same rows."""

import os
import random
import struct
import zlib

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import reader as jreader
from paddle_tpu import recordio_writer as jrw
from paddle_tpu.core import native as jnative
from paddle_tpu_torch import reader as preader
from paddle_tpu_torch import recordio_writer as prw
from paddle_tpu_torch.core import native as pnative

from torch_parity import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(jnative.lib() is None,
                                reason="no native lib for the JAX RecordIO")


def _samples(n=53, width=37, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 1000, (width,)).astype(np.int32),
             rng.standard_normal((2, 3)).astype(np.float32),
             np.int64(i)) for i in range(n)]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _scan(mod, path):
    """(records before the verdict, the verdict: None or 'IOError')."""
    s = mod.RecordIOScanner(path)
    out = []
    try:
        for rec in s:
            out.append(bytes(rec))
    except IOError:
        return out, "IOError"
    finally:
        s.close()
    return out, None


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("compressor", [None, "deflate", "snappy"])
@pytest.mark.parametrize("max_num_records", [7, 1000])
def test_writer_bytes_equal_jax(tmp_path, compressor, max_num_records):
    samples = _samples()
    a, b = str(tmp_path / "jax.rec"), str(tmp_path / "port.rec")
    nj = jf.convert_reader_to_recordio_file(
        a, lambda: iter(samples), compressor=compressor,
        max_num_records=max_num_records)
    np_ = pf.convert_reader_to_recordio_file(
        b, lambda: iter(samples), compressor=compressor,
        max_num_records=max_num_records)
    assert nj == np_ == len(samples)
    assert _read(a) == _read(b)
    # each package reads the other's file
    assert _scan(jnative, b) == _scan(pnative, a) == _scan(jnative, a)
    _assert_samples_equal(list(prw.recordio_reader_creator([a])()),
                          list(jrw.recordio_reader_creator([b])()))


def test_byte_bound_flushes_like_native(tmp_path):
    """A chunk also closes at max_chunk_bytes of payload: both writers
    cut the same chunks from records of mixed sizes."""
    rng = np.random.RandomState(1)
    recs = [rng.bytes(int(n)) for n in rng.randint(0, 900, 40)]
    a, b = str(tmp_path / "a.rec"), str(tmp_path / "b.rec")
    for path, mod in ((a, jnative), (b, pnative)):
        w = mod.RecordIOWriter(path, max_chunk_records=100,
                               max_chunk_bytes=2048, compressor="deflate")
        for r in recs:
            w.write(r)
        w.close()
    assert _read(a) == _read(b)
    assert _scan(pnative, a) == (recs, None)


def test_files_split_equal_jax(tmp_path):
    samples = _samples(n=23)
    for mod, sub in ((jf, "jax"), (pf, "port")):
        os.makedirs(str(tmp_path / sub))
        n = mod.recordio_writer.convert_reader_to_recordio_files(
            str(tmp_path / sub / "d.recordio"), 10, lambda: iter(samples),
            compressor="deflate", max_num_records=4)
        assert n == 23
    names = sorted(os.listdir(str(tmp_path / "jax")))
    assert names == sorted(os.listdir(str(tmp_path / "port"))) == [
        "d-00000.recordio", "d-00001.recordio", "d-00002.recordio"]
    for name in names:
        assert _read(str(tmp_path / "jax" / name)) == \
            _read(str(tmp_path / "port" / name))
    with pytest.raises(ValueError):
        prw.convert_reader_to_recordio_files(
            str(tmp_path / "x.rec"), 10, lambda: iter(samples))


def _plain_chunk(payload, num, crc=None):
    crc = zlib.crc32(payload) & 0xFFFFFFFF if crc is None else crc
    return struct.pack("<IIQI", 0x50545243, num, len(payload), crc) \
        + payload


def _damaged(tmp_path):
    """{name: file bytes} of damage kinds, from a 3-chunk healthy file."""
    src = str(tmp_path / "healthy.rec")
    jf.convert_reader_to_recordio_file(src, lambda: iter(_samples(n=12)),
                                       max_num_records=4)
    raw = _read(src)
    (raw0,) = struct.unpack_from("<Q", raw, 8)
    c1 = 20 + raw0
    out = {"healthy": raw}
    flip = bytearray(raw)
    flip[c1 + 20 + 30] ^= 0xFF                      # chunk 1 payload
    out["crc_flip"] = bytes(flip)
    out["torn_header"] = raw[:c1 + 9]
    out["torn_payload"] = raw[:c1 + 40]
    out["sub_magic_tail"] = raw + b"\x50\x54"
    out["bad_magic"] = raw[:c1] + b"\xde\xad\xbe\xef" + raw[c1 + 4:]
    out["huge_size"] = raw[:8] + struct.pack("<Q", 1 << 40) + raw[16:]
    overrun = struct.pack("<I", 3) + b"abc" + struct.pack("<I", 99) + b"x"
    out["framing_overrun"] = raw[:c1] + _plain_chunk(overrun, 2)
    out["empty_chunk"] = raw[:c1] + _plain_chunk(b"", 0)
    # deflate: a damaged zlib stream under a valid header
    z = zlib.compress(struct.pack("<I", 4) + b"data")
    zbad = bytearray(z)
    zbad[len(zbad) // 2] ^= 0x55
    out["deflate_damaged"] = raw[:c1] + struct.pack(
        "<IIQQI", 0x5A545243, 1, 8, len(zbad),
        zlib.crc32(struct.pack("<I", 4) + b"data") & 0xFFFFFFFF) \
        + bytes(zbad)
    return out


def test_scanner_verdicts_equal_native(tmp_path):
    for name, data in _damaged(tmp_path).items():
        p = str(tmp_path / (name + ".rec"))
        with open(p, "wb") as f:
            f.write(data)
        want = _scan(jnative, p)
        assert _scan(pnative, p) == want, name
        assert (want[1] is None) == (name in ("healthy", "sub_magic_tail"))


def test_reference_chunks_scan_like_native(tmp_path):
    """The reference's chunk format (magic 0x01020304): plain and snappy
    framing, healthy and with a damaged frame CRC."""
    from test_torch_data_plane import _write_reference_snappy_shard

    records = [b"ref.rec.%03d" % i for i in range(8)]
    p = str(tmp_path / "snappy.rec")
    stored = _write_reference_snappy_shard(p, records)
    assert _scan(pnative, p) == _scan(jnative, p) == (records, None)
    bad = bytearray(stored)
    bad[14] ^= 0x40
    pb = str(tmp_path / "snappy_bad.rec")
    _write_reference_snappy_shard(pb, records, stored=bytes(bad))
    assert _scan(pnative, pb) == _scan(jnative, pb) == ([], "IOError")
    payload = b"".join(struct.pack("<I", len(r)) + r for r in records)
    pp = str(tmp_path / "plain_ref.rec")
    with open(pp, "wb") as f:
        f.write(struct.pack("<IIIII", 0x01020304, len(records),
                            zlib.crc32(payload) & 0xFFFFFFFF, 0,
                            len(payload)) + payload)
    assert _scan(pnative, pp) == _scan(jnative, pp) == (records, None)


def test_writer_rejects_what_native_rejects(tmp_path):
    with pytest.raises(ValueError):
        pnative.RecordIOWriter(str(tmp_path / "x.rec"), compressor="lz4")
    with pytest.raises(IOError):
        pnative.RecordIOWriter(str(tmp_path / "no" / "x.rec"))
    with pytest.raises(IOError):
        pnative.RecordIOScanner(str(tmp_path / "missing.rec"))


def _malformed():
    rec = prw.serialize_sample((np.arange(6, dtype=np.float32),
                                np.int64(3)))
    one = prw.serialize_sample((np.arange(4, dtype=np.float32),))
    cases = {"cut%d" % cut: rec[:cut] for cut in range(0, len(rec) - 1, 3)}
    b = bytearray(one)
    b[4] = 0xEE
    cases["dtype_len"] = bytes(b)
    b = bytearray(one)
    struct.pack_into("<I", b, 0, 1 << 30)
    cases["field_count"] = bytes(b)
    b = bytearray(one)
    struct.pack_into("<Q", b, 24, 1 << 40)
    cases["payload_len"] = bytes(b)
    b = bytearray(one)
    struct.pack_into("<q", b, 16, 5)
    cases["shape_mismatch"] = bytes(b)
    b = bytearray(one)
    struct.pack_into("<q", b, 16, -1)
    cases["negative_dim"] = bytes(b)
    b = bytearray(one)
    b[8:12] = b"<zz9"
    cases["dtype_tag"] = bytes(b)
    b = bytearray(one)
    struct.pack_into("<I", b, 12, 65)
    cases["rank"] = bytes(b)
    cases["junk"] = b"\xde\xad\xbe\xef" * 3
    return cases


@pytest.mark.parametrize("name", sorted(_malformed()))
def test_deserialize_rejects_like_jax(name):
    payload = _malformed()[name]
    with pytest.raises(jrw.RecordFormatError) as je:
        jrw.deserialize_sample(payload)
    with pytest.raises(prw.RecordFormatError) as pe:
        prw.deserialize_sample(payload)
    assert str(pe.value) == str(je.value)


def test_serialize_sample_bytes_equal_jax():
    for sample in _samples(n=3) + [np.float32(2.5), [np.zeros((0, 3))],
                                    (np.array(["ab"]),)]:
        assert prw.serialize_sample(sample) == jrw.serialize_sample(sample)
        _assert_samples_equal(
            [prw.deserialize_sample(prw.serialize_sample(sample))],
            [jrw.deserialize_sample(jrw.serialize_sample(sample))])


def test_reader_creator_torn_shard_error_equal_jax(tmp_path):
    data = _damaged(tmp_path)["crc_flip"]
    p = str(tmp_path / "s.rec")
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises(jrw.RecordFormatError) as je:
        list(jrw.recordio_reader_creator([p])())
    with pytest.raises(prw.RecordFormatError) as pe:
        list(prw.recordio_reader_creator(p)())
    assert str(pe.value) == str(je.value)


def _stream(reader):
    return [tuple(np.asarray(x).tolist() for x in s)
            if isinstance(s, tuple) else np.asarray(s).tolist()
            for s in reader()]


def test_decorators_equal_jax(tmp_path):
    base = [(np.float32(i), np.int64(i * i)) for i in range(11)]

    def src():
        return iter(base)

    def other():
        return iter(range(11))

    cases = [
        lambda m: m.map_readers(lambda a, b: (a[0] + b,), src, other),
        lambda m: m.chain(src, m.firstn(src, 3)),
        lambda m: m.compose(src, other),
        lambda m: m.compose(src, m.firstn(other, 4), check_alignment=False),
        lambda m: m.buffered(src, 2),
        lambda m: m.firstn(src, 5),
        lambda m: m.cache(src),
        lambda m: m.xmap_readers(lambda s: (s[0] * 2,), src, 1, 4),
        lambda m: m.multiprocess_reader([src, other]),
        lambda m: m.batch(src, 4),
        lambda m: m.batch(src, 4, drop_last=True),
        lambda m: m.creator.np_array(np.arange(12).reshape(4, 3)),
    ]
    for make in cases:
        assert _stream(make(preader)) == _stream(make(jreader))
    assert pf.batch is preader.batch
    # shuffle draws from the global `random`: the same seed, the same order
    random.seed(5)
    want = _stream(jreader.shuffle(src, 4))
    random.seed(5)
    assert _stream(preader.shuffle(src, 4)) == want
    # an unordered xmap with workers: the same multiset
    got = sorted(_stream(preader.xmap_readers(lambda s: (s[0] * 2,), src,
                                              3, 4)))
    assert got == sorted(_stream(jreader.xmap_readers(
        lambda s: (s[0] * 2,), src, 3, 4)))
    with pytest.raises(preader.ComposeNotAligned):
        list(preader.compose(src, preader.firstn(other, 4))())
    text = tmp_path / "t.txt"
    text.write_text("a\nbb\n\nc")
    assert list(preader.creator.text_file(str(text))()) == \
        list(jreader.creator.text_file(str(text))())
    shard = str(tmp_path / "s.rec")
    jf.convert_reader_to_recordio_file(shard, src)
    _assert_samples_equal(list(preader.creator.recordio(shard)()),
                          list(jreader.creator.recordio(shard)()))


@pytest.mark.parametrize("cls", ["PyReader", "PipeReader"])
def test_unported_readers_raise_naming_item(cls):
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        getattr(preader, cls)("cat x")


def _feed_program(mod):
    main, startup = mod.Program(), mod.Program()
    with mod.program_guard(main, startup):
        x = mod.layers.data(name="x", shape=[4], dtype="float32")
        y = mod.layers.data(name="y", shape=[1], dtype="int64")
        s = mod.layers.data(name="s", shape=[1], dtype="int64",
                            lod_level=1)
        z = mod.layers.data(name="z", shape=[2, 3], dtype="float32")
    return main, [x, y, s, z]


def test_data_feeder_equal_jax():
    rng = np.random.RandomState(2)
    rows = [(rng.standard_normal(4), i, rng.randint(0, 9, (i + 1, 1)),
             rng.standard_normal(6)) for i in range(5)]
    outs = []
    for mod in (jf, pf):
        main, feed_list = _feed_program(mod)
        feeder = mod.DataFeeder(feed_list, program=main)
        outs.append(feeder.feed(rows))
        by_name = mod.DataFeeder(["x", "y", "s", "z"], program=main)
        outs.append(by_name.feed(rows))
    want = outs[0]
    for got in outs[1:]:
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    assert want["y"].shape == (5, 1) and want["z"].shape == (5, 2, 3)


def test_data_feed_desc_describes_like_jax():
    descs = []
    for mod in (jf, pf):
        d = mod.DataFeedDesc()
        d.add_slot("ids", "uint64").add_slot("dense", "float",
                                             is_dense=True)
        d.set_batch_size(32)
        d.set_use_slots(["ids"])
        descs.append(d.desc())
    assert descs[0] == descs[1]
    ds = pf.DatasetFactory().create_dataset("QueueDataset")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        ds.set_data_feed_desc(pf.DataFeedDesc())
