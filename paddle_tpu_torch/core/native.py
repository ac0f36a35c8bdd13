"""The port's counterparts of the JAX package's ``core/native.py``, in
Python: the sealed model frame of ``__model__`` (`program_seal` /
`program_unseal` :155-190, their pure-Python branch) and the RecordIO
chunk writer and scanner (`RecordIOWriter` :247, `RecordIOScanner` :288).
The JAX package drives ``native/recordio.cc`` through ctypes; the port
implements that file's format here and loads no native library.

The model frame: a 20-byte little-endian header — magic 0x50545047,
format version 1, payload length (u64), CRC32 of the payload — then the
payload.

A RecordIO file is chunks back to back, all little-endian:

    plain chunk   : magic u32 'PTRC' (0x50545243), num_records u32,
                    raw_bytes u64, crc32(raw payload) u32, payload
    deflate chunk : magic u32 'PTRZ' (0x5A545243), num_records u32,
                    raw_bytes u64, comp_bytes u64, crc32(raw payload)
                    u32, then comp_bytes of zlib stream
    payload       : (len u32, bytes)* back to back

The scanner also reads the reference's chunks (magic 0x01020304: header
u32 x5 {magic, num_records, crc32 of the stored bytes, compressor,
compress_size}, the payload plain or in snappy's framing format). With
the same records, `max_chunk_records`, `max_chunk_bytes` and compressor
the writer gives the native writer's bytes: a chunk is flushed when it
holds `max_chunk_records` records or `max_chunk_bytes` payload bytes,
and before a record that would take the payload to 1 GiB; deflate is
zlib at its default level (``compress2(Z_DEFAULT_COMPRESSION)``).

One chunk decoder (`_read_chunk`, `_split_records`; the JAX package's
``data_plane.py`` :316, :473) serves both the scanner and the data
plane's containment reader (``data_plane.iter_shard_records``): the
scanner turns its damage verdicts into the native -2, the data plane
routes them through its anomaly policy.
"""

import struct
import zlib

__all__ = ["is_sealed", "program_seal", "program_unseal", "RecordIOWriter",
           "RecordIOScanner"]

_MAGIC = 0x50545047
_VERSION = 1
_HEADER = "<IIQI"
_HEADER_BYTES = struct.calcsize(_HEADER)


def program_seal(payload: bytes) -> bytes:
    """Frame program bytes with magic, version, length and CRC."""
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return struct.pack(_HEADER, _MAGIC, _VERSION, len(payload),
                       crc) + payload


def is_sealed(buf: bytes) -> bool:
    """True when `buf` starts with the frame's magic."""
    return buf[:4] == struct.pack("<I", _MAGIC)


def program_unseal(buf: bytes) -> bytes:
    """The payload of a sealed frame; ValueError on a truncated frame, a
    wrong magic, an unknown version or a CRC mismatch."""
    if len(buf) < _HEADER_BYTES:
        raise ValueError("bad program file: truncated")
    magic, version, plen, crc = struct.unpack(_HEADER, buf[:_HEADER_BYTES])
    if magic != _MAGIC:
        raise ValueError("bad program file: magic")
    if version != _VERSION:
        raise ValueError("unsupported program version %d" % version)
    payload = buf[_HEADER_BYTES:_HEADER_BYTES + plen]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise ValueError("bad program file: CRC mismatch")
    return payload


# native/recordio.cc's constants
_CHUNK_MAGIC = 0x50545243      # "PTRC"
_CHUNK_MAGIC_Z = 0x5A545243    # "PTRZ" (deflate)
_REF_MAGIC = 0x01020304        # the reference's chunks (read only)
MAX_CHUNK_BYTES = 1 << 30      # kMaxChunkBytes: a sanity bound on sizes


class RecordIOWriter:
    """Chunked CRC'd record file writer (``native/recordio.cc`` Writer).

    compressor: 0/None = plain, 1/'deflate' = zlib-compressed chunks
    ('snappy' accepted as an alias, as in the JAX package: the wire
    format is the repo's, deflate its codec)."""

    _COMPRESSORS = {None: 0, "": 0, 0: 0, "none": 0,
                    1: 1, "deflate": 1, "snappy": 1}

    def __init__(self, path, max_chunk_records=1000,
                 max_chunk_bytes=1 << 20, compressor=None):
        key = compressor.lower() if isinstance(compressor, str) \
            else compressor
        if key not in self._COMPRESSORS:
            raise ValueError("unknown recordio compressor %r" % compressor)
        self._compressor = self._COMPRESSORS[key]
        self._max_records = int(max_chunk_records) or 1000
        self._max_bytes = int(max_chunk_bytes) or (1 << 20)
        try:
            self._f = open(path, "wb")
        except OSError:
            raise IOError("cannot open %s" % path)
        self._payload = bytearray()
        self._num = 0

    def _flush_chunk(self):
        if self._num == 0:
            return
        raw = bytes(self._payload)
        crc = zlib.crc32(raw) & 0xFFFFFFFF
        if self._compressor == 1:
            comp = zlib.compress(raw)
            # incompressible data past the scanner's bound: a plain chunk
            if len(comp) < MAX_CHUNK_BYTES:
                self._f.write(struct.pack("<IIQQI", _CHUNK_MAGIC_Z,
                                          self._num, len(raw), len(comp),
                                          crc))
                self._f.write(comp)
                self._payload.clear()
                self._num = 0
                return
        self._f.write(struct.pack("<IIQI", _CHUNK_MAGIC, self._num,
                                  len(raw), crc))
        self._f.write(raw)
        self._payload.clear()
        self._num = 0

    def write(self, record: bytes):
        n = len(record)
        if n + 4 >= MAX_CHUNK_BYTES:
            raise IOError("recordio write failed")
        if len(self._payload) + n + 4 >= MAX_CHUNK_BYTES:
            self._flush_chunk()
        self._payload += struct.pack("<I", n)
        self._payload += record
        self._num += 1
        if self._num >= self._max_records \
                or len(self._payload) >= self._max_bytes:
            self._flush_chunk()

    def close(self):
        if self._f is not None:
            try:
                self._flush_chunk()
            finally:
                self._f.close()
                self._f = None


# The chunk decoder: the scanner's and the data plane's containment
# reader's (``data_plane.iter_shard_records``).

_CRC32C_TABLE = None


def _crc32c(buf):
    """CRC-32C (Castagnoli) — the snappy framing format's per-chunk
    checksum."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        tab = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
            tab.append(c)
        _CRC32C_TABLE = tab
    tab = _CRC32C_TABLE
    c = 0xFFFFFFFF
    for b in buf:
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _snappy_block_uncompress(src):
    """One raw snappy block (varint uncompressed length, then
    literal/copy elements), decoded from the public format spec.
    Returns the decoded bytes, or None on any malformed input (bounds,
    bad offsets, length mismatch)."""
    n = len(src)
    pos = 0
    ulen = 0
    shift = 0
    while True:
        if pos >= n or shift > 35:
            return None
        b = src[pos]
        pos += 1
        ulen |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    if ulen >= MAX_CHUNK_BYTES:
        return None
    out = bytearray()
    while pos < n:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59  # 1..4 length bytes
                if pos + nb > n:
                    return None
                ln = int.from_bytes(src[pos:pos + nb], "little")
                pos += nb
            ln += 1
            if pos + ln > n or len(out) + ln > ulen:
                return None
            out += src[pos:pos + ln]
            pos += ln
        else:  # copy
            if kind == 1:
                if pos + 1 > n:
                    return None
                ln = ((tag >> 2) & 0x7) + 4
                offset = ((tag >> 5) << 8) | src[pos]
                pos += 1
            elif kind == 2:
                if pos + 2 > n:
                    return None
                ln = (tag >> 2) + 1
                offset = src[pos] | (src[pos + 1] << 8)
                pos += 2
            else:
                if pos + 4 > n:
                    return None
                ln = (tag >> 2) + 1
                offset = int.from_bytes(src[pos:pos + 4], "little")
                pos += 4
            if offset == 0 or offset > len(out) or len(out) + ln > ulen:
                return None
            frm = len(out) - offset
            for i in range(ln):  # may overlap: byte-wise
                out.append(out[frm + i])
    return bytes(out) if len(out) == ulen else None


def _snappy_framed_uncompress(data):
    """Snappy framing format — (type u8, len u24le, body)* with a
    'sNaPpY' stream id and masked CRC-32C per data chunk. Returns the
    decoded bytes, or None on malformed input."""
    n = len(data)
    pos = 0
    out = bytearray()
    while pos < n:
        if pos + 4 > n:
            return None
        ftype = data[pos]
        ln = int.from_bytes(data[pos + 1:pos + 4], "little")
        pos += 4
        if pos + ln > n:
            return None
        body = data[pos:pos + ln]
        if ftype == 0xFF:
            if ln != 6 or body != b"sNaPpY":
                return None
        elif ftype in (0x00, 0x01):
            if ln < 4:
                return None
            masked = int.from_bytes(body[:4], "little")
            piece = (_snappy_block_uncompress(body[4:]) if ftype == 0x00
                     else bytes(body[4:]))
            if piece is None:
                return None
            crc = _crc32c(piece)
            want = ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF)
                    + 0xA282EAD8) & 0xFFFFFFFF
            if want != masked:
                return None
            if len(out) + len(piece) >= MAX_CHUNK_BYTES:
                return None
            out += piece
        elif 0x02 <= ftype <= 0x7F:
            return None  # reserved unskippable
        # 0x80-0xfd reserved skippable, 0xfe padding: skip
        pos += ln
    return bytes(out)


class _ChunkDamage(Exception):
    """Internal: one chunk failed verification but the stream is
    positioned at the next chunk header (containment can continue)."""

    def __init__(self, kind, num_records, detail):
        super().__init__(detail)
        self.kind = kind
        self.num_records = num_records
        self.detail = detail


class _ShardTorn(Exception):
    """Internal: the shard's tail is unreadable (truncated header or
    payload, implausible declared size) — no further chunk boundary is
    recoverable, so containment must stop the shard here. `sub_magic`
    marks a tail shorter than a chunk magic, which the scanner reads as
    a clean end."""

    def __init__(self, detail, sub_magic=False):
        super().__init__(detail)
        self.detail = detail
        self.sub_magic = sub_magic


def _read_chunk(f, force_corrupt=False):
    """Read and verify one chunk; returns (payload_bytes, num_records)
    or None at clean EOF. Raises _ChunkDamage (recoverable — the file
    is positioned at the next chunk) or _ShardTorn (fatal for this
    shard). `force_corrupt` fails the CRC verdict while still consuming
    the chunk's bytes — the `data_corrupt_shard` injector's hook."""
    head = f.read(4)
    if not head:
        return None
    if len(head) < 4:
        raise _ShardTorn("truncated chunk magic (%d byte tail)"
                         % len(head), sub_magic=True)
    (magic,) = struct.unpack("<I", head)
    if magic == _CHUNK_MAGIC or magic == _CHUNK_MAGIC_Z:
        deflate = magic == _CHUNK_MAGIC_Z
        hdr_len = 20 if not deflate else 28
        hdr = f.read(hdr_len - 4)
        if len(hdr) < hdr_len - 4:
            raise _ShardTorn("truncated chunk header")
        if deflate:
            num, raw_len, comp_len, crc = struct.unpack("<IQQI", hdr)
        else:
            num, raw_len, crc = struct.unpack("<IQI", hdr)
            comp_len = raw_len
        if raw_len >= MAX_CHUNK_BYTES or comp_len >= MAX_CHUNK_BYTES:
            raise _ShardTorn("implausible declared chunk size %d"
                             % max(raw_len, comp_len))
        stored = f.read(comp_len)
        if len(stored) < comp_len:
            raise _ShardTorn("truncated chunk payload (%d of %d bytes)"
                             % (len(stored), comp_len))
        if deflate:
            try:
                payload = zlib.decompress(stored)
            except zlib.error as e:
                raise _ChunkDamage("crc", num,
                                   "deflate stream damaged: %s" % e)
            if len(payload) != raw_len:
                raise _ChunkDamage("crc", num,
                                   "decompressed size mismatch")
        else:
            payload = stored
        if force_corrupt or zlib.crc32(payload) != crc:
            raise _ChunkDamage("crc", num, "chunk CRC mismatch"
                               if not force_corrupt
                               else "injected CRC failure "
                                    "(data_corrupt_shard)")
        return payload, num
    if magic == _REF_MAGIC:
        # reference-written chunk: header tail u32x4 {num, checksum (of
        # the bytes AS STORED), compressor, compress_size}. The
        # resilient reader verifies the stored-bytes CRC (that's the
        # containment) and decodes both reference kinds inline —
        # kNoCompress verbatim, kSnappy through the framing decoder —
        # so healthy reference shards stream
        # bitwise-identically to `recordio_reader_creator` under every
        # policy
        hdr = f.read(16)
        if len(hdr) < 16:
            raise _ShardTorn("truncated reference chunk header")
        num, checksum, compressor, csize = struct.unpack("<IIII", hdr)
        if csize >= MAX_CHUNK_BYTES:
            raise _ShardTorn("implausible reference chunk size %d"
                             % csize)
        stored = f.read(csize)
        if len(stored) < csize:
            raise _ShardTorn("truncated reference chunk payload")
        if force_corrupt or zlib.crc32(stored) != checksum:
            raise _ChunkDamage("crc", num, "reference chunk CRC mismatch"
                               if not force_corrupt
                               else "injected CRC failure "
                                    "(data_corrupt_shard)")
        if compressor == 0:  # kNoCompress
            return stored, num
        if compressor == 1:  # kSnappy (framing format)
            payload = _snappy_framed_uncompress(stored)
            if payload is None:
                raise _ChunkDamage("framing", num,
                                   "snappy framed stream damaged")
            return payload, num
        # kGzip is unimplemented in the reference too — the scanner
        # rejects it identically
        raise _ChunkDamage("framing", num,
                           "unsupported reference compressor %d"
                           % compressor)
    raise _ShardTorn("bad chunk magic 0x%08x" % magic)


def _split_records(payload, num_records):
    """Split a verified chunk payload into records. Returns (records,
    damage) where damage is a _ChunkDamage for a framing overrun (the
    already-split prefix is still good)."""
    records = []
    off, size = 0, len(payload)
    while off < size:
        if off + 4 > size:
            return records, _ChunkDamage(
                "framing", num_records - len(records),
                "record length header overruns the chunk")
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        if off + n > size:
            return records, _ChunkDamage(
                "framing", num_records - len(records),
                "record payload overruns the chunk (len=%d)" % n)
        records.append(payload[off:off + n])
        off += n
    return records, None


class RecordIOScanner:
    """Record-by-record reader of a RecordIO file (``native/recordio.cc``
    Scanner), on the chunk decoder above. A tail shorter than a chunk
    magic is a clean end, as for the native scanner; any other damage (a
    bad magic, a short header or payload, a declared size past 1 GiB, a
    CRC or deflate failure, a record overrunning its chunk, an empty
    chunk) raises the native scanner's -2 verdict as ``IOError``, after
    the records before it."""

    def __init__(self, path):
        try:
            self._f = open(path, "rb")
        except OSError:
            raise IOError("cannot open %s" % path)

    def __iter__(self):
        while True:
            try:
                loaded = _read_chunk(self._f)
            except _ShardTorn as torn:
                if torn.sub_magic:
                    return
                raise IOError("corrupt recordio chunk (CRC)") from None
            except _ChunkDamage:
                raise IOError("corrupt recordio chunk (CRC)") from None
            if loaded is None:
                return
            records, damage = _split_records(*loaded)
            yield from records
            if damage is not None or not records:
                raise IOError("corrupt recordio chunk (CRC)")

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
