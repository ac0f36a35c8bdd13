"""The sealed model frame of ``__model__`` (parity: the JAX package's
``core/native.py`` `program_seal` / `program_unseal` :155-190, their
pure-Python branch): a 20-byte little-endian header — magic 0x50545047,
format version 1, payload length (u64), CRC32 of the payload — then the
payload. The port reads and writes the frame in Python; it loads no
native library."""

import struct
import zlib

__all__ = ["is_sealed", "program_seal", "program_unseal"]

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
