"""Block-level archive framing.

Every compressed block is self-contained:

    magic "JAM" | crc:u32le | csize:u32le | blocksize:u32le | payload[csize]

`blocksize` is the *configured* block size (the maximum raw size), not the
raw size of this particular block; the raw size is recovered by decoding.
This framing is what makes the format embarrassingly parallel and
block-granular restartable.

Reference behavior: jampack.cpp:122-164 (CompWriteBlock/DecompReadBlock).
"""

import struct
from dataclasses import dataclass

from .constants import BWT_UNITS, MAGIC, MIN_BLOCKSIZE, MAX_BLOCKSIZE

# Native-mode container (JTX v2): same framing plus two stream-parameter
# words (the BWT anchor count and the rANS lane-interleave width).  Only
# this framework reads it; the default "JAM" framing stays byte-compatible
# with the reference.  History: v1 carried a single '<i' ext word (units
# only); the one-time pre-format-lock growth to '<ii' happened before the
# .jtx golden fixture locked the bytes.  Any future ext-layout change MUST
# bump this magic — the ext words carry no version field of their own.
MAGIC_NATIVE = b"JTX"
# JT3: the v3 native container — same framing, THREE stream-parameter ext
# words (units, lanes, lpx_spans).  Ext layout changes bump the magic, so
# JTX archives (two ext words) keep parsing forever.
MAGIC_NATIVE3 = b"JT3"
MAX_RANS_LANES = 4096  # mirrored by runtime.pipeline.validate_rans_lanes
MAX_LPX_SPANS = 1 << 16
DEFAULT_LPX_SPANS = 4  # the reference's format-fixed split (lpx.cpp:150)
# lpx_spans == 0 in a JT3 ext word means the Lpx stage was SKIPPED for this
# block (round 4): the encoder sets it when its measured Lpx gain is below
# threshold, removing the decode chain's dominant serial-walk term.  0 was
# never a valid span count, so every JT3 stream ever written still parses.

_HEADER = struct.Struct("<3sIii")
_NATIVE_EXT = struct.Struct("<ii")
_NATIVE_EXT3 = struct.Struct("<iii")
HEADER_SIZE = _HEADER.size  # 15


@dataclass
class BlockHeader:
    crc: int
    csize: int
    blocksize: int
    units: int = BWT_UNITS
    lanes: int = 0
    lpx_spans: int = DEFAULT_LPX_SPANS


def is_native(units: int, lanes: int = 0, lpx_spans: int = DEFAULT_LPX_SPANS) -> bool:
    """True when the stream parameters require a native container."""
    return (units != BWT_UNITS or lanes >= 2
            or lpx_spans != DEFAULT_LPX_SPANS)


def header_size(units: int, lanes: int = 0,
                lpx_spans: int = DEFAULT_LPX_SPANS) -> int:
    """On-disk header bytes for a block with these stream parameters."""
    if lpx_spans != DEFAULT_LPX_SPANS:
        return HEADER_SIZE + _NATIVE_EXT3.size
    return HEADER_SIZE + (_NATIVE_EXT.size if is_native(units, lanes) else 0)


def write_block(out, crc: int, payload: bytes, blocksize: int,
                units: int = BWT_UNITS, lanes: int = 0,
                lpx_spans: int = DEFAULT_LPX_SPANS) -> None:
    v3 = lpx_spans != DEFAULT_LPX_SPANS
    native = is_native(units, lanes, lpx_spans)
    magic = (MAGIC_NATIVE3 if v3 else MAGIC_NATIVE) if native else MAGIC
    out.write(_HEADER.pack(magic, crc & 0xFFFFFFFF, len(payload), blocksize))
    if v3:
        out.write(_NATIVE_EXT3.pack(units, lanes, lpx_spans))
    elif native:
        out.write(_NATIVE_EXT.pack(units, lanes))
    out.write(payload)


def read_block(inp, want_payload: bool = True):
    """Read one framed block; returns (BlockHeader, payload) or None at EOF.

    want_payload=False skips the payload (seek on seekable streams) and
    returns payload=None — cheap block enumeration for multi-host work
    division and `jam i`."""
    raw = inp.read(HEADER_SIZE)
    if len(raw) == 0:
        return None
    if len(raw) < HEADER_SIZE:
        raise ValueError("truncated block header")
    magic, crc, csize, blocksize = _HEADER.unpack(raw)
    if (
        magic not in (MAGIC, MAGIC_NATIVE, MAGIC_NATIVE3)
        or blocksize < MIN_BLOCKSIZE
        or blocksize > MAX_BLOCKSIZE
        or csize < 0
        or csize > MAX_BLOCKSIZE
    ):
        raise ValueError("refusing to read from corrupt header")
    units, lanes, lpx_spans = BWT_UNITS, 0, DEFAULT_LPX_SPANS
    if magic in (MAGIC_NATIVE, MAGIC_NATIVE3):
        ext_s = _NATIVE_EXT3 if magic == MAGIC_NATIVE3 else _NATIVE_EXT
        ext = inp.read(ext_s.size)
        if len(ext) < ext_s.size:
            raise ValueError("truncated native header")
        if magic == MAGIC_NATIVE3:
            units, lanes, lpx_spans = ext_s.unpack(ext)
        else:
            units, lanes = ext_s.unpack(ext)
        if units < 1 or units > (1 << 24):
            raise ValueError("corrupt native anchor count")
        if lanes < 0 or lanes == 1 or lanes > MAX_RANS_LANES:
            raise ValueError("corrupt native lane count")
        if lpx_spans < 0 or lpx_spans > MAX_LPX_SPANS:
            raise ValueError("corrupt native lpx span count")
    if not want_payload:
        # forward skip: seek when possible, bounded read otherwise
        if inp.seekable():
            pos = inp.tell()
            inp.seek(0, 2)
            end = inp.tell()
            if end - pos < csize:
                raise ValueError("truncated block payload")
            inp.seek(pos + csize)
        else:
            skipped = len(inp.read(csize))
            if skipped < csize:
                raise ValueError("truncated block payload")
        return BlockHeader(crc, csize, blocksize, units, lanes, lpx_spans), None
    payload = inp.read(csize)
    if len(payload) < csize:
        raise ValueError("truncated block payload")
    return BlockHeader(crc, csize, blocksize, units, lanes, lpx_spans), payload
