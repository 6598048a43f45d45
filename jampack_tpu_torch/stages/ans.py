"""Entropy-stage framing: the chunk header (256 LEB128 rank freqs + olen +
clen + rlen) and the JTX lane table.  The port's copy of those functions
of jampack_tpu/stages/ans.py (ans.cpp:14-302 semantics)."""

from ..format.constants import ANS_CHUNK_SIZE
from ..format.varint import decode_leb128, encode_leb128


def write_chunk_header(freqs, olen: int, clen: int, rlen: int) -> bytes:
    out = bytearray()
    for f in freqs:
        out += encode_leb128(int(f))
    out += encode_leb128(olen)
    out += encode_leb128(clen)
    out += encode_leb128(rlen)
    return bytes(out)


def read_chunk_header(buf, pos: int):
    freqs = [0] * 256
    for i in range(256):
        freqs[i], pos = decode_leb128(buf, pos)
    olen, pos = decode_leb128(buf, pos)
    clen, pos = decode_leb128(buf, pos)
    rlen, pos = decode_leb128(buf, pos)
    if not (0 <= olen <= ANS_CHUNK_SIZE) or not (0 <= rlen <= ANS_CHUNK_SIZE):
        raise ValueError("misaligned or corrupt chunk header")
    return freqs, olen, clen, rlen, pos


def lane_rlen(rlen: int, lanes: int, lane: int) -> int:
    """Symbols owned by `lane` when rlen symbols are dealt round-robin."""
    return (rlen - lane + lanes - 1) // lanes


def read_lane_table(buf, pos: int, rlen: int, lanes: int):
    """Per-lane payload lengths prefixed to a JTX wide-interleave payload."""
    lane_clens = []
    for _ in range(lanes):
        c, pos = decode_leb128(buf, pos)
        lane_clens.append(c)
    return lane_clens, pos
