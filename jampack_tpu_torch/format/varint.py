"""LEB128-with-carry variable length integers.

Nonstandard big-endian 7-bit-group varint where the terminator flag 0x80 sits
on the LAST byte and each encoded length maps a disjoint, cumulative value
range (so e.g. two-byte codes start at 127 rather than overlapping one-byte
codes).  Format-visible: used by ANS chunk headers and LZ77 tokens.

Reference behavior: utils.cpp:22-90, range constants utils.hpp:19-22.
"""

# Cumulative range bases: values below CONSTANTS[k] encode in k+1 bytes.
CONSTANTS = (
    0xFF >> 1,
    (0xFFFF >> 2) + (0xFF >> 1),
    (0xFFFFFF >> 3) + (0xFFFF >> 2) + (0xFF >> 1),
    (0xFFFFFFFF >> 4) + (0xFFFFFF >> 3) + (0xFFFF >> 2) + (0xFF >> 1),
)


def size_of_value(val: int) -> int:
    """Number of bytes encode_leb128 will use for val."""
    if val < 0:
        raise ValueError("cannot size a negative number")
    for i, c in enumerate(CONSTANTS):
        if val < c:
            return i + 1
    return 5


def encode_leb128(val: int) -> bytes:
    """Encode a non-negative int; returns the encoded bytes."""
    if val < 0:
        raise ValueError("cannot encode a negative number")
    if val >= CONSTANTS[3] + (1 << 35):
        # the 5-byte payload carries 35 bits past the length-4 base; beyond
        # that the masks below would silently truncate (the reference's
        # 32-bit Index type cannot reach this range at all)
        raise ValueError("value out of varint range")
    n = size_of_value(val)
    if n > 1:
        val -= CONSTANTS[n - 2]
    out = bytearray(n)
    for k in range(n - 1):
        out[k] = (val >> (7 * (n - 1 - k))) & 0x7F
    out[n - 1] = (val & 0x7F) | 0x80
    return bytes(out)


def decode_leb128(buf, pos: int = 0):
    """Decode one varint from buf at pos; returns (value, new_pos)."""
    d = 0
    val = 0
    while (buf[pos + d] & 0x80) == 0:
        if d >= 4:
            raise ValueError("LEB128 value longer than the type supports")
        val = (val << 7) | buf[pos + d]
        d += 1
    val = (val << 7) | (buf[pos + d] & 0x7F)
    if d > 0:
        val += CONSTANTS[d - 1]
    return val, pos + d + 1
