"""The LZ77 token writer (lz77.cpp:53-102 format): the port's copy of
jampack_tpu/stages/lz77.py::write_token.  The store framing writes one end
token (offset 0) ahead of the raw bytes.

    byte  MMMMM_LLL   match-MIN_MATCH (5 bits, 31 = extend) | literal (3 bits, 7 = extend)
    leb128 offset
    [leb128 match-MIN_MATCH-31  if M field == 31]
    [leb128 literal-7           if L field == 7]
"""

from ..format.constants import LZ_MIN_MATCH
from ..format.varint import encode_leb128


def write_token(match: int, literal: int, offset: int) -> bytes:
    m = match - LZ_MIN_MATCH
    out = bytearray()
    out.append((min(m, 31) << 3) | min(literal, 7))
    out += encode_leb128(offset)
    if min(m, 31) == 31:
        out += encode_leb128(m - 31)
    if min(literal, 7) == 7:
        out += encode_leb128(literal - 7)
    return bytes(out)
