"""The LZ77 stage of the encode: the token writer (lz77.cpp:53-102
format), the port's copy of jampack_tpu/stages/lz77.py::write_token, and
the stage's finder dispatch.  The store framing writes one end token
(offset 0) ahead of the raw bytes.

    byte  MMMMM_LLL   match-MIN_MATCH (5 bits, 31 = extend) | literal (3 bits, 7 = extend)
    leb128 offset
    [leb128 match-MIN_MATCH-31  if M field == 31]
    [leb128 literal-7           if L field == 7]
"""

import numpy as np

from ..format.constants import LZ_MIN_MATCH
from ..format.varint import encode_leb128
from ..runtime.options import LZ_MODE_STORE


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


def lz_encode(data, mode: int) -> np.ndarray:
    """The LZ77 stage of `data` by finder `mode`, as the JAX package's
    engines dispatch it (jampack_tpu/runtime/engines.py::NativeEngine.
    lz_encode): 3 (store) the end token ahead of the raw bytes, 0 the
    dedupe, 1 the hash-chain and 2 the suffix-array finder of the native
    copy (jampack_tpu_torch/native)."""
    data = np.asarray(data, dtype=np.uint8)
    if mode == LZ_MODE_STORE:
        head = np.frombuffer(write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0),
                             np.uint8)
        return np.concatenate([head, data])
    from .. import native

    return native.lz_encode(data, mode)
