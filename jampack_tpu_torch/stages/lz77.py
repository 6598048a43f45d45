"""LZ77 stage: token codec, dedupe match finder, and decoder.

Token format (format-visible, lz77.cpp:53-102):

    byte  MMMMM_LLL   match-MIN_MATCH (5 bits, 31 = extend) | literal (3 bits, 7 = extend)
    leb128 offset
    [leb128 match-MIN_MATCH-31  if M field == 31]
    [leb128 literal-7           if L field == 7]
    literal bytes follow the token

End of stream: a token with offset == 0; the rest of the input is raw bytes.

The decoder is exact.  The encoders are format-producers (any valid token
stream decodes identically in the reference), replicating the reference's
match-finder behaviors: m0 fast dedupe here; the m1 hash-chain and m2
suffix-array anti-context finders live in the native C++ engine.

Reference behavior: lz77.cpp:126-714.
"""

import numpy as np

from ..format.constants import (
    GOLDEN_PRIME,
    LZ_DUPE_MATCH,
    LZ_HASH_BITS,
    LZ_HASH_SIZE,
    LZ_MIN_MATCH,
)
from ..format.varint import decode_leb128, encode_leb128, size_of_value

_M32 = 0xFFFFFFFF


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


def read_token(buf, pos: int):
    token = buf[pos]
    pos += 1
    offset, pos = decode_leb128(buf, pos)
    match = token >> 3
    if match == 31:
        ext, pos = decode_leb128(buf, pos)
        match = ext + 31
    match += LZ_MIN_MATCH
    literal = token & 7
    if literal == 7:
        ext, pos = decode_leb128(buf, pos)
        literal = ext + 7
    return match, literal, offset, pos


def token_cost(match: int, literal: int, offset: int) -> int:
    cost = 1
    if (match - LZ_MIN_MATCH) >= 31:
        cost += size_of_value(match - LZ_MIN_MATCH - 31)
    if literal >= 7:
        cost += size_of_value(literal - 7)
    cost += size_of_value(offset)
    return cost


def compressible(match: int, literal: int, offset: int) -> float:
    """Compression ratio of a candidate token (lz77.cpp:107-119)."""
    cost = token_cost(match, literal, offset)
    if match < LZ_MIN_MATCH or match <= cost:
        return 0.0
    return match / cost


def lz77_dedupe_encode(data: np.ndarray) -> np.ndarray:
    """m0 fast dedupe: rolling-context hash, only matches >= 256 accepted.

    Replicates lz77.cpp:544-625 with the out-of-tail context reads defined
    as zero (the reference reads unwritten buffer slack there; candidate
    choice differs at most in the last 256 bytes, which stays format-valid).
    """
    t = np.asarray(data, dtype=np.uint8)
    n = t.size
    # slack so the context reads at pos+DUPE_MATCH never go out of bounds
    tt = np.zeros(n + LZ_DUPE_MATCH + 8, dtype=np.uint8)
    tt[:n] = t
    b = tt.tobytes()
    table = np.zeros(LZ_HASH_SIZE, dtype=np.int64)

    shift = 1 if LZ_DUPE_MATCH > 32 else 32 // LZ_DUPE_MATCH
    out = bytearray()
    cxt = 0
    pos = 0
    lit = 0

    def _hash(v):
        return ((v * GOLDEN_PRIME) & _M32) >> (32 - LZ_HASH_BITS)

    while pos < n:
        back = 0
        length = 0
        off = 0
        found = False

        h = _hash(cxt)
        cand = int(table[h])
        if cand > 0:
            cpos = pos
            ppos = cand
            mb = 0
            while b[ppos - mb - 1] == b[cpos - mb - 1] and (ppos - mb - 1) > 0 and mb < lit:
                mb += 1
            mf = 0
            while b[ppos + mf] == b[cpos + mf] and (cpos + mf + LZ_MIN_MATCH) < n:
                mf += 1
            if (mf + mb) >= LZ_DUPE_MATCH:
                found = True
                length = mf
                back = mb
                off = cpos - ppos

        if found:
            length += back
            lit -= back
            pos -= back
            out += write_token(length, lit, off)
            out += b[pos - lit : pos]
            for i in range(length):
                h = _hash(cxt)
                table[h] = pos
                cxt = ((cxt << shift) ^ b[pos + LZ_DUPE_MATCH + i]) & _M32
            pos += length
            lit = 0

        h = _hash(cxt)
        table[h] = pos
        cxt = ((cxt << shift) ^ b[pos + LZ_DUPE_MATCH]) & _M32
        pos += 1
        lit += 1

    out += write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0)
    out += b[pos - lit : min(pos, n)]
    return np.frombuffer(bytes(out), dtype=np.uint8)


def lz77_store_encode(data: np.ndarray) -> np.ndarray:
    """m3 "store": the end token followed by the whole input as the raw
    tail (the decoder treats everything after an offset-0 token as one
    literal, lz77.cpp:688,705).  Deterministic and engine-independent —
    the mode that makes a fully device-resident encode chain possible
    (every stage length becomes a static function of the block size).
    The output stays decodable by the reference binary; mode 3 itself is
    an extension of this framework (the reference CLI only has -m0..2)."""
    t = np.asarray(data, dtype=np.uint8)
    head = np.frombuffer(
        write_token(LZ_MIN_MATCH, LZ_MIN_MATCH, 0), dtype=np.uint8)
    return np.concatenate([head, t])


def lz77_decode(data: np.ndarray) -> np.ndarray:
    buf = np.asarray(data, dtype=np.uint8).tobytes()
    n = len(buf)
    out = bytearray()
    pos = 0
    while pos < n:
        match, literal, offset, pos = read_token(buf, pos)
        if offset:
            out += buf[pos : pos + literal]
            pos += literal
            if pos >= n or len(out) - offset < 0:
                raise ValueError("invalid lz77 token")
            # forward overlap-safe copy (chunked: each pass can copy at most
            # `offset` bytes before re-reading freshly written output)
            remaining = match
            while remaining > 0:
                start = len(out) - offset
                span = min(offset, remaining)
                out += out[start : start + span]
                remaining -= span
        else:
            out += buf[pos:]
            break
    return np.frombuffer(bytes(out), dtype=np.uint8)
