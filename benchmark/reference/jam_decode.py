"""A plain decoder of JAM archives: the check behind a backup's `correct`.

It decodes archives as the reference's format defines them (Jampack v0.80,
github.com/loxxous/Jampack) and raises on any fault it can see:

    block:  "JAM" | crc u32 | csize i32 | blocksize i32 | payload[csize]
            (JTX adds the anchor count and the rANS lanes, JT3 the Lpx
            spans too; JAM means 120 anchors, one chain a chunk, 4 spans)
    payload, decoded in this order:
      entropy   per chunk: 256 LEB128 rank frequencies, olen, clen, rlen,
                then the chain: four interleaved 32-bit rANS states that
                decode two (exponent, mantissa) pairs a 16-bit symbol with
                a bank of adaptive (exponent, mantissa 0-1) and quasi-static
                (mantissa 2-7) models; RLE0 back to olen bytes, then the
                sorted rank lists (SRC) back to the bytes
      BWT       the inverse over `units` anchor chains
      LZ77      the configured pass
      Lpx       over `spans` equal spans (skipped where JT3 says 0)
      filters   per 64 KiB: (type, width), then delta / LPC / inline delta
      LZ77      the dedupe pass
      checksum  the block's, against the header's crc

It is written from the format's description and imports nothing of the
program.  The serial walks (rANS, SRC, Lpx, LPC) are plain Python over one
chain at a time; the rest is NumPy.  The checksum's serial lanes are
vectorised exactly: its multiplier is odd, so the low three bits of a
lane's state follow an 8-state machine that a block of words composes,
and the state is the initial one XOR every word's term.

decode(archive) decodes in this process.  verify(archive, raw, ...)
checks an archive file against the raw file it was written from: every
block's framing, entropy framing and checksum, and a full decode of the
blocks it is given, in worker processes; it returns what it found in each
block.  The command line of this module
is one such worker:

    python -m benchmark.reference.jam_decode ARCHIVE RAW BLOCKSIZE [+]INDEX...

It prints one JSON line a block (+: decoded in full): index, raw bytes,
bytes wrong, error, seconds.

Departures from the reference's semantics: none.  Where the reference
reads past a buffer on a corrupt stream, this raises.
"""

import bisect
import io
import json
import os
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# framing
_HEADER = struct.Struct("<3sIii")
_EXT = {b"JAM": None, b"JTX": struct.Struct("<ii"),
        b"JT3": struct.Struct("<iii")}
UNITS, SPANS = 120, 4
MIN_BLOCK, MAX_BLOCK = 1 << 20, 1000 << 20

# LEB128 with carry: big-endian 7-bit groups, 0x80 on the last byte, each
# length a range of its own
_LEB_BASE = (0x7F, 0x3FFF + 0x7F, 0x1FFFFF + 0x3FFF + 0x7F,
             0xFFFFFFF + 0x1FFFFF + 0x3FFF + 0x7F)

# entropy stage
CHUNK = 1 << 20
RANS_L = 1 << 23
EXPONENT = (0, 2, 4, 8, 16, 32, 64, 128, 257)
SCALE = 1 << 16
QUASI_FIRST = 8  # symbols before a quasi-static model's first rescale
QUASI_LAST = 64 << 10  # the rescale period doubles up to this

# filters
FILTER_BLOCK = 64 << 10
FILTER_TYPES, FILTER_WIDTH = 3, 32

# Lpx
LPX_MAX_THRESHOLD, LPX_MIN_THRESHOLD = 128, 4
LPX_MAX_RECORD = 64 << 10

GOLDEN = 0x9E3779B1
M32 = 0xFFFFFFFF


class CorruptArchive(ValueError):
    pass


def leb128(buf, pos: int):
    """(value, next position) of the varint at buf[pos]."""
    d = val = 0
    while not buf[pos + d] & 0x80:
        if d >= 4:
            raise CorruptArchive("LEB128 value too long")
        val = (val << 7) | buf[pos + d]
        d += 1
    val = (val << 7) | (buf[pos + d] & 0x7F)
    return val + (_LEB_BASE[d - 1] if d else 0), pos + d + 1


# ---------------------------------------------------------------- framing

def read_header(f, blocksize: int = None):
    """(crc, blocksize, units, lanes, spans, csize) of the block at f's
    position, or None at the end.  With `blocksize`, the header has to
    state that block size; without, one the format allows."""
    raw = f.read(_HEADER.size)
    if not raw:
        return None
    if len(raw) < _HEADER.size:
        raise CorruptArchive("truncated block header")
    size = blocksize
    magic, crc, csize, blocksize = _HEADER.unpack(raw)
    if (magic not in _EXT or not 0 <= csize <= MAX_BLOCK
            or (blocksize != size if size else
                not MIN_BLOCK <= blocksize <= MAX_BLOCK)):
        raise CorruptArchive("corrupt block header")
    units, lanes, spans = UNITS, 0, SPANS
    ext = _EXT[magic]
    if ext is not None:
        words = f.read(ext.size)
        if len(words) < ext.size:
            raise CorruptArchive("truncated block header")
        units, lanes, *rest = ext.unpack(words)
        spans = rest[0] if rest else SPANS
        if (not 1 <= units <= 1 << 24 or lanes < 0 or lanes == 1
                or lanes > 4096 or not 0 <= spans <= 1 << 16):
            raise CorruptArchive("corrupt block header")
    return crc, blocksize, units, lanes, spans, csize


def index(path: str, blocksize: int = None) -> list:
    """[(offset of the payload, header)] of every block of an archive
    file (`blocksize` as read_header's)."""
    out = []
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        while (h := read_header(f, blocksize)) is not None:
            at = f.tell()
            if at + h[-1] > size:
                raise CorruptArchive("truncated block payload")
            out.append((at, h))
            f.seek(at + h[-1])
    return out


# --------------------------------------------------------------- checksum

# the next low three bits of a lane's state, by (word & 7, bits)
_LOW = np.array([[(s ^ (v + (1 << s))) & 7 for s in range(8)]
                 for v in range(8)], np.uint8).reshape(-1)
_RUN = 256  # words a composed step covers


def _lane(acc: int, words: np.ndarray) -> int:
    """A lane's state after folding `words` (uint32) into `acc`:
    acc ^= ((w + (1 << (acc & 7))) * GOLDEN) mod 2**32, word by word."""
    n = words.size
    if n == 0:
        return acc
    pad = -n % _RUN
    v = np.concatenate([words & 7, np.zeros(pad, np.uint32)]).astype(
        np.intp).reshape(-1, _RUN) * 8
    real = np.arange(n + pad).reshape(-1, _RUN) < n
    # each run's map of the three bits, from every start
    maps = np.tile(np.arange(8, dtype=np.intp), (v.shape[0], 1))
    for j in range(_RUN):
        step = _LOW[v[:, j:j + 1] + maps]
        maps = np.where(real[:, j:j + 1], step, maps)
    starts = np.empty(v.shape[0], np.intp)
    s = acc & 7
    for r, m in enumerate(maps.tolist()):
        starts[r] = s
        s = m[s]
    low = np.empty(v.shape, np.intp)
    s = starts
    for j in range(_RUN):
        low[:, j] = s
        s = np.where(real[:, j], _LOW[v[:, j] + s], s)
    bit = np.uint64(1) << low.reshape(-1)[:n].astype(np.uint64)
    terms = (words.astype(np.uint64) + bit) * np.uint64(GOLDEN)
    return acc ^ int(np.bitwise_xor.reduce(terms & np.uint64(M32)))


def checksum(data) -> int:
    """The block checksum: four lanes over the big-endian words of each
    16-byte stride but the last (full or not), whose bytes fold into lane
    0, XOR-merged."""
    buf = np.frombuffer(memoryview(data), np.uint8)
    n = max(0, (buf.size - 1) // 16)
    words = buf[:n * 16].reshape(n, 4, 4).astype(np.uint32)
    words = ((words[:, :, 0] << 24) | (words[:, :, 1] << 16)
             | (words[:, :, 2] << 8) | words[:, :, 3])
    lanes = [_lane(s, np.ascontiguousarray(words[:, k]))
             for k, s in enumerate((3, 0, 0, 0))]
    acc = lanes[0]
    for b in buf[n * 16:].tolist():
        acc ^= ((b + (1 << (acc & 7))) * GOLDEN) & M32
    return acc ^ lanes[1] ^ lanes[2] ^ lanes[3]


# ---------------------------------------------------------- entropy stage

def _mix(alpha: int) -> list:
    """The adaptive model's target cumulative table for each symbol."""
    return [[j + (SCALE - alpha if j > s else 0) for j in range(alpha + 1)]
            for s in range(alpha)]


_MIX8 = _mix(8)


def _flat(alpha: int) -> list:
    scale = SCALE // alpha
    f = [scale] * alpha
    f[0] += SCALE - scale * alpha
    return _cumulative(f)


def _cumulative(f: list) -> list:
    out, t = [0], 0
    for v in f:
        t += v
        out.append(t)
    return out


def _rescale(counts: list) -> list:
    """A quasi-static model's new cumulative table from its counts."""
    alpha = len(counts)
    total, log = sum(counts), 0
    while (total >> log) + alpha > SCALE:
        log += 1
    f = [(c >> log) + 1 for c in counts]
    total = sum(f)
    f = [(v << 16) // total for v in f]
    f[0] += SCALE - sum(f)
    return _cumulative(f)


# The exponent model's nine boundaries packed in one integer, 20 bits
# each: one comparison of every boundary with a state's low 16 bits, and
# one update of every boundary toward its target, is a handful of integer
# operations (each lane kept non-negative by a bias of 2**17).
_W = 20
_REP = sum(1 << (_W * k) for k in range(9))
_BIAS = (1 << 17) * _REP
_LANE = (1 << 17) - 1
_KEEP = ((1 << 13) - 1) * _REP
_HALF = (1 << 12) * _REP
_SHIFT = [_W * e for e in range(9)]


def _pack(values) -> int:
    return sum(v << (_W * k) for k, v in enumerate(values))


_TARGET = [_pack(row) + _BIAS for row in _MIX8]


def rans_chain(buf, p: int, rlen: int) -> list:
    """The rlen 16-bit symbols of the chain whose four states start at
    buf[p]."""
    a = int.from_bytes(buf[p:p + 4], "little")
    b = int.from_bytes(buf[p + 4:p + 8], "little")
    c = int.from_bytes(buf[p + 8:p + 12], "little")
    d = int.from_bytes(buf[p + 12:p + 16], "little")
    p += 16
    cfe = _pack(_flat(8))
    c0 = c1 = SCALE >> 1  # the two binary mantissa models' one boundary
    alphas = [0, 0] + [EXPONENT[e + 1] - EXPONENT[e] for e in range(2, 8)]
    cum = [_flat(n) if n else None for n in alphas]
    counts = [[0] * n for n in alphas]
    period = [QUASI_FIRST] * 8
    left = [QUASI_FIRST + 1] * 8  # symbols to the next rescale
    out = [0] * rlen
    right = bisect.bisect_right
    L = RANS_L
    for i in range(rlen):
        # the exponent, from the state in turn
        r = a & 0xFFFF
        e = ((r * _REP + _BIAS - cfe) & _BIAS).bit_count() - 1
        sh = _SHIFT[e]
        lo = (cfe >> sh) & _LANE
        x = ((((cfe >> (sh + _W)) & _LANE) - lo) * (a >> 16) + r - lo) & M32
        if x < L:
            x = (x << 8) | buf[p]
            p += 1
            if x < L:
                x = (x << 8) | buf[p]
                p += 1
        cfe += (((_TARGET[e] - cfe) >> 5) & _KEEP) - _HALF
        a, b, c, d = b, c, d, x
        # the mantissa, from the next state, in the exponent's model
        r = a & 0xFFFF
        if e > 1:
            cq = cum[e]
            m = right(cq, r) - 1
            lo = cq[m]
            x = ((cq[m + 1] - lo) * (a >> 16) + r - lo) & M32
            counts[e][m] += 16
            left[e] -= 1
            if not left[e]:
                cum[e] = _rescale(counts[e])
                counts[e] = [0] * alphas[e]
                period[e] = min(period[e] << 1, QUASI_LAST)
                left[e] = period[e] + 1
        elif e:
            if r >= c1:
                m = 1
                x = ((SCALE - c1) * (a >> 16) + r - c1) & M32
                c1 += (1 - c1) >> 5
            else:
                m = 0
                x = (c1 * (a >> 16) + r) & M32
                c1 += (SCALE - 1 - c1) >> 5
        else:
            if r >= c0:
                m = 1
                x = ((SCALE - c0) * (a >> 16) + r - c0) & M32
                c0 += (1 - c0) >> 5
            else:
                m = 0
                x = (c0 * (a >> 16) + r) & M32
                c0 += (SCALE - 1 - c0) >> 5
        if x < L:
            x = (x << 8) | buf[p]
            p += 1
            if x < L:
                x = (x << 8) | buf[p]
                p += 1
        a, b, c, d = b, c, d, x
        out[i] = EXPONENT[e] + m
    if not a == b == c == d == L:
        raise CorruptArchive("invalid rANS state")
    return out


def rle0(syms, olen: int) -> np.ndarray:
    """RLE0's inverse: a symbol s > 1 is the byte s - 1; a maximal run of
    symbols 0 and 1 is a binary number, with a leading 1 implied, one more
    than the count of zero bytes it stands for."""
    s = np.asarray(syms, np.int64)
    if s.size == 0:
        if olen:
            raise CorruptArchive("rle mismatch")
        return np.zeros(0, np.uint8)
    bit = s <= 1
    lit = ~bit
    head = lit | (bit & ~np.concatenate([[False], bit[:-1]]))
    starts = np.flatnonzero(head)
    tok = np.cumsum(head) - 1  # each symbol's token: a literal or a run
    bits = np.bincount(tok[bit], minlength=starts.size)
    place = bits[tok] - 1 - (np.arange(s.size) - starts[tok])
    value = (np.int64(1) << bits) + np.bincount(
        tok[bit], weights=(s << np.maximum(place, 0))[bit],
        minlength=starts.size).astype(np.int64)
    size = np.where(lit[starts], 1, value - 1)
    if int(size.sum()) != olen:
        raise CorruptArchive("rle mismatch")
    out = np.zeros(olen, np.uint8)
    at = np.cumsum(size) - size
    out[at[lit[starts]]] = (s[lit] - 1).astype(np.uint8)
    return out


def src(ranks: np.ndarray, freqs: list) -> bytes:
    """Sorted rank coding's inverse: the symbols in falling frequency
    (ties: the lower first) own consecutive buckets of ranks; the rank at
    the current symbol's bucket cursor moves it that far into the
    move-to-front list, whose head is the next symbol."""
    n = ranks.size
    if sum(freqs) != n:
        raise CorruptArchive("invalid decoder frequencies")
    order = sorted((s for s in range(256) if freqs[s]),
                   key=lambda s: (-freqs[s], s))
    unique = len(order)
    rk = ranks.tobytes()
    cursor, end = [0] * 256, [0] * 256
    r2s = bytearray(256)
    pos = 0
    for s in order:
        r2s[rk[pos]] = s
        cursor[s] = pos + 1
        pos += freqs[s]
        end[s] = pos
    out = bytearray(n)
    sym = r2s[0]
    for i in range(n):
        out[i] = sym
        k = cursor[sym]
        if k < end[sym]:
            rank = rk[k]
            cursor[sym] = k + 1
            if rank:
                r2s[0:rank] = r2s[1:rank + 1]
                r2s[rank] = sym
                sym = r2s[0]
        elif unique > 0:
            unique -= 1
            k = max(1, unique)
            r2s[0:k] = r2s[1:k + 1]
            sym = r2s[0]
    return bytes(out)


def entropy(payload, lanes: int) -> np.ndarray:
    """The entropy stage's inverse over a block's payload."""
    parts, pos = [], 0
    while pos < len(payload):
        freqs = [0] * 256
        for s in range(256):
            freqs[s], pos = leb128(payload, pos)
        olen, pos = leb128(payload, pos)
        clen, pos = leb128(payload, pos)
        rlen, pos = leb128(payload, pos)
        if olen > CHUNK or rlen > CHUNK:
            raise CorruptArchive("corrupt chunk header")
        if lanes >= 2:
            table, p = [], pos
            for _ in range(lanes):
                v, p = leb128(payload, p)
                table.append(v)
            if sum(table) != clen - (p - pos):
                raise CorruptArchive("corrupt lane table")
            syms = np.empty(rlen, np.int64)
            for k in range(lanes):
                syms[k::lanes] = rans_chain(payload, p,
                                            (rlen - k + lanes - 1) // lanes)
                p += table[k]
        else:
            syms = rans_chain(payload, pos, rlen)
        parts.append(src(rle0(syms, olen), freqs))
        pos += clen
    return np.frombuffer(b"".join(parts), np.uint8)


# -------------------------------------------------------------------- BWT

def inverse_bwt(buf: np.ndarray, units: int) -> np.ndarray:
    """The forward transform wrote the BWT of the first n - n % units
    bytes with the primary row left out (its first byte the text's last),
    the raw tail, and the +1-biased rows of `units` equally spaced
    suffixes; each anchor starts a chain of n // units LF steps."""
    n = buf.size - 4 * units
    if n < 0:
        raise CorruptArchive("BWT block shorter than its anchors")
    anchors = buf[n:].view("<i4").astype(np.int64)
    nlen = n - n % units
    out = np.empty(n, np.uint8)
    out[nlen:] = buf[nlen:n]
    if nlen:
        bwt = buf[:nlen]
        idx = int(anchors[0])
        if np.any((anchors < 0) | (anchors > nlen)):
            raise CorruptArchive("corrupt BWT anchor")
        rows = np.arange(nlen, dtype=np.int64)
        rows[idx:] += 1
        lf = rows[np.argsort(bwt, kind="stable")]
        step = nlen // units
        p = anchors
        chains = np.empty((units, step), np.uint8)
        for i in range(step):
            p = lf[p - 1]
            chains[:, i] = bwt[p - (p >= idx)]
        out[:nlen] = chains.reshape(-1)
    return out


# ------------------------------------------------------------------- LZ77

def lz77(buf: np.ndarray, cap: int) -> np.ndarray:
    """Tokens of a match length (5 bits, 31 extends), a literal count (3
    bits, 7 extends) and an offset, each literal run after its token; an
    offset of 0 ends the tokens and the rest is raw.  The output may not
    pass `cap`, the size of the reference's stage buffers."""
    data = buf.tobytes()
    n = len(data)
    out = bytearray()
    pos = 0
    while pos < n:
        token = data[pos]
        offset, pos = leb128(data, pos + 1)
        match = token >> 3
        if match == 31:
            ext, pos = leb128(data, pos)
            match += ext
        match += 4
        literal = token & 7
        if literal == 7:
            ext, pos = leb128(data, pos)
            literal += ext
        if not offset:
            out += data[pos:]
            break
        out += data[pos:pos + literal]
        pos += literal
        if pos >= n or len(out) < offset or len(out) + match > cap:
            raise CorruptArchive("invalid lz77 token")
        while match > 0:  # a copy may overlap what it writes
            start = len(out) - offset
            span = min(offset, match)
            out += out[start:start + span]
            match -= span
    return np.frombuffer(bytes(out), np.uint8)


# -------------------------------------------------------------------- Lpx

def _lpx_span(inp: bytes, out: bytearray, base: int, length: int) -> None:
    """One span's inverse: three order tables of 256 records (context,
    position, hits, misses, threshold) keyed by the byte `order` back;
    where the record of the current order and the last byte has more hits
    than its threshold and its position is under 64 KiB back, the coded
    bytes are XOR errors against the bytes that far back, up to and
    including the first nonzero one.  After each byte the record of the
    current order is updated, which may move the order, and a threshold
    of the new order's record for the same byte."""
    cx = [0] * 768
    at = [0] * 768
    hits = [0] * 768
    miss = [0] * 768
    thr = [LPX_MAX_THRESHOLD >> 1] * 768
    masks = (0, 0xFF, 0xFFFF, 0xFFFFFF)
    shifts = (0, 8, 16, 24)
    offs = (0, 0, 256, 512)  # the first record of each order's table
    cxt, order = 0, 3
    run, dist = False, 0
    for j in range(base, base + length):
        i = j - base
        if not run:
            k = offs[order] + (cxt & 0xFF)
            dist = (i - at[k]) & M32
            run = hits[k] > thr[k] and dist < LPX_MAX_RECORD
        if run:
            err = inp[j]
            byte = out[j - dist] ^ err
            run = not err
        else:
            byte = inp[j]
        out[j] = byte
        o = order
        lp = (cxt >> shifts[o]) & 0xFF
        k = offs[o] + lp
        if i > o:
            if cx[k] == cxt & masks[o]:
                hk = hits[k]
                dk = i - at[k]
                at[k] = i - o
                hits[k] = hk + 1
                miss[k] = 0
                kn = k
                if hk + 1 > (thr[k] << o) << 3 and o > 1:
                    order = o - 1
                    kn = offs[order] + lp
                if miss[kn] == 0 and hits[kn] > thr[kn] << 1:
                    if dk <= LPX_MIN_THRESHOLD:
                        bound = LPX_MIN_THRESHOLD
                    else:
                        upper = (max(dk, LPX_MIN_THRESHOLD)
                                 if hk < LPX_MAX_THRESHOLD else
                                 min(dk >> o, LPX_MAX_THRESHOLD >> o))
                        bound = upper if dk > upper else dk
                    thr[kn] += (bound - thr[kn]) >> order
            else:
                hits[k] >>= 2
                mk = miss[k] + 1
                miss[k] = mk
                cx[k] = cxt & masks[o]
                kn = k
                if o < 3 and mk > thr[k] * thr[k] * o:
                    order = o + 1
                    kn = offs[order] + lp
                if miss[kn] > thr[kn]:
                    thr[kn] += (LPX_MAX_THRESHOLD - thr[kn]) >> (4 - order)
        cxt = ((cxt << 8) | byte) & M32


def lpx(buf: np.ndarray, spans: int) -> np.ndarray:
    """Lpx's inverse over `spans` equal spans, the last one taking the
    rest (fewer than `spans` bytes: one span)."""
    n = buf.size
    inp = buf.tobytes()
    out = bytearray(n)
    size = n // spans
    if size == 0:
        bounds = [(0, n)] if n else []
    else:
        bounds = [(s, size if s + size < n else n - s)
                  for s in range(0, n, size)]
    for base, length in bounds:
        _lpx_span(inp, out, base, length)
    return np.frombuffer(bytes(out), np.uint8)


# ---------------------------------------------------------------- filters

def _lpc(buf: bytes) -> np.ndarray:
    """An order-2 predictor with an adaptive weight, byte by byte."""
    out = bytearray(len(buf))
    weight = p1 = p2 = 0
    for i, err in enumerate(buf):
        cur = (weight + p1 + p1 - p2 - err) & 0xFF
        out[i] = cur
        weight += (err - weight) >> 6
        p2, p1 = p1, cur
    return np.frombuffer(bytes(out), np.uint8)


def _channels(n: int, width: int) -> np.ndarray:
    """Where the bytes of channel 0, then 1, ... of a width-wide
    interleave sit."""
    return np.concatenate([np.arange(c, n, width) for c in range(width)])


def filters(buf: np.ndarray) -> np.ndarray:
    """Per 64 KiB (the last chunk takes the rest): a (type, width) header,
    then the chunk as is (width 0), delta over its channels laid out one
    after another (type 0), LPC so (type 1), or a delta down each channel
    in place after the first n % width bytes (type 2)."""
    out, i, n = [], 0, buf.size
    while i < n:
        if i + 2 > n:
            raise CorruptArchive("truncated filter header")
        kind, width = int(buf[i]), int(buf[i + 1])
        i += 2
        if kind >= FILTER_TYPES or width > FILTER_WIDTH:
            raise CorruptArchive("unsupported filter configuration")
        size = FILTER_BLOCK if i + FILTER_BLOCK < n else n - i
        part = buf[i:i + size]
        if width and kind < 2:
            flat = (np.cumsum(part, dtype=np.uint8) if kind == 0
                    else _lpc(part.tobytes()))
            part = np.empty_like(flat)
            part[_channels(size, width)] = flat
        elif width:
            head = size % width
            body = np.cumsum(part[head:].reshape(-1, width), axis=0,
                             dtype=np.uint8)
            part = np.concatenate([part[:head], body.reshape(-1)])
        out.append(part)
        i += size
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


# ------------------------------------------------------------------ block

def decode_block(header, payload) -> np.ndarray:
    """One block's raw bytes; raises CorruptArchive on any fault, the
    checksum's included."""
    crc, blocksize, units, lanes, spans, _ = header
    cap = int(blocksize * 1.05) + 1024  # the reference's stage buffers
    try:
        s = entropy(memoryview(payload).tobytes(), lanes)
        s = lz77(inverse_bwt(s, units), cap)
        if spans:
            s = lpx(s, spans)
        s = lz77(filters(s), cap)
    except IndexError as e:
        raise CorruptArchive(f"stream ends inside a stage: {e}") from None
    if checksum(s) != crc:
        raise CorruptArchive("detected corrupt block")
    return s


def decode(archive, blocksize: int = None) -> bytes:
    """The raw bytes of a whole archive, in this process (`blocksize` as
    read_header's)."""
    f = io.BytesIO(archive)
    parts = []
    while (h := read_header(f, blocksize)) is not None:
        payload = f.read(h[-1])
        if len(payload) < h[-1]:
            raise CorruptArchive("truncated block payload")
        parts.append(decode_block(h, payload).tobytes())
    return b"".join(parts)


def chunks(payload, lanes: int) -> int:
    """Check a block's entropy framing without decoding it: every chunk
    header's frequencies add up to its olen, olen and rlen are at most a
    chunk, the lane table adds up, and the chunks tile the payload.
    Returns the stage's length (the sum of olen)."""
    pos = total = 0
    while pos < len(payload):
        freqs = 0
        for _ in range(256):
            f, pos = leb128(payload, pos)
            freqs += f
        olen, pos = leb128(payload, pos)
        clen, pos = leb128(payload, pos)
        rlen, pos = leb128(payload, pos)
        if olen > CHUNK or rlen > CHUNK or freqs != olen:
            raise CorruptArchive("corrupt chunk header")
        if lanes >= 2:
            table, p = 0, pos
            for _ in range(lanes):
                v, p = leb128(payload, p)
                table += v
            if table != clen - (p - pos):
                raise CorruptArchive("corrupt lane table")
        pos += clen
        total += olen
    if pos != len(payload):
        raise CorruptArchive("the chunks overrun the block")
    return total


def check_block(archive: str, raw: str, at: int, header, block: int,
                full: bool) -> dict:
    """Check block `block` of the archive file (its payload at `at`)
    against the raw file's bytes at block * blocksize, a block long or up
    to the raw file's end: decoded in full, or (full=False) its entropy
    framing and its header's checksum of those raw bytes."""
    start = time.perf_counter()
    got = {"block": block, "full": full, "bytes": 0, "wrong": 0,
           "error": None, "seconds": 0.0}
    with open(archive, "rb") as f:
        f.seek(at)
        payload = f.read(header[-1])
    with open(raw, "rb") as f:
        f.seek(block * header[1])
        want = np.frombuffer(f.read(header[1]), np.uint8)
    try:
        if full:
            data = decode_block(header, payload)
            got["bytes"] = int(data.size)
            n = min(data.size, want.size)
            got["wrong"] = int(np.count_nonzero(want[:n] != data[:n])
                               + abs(data.size - want.size))
        else:
            chunks(payload, header[3])
            if checksum(want) != header[0]:
                raise CorruptArchive("the header's checksum is not that "
                                     "of the raw bytes")
            got["bytes"] = int(want.size)
    except (CorruptArchive, IndexError) as e:
        got["error"] = str(e) or type(e).__name__
    got["seconds"] = time.perf_counter() - start
    return got


def verify(archive: str, raw: str, blocksize: int, full=None,
           workers: int = 0) -> list:
    """Check the archive file against the raw file it was written from:
    as many blocks as the raw file fills and one more (the reference's
    end-of-file rule), each stating `blocksize`; the blocks in `full`
    (default: every one) decoded in full and compared with their raw
    bytes, the others checked by check_block(full=False).  workers > 0:
    that many worker processes (this module's command line), each full
    block on its own and the rest shared out; 0: in this process.
    Returns each block's record (a block at fault: its `error` or its
    bytes `wrong`); raises CorruptArchive where the archive cannot be
    read at all."""
    blocks = index(archive, blocksize)
    size = os.path.getsize(raw)
    if len(blocks) != size // blocksize + 1:
        raise CorruptArchive(f"{len(blocks)} blocks for {size} raw bytes "
                             f"in blocks of {blocksize}")
    full = set(range(len(blocks)) if full is None else full)
    if workers:
        # the full decodes first, longest payload first; the rest after
        heavy = sorted(full, key=lambda b: -blocks[b][1][-1])
        light = [b for b in range(len(blocks)) if b not in full]
        tasks = [[f"+{b}"] for b in heavy] + [
            [str(b) for b in light[k::workers]] for k in range(workers)]
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))

        def run(task):
            if not task:
                return []
            p = subprocess.run(
                [sys.executable, "-m", __spec__.name, archive, raw,
                 str(blocksize), *task],
                capture_output=True, text=True, cwd=root)
            if p.returncode:
                raise CorruptArchive(f"the decoder of {task} exited "
                                     f"{p.returncode}: {p.stderr[-2000:]}")
            return [json.loads(line) for line in p.stdout.splitlines()]

        with ThreadPoolExecutor(workers) as pool:
            got = [g for part in pool.map(run, tasks) for g in part]
        got.sort(key=lambda g: g["block"])
    else:
        got = [check_block(archive, raw, at, h, b, b in full)
               for b, (at, h) in enumerate(blocks)]
    return got


def main(argv) -> int:
    """ARCHIVE RAW BLOCKSIZE INDEX...: check_block of each block, "+INDEX"
    decoded in full."""
    archive, raw, blocksize, *blocks = argv
    where = index(archive, int(blocksize))
    for b in blocks:
        k = int(b.lstrip("+"))
        print(json.dumps(check_block(archive, raw, *where[k], k,
                                     b.startswith("+"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
