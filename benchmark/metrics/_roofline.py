"""A kernel's roofline: the least time the card could take for its work.

The least time is the larger of the bytes the work needs over the card's
memory bandwidth and the int32 operations it needs over the card's peak
integer rate.  It has no serial floor (chip_smoke.bound adds one that
depends on how a kernel splits its chains), so the share reads the same
work whatever implements it, and no share can pass 100% unless the counts
are too high or the kernel time leaves work out.

The counts come from the archive's own streams, parsed here from the
format (the framing of format/framing.py, the chunk headers of
stages/ans.py, the LEB128 of format/varint.py, frozen in this file)."""

import struct

# H100 SXM5 at its 700 W limit.  Bandwidth: NVIDIA's H100 data sheet,
# 3.35 TB/s of HBM3.  int32: NVIDIA H100 Tensor Core GPU Architecture
# whitepaper (2022): 132 SMs, each with 64 INT32 lanes (16 in each of its
# four partitions, beside 32 FP32 lanes), at the 1.98 GHz boost clock at
# which the data sheet's 67 TFLOPS of FP32 hold (132 x 128 lanes x 2 x
# 1.98e9): 132 x 64 x 1.98e9 = 16.73e12 int32 instructions a second, each
# of K1's counted operations one instruction.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "int32_ops_per_s": 132 * 64 * 1.98e9}}

_HEADER = struct.Struct("<3sIii")
_EXT = {b"JAM": 0, b"JTX": 8, b"JT3": 12}
_LEB_BASE = (0xFF >> 1,
             (0xFFFF >> 2) + (0xFF >> 1),
             (0xFFFFFF >> 3) + (0xFFFF >> 2) + (0xFF >> 1),
             (0xFFFFFFFF >> 4) + (0xFFFFFF >> 3) + (0xFFFF >> 2) + (0xFF >> 1))


def leb128(buf, pos: int):
    """(value, next position) of the format's varint at buf[pos]: 7-bit
    groups, big-endian, 0x80 on the last byte, each length a range of its
    own."""
    d = val = 0
    while not buf[pos + d] & 0x80:
        val = (val << 7) | buf[pos + d]
        d += 1
    val = (val << 7) | (buf[pos + d] & 0x7F)
    return val + (_LEB_BASE[d - 1] if d else 0), pos + d + 1


def blocks(archive: bytes):
    """(lanes, payload) of each framed block."""
    pos = 0
    while pos < len(archive):
        magic, _, csize, _ = _HEADER.unpack_from(archive, pos)
        ext = _EXT[magic]
        lanes = (struct.unpack_from("<i", archive, pos + _HEADER.size + 4)[0]
                 if ext else 0)
        start = pos + _HEADER.size + ext
        yield lanes, memoryview(archive)[start:start + csize]
        pos = start + csize


def chains(archive: bytes) -> dict:
    """The entropy stage of every block: its rANS chains, their payload
    bytes (lane tables left out) and their symbols."""
    out = {"chains": 0, "chain_bytes": 0, "symbols": 0}
    for lanes, payload in blocks(archive):
        pos = 0
        while pos < len(payload):
            for _ in range(256 + 1):  # rank frequencies, olen
                _, pos = leb128(payload, pos)
            clen, pos = leb128(payload, pos)
            rlen, body = leb128(payload, pos)
            table = body
            for _ in range(lanes if lanes >= 2 else 0):
                _, table = leb128(payload, table)
            out["chains"] += max(lanes, 1)
            out["chain_bytes"] += clen - (table - body)
            out["symbols"] += rlen
            pos = body + clen
    return out


def k1_work(archive: bytes):
    """(bytes, int32 ops) that K1, the rANS decode, needs for the archive:
    each chain's payload read once, its start and length (8 bytes) read
    and its status byte written, each RLE0 symbol written once at the
    format's 16 bits; 60 ops a symbol (chip_smoke's count: its two pairs'
    range searches of the model bank, state updates and renormalisations,
    and the model updates)."""
    c = chains(archive)
    moved = c["chain_bytes"] + 9 * c["chains"] + 2 * c["symbols"]
    return moved, 60 * c["symbols"]


def least_seconds(moved: int, ops: int, kind: str) -> float:
    peak = PEAKS[kind]
    return max(moved / peak["bytes_per_s"], ops / peak["int32_ops_per_s"])


def k4_work(archive: bytes):
    """(bytes, int32 ops) that K4, the encode's model pass, needs for the
    archive: each chain's RLE0 symbols read once at the format's 16 bits,
    its length read (4 bytes) and its ok flag written (1), each symbol's
    exponent and mantissa ops written as a 16-bit low and a 16-bit
    frequency each (8 bytes); 50 ops a symbol (chip_smoke's count: the
    exponent's ballot, two pairs from the model bank, the bank's
    update)."""
    c = chains(archive)
    return 10 * c["symbols"] + 5 * c["chains"], 50 * c["symbols"]
