"""Lpx — localized prefix model (bijective XOR-prediction filter).

Order-1..3 context tables (256 records each) track consecutive hits of a
leading prefix byte; when a record's hits exceed its adaptive threshold and
the anchor distance is under 64 KB, the coder emits input[i-dist] ^ input[i]
runs until the first nonzero prediction error.  Output size == input size.
The block is split into 4 equal sub-blocks, each modeled independently
(format-visible split).

Reference behavior: lpx.cpp:11-170, thresholds lpx.hpp:14-16.
"""

import numpy as np

from ..format.constants import (
    LPX_MAX_RECORD_SIZE,
    LPX_MAX_THRESHOLD,
    LPX_MIN_THRESHOLD,
)

_M32 = 0xFFFFFFFF


class _Tables:
    """3 order tables of 256 records: cxt, pos, hits, miss, threshold."""

    __slots__ = ("cxt", "pos", "hits", "miss", "threshold")

    def __init__(self):
        self.cxt = [[0] * 256 for _ in range(3)]
        self.pos = [[0] * 256 for _ in range(3)]
        self.hits = [[0] * 256 for _ in range(3)]
        self.miss = [[0] * 256 for _ in range(3)]
        self.threshold = [[LPX_MAX_THRESHOLD >> 1] * 256 for _ in range(3)]


def _update_table(tb: _Tables, cxt: int, pos: int, order: int) -> int:
    """Returns the (possibly adjusted) order.  lpx.cpp:11-54."""
    o = order
    lp = (cxt >> (o * 8)) & 0xFF
    ls = cxt & ((1 << (o * 8)) - 1)
    t = o - 1
    distance = pos - tb.pos[t][lp]  # int; pos stored values are <= pos

    lower = LPX_MIN_THRESHOLD
    if tb.hits[t][lp] < LPX_MAX_THRESHOLD:
        upper = max(distance, LPX_MIN_THRESHOLD)
    else:
        upper = min(distance >> o, LPX_MAX_THRESHOLD >> o)

    bound = lower if distance <= lower else (upper if distance > upper else distance)

    # The reference re-dereferences *order at every use (lpx.cpp:29-52), so
    # after an order[0]--/++ the trailing threshold check reads AND writes
    # the NEW order's record for the same leading prefix, not the record
    # that was just updated.
    if pos > o:
        if tb.cxt[t][lp] == ls:
            tb.pos[t][lp] = pos - o
            tb.hits[t][lp] += 1
            tb.miss[t][lp] = 0
            if (
                tb.hits[t][lp] > ((tb.threshold[t][lp] << o) << 3)
                and o > 1
                and o <= 3
            ):
                o -= 1
            tn = o - 1
            if tb.hits[tn][lp] > (tb.threshold[tn][lp] << 1) and tb.miss[tn][lp] == 0:
                tb.threshold[tn][lp] += (bound - tb.threshold[tn][lp]) >> o
        else:
            tb.hits[t][lp] >>= 2
            tb.miss[t][lp] += 1
            tb.cxt[t][lp] = ls
            if (
                tb.miss[t][lp] > tb.threshold[t][lp] * tb.threshold[t][lp] * o
                and o >= 1
                and o < 3
            ):
                o += 1
            tn = o - 1
            if tb.miss[tn][lp] > tb.threshold[tn][lp]:
                tb.threshold[tn][lp] += (LPX_MAX_THRESHOLD - tb.threshold[tn][lp]) >> (4 - o)
    return o


def _code_block(inp, out, length: int, decode: bool):
    tb = _Tables()
    cxt = 0
    order = 3
    # `orig` is the un-XORed data stream the predictions read from: the input
    # while encoding, the reconstructed output while decoding.
    orig = out if decode else inp
    i = 0
    while i < length:
        t = order - 1
        lp0 = cxt & 0xFF
        dist = (i - tb.pos[t][lp0]) & _M32  # unsigned int in reference
        if tb.hits[t][lp0] > tb.threshold[t][lp0] and dist < LPX_MAX_RECORD_SIZE:
            while True:
                if decode:
                    err = inp[i]  # the coded (XOR) byte drives the run exit
                    out[i] = orig[i - dist] ^ err
                else:
                    err = orig[i - dist] ^ inp[i]
                    out[i] = err
                order = _update_table(tb, cxt, i, order)
                cxt = ((cxt << 8) | orig[i]) & _M32
                i += 1
                if err != 0 or i >= length:
                    break
        else:
            out[i] = inp[i]
            order = _update_table(tb, cxt, i, order)
            cxt = ((cxt << 8) | out[i]) & _M32
            i += 1


def _split_spans(n: int, spans: int = 4):
    block = n // spans
    if block == 0:
        # degenerate tiny input: the reference would loop forever; treat the
        # whole input as one span (format-equivalent for n < 4)
        return [(0, n)] if n else []
    spans = []
    i = 0
    while i < n:
        ln = block if (i + block) < n else (n - i)
        spans.append((i, ln))
        i += block
    return spans


def lpx_encode(data: np.ndarray, spans: int = 4) -> np.ndarray:
    inp = bytearray(np.asarray(data, dtype=np.uint8).tobytes())
    out = bytearray(len(inp))
    for start, ln in _split_spans(len(inp), spans):
        _code_block(
            memoryview(inp)[start : start + ln],
            memoryview(out)[start : start + ln],
            ln,
            decode=False,
        )
    return np.frombuffer(bytes(out), dtype=np.uint8)


def lpx_decode(data: np.ndarray, spans: int = 4) -> np.ndarray:
    inp = bytearray(np.asarray(data, dtype=np.uint8).tobytes())
    out = bytearray(len(inp))
    for start, ln in _split_spans(len(inp), spans):
        _code_block(
            memoryview(inp)[start : start + ln],
            memoryview(out)[start : start + ln],
            ln,
            decode=True,
        )
    return np.frombuffer(bytes(out), dtype=np.uint8)
