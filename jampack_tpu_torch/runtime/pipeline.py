"""Per-block codec pipeline and whole-archive compress/decompress: the
port's copy of jampack_tpu/runtime/pipeline.py.

Encode chain per block (jampack.cpp:30-42):
    checksum -> LZ77 dedupe -> filters -> Lpx -> LZ77 (configured mode)
    -> forward BWT -> entropy (rank/RLE0/rANS)
Decode runs the inverse chain and verifies the checksum (jampack.cpp:47-58).

This module is engine-agnostic: `Engine` is the executable-spec
Python/numpy engine (the CLI's --engine numpy); the native C++ engine, the
per-stage GPU engine and the hybrid engine (runtime/engines.py) plug in
with the same stage interface.  Options and its validators live in
runtime/options.py.  tests/test_torch_standalone.py holds Engine and the
block and stream functions equal to their originals line for line, and
the gate by behaviour.
"""

import numpy as np

from ..format import checksum as _checksum
from ..format import framing
from ..format.constants import DEFAULT_BLOCKSIZE
from ..stages.ans import ans_decode, ans_encode
from ..stages.bwt import forward_bwt, inverse_bwt
from ..stages.filters import filters_decode, filters_encode
from ..stages.lpx import lpx_decode, lpx_encode
from ..stages.lz77 import lz77_decode, lz77_dedupe_encode
from .options import (  # noqa: F401  (re-exported, as the original defines them)
    LZ_MODE_STORE,
    MAX_LPX_SPANS,
    MAX_RANS_LANES,
    Options,
    validate_lpx_spans,
    validate_match_finder,
    validate_rans_lanes,
)


class Engine:
    """Executable-spec engine: pure Python/numpy stage implementations."""

    name = "numpy"

    def checksum(self, data) -> int:
        return _checksum.integrity_check(data)

    def lz_encode(self, data, mode: int):
        if mode == LZ_MODE_STORE:
            from ..stages.lz77 import lz77_store_encode

            return lz77_store_encode(data)
        if mode == 1:
            from ..stages.lz77_mf import lz77_m1_encode

            return lz77_m1_encode(data)
        if mode >= 2:
            from ..stages.lz77_mf import lz77_m2_encode

            return lz77_m2_encode(data)
        return lz77_dedupe_encode(data)

    def lz_decode(self, data, cap=None):
        return lz77_decode(data)

    def filters_encode(self, data, mode: int):
        return filters_encode(data, mode)

    def filters_decode(self, data):
        return filters_decode(data)

    def lpx_encode(self, data, spans=4):
        return lpx_encode(data, spans)

    def lpx_decode(self, data, spans=4):
        return lpx_decode(data, spans)

    def bwt_forward(self, data, units=120):
        return forward_bwt(data, units)

    def bwt_inverse(self, data, units=120):
        return inverse_bwt(data, units)

    def ans_encode(self, data, chunk=1 << 20, lanes=0):
        return ans_encode(data, chunk, lanes)

    def ans_decode(self, data, cap=None, lanes=0):
        return ans_decode(data, lanes=lanes)


# Lpx auto-gate threshold: keep the stage only when it zeroes at least
# NUM/DEN of the block's bytes (zeros feed RLE0 directly, so zeros-gained
# is the stage's whole downstream win).  Integer arithmetic, in gain_gate
# alone: the device encode (kernels/encode_stages.encode_front) computes
# the zero counts on the card and calls the same function, so the two
# comparisons cannot drift.
LPX_AUTO_GAIN_NUM = 1
LPX_AUTO_GAIN_DEN = 100
LPX_AUTO_MIN_ZERO_GAIN = LPX_AUTO_GAIN_NUM / LPX_AUTO_GAIN_DEN  # for display


def gain_gate(zeros_before: int, zeros_after: int, n: int) -> bool:
    """True when the Lpx stage's output of an n-byte block holds enough
    more zero bytes than its input."""
    if n == 0:
        return False
    return ((zeros_after - zeros_before) * LPX_AUTO_GAIN_DEN
            >= n * LPX_AUTO_GAIN_NUM)


def _lpx_gain_gate(before: np.ndarray, after: np.ndarray) -> bool:
    """True when the Lpx stage earns its decode cost on this block."""
    return gain_gate(int(np.count_nonzero(before == 0)),
                     int(np.count_nonzero(after == 0)), before.size)


def compress_block_ex(data: np.ndarray, opt: Options, engine=None):
    """Returns (crc, compressed_payload_bytes, lpx_spans_used).

    With opt.lpx_auto the Lpx stage is measured on this block and dropped
    (spans_used = 0) when its zero-gain is below LPX_AUTO_MIN_ZERO_GAIN;
    the caller must frame the block with the RETURNED span count."""
    eng = engine or Engine()
    data = np.asarray(data, dtype=np.uint8)
    crc = eng.checksum(data)
    # dedupe pre-pass: always mode 0 (jampack.cpp:34-36) except under the
    # store extension, which turns off both LZ stages
    pre = LZ_MODE_STORE if opt.match_finder == LZ_MODE_STORE else 0
    s = eng.lz_encode(data, pre)
    s = eng.filters_encode(s, opt.filters)
    spans = opt.lpx_spans
    if spans > 0:
        t = eng.lpx_encode(s, spans)
        if opt.lpx_auto and not _lpx_gain_gate(np.asarray(s), np.asarray(t)):
            spans = 0
        else:
            s = t
    s = eng.lz_encode(s, opt.match_finder)
    s = eng.bwt_forward(s, opt.anchor_units)
    payload = eng.ans_encode(s, opt.ans_chunk, opt.rans_lanes)
    return crc, bytes(payload), spans


def compress_block(data: np.ndarray, opt: Options, engine=None):
    """Returns (crc, compressed_payload_bytes).  Callers that frame blocks
    themselves must use compress_block_ex when opt.lpx_auto is set (the
    header's span word must match the encoder's per-block choice)."""
    crc, payload, spans = compress_block_ex(data, opt, engine)
    if spans != opt.lpx_spans:
        raise ValueError(
            "lpx_auto chose a different span count; use compress_block_ex")
    return crc, payload


def decompress_block(payload, crc: int, engine=None,
                     blocksize: int = DEFAULT_BLOCKSIZE,
                     units: int = 120, lanes: int = 0,
                     lpx_spans: int = 4) -> np.ndarray:
    eng = engine or Engine()
    # the reference sizes all stage buffers at 1.05x the block size
    cap = int(blocksize * 1.05) + 1024
    s = eng.ans_decode(np.frombuffer(payload, dtype=np.uint8), cap=cap,
                       lanes=lanes)
    s = eng.bwt_inverse(s, units)
    s = eng.lz_decode(s, cap=cap)
    if lpx_spans > 0:  # 0 = the encoder skipped the stage (framing.py)
        s = eng.lpx_decode(s, lpx_spans)
    s = eng.filters_decode(s)
    s = eng.lz_decode(s, cap=cap)
    out = np.asarray(s, dtype=np.uint8)
    if eng.checksum(out) != (crc & 0xFFFFFFFF):
        raise ValueError("detected corrupt block")
    return out


def compress_stream(inp, out, opt: Options = None, engine=None):
    """File-object to file-object archive compression.

    Replicates the reference's feof-driven read loop exactly
    (jampack.cpp:205-214): eof is only observed on a read PAST the data,
    so an input of K*blocksize bytes (including K = 0) compresses one
    extra EMPTY block — archive bytes are the contract."""
    opt = opt or Options()
    raw = comp = 0
    pending_empty = True  # empty input -> one empty block, like the ref
    while True:
        block = inp.read(opt.blocksize)
        data = np.frombuffer(block, dtype=np.uint8)
        if len(block) == 0 and not pending_empty:
            break
        crc, payload, spans = compress_block_ex(data, opt, engine)
        framing.write_block(out, crc, payload, opt.blocksize,
                            opt.anchor_units, opt.rans_lanes, spans)
        raw += len(block)
        comp += len(payload) + framing.HEADER_SIZE
        if len(block) == 0:
            break
        pending_empty = len(block) == opt.blocksize
    return raw, comp


def decompress_stream(inp, out, engine=None):
    raw = comp = 0
    while True:
        rec = framing.read_block(inp)
        if rec is None:
            break
        header, payload = rec
        data = decompress_block(payload, header.crc, engine,
                                header.blocksize, header.units, header.lanes,
                                header.lpx_spans)
        out.write(data.tobytes())
        comp += header.csize + framing.HEADER_SIZE
        raw += data.size
    return comp, raw
