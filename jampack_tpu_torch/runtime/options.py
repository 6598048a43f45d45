"""Codec options: the port's copy of jampack_tpu/runtime/pipeline.py's
Options record and its validators (same fields, defaults and ranges).

Every port function that takes options reads only their attributes, so it
takes this record or any object with the same attributes (the JAX
package's Options included).
"""

from ..format.constants import DEFAULT_BLOCKSIZE, MAX_BLOCKSIZE, MIN_BLOCKSIZE

MAX_RANS_LANES = 4096
MAX_LPX_SPANS = 1 << 16
LZ_MODE_STORE = 3


class Options:
    def __init__(self, blocksize=DEFAULT_BLOCKSIZE, match_finder=0, filters=1,
                 threads=1, multiblock=True, anchor_units=120,
                 ans_chunk=1 << 20, rans_lanes=0, lpx_spans=4,
                 lpx_auto=False):
        self.blocksize = int(min(max(blocksize, MIN_BLOCKSIZE), MAX_BLOCKSIZE))
        # 0..2 = the reference's finders (main.cpp:65-89 semantics);
        # 3 = "store": both LZ stages emit a bare end-token stream, so every
        # stage length is a function of the block size
        self.match_finder = validate_match_finder(match_finder)
        self.filters = filters
        self.threads = threads
        self.multiblock = multiblock
        # native stream parameters; anchor_units != 120 or rans_lanes >= 2
        # switches the block framing to the JTX native container
        self.anchor_units = anchor_units
        self.ans_chunk = ans_chunk
        self.rans_lanes = validate_rans_lanes(rans_lanes)
        # Lpx sub-block count: 4 = reference split (lpx.cpp:150-169); other
        # values switch framing to JT3; 0 = skip the Lpx stage
        self.lpx_spans = validate_lpx_spans(lpx_spans)
        # lpx_auto: write lpx_spans=0 into blocks where Lpx gains nothing
        self.lpx_auto = bool(lpx_auto)


def validate_match_finder(mode) -> int:
    mode = int(mode)
    if mode < 0 or mode > LZ_MODE_STORE:
        raise ValueError(f"match_finder {mode} out of range (0..3)")
    return mode


def validate_lpx_spans(spans) -> int:
    spans = int(spans)
    if spans < 0 or spans > MAX_LPX_SPANS:
        raise ValueError(f"lpx_spans {spans} out of range (0..{MAX_LPX_SPANS})")
    return spans


def validate_rans_lanes(lanes) -> int:
    """0 (classic 4-state stream) or 2..MAX_RANS_LANES; anything else is
    refused so that no header can disagree with its payload."""
    lanes = int(lanes)
    if lanes < 2:
        return 0
    if lanes > MAX_RANS_LANES:
        raise ValueError(
            f"rans_lanes {lanes} out of range (2..{MAX_RANS_LANES})"
        )
    return lanes
