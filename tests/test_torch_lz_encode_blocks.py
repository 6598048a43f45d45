"""The host-LZ encode route's block payloads (-m0/-m1/-m2) on the CPU,
byte-identical to the native compress_block_ex: every match finder x
-f0/-f1/-f2 x -S0/-S4/-S4096 -Sa, the empty block, one byte and a block
under 1,024 B at the JAM stream, and the production JT3 stream; each
decoded back by the port."""

import numpy as np
import pytest

from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu.runtime.pipeline import Options, compress_block_ex
from jampack_tpu_torch.runtime.device_decode import decode_block_device
from jampack_tpu_torch.runtime.device_encode import encode_block_device_ex

from golden_cases import one_thread
from lpx_cases import log_records
from lz_encode_cases import block


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _opt(mode, filters, spans, auto=False, **kw):
    kw = {"rans_lanes": 4, "ans_chunk": 4096, "anchor_units": 120, **kw}
    return Options(blocksize=1 << 20, match_finder=mode, filters=filters,
                   lpx_spans=spans, lpx_auto=auto, **kw)


def _check_block(data, opt):
    times = {}
    got = encode_block_device_ex(data, opt, "cpu", times)
    assert got == compress_block_ex(data, opt, NativeEngine())
    assert {"host_crc", "lz_pre", "h2d", "d2h_s2", "lz", "h2d_s3", "bwt",
            "rans", "d2h", "splice"} <= set(times)
    back = decode_block_device(got[1], got[0], opt.blocksize,
                               opt.anchor_units, opt.rans_lanes, got[2], "cpu")
    assert np.array_equal(back, data)
    return got


@pytest.mark.parametrize("spans,auto", [(0, False), (4, False), (4096, True)],
                         ids=["S0", "S4", "S4096a"])
@pytest.mark.parametrize("filters", [0, 1, 2])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_block_payload_matches_native(mode, filters, spans, auto):
    _check_block(block(24000, mode + 3 * filters), _opt(mode, filters, spans,
                                                         auto))


@pytest.mark.parametrize("n", [0, 1, 700])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_short_blocks_match_native(mode, n):
    """The empty block, one byte and a block under 1,024 B (the JAX
    package sends both of the last to its host engine) at the JAM
    stream."""
    _check_block(block(1000, n)[:n], _opt(mode, 1, 4, rans_lanes=0,
                                           ans_chunk=1 << 20))


@pytest.mark.parametrize("mode", [0, 2])
def test_jt3_stream_matches_native(mode):
    """The production stream's parameters (-c16 -L4 -u960 -S4096 -Sa) on
    the host-LZ route: the gate keeps the stage on the records' short
    lines."""
    data = np.concatenate([log_records(40000),
                           np.frombuffer(b"%05d,1,OK\n" * 3000, np.uint8)])
    _check_block(data, _opt(mode, 1, 4096, True, rans_lanes=4,
                            ans_chunk=16 << 10, anchor_units=960))
