"""The port's per-stage GPU engine against the JAX package's per-stage
engine on the CPU: the BWT both ways and the entropy stage (the file of
the filter, Lpx and LZ stages is tests/test_torch_engines.py).

GpuEngine("cpu") runs the plain PyTorch versions of K1, K3, K4 and K5;
TpuEngine runs the JAX functions on the CPU.  The same seeded numpy inputs
go through both; every comparison is exact, byte for byte."""

import numpy as np
import pytest

from jampack_tpu.runtime.engines import NativeEngine as JaxNative
from jampack_tpu.runtime.engines import TpuEngine
from jampack_tpu_torch.runtime.engines import GpuEngine

from golden_cases import one_thread
from lz_encode_cases import mixed

JN = JaxNative()


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def engines():
    return TpuEngine(), GpuEngine("cpu")


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("units", [1, 24, 120, 960])
@pytest.mark.parametrize("n", [0, 5, 119, 120, 961, 5000])
def test_bwt_both_ways(engines, units, n):
    """Every length, below one anchor unit included: the per-stage forward
    BWT writes the native engine's bytes there (ROADMAP C7 is the fused
    encode's alone)."""
    jax_eng, gpu = engines
    data = mixed(max(n, 1), n)[:n]
    fwd = gpu.bwt_forward(data, units)
    _eq(fwd, jax_eng.bwt_forward(data, units))
    _eq(fwd, JN.bwt_forward(data, units))
    _eq(gpu.bwt_inverse(fwd, units), jax_eng.bwt_inverse(fwd, units))
    _eq(gpu.bwt_inverse(fwd, units), data)


def test_bwt_inverse_bad_anchor_raises(engines):
    jax_eng, gpu = engines
    fwd = JN.bwt_forward(mixed(4000, 2), 24).copy()
    fwd[-4:] = 0xFF  # anchor past the row count
    for eng in engines:
        with pytest.raises(ValueError):
            eng.bwt_inverse(fwd, 24)


@pytest.mark.parametrize("chunk,lanes", [(4096, 0), (1 << 20, 0),
                                         (16384, 4), (2048, 16)])
def test_ans_both_ways(engines, chunk, lanes):
    jax_eng, gpu = engines
    s4 = JN.bwt_forward(JN.lz_encode(mixed(6000, chunk % 7), 1), 120)
    enc = gpu.ans_encode(s4, chunk, lanes)
    assert enc == jax_eng.ans_encode(s4, chunk, lanes)
    assert enc == bytes(JN.ans_encode(s4, chunk, lanes))
    buf = np.frombuffer(enc, np.uint8)
    _eq(gpu.ans_decode(buf, lanes=lanes), jax_eng.ans_decode(buf, lanes=lanes))
    _eq(gpu.ans_decode(buf, lanes=lanes), s4)


def test_ans_heavy_quasi_rescale(engines):
    """The wrap regime of tests/test_ans.py::test_ans_heavy_quasi_rescale_
    roundtrip: a constant high MTF rank hammers one quasi-model mantissa
    through many rescales; it encodes, and both engines agree."""
    jax_eng, gpu = engines
    data = np.tile(np.arange(251, dtype=np.uint8), 97)
    enc = gpu.ans_encode(data, 4096, 0)
    assert enc == jax_eng.ans_encode(data, 4096, 0)
    _eq(gpu.ans_decode(np.frombuffer(enc, np.uint8)), data)


def test_ans_decode_corrupt_raises(engines):
    jax_eng, gpu = engines
    enc = bytearray(JN.ans_encode(mixed(3000, 1), 1024, 4))
    enc[-3] ^= 0x5A
    for eng in engines:
        with pytest.raises(ValueError):
            eng.ans_decode(np.frombuffer(bytes(enc), np.uint8), lanes=4)


def test_empty_streams(engines):
    jax_eng, gpu = engines
    z = np.zeros(0, np.uint8)
    assert gpu.ans_encode(z) == jax_eng.ans_encode(z) == b""
    _eq(gpu.ans_decode(z), jax_eng.ans_decode(z))
    _eq(gpu.lpx_encode(z), jax_eng.lpx_encode(z))
    _eq(gpu.filters_decode(z), jax_eng.filters_decode(z))
