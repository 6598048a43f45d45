"""The port's fused block decode, its stream decode and its CLI, on the CPU.

decode_block_device(..., device="cpu") runs the whole chain with the plain
PyTorch versions of the kernels; it must give the original bytes, and the
JAX decode_block_device's bytes where both run."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from jampack_tpu.runtime.device_decode import decode_block_device as jax_decode
from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu.runtime.pipeline import Options, compress_block_ex
from jampack_tpu_torch.runtime.device_decode import (
    decode_block_device,
    decompress_stream_device,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    rec = np.frombuffer(b"".join(bytes([i % 256, (i * 3) % 256, 7])
                                 for i in range(n // 6)), np.uint8)
    txt = np.frombuffer((b"device resident decode " * (n // 23 + 1))[: n // 3],
                        np.uint8)
    noise = rng.integers(0, 5, n // 4).astype(np.uint8)
    return np.concatenate([rec, txt, noise, rec[:400]])


def _block(filters, lanes, units, n=7000, seed=0):
    data = _corpus(n, seed)
    opt = Options(blocksize=1 << 20, filters=filters, anchor_units=units,
                  rans_lanes=lanes, ans_chunk=4096 if lanes else 1 << 20,
                  lpx_spans=0)
    crc, payload, spans = compress_block_ex(data, opt, NativeEngine())
    assert spans == 0
    return data, opt, crc, payload


# the JAX chain compiles once per shape: hold it to four of the cases
_JAX_CASES = {(0, 4, 24), (1, 0, 960), (2, 4, 960), (1, 4, 24)}


@pytest.mark.parametrize("units", [24, 960])
@pytest.mark.parametrize("lanes", [0, 4])
@pytest.mark.parametrize("filters", [0, 1, 2])
def test_block_decode_matches_original_and_jax(filters, lanes, units):
    data, opt, crc, payload = _block(filters, lanes, units)
    got = decode_block_device(payload, crc, opt.blocksize, units, lanes, 0,
                              device="cpu")
    assert np.array_equal(got, data)
    if (filters, lanes, units) in _JAX_CASES:
        want = jax_decode(payload, crc, opt.blocksize, units, lanes, 0)
        assert np.array_equal(got, np.asarray(want))


def test_golden_jt3_prod_fixture_decodes():
    out = io.BytesIO()
    comp, raw = decompress_stream_device(
        io.BytesIO(_read("golden_jt3_prod_u960_L4_c16_Sa.jt3")), out, "cpu")
    assert out.getvalue() == _read("golden_input.bin")
    assert raw == len(out.getvalue())


def test_flipped_payload_byte_raises():
    data, opt, crc, payload = _block(1, 4, 24, n=5000, seed=3)
    bad = bytearray(payload)
    bad[len(bad) // 2] ^= 0x40
    with pytest.raises(ValueError):
        decode_block_device(bytes(bad), crc, opt.blocksize, 24, 4, 0,
                            device="cpu")


def test_cli_round_trip_on_cpu(tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(_corpus(20000, 5).tobytes())
    arc, back = tmp_path / "in.jt3", tmp_path / "back.bin"
    cmd = [sys.executable, "-m", "jampack_tpu_torch.cli"]
    # a host encode (the JAX package's CLI, native engine), the port's decode
    res = subprocess.run([sys.executable, "-m", "jampack_tpu.cli", "c",
                          str(src), str(arc), "-c4", "-L4", "-u24", "-S0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    res = subprocess.run([*cmd, "d", str(arc), str(back), "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[fused x1: cpu]" in res.stdout
    assert back.read_bytes() == src.read_bytes()
