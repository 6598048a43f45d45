"""The host-LZ encode route (-m0/-m1/-m2) on the CPU, held against the JAX
package and the native host engine, exactly.

The port's LZ stage (runtime.engines.NativeEngine.lz_encode over its native
copy, which the device encode runs) against
the native and the spec engines; encode_front and encode_back against
JAX's encode_front_jit and encode_back_jit on the same stage streams and
picks; the CLI's default encode against the JAX package's CLI and
golden_f1.jam.  The block payloads are in test_torch_lz_encode_blocks.py,
the golden archives in the test_torch_lz_encode_golden*.py files."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jampack_tpu.kernels.encode_stages import encode_back_jit, encode_front_jit
from jampack_tpu.runtime.engines import NativeEngine
from jampack_tpu.runtime.pipeline import Engine, Options, compress_block_ex
from jampack_tpu_torch.kernels.encode_stages import encode_back, encode_front
from jampack_tpu_torch.runtime.device_encode import (
    encode_block_device_ex,
    filter_configs,
)
from jampack_tpu_torch.runtime.engines import NativeEngine as PortNative

from golden_cases import one_thread
from lpx_cases import log_records
from lz_encode_cases import block, mixed

lz_encode = PortNative().lz_encode
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
FBS = 64 << 10


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


# ---------------------------------------------------------------------------
# the LZ stage


_LZ_CASES = {
    "empty": lambda: np.zeros(0, np.uint8),
    "one": lambda: np.asarray([7], np.uint8),
    "mixed3k": lambda: mixed(3000, 3),
    "records64k": lambda: log_records(64 << 10),
    "random": lambda: np.random.default_rng(5).integers(0, 256, 5000,
                                                        dtype=np.uint8),
}


@pytest.mark.parametrize("case", sorted(_LZ_CASES))
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_lz_encode_matches_native_and_spec(mode, case):
    data = _LZ_CASES[case]()
    got = lz_encode(data, mode)
    assert got.dtype == np.uint8
    assert np.array_equal(got, np.asarray(NativeEngine().lz_encode(data, mode)))
    assert np.array_equal(got, np.asarray(Engine().lz_encode(data, mode)))


# ---------------------------------------------------------------------------
# encode_front against encode_front_jit


def _cap(n: int) -> int:
    """The JAX route's pow2 capacity (device_encode._bucket_cap)."""
    return max(1 << (max(n, 1) - 1).bit_length(), 1 << 16)


def _front_input(kind: str):
    """A stage-1 stream of `kind`.  -S4096 needs n2 % 4096 <= n2 // 4096
    for JAX's device walk (lpx_dyn_core's supported split): 131,068 bytes
    make n2 = 131,072."""
    if kind == "lz":
        return lz_encode(block(24000, 1), 0)
    if kind == "records128k":
        return log_records(2 * FBS - 4)
    return block(30000, 2)


@pytest.mark.parametrize("kind,filters,spans,auto", [
    ("lz", 0, 0, False), ("lz", 1, 4, False), ("lz", 2, 4, False),
    ("raw", 1, 4, True), ("raw", 0, 4, True), ("records128k", 1, 4096, False),
    ("records128k", 2, 4096, True), ("records128k", 0, 4096, True)])
def test_encode_front_matches_jax(kind, filters, spans, auto):
    s1 = _front_input(kind)
    n1 = s1.size
    fc = filter_configs(torch.from_numpy(s1.copy()), filters)
    s2, kept = encode_front(torch.from_numpy(s1.copy()), fc, lpx_spans=spans,
                            lpx_auto=auto)
    nf = -(-n1 // FBS)
    assert s2.numel() == n1 + 2 * nf
    cap1 = _cap(n1)
    pad1 = np.zeros(cap1, np.uint8)
    pad1[:n1] = s1
    fc_j = None
    if fc is not None:
        fc_j = np.zeros((-(-cap1 // FBS), 2), np.int32)
        fc_j[:nf] = fc
        fc_j = jnp.asarray(fc_j)
    w2, wn2, sup, keep = encode_front_jit(jnp.asarray(pad1), jnp.int32(n1),
                                          fc_j, lpx_spans=spans,
                                          lpx_auto=auto)
    assert bool(sup), "the case left JAX's device Lpx split"
    assert int(wn2) == s2.numel()
    assert np.array_equal(s2.numpy(), np.asarray(w2)[:int(wn2)])
    assert kept == bool(keep)
    if not spans:
        assert not kept
    elif not auto:
        assert kept


# ---------------------------------------------------------------------------
# encode_back against encode_back_jit


@pytest.mark.parametrize("n,mode,units,chunk,lanes", [
    (30000, 0, 120, 1 << 20, 0),   # the JAM shape: one chunk, no lanes
    (20000, 1, 960, 4096, 4),      # n3 % units != 0
    (20000, 2, 24, 2048, 16),
    (300, 0, 120, 4096, 4),        # n3 < 4 * units
    (100, 2, 24, 1 << 20, 0)])
def test_encode_back_matches_jax(n, mode, units, chunk, lanes):
    s3 = lz_encode(block(n, n), mode)
    n3 = s3.size
    got = encode_back(torch.from_numpy(s3.copy()), units=units, chunk=chunk,
                      lanes=lanes)
    pad3 = np.zeros(_cap(n3), np.uint8)
    pad3[:n3] = s3
    want = [np.asarray(w) for w in encode_back_jit(
        jnp.asarray(pad3), jnp.int32(n3), units=units, chunk=chunk,
        lanes=lanes)]
    bufs, ptrs, oks, freqs, rlens = (g.numpy() for g in got)
    C = -(-(n3 + 4 * units) // chunk)
    NL = C * max(lanes, 1)
    assert freqs.shape == (C, 256) and rlens.shape == (C,) and ptrs.shape == (NL,)
    assert np.array_equal(freqs, want[3][:C])
    assert np.array_equal(rlens, want[4][:C])
    assert np.array_equal(ptrs, want[1][:NL])
    assert np.array_equal(oks, want[2][:NL]) and oks.all()
    for l in range(NL):
        assert np.array_equal(bufs[l, ptrs[l]:], want[0][l, ptrs[l]:]), l


def test_encode_back_below_one_unit_follows_native():
    """A stage-4 stream shorter than one anchor unit (the empty block's two
    bytes at -m0): no byte is suffix-sorted, and the native engine writes
    every anchor 0 where JAX's encode_back_core writes 1 (its anchors are
    isa + 1 of an empty sort).  JAX's route never takes such a stream to
    the device (encode_block_device_lz sends streams under max(4 * units,
    1024) bytes to its host engine); the port encodes it on the device and
    follows the native engine, as the block tests below hold."""
    s3 = lz_encode(np.zeros(0, np.uint8), 0)
    freqs = encode_back(torch.from_numpy(s3.copy()), units=120,
                        chunk=1 << 20, lanes=0)[3].numpy()
    pad3 = np.zeros(_cap(s3.size), np.uint8)
    pad3[:s3.size] = s3
    want = np.asarray(encode_back_jit(jnp.asarray(pad3), jnp.int32(s3.size),
                                      units=120, chunk=1 << 20, lanes=0)[3])
    assert freqs[0, 0] == 480 and freqs[0, 1] == 0
    assert want[0, 0] == 360 and want[0, 1] == 120
    opt = Options(blocksize=1 << 20, match_finder=0, filters=0, lpx_spans=0)
    assert encode_block_device_ex(np.zeros(0, np.uint8), opt, "cpu") == \
        compress_block_ex(np.zeros(0, np.uint8), opt, NativeEngine())


# ---------------------------------------------------------------------------
# the CLI's default encode


def test_cli_default_encode_matches_host_and_golden(tmp_path):
    """`cli c` with no flag writes the reference's default archive (-m0
    -f1 -S4, JAM), equal to the JAX package's CLI and golden_f1.jam."""
    src = os.path.join(FIXTURES, "golden_input.bin")
    host, dev = tmp_path / "host.jam", tmp_path / "dev.jam"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for pkg, out, extra in (("jampack_tpu", host, []),
                            ("jampack_tpu_torch", dev, ["--device", "cpu"])):
        res = subprocess.run([sys.executable, "-m", f"{pkg}.cli", "c", src,
                              str(out), *extra], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr
    with open(os.path.join(FIXTURES, "golden_f1.jam"), "rb") as f:
        golden = f.read()
    assert dev.read_bytes() == host.read_bytes() == golden
