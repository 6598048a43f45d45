"""The port's per-stage GPU engine against the JAX package's per-stage
engine, stage by stage, on the CPU.

GpuEngine("cpu") runs the plain PyTorch versions of the kernels (K1, K3,
K4, K5, K7, K8, K10, K11); TpuEngine runs the JAX functions on the CPU.
The same seeded numpy inputs go through both; every comparison is exact,
byte for byte.  Inputs stay small: the plain walks step in Python."""

import numpy as np
import pytest

from jampack_tpu.runtime.engines import NativeEngine as JaxNative
from jampack_tpu.runtime.engines import TpuEngine
from jampack_tpu_torch.runtime.engines import GpuEngine

from golden_cases import one_thread
from lz_encode_cases import block, mixed, sines

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


def _s1(n, seed):
    """A dedupe-stage stream, the filter stage's input."""
    return JN.lz_encode(block(n, seed), 0)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_filters_encode(engines, mode):
    jax_eng, gpu = engines
    s1 = _s1(24000, mode)
    _eq(gpu.filters_encode(s1, mode), jax_eng.filters_encode(s1, mode))


@pytest.mark.parametrize("kind", ["sines", "text", "noise", "ramp", "tiny",
                                  "empty", "short_tail"])
def test_filters_encode_f3_picks(engines, kind):
    """-f3 has no native counterpart (the native engine clamps it to -f2):
    its picks are TpuEngine's own, an inline delta or raw a chunk."""
    jax_eng, gpu = engines
    rng = np.random.default_rng(31)
    data = {"sines": sines(150000, 2),
            "text": mixed(70000, 4),
            "noise": rng.integers(0, 256, 70000).astype(np.uint8),
            "ramp": (np.arange(70000) * 3 % 256).astype(np.uint8),
            "tiny": sines(9, 1),
            "empty": np.zeros(0, np.uint8),
            "short_tail": sines((1 << 16) + 3, 5)}[kind]
    got = gpu.filters_encode(data, 3)
    _eq(got, jax_eng.filters_encode(data, 3))
    _eq(gpu.filters_decode(got), data)
    _eq(JN.filters_decode(got), data)


def test_filters_encode_f3_scores_agree_within_float32():
    """JAX sums the entropy terms in float32, the port in float64, so a
    pick can flip between the two where the least score of a chunk and
    the next (or the least and the raw score less PICK_MARGIN) lie within
    float32 rounding of each other (ROADMAP C8).  The scores agree to 1e-5
    bits a byte; on these chunks the pick's margins are wider than that,
    so the picks are equal."""
    import jax.numpy as jnp
    import torch

    from jampack_tpu.kernels.filters import score_delta_configs as jax_scores
    from jampack_tpu_torch.kernels import filters as f3
    from jampack_tpu_torch.kernels.encode_stages import filter_rows

    rng = np.random.default_rng(8)
    chunks = [sines(1 << 16, 3), mixed(1 << 16, 5),
              rng.integers(0, 256, 40000).astype(np.uint8),
              np.tile(np.arange(12, dtype=np.uint8), 3000)]
    for c in chunks:
        rows, lens, _ = filter_rows(torch.from_numpy(c.copy()))
        mine = f3.score_delta_configs(rows, lens).numpy()[0]
        ref = np.asarray(jax_scores(jnp.asarray(c), c.size), np.float64)
        assert np.abs(mine - ref).max() < 1e-5
        least, second = np.sort(mine)[:2]
        margin = min(second - least, abs(least - (mine[0] - f3.PICK_MARGIN)))
        assert margin > 1e-5
        assert f3.pick_configs(mine[None], [c.size]) == [
            tuple(int(v) for v in TpuEngine().filters_encode(c, 3)[:2])]


@pytest.mark.parametrize("mode", [1, 2])
def test_filters_decode(engines, mode):
    jax_eng, gpu = engines
    s2 = JN.filters_encode(_s1(30000, 7), mode)
    _eq(gpu.filters_decode(s2), jax_eng.filters_decode(s2))


@pytest.mark.parametrize("spans", [1, 4, 16])
def test_lpx_below_the_c6_bound(engines, spans):
    """Spans under 26.7 KiB, where the JAX walk and the native engine agree
    (ROADMAP C6)."""
    jax_eng, gpu = engines
    s2 = JN.filters_encode(_s1(12000, 3), 1)
    enc = gpu.lpx_encode(s2, spans)
    _eq(enc, jax_eng.lpx_encode(s2, spans))
    _eq(gpu.lpx_decode(enc, spans), jax_eng.lpx_decode(enc, spans))
    _eq(gpu.lpx_decode(enc, spans), s2)


@pytest.mark.parametrize("mode", [3, 0, 1, 2])
def test_lz_decode(engines, mode):
    jax_eng, gpu = engines
    data = block(30000, mode)
    s = JN.lz_encode(data, mode) if mode != 3 else jax_eng.lz_encode(data, 3)
    _eq(gpu.lz_decode(s), jax_eng.lz_decode(s))
    _eq(gpu.lz_decode(s, cap=data.size), data)


def test_lz_decode_empty_and_corrupt(engines):
    from jampack_tpu_torch.stages.lz77 import write_token

    jax_eng, gpu = engines
    _eq(gpu.lz_decode(np.zeros(0, np.uint8)),
        jax_eng.lz_decode(np.zeros(0, np.uint8)))
    # a match reaching back past the start of the output
    s = np.frombuffer(write_token(4, 2, 100) + b"ab"
                      + write_token(4, 4, 0) + b"tail", np.uint8)
    for eng in engines:
        with pytest.raises(ValueError):
            eng.lz_decode(s)
